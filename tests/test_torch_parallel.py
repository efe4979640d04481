"""The port's multi-device receive (fun_ofdm_tpu_torch.parallel) against
fun_ofdm_tpu.parallel, on the CPU.

The sharded receives run SPMD over 4 gloo ranks on the CPU (a 2 x 2
(channel, time) mesh), each rank a process that imports only torch and
the port: this file run as a script is that worker. The JAX side runs in
the pytest process on a 2 x 2 mesh of the virtual CPU devices that
tests/conftest.py sets up, and the two are held equal slot for slot in
fun_ofdm_tpu's global layout, on every rank. Frames straddle the time
cut. Every multi-process case has a hard limit: the process group times
out in 60 s, the parent waits a bounded time and kills what is left.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from fun_ofdm_tpu_torch.models import frontend
from fun_ofdm_tpu_torch.parallel import distributed, dryrun, stream_shard
from fun_ofdm_tpu_torch.parallel.mesh import make_mesh
from fun_ofdm_tpu_torch.rates import Rate, params_for

REPO = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(REPO))
#: seconds a spawned group may take
LIMIT = 120

BLOCK, CHANNELS = 4096, 2
STATIC = dict(rate=Rate.RATE_1_2_BPSK, length=20, max_frames=4)
DYNAMIC = dict(rates=(Rate.RATE_1_2_BPSK, Rate.RATE_3_4_QAM16),
               max_length=20, max_frames=4)
STATIC_KEYS = ("starts", "valid", "crc_ok", "header_ok", "payload")
DYNAMIC_KEYS = STATIC_KEYS + ("rate_field", "hdr_length", "detect_dropped")


# ------------------------------------------------- the worker (a rank) ----

def _worker(argv) -> int:
    """One rank: --inputs NPZ --out DIR (and launch()'s --rank,
    --world-size, --address). Runs both sharded receives on its block of
    a 2 x 2 mesh and writes the global results to DIR/rank<r>.npz."""
    import argparse

    ap = argparse.ArgumentParser()
    for flag in ("--inputs", "--out", "--address"):
        ap.add_argument(flag)
    ap.add_argument("--rank", type=int)
    ap.add_argument("--world-size", type=int)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    distributed.initialize(args.address, args.world_size, args.rank,
                           backend="gloo")
    try:
        mesh = distributed.global_mesh(channel=2, time=2, device="cpu")
        data = np.load(args.inputs)
        c, t = mesh.coords
        out = {}
        for kind, fn, cfg in (
                ("static", stream_shard.sharded_receive,
                 (STATIC["rate"], STATIC["length"])),
                ("dynamic", stream_shard.sharded_receive_dynamic,
                 (DYNAMIC["rates"], DYNAMIC["max_length"]))):
            s = data[kind]
            c_loc, n_loc = distributed.local_capture_shape(mesh, *s.shape)
            slab = s[c * c_loc:(c + 1) * c_loc, t * n_loc:(t + 1) * n_loc]
            block = distributed.shard_host_capture(
                mesh, slab.real, slab.imag, global_shape=s.shape)
            mf = (STATIC if kind == "static" else DYNAMIC)["max_frames"]
            res = fn(block, *cfg, mesh, mf)
            out.update({f"{kind}_{k}": v.numpy() for k, v in res.items()})
        np.savez(Path(args.out) / f"rank{args.rank}.npz", **out)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(_worker(sys.argv[1:]))


# ----------------------------------------------------------- captures ----

def _frame(payload: np.ndarray, rate: Rate) -> np.ndarray:
    from fun_ofdm_tpu.models import tx as j_tx
    import jax.numpy as jnp

    re, im = j_tx.build_frame_p(jnp.asarray(payload), rate)
    return np.asarray(re) + 1j * np.asarray(im)


def _captures():
    """(C, 2 * BLOCK) complex64 captures: the static one at one (rate,
    length), the dynamic one at mixed rates (tests/test_dynamic_rx.py's
    plan on two blocks); each with a frame straddling the time cut."""
    rng = np.random.default_rng(55)
    n = 2 * BLOCK
    rate, length = STATIC["rate"], STATIC["length"]
    flen = params_for(rate).frame_samples(length)
    static = np.zeros((CHANNELS, n), np.complex64)
    for c in range(CHANNELS):
        f = _frame(rng.integers(0, 256, length, dtype=np.uint8), rate)
        for pos in (300, BLOCK - flen // 2, n - flen - 130):
            static[c, pos:pos + flen] = f
    r0, r1 = DYNAMIC["rates"]
    flens = {r: params_for(r).frame_samples(DYNAMIC["max_length"])
             for r in (r0, r1)}
    plan = [(300, r0), (BLOCK - flens[r1] // 2, r1), (BLOCK + 777, r1),
            (n - flens[r0] - 40, r0)]
    dynamic = np.zeros((CHANNELS, n), np.complex64)
    for c in range(CHANNELS):
        for pos, r in plan:
            f = _frame(rng.integers(0, 256, DYNAMIC["max_length"],
                                    dtype=np.uint8), r)
            dynamic[c, pos:pos + f.size] = f
    return static, dynamic


def _jax_receive(static, dynamic) -> dict:
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from fun_ofdm_tpu.parallel import stream_shard as j_shard
    from fun_ofdm_tpu.parallel.mesh import make_mesh as j_make_mesh

    mesh = j_make_mesh(jax.devices("cpu")[:4], channel=2, time=2)
    sharding = NamedSharding(mesh, P("channel", "time"))

    def put(s):
        return tuple(jax.device_put(jnp.asarray(x.astype(np.float32)),
                                    sharding) for x in (s.real, s.imag))

    out = {}
    res = jax.jit(lambda s: j_shard.sharded_receive(
        s, STATIC["rate"], STATIC["length"], mesh,
        STATIC["max_frames"]))(put(static))
    out.update({f"static_{k}": np.asarray(v) for k, v in res.items()})
    res = jax.jit(lambda s: j_shard.sharded_receive_dynamic(
        s, DYNAMIC["rates"], DYNAMIC["max_length"], mesh,
        DYNAMIC["max_frames"]))(put(dynamic))
    out.update({f"dynamic_{k}": np.asarray(v) for k, v in res.items()})
    return out


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """Both receives on 4 gloo ranks and in JAX: (per-rank outputs, JAX
    outputs, the captures)."""
    tmp = tmp_path_factory.mktemp("sharded")
    static, dynamic = _captures()
    np.savez(tmp / "inputs.npz", static=static, dynamic=dynamic)
    results = dryrun.launch(
        [sys.executable, __file__, "--inputs", str(tmp / "inputs.npz"),
         "--out", str(tmp)], 4, LIMIT, env=ENV)
    for r, (rc, out, err) in enumerate(results):
        assert rc == 0, f"rank {r}: returncode {rc}\n{err[-3000:]}"
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(4)]
    return ranks, _jax_receive(static, dynamic), (static, dynamic)


# ------------------------------------------------------------ parity ----

@pytest.mark.parametrize("key", [f"static_{k}" for k in STATIC_KEYS]
                         + [f"dynamic_{k}" for k in DYNAMIC_KEYS])
def test_sharded_receive_matches_jax_slot_for_slot(sharded, key):
    ranks, want, _ = sharded
    kind = key.split("_")[0]
    for r, got in enumerate(ranks):
        assert got[key].shape == want[key].shape, (r, key)
        g, w = got[key].astype(np.int64), want[key].astype(np.int64)
        if key.endswith("payload"):
            # a slot that holds no frame decodes the noise at the start of
            # the block, which the two packages' float rounding may settle
            # differently: payloads are held where a frame was detected
            valid = want[f"{kind}_valid"]
            assert valid.sum() >= 3 * CHANNELS
            g, w = g[valid], w[valid]
        np.testing.assert_array_equal(g, w, err_msg=f"rank {r}")


def test_straddling_frames_delivered_once(sharded):
    ranks, _, (static, dynamic) = sharded
    for kind, s in (("static", static), ("dynamic", dynamic)):
        got = ranks[0]
        for c in range(CHANNELS):
            starts = sorted(got[f"{kind}_starts"][c][got[f"{kind}_crc_ok"][c]])
            # every frame, the one across the cut at BLOCK included
            assert len(starts) == len(set(starts)) >= 3
            assert any(BLOCK - 1000 < st < BLOCK for st in starts), starts
            assert all(np.abs(s[c, st:st + 160]).max() > 0 for st in starts)


def test_one_process_mesh_equals_receive_capture():
    static, _ = _captures()
    mesh = make_mesh(1, device="cpu")
    assert mesh.shape == (1, 1) and mesh.group is None
    block = distributed.shard_host_capture(mesh, static.real, static.imag,
                                           global_shape=static.shape)
    got = stream_shard.sharded_receive(block, STATIC["rate"],
                                       STATIC["length"], mesh,
                                       STATIC["max_frames"])
    want = frontend.receive_capture_p(
        (torch.from_numpy(static.real.astype(np.float32)),
         torch.from_numpy(static.imag.astype(np.float32))),
        STATIC["rate"], STATIC["length"], STATIC["max_frames"])
    for key in ("valid", "crc_ok", "header_ok", "payload"):
        assert torch.equal(got[key], want[key]), key
    # the ownership rule: a start past the block is no slot of this rank
    n = static.shape[-1]
    assert torch.equal(got["starts"].long(),
                       torch.where(want["starts"] < n, want["starts"], -1))
    assert int(got["crc_ok"].sum()) == 3 * CHANNELS


# ------------------------------------------------------ mesh and slabs ----

@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_make_mesh_splits_like_jax(n):
    import jax

    from fun_ofdm_tpu.parallel.mesh import make_mesh as j_make_mesh

    devs = jax.devices("cpu")[:n]
    for kw in (dict(), dict(channel=1), dict(time=1), dict(channel=n)):
        mesh = make_mesh(n, device="cpu", **kw)
        assert mesh.shape == j_make_mesh(devs, **kw).devices.shape, kw
        # rank-major: rank r at (r // time, r % time)
        time = mesh.shape[1]
        assert all(mesh.ranks[r // time][r % time] == r for r in range(n))
    if n > 1:
        with pytest.raises(ValueError, match="mesh 3x"):
            make_mesh(n, channel=3, device="cpu")
        with pytest.raises(ValueError):
            j_make_mesh(devs, channel=3)


def test_mesh_coords_and_default_device(monkeypatch):
    mesh = make_mesh(8, channel=2, rank=6, device="cpu")
    assert mesh.ranks == ((0, 1, 2, 3), (4, 5, 6, 7))
    assert mesh.coords == (1, 2) and mesh.size == 8
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert make_mesh(2, rank=1).device == torch.device("cuda", 3)
    monkeypatch.delenv("LOCAL_RANK")
    assert make_mesh(2, rank=1).device == torch.device("cuda", 1)
    with pytest.raises(ValueError, match="not in the mesh"):
        make_mesh([0, 1], rank=5, device="cpu").coords


def test_local_capture_shape_rejects_nondivisible():
    """tests/test_runtime.py:623; a rank here is one block of the mesh."""
    mesh = make_mesh(8, channel=2, time=4, device="cpu")
    assert distributed.local_capture_shape(mesh, 4, 4096) == (2, 1024)
    with pytest.raises(ValueError):
        distributed.local_capture_shape(mesh, 3, 4096)
    with pytest.raises(ValueError):
        distributed.local_capture_shape(mesh, 4, 4097)


def test_shard_host_capture_checks_the_slab():
    mesh = make_mesh(4, channel=2, time=2, rank=1, device="cpu")
    re = np.ones((2, 512), np.float64)
    got = distributed.shard_host_capture(mesh, re, -re, (4, 1024))
    assert got[0].dtype == torch.float32 and got[1].shape == (2, 512)
    assert got[0].device == torch.device("cpu")
    with pytest.raises(ValueError, match="expected"):
        distributed.shard_host_capture(mesh, re, re, (4, 2048))
    with pytest.raises(ValueError, match="expected"):
        distributed.shard_host_capture(mesh, re, re[:, :10], (4, 1024))
    with pytest.raises(ValueError, match="divide"):
        distributed.shard_host_capture(mesh, re, re, (3, 1024))


def test_halo_longer_than_the_block_raises():
    mesh = make_mesh(1, device="cpu")
    z = torch.zeros((1, 1000))
    with pytest.raises(ValueError, match=r"halo of \d+ samples is longer "
                                         r"than the block of 1000"):
        stream_shard.sharded_receive((z, z), Rate.RATE_1_2_BPSK, 20, mesh, 2)


def test_mesh_of_several_ranks_needs_its_group():
    mesh = make_mesh(4, device="cpu")
    z = torch.zeros((1, 8192))
    with pytest.raises(RuntimeError, match="4 ranks"):
        stream_shard.sharded_receive_dynamic((z, z), (Rate.RATE_1_2_BPSK,),
                                             20, mesh, 2)


# ---------------------------------------------------------- bring-up ----

_INIT_WORKER = """
import json, sys
import torch, torch.distributed as dist
from fun_ofdm_tpu_torch.parallel import distributed
args = dict(zip(sys.argv[1::2], sys.argv[2::2]))
torch.set_num_threads(1)
rank, n = int(args["--rank"]), int(args["--world-size"])
assert distributed.initialize(args["--address"], n, rank, backend="gloo")
assert distributed.initialize()                 # idempotent
x = torch.tensor([rank + 1.0])
dist.all_reduce(x)
mesh = distributed.global_mesh(device="cpu")
print(json.dumps({"rank": dist.get_rank(), "world": dist.get_world_size(),
                  "sum": float(x), "mesh": list(mesh.shape),
                  "coords": list(mesh.coords)}))
dist.destroy_process_group()
"""


def test_two_process_initialize_from_explicit_arguments():
    """The analogue of tests/test_multihost.py: two processes join one
    group from an explicit address, world size and rank."""
    results = dryrun.launch([sys.executable, "-c", _INIT_WORKER], 2, LIMIT,
                            env=ENV)
    lines = []
    for r, (rc, out, err) in enumerate(results):
        assert rc == 0, f"process {r}: returncode {rc}\n{err[-3000:]}"
        lines.append(json.loads(out.strip().splitlines()[-1]))
    assert lines == [{"rank": r, "world": 2, "sum": 3.0, "mesh": [1, 2],
                      "coords": [0, r]} for r in range(2)]


def test_initialize_with_nothing_configured_is_a_no_op(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize() is False
    assert not dist.is_initialized()
    mesh = distributed.global_mesh(device="cpu")
    assert mesh.shape == (1, 1) and mesh.group is None


@pytest.mark.parametrize("kw", [
    dict(address="tcp://127.0.0.1:notaport", world_size=2, rank=0),
    dict(address="tcp://127.0.0.1:99999", world_size=2, rank=0),
    # half configured: no address and no MASTER_ADDR to rendezvous at
    dict(world_size=2, rank=0)])
def test_initialize_with_a_bad_address_raises(monkeypatch, kw):
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    with pytest.raises(ValueError):
        distributed.initialize(**kw, backend="gloo")
    assert not dist.is_initialized()


def test_dryrun_on_four_cpu_ranks():
    proc = subprocess.run(
        [sys.executable, "-m", "fun_ofdm_tpu_torch.parallel.dryrun",
         "--ranks", "4", "--device", "cpu"],
        env=ENV, cwd=REPO, capture_output=True, text=True,
        timeout=dryrun.RANK_TIMEOUT_S + 30)
    assert proc.returncode == 0, proc.stderr[-3000:]
    recs = [json.loads(ln) for ln in proc.stdout.splitlines()]
    assert [r["coords"] for r in recs] == [[0, 0], [0, 1], [1, 0], [1, 1]]
    for r in recs:
        for kind in ("static", "dynamic"):
            assert r[kind]["delivered"] == r[kind]["frames"] > 0


def test_launch_reports_failures_and_kills_at_the_limit():
    failed = dryrun.launch(
        [sys.executable, "-c", "import sys; sys.exit(3)"], 2, LIMIT)
    assert [rc for rc, _, _ in failed] == [3, 3]
    hung = dryrun.launch(
        [sys.executable, "-c", "import time; time.sleep(60)"], 2, 1.0)
    assert [rc for rc, _, _ in hung] == [None, None]
