"""Multi-rank dry run of the sharded receive
(fun_ofdm_tpu's __graft_entry__.dryrun_multichip).

    python -m fun_ofdm_tpu_torch.parallel.dryrun --ranks 4 [--device cpu]

Spawns N ranks on this host over torch.distributed (rank r on
cuda:<r> by default; --device names one device for every rank, e.g.
"cpu" or "cuda:0"; --backend defaults to nccl on cards, gloo on the
CPU), or, started by torchrun, runs as one rank. Each rank builds the
same seeded capture, takes its block of a default (channel, time) mesh
and runs two passes:

  1. sharded_receive at one (rate, length): one frame straddling every
     time cut, one inside the first block, one near the end; every frame
     delivered exactly once, at its exact global start, with its payload;
  2. sharded_receive_dynamic over three rates: mixed-rate frames (one
     straddling every cut) decoded from their SIGNAL headers, each with
     its header's rate and its payload.

Each rank prints one JSON line (its mesh place, the passes' counts, and
the CUDA kernels' launches). The parent prints them and exits nonzero if
a rank fails, prints no line, or outlives RANK_TIMEOUT_S.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

from ..models import tx
from ..ops import viterbi_cuda
from ..rates import Rate, params_for
from . import distributed, stream_shard

#: samples per time block of the dry run (more than a frame and its halo)
BLOCK = 4096
#: seconds the ranks may take, from their start
RANK_TIMEOUT_S = 240.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(cmd: list[str], n: int, timeout_s: float,
           env: dict | None = None) -> list[tuple[int, str, str]]:
    """Run `cmd` as n ranks of one group on this host: each gets --rank r
    --world-size n --address tcp://127.0.0.1:<free port> and LOCAL_RANK=r.
    Returns each rank's (returncode, stdout, stderr); a rank still running
    timeout_s after the start is killed and reports returncode None."""
    deadline = time.monotonic() + timeout_s
    address = f"tcp://127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen(
        cmd + ["--rank", str(r), "--world-size", str(n), "--address",
               address],
        env=dict(env or os.environ, LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(n)]
    results = []
    try:
        for p in procs:
            try:
                out, err = p.communicate(
                    timeout=max(0.0, deadline - time.monotonic()))
                results.append((p.returncode, out, err))
            except subprocess.TimeoutExpired:
                p.kill()
                out, err = p.communicate()
                results.append((None, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return results


def _frames(payloads: np.ndarray, rate: Rate, device) -> np.ndarray:
    fre, fim = tx.build_frame_p(torch.from_numpy(payloads).to(device), rate)
    return fre.cpu().numpy() + 1j * fim.cpu().numpy()


def _receive(mesh, s: np.ndarray, fn, *args, max_frames: int) -> dict:
    """Run a sharded receive, fn(block, *args, mesh, max_frames), on this
    rank's block of the global capture s; the global result as numpy."""
    c_loc, n_loc = distributed.local_capture_shape(mesh, *s.shape)
    c, t = mesh.coords
    slab = s[c * c_loc:(c + 1) * c_loc, t * n_loc:(t + 1) * n_loc]
    block = distributed.shard_host_capture(mesh, slab.real, slab.imag,
                                           global_shape=s.shape)
    out = fn(block, *args, mesh, max_frames)
    return {k: v.cpu().numpy() for k, v in out.items()}


def _delivered(out: dict, c: int) -> list[int]:
    return sorted(int(x) for x in out["starts"][c][out["crc_ok"][c]])


def passes(mesh) -> dict:
    """The two passes on this rank's block; raises on a wrong delivery."""
    n_chan, n_time = mesh.shape
    channels = n_chan * -(-2 // n_chan)
    n = BLOCK * n_time
    rng = np.random.default_rng(1)

    rate, length = Rate.RATE_1_2_BPSK, 16
    frame_len = params_for(rate).frame_samples(length)
    starts = sorted({100, n - frame_len - 130,
                     *(t * BLOCK - frame_len // 2 for t in range(1, n_time))})
    payloads = rng.integers(0, 256, (channels, length), dtype=np.uint8)
    frames = _frames(payloads, rate, mesh.device)
    s = np.zeros((channels, n), np.complex64)
    for pos in starts:
        s[:, pos:pos + frame_len] = frames
    out = _receive(mesh, s, stream_shard.sharded_receive, rate, length,
                   max_frames=len(starts))
    for c in range(channels):
        got = _delivered(out, c)
        if got != starts:
            raise AssertionError(f"channel {c}: exactly-once violated: "
                                 f"planted {starts}, decoded {got}")
        for k in np.nonzero(out["crc_ok"][c])[0]:
            if not np.array_equal(out["payload"][c, k], payloads[c]):
                raise AssertionError(f"channel {c} slot {k}: payload")
    rec = {"static": {"channels": channels, "samples": n,
                      "frames": channels * len(starts),
                      "delivered": int(out["crc_ok"].sum())}}

    rates = (Rate.RATE_1_2_BPSK, Rate.RATE_3_4_QAM16, Rate.RATE_2_3_QAM64)
    max_length = 24
    flens = {r: params_for(r).frame_samples(max_length) for r in rates}
    plan = [(100, rates[0])]
    plan += [(t * BLOCK - flens[rates[t % 3]] // 2, rates[t % 3])
             for t in range(1, n_time)]
    plan.append((n - max(flens.values()) - 64, rates[-1]))
    plan.sort()
    s = np.zeros((channels, n), np.complex64)
    planted = {}
    for c in range(channels):
        for pos, r in plan:
            payload = rng.integers(0, 256, (1, max_length), dtype=np.uint8)
            planted[(c, pos)] = (r, payload[0])
            s[c, pos:pos + flens[r]] = _frames(payload, r, mesh.device)[0]
    out = _receive(mesh, s, stream_shard.sharded_receive_dynamic, rates,
                   max_length, max_frames=len(plan))
    want = [pos for pos, _ in plan]
    for c in range(channels):
        got = _delivered(out, c)
        if got != want:
            raise AssertionError(f"dynamic channel {c}: exactly-once "
                                 f"violated: planted {want}, decoded {got}")
        for k in np.nonzero(out["crc_ok"][c])[0]:
            r, payload = planted[(c, int(out["starts"][c, k]))]
            if int(out["rate_field"][c, k]) != params_for(r).rate_field \
                    or not np.array_equal(out["payload"][c, k], payload):
                raise AssertionError(f"dynamic channel {c} start "
                                     f"{out['starts'][c, k]}: wrong rate or "
                                     f"payload")
    rec["dynamic"] = {"channels": channels, "samples": n,
                      "frames": channels * len(plan),
                      "delivered": int(out["crc_ok"].sum()),
                      "detect_dropped": int(out["detect_dropped"].sum())}
    return rec


def _rank_main(args) -> int:
    backend = args.backend or ("gloo" if args.device == "cpu" else "nccl")
    if args.device == "cpu":
        torch.set_num_threads(1)
    distributed.initialize(args.address, args.world_size, args.rank,
                           backend=backend)
    try:
        mesh = distributed.global_mesh(device=args.device)
        viterbi_cuda.reset_launches()
        rec = {"rank": mesh.rank, "mesh": list(mesh.shape),
               "coords": list(mesh.coords), "device": str(mesh.device),
               "backend": backend, **passes(mesh)}
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        rec["launches"] = dict(viterbi_cuda.launches)
        print(json.dumps(rec), flush=True)
    finally:
        torch.distributed.destroy_process_group()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks to spawn (default: every card)")
    ap.add_argument("--device", default=None,
                    help="every rank's device (default cuda:<local rank>)")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"))
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--world-size", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--address", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None or "RANK" in os.environ:
        return _rank_main(args)
    n = args.ranks or torch.cuda.device_count()
    if n < 1:
        ap.error("no ranks: pass --ranks")
    if args.device != "cpu":
        viterbi_cuda.build()     # once, before the ranks load it
    cmd = [sys.executable, "-m", __spec__.name]
    for flag in ("device", "backend"):
        if getattr(args, flag) is not None:
            cmd += [f"--{flag}", getattr(args, flag)]
    results = launch(cmd, n, RANK_TIMEOUT_S)
    failed = []
    for r, (rc, out, err) in enumerate(results):
        lines = [ln for ln in out.splitlines() if ln.startswith("{")]
        for ln in lines:
            print(ln, flush=True)
        if rc != 0 or not lines:
            failed.append(r)
            print(f"rank {r}: returncode {rc}\n{err[-3000:]}",
                  file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
