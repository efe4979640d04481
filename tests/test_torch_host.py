"""The port's own host side against fun_ofdm_tpu's, on the CPU, and the
port's independence from the JAX package.

The rate table, the chain configuration and the preamble are the port's
own copies: every field and array must equal fun_ofdm_tpu's exactly. The
wire formats (runtime/wire.py) must pack the same bytes and unpack the
same floats, on the host and on the device path, and the native chunker
and ring (runtime/native.py, csrc/stream_runtime.cpp, built into the
port's own build directory) must return the same windows. Last, importing
any module of the port, or chip_smoke.py, must import neither jax nor
any part of fun_ofdm_tpu.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fun_ofdm_tpu import config as j_config
from fun_ofdm_tpu import preamble as j_preamble
from fun_ofdm_tpu import rates as j_rates
from fun_ofdm_tpu.runtime import chain as j_chain
from fun_ofdm_tpu.runtime import native as j_native
from fun_ofdm_tpu_torch import config, preamble, rates
from fun_ofdm_tpu_torch.runtime import chain, native, wire

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "fun_ofdm_tpu_torch"


# ------------------------------------------------------------ tables ----

@pytest.mark.parametrize("rate", list(j_rates.Rate), ids=lambda r: r.name)
def test_rate_params_equal_jax(rate):
    mine, ref = rates.params_for(rate), j_rates.params_for(rate)
    assert type(mine) is rates.RateParams
    for f in dataclasses.fields(j_rates.RateParams):
        a, b = getattr(mine, f.name), getattr(ref, f.name)
        assert a == b and type(a).__name__ == type(b).__name__, f.name
    assert mine.coding_rate == ref.coding_rate
    for length in (0, 1, 17, 200, 1500, 2000):
        for m in ("num_symbols", "num_data_bits", "num_data_bytes",
                  "frame_samples"):
            assert getattr(mine, m)(length) == getattr(ref, m)(length)
    assert rates.from_rate_field(ref.rate_field) == mine
    assert rates.Rate[rate.name] == rate and int(rates.Rate(rate)) == rate


def test_rate_table_and_config_equal_jax():
    assert [(r.name, int(r)) for r in rates.ALL_RATES] == \
        [(r.name, int(r)) for r in j_rates.ALL_RATES]
    assert rates.VALID_RATE_FIELDS == j_rates.VALID_RATE_FIELDS
    assert [(f.name, f.default) for f in dataclasses.fields(
        config.ChainParams)] == [(f.name, f.default) for f in
                                 dataclasses.fields(j_config.ChainParams)]
    assert dataclasses.asdict(config.DEFAULT_PARAMS) == \
        dataclasses.asdict(j_config.DEFAULT_PARAMS)


def test_preamble_equal_jax():
    names = [k for k, v in vars(j_preamble).items()
             if not k.startswith("_") and isinstance(v, (int, np.ndarray))]
    assert len(names) >= 14
    for k in names:
        a, b = getattr(preamble, k), getattr(j_preamble, k)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, k
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            assert a == b, k
    np.testing.assert_array_equal(
        preamble.freq_to_time(preamble.LTS_FREQ_DOMAIN),
        j_preamble.freq_to_time(j_preamble.LTS_FREQ_DOMAIN))


# -------------------------------------------------------- wire formats ----

def _wire_samples(fmt: str, n: int = 4096):
    """Seeded samples over and past the full scale, the clip limits and
    the values next to them included."""
    _, scale = wire.INGEST_FORMATS[fmt]
    lim = {"int12": 2048, "int10": 512}[fmt]
    rng = np.random.default_rng(lim)
    x = rng.normal(0, lim / scale / 3, n)
    edge = np.array([-lim - 7, -lim - 1, -lim, -lim + 1, -1, 0, 1,
                     lim - 2, lim - 1, lim, lim + 9, -0.5, 0.5, 1.5])
    x[:edge.size] = edge / scale
    x[edge.size:edge.size + 4] = [1e6, -1e6, 2e4, -3e3]
    return x.astype(np.float32)


@pytest.mark.parametrize("fmt", ["int12", "int10"])
def test_packed_wire_equals_jax(fmt):
    _, scale = wire.INGEST_FORMATS[fmt]
    x = _wire_samples(fmt)
    two = np.stack([x, x[::-1]])                 # a leading channel axis
    packed = wire._pack_np(two, fmt, scale)
    np.testing.assert_array_equal(packed, j_chain._pack_np(two, fmt, scale))
    floats = wire._unpack_np(packed, fmt, scale)
    assert floats.dtype == np.float32
    np.testing.assert_array_equal(floats,
                                  j_chain._unpack_np(packed, fmt, scale))
    # the chain's device-side unpack reads the same floats
    np.testing.assert_array_equal(
        chain._unpack_device(torch.from_numpy(packed), fmt, scale).numpy(),
        floats)


@pytest.mark.parametrize("dtype", [np.int16, np.int8, np.float32])
def test_wire_tables_and_dequantize_equal_jax(dtype):
    assert wire.INGEST_FORMATS == j_chain.INGEST_FORMATS
    assert wire.PACKED_FORMATS == j_chain.PACKED_FORMATS
    assert wire._WIRE_SCALE == j_chain._WIRE_SCALE
    info = np.iinfo(dtype) if dtype != np.float32 else None
    rng = np.random.default_rng(5)
    if info is None:
        x = rng.normal(size=300).astype(dtype)
    else:
        x = rng.integers(info.min, info.max, 300, endpoint=True).astype(dtype)
        x[:2] = info.min, info.max
    got, want = wire._dequantize_wire(x), j_chain._dequantize_wire(x)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert chain.pack10 is wire.pack10


# ----------------------------------------------------- native runtime ----

def test_native_library_is_the_ports_own():
    path = native.library_path()
    assert path.parent == PORT / "csrc" / "build"
    assert native.SOURCE == PORT / "csrc" / "stream_runtime.cpp"
    native.load()
    assert path.exists()
    assert Path(j_native._lib_path()).resolve() != path.resolve()


def test_chunker_pushes_equal_jax():
    """Pieces of random sizes (empty ones included), complex and planar,
    through both chunkers: the same windows and positions, the same
    padded tail."""
    rng = np.random.default_rng(9)
    stride, window = 1000, 1700
    mine, ref = native.Chunker(stride, window), j_native.Chunker(stride,
                                                                 window)
    popped = 0
    for k in range(40):
        n = int(rng.integers(0, 900))
        re = rng.normal(size=n).astype(np.float32)
        im = rng.normal(size=n).astype(np.float32)
        piece = (re, im) if k % 2 else re + 1j * im
        mine.push(piece)
        ref.push(piece)
        assert mine.available == ref.available
        while ref.ready():
            assert mine.ready()
            a, b = mine.pop(), ref.pop()
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])
            assert a[2] == b[2]
            popped += 1
        assert not mine.ready()
    a, b = mine.pop(pad=True), ref.pop(pad=True)
    np.testing.assert_array_equal(a[0], b[0])
    assert a[2] == b[2] and popped > 5
    with pytest.raises(ValueError):
        native.Chunker(10, 5)


def test_sample_ring_equals_jax():
    rng = np.random.default_rng(11)
    mine, ref = native.SampleRing(4096), j_native.SampleRing(4096)
    x = (rng.normal(size=3000) + 1j * rng.normal(size=3000)).astype(
        np.complex64)
    assert mine.push(x) == ref.push(x) == 3000
    assert len(mine) == len(ref) == 3000
    for n in (1000, 5, 1995):
        a, b = mine.pop(n), ref.pop(n)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    mine.close()
    ref.close()
    assert mine.pop(10, timeout=0.01)[0].size == \
        ref.pop(10, timeout=0.01)[0].size == 0


# ------------------------------------------------ independence from JAX ----

def _port_modules() -> list[str]:
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        mods.append(".".join(parts))
    return mods + ["chip_smoke"]


@pytest.fixture(scope="module")
def imports_seen():
    """For each module of the port (and chip_smoke), in one fresh
    interpreter importing them in turn: the JAX package's and jax's
    modules present right after its import. Imports only accumulate, so
    a module that pulls one in is the first to show it."""
    code = (
        "import importlib, json, sys\n"
        "seen = {}\n"
        "for m in json.loads(sys.argv[1]):\n"
        "    importlib.import_module(m)\n"
        "    seen[m] = sorted(k for k in sys.modules if k == 'jax'\n"
        "                     or k.startswith('jax.') or k == 'fun_ofdm_tpu'"
        "\n                     or k.startswith('fun_ofdm_tpu.'))\n"
        "print(json.dumps(seen))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", code, json.dumps(_port_modules())], env=env,
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("module", _port_modules())
def test_port_imports_no_jax(imports_seen, module):
    assert imports_seen[module] == [], (
        f"importing {module} imported {imports_seen[module][:5]}")
