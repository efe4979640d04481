"""The plain 802.11a transmitter and receiver against the upstream C++
golden vectors (tests/golden/golden.npz, read as data): frames, soft
demapping, the Viterbi, and the receiver's decode of the reference's own
frames."""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from phybench.reference import phy

GOLDEN = (Path(__file__).resolve().parents[2] / "tests" / "golden"
          / "golden.npz")


@pytest.fixture(scope="module")
def g():
    return np.load(GOLDEN)


def golden_payload(length: int, seed: int) -> np.ndarray:
    """The golden generator's payload: the low byte of std::mt19937(seed)'s
    outputs (numpy's legacy RandomState is the same generator, seeded the
    same way)."""
    rs = np.random.RandomState(seed)
    return (rs.randint(0, 2**32, size=length, dtype=np.uint64)
            & 0xFF).astype(np.uint8)


@pytest.mark.parametrize("rate", range(11))
def test_frames_match_reference(g, rate):
    ours = phy.build_frames(golden_payload(120, 1000 + rate)[None], rate)[0]
    want = g[f"frame_r{rate}"]
    assert ours.shape == want.shape
    diff = np.abs(ours.numpy() - want)
    # sample 160: the reference table stores -0.078 for the exact -0.078125
    assert diff[160] < 2e-4
    diff[160] = 0
    assert diff.max() < 1e-9


@pytest.mark.parametrize("rate", range(11))
def test_demodulate_matches_reference(g, rate):
    soft = phy.demodulate(torch.from_numpy(g[f"demod_in_r{rate}"]), rate)
    np.testing.assert_array_equal(soft.numpy(), g[f"demod_r{rate}"])


def test_viterbi_matches_reference(g):
    soft = torch.from_numpy(g["vit_soft"].astype(np.int64))[None]
    bits = phy.viterbi(soft, 800)[0].numpy().astype(np.uint8)
    np.testing.assert_array_equal(np.packbits(bits), g["vit_bits"][:100])


@pytest.mark.parametrize("rate", range(11))
def test_receiver_decodes_reference_frames(g, rate):
    frame = g[f"frame_r{rate}"]
    x = torch.from_numpy(np.concatenate([np.zeros(200), frame,
                                         np.zeros(300)]))
    assert phy.detect(x[None])[0].tolist() == [200]
    dec = phy.decode(x, [200])
    assert dec.header_ok[0] and dec.crc_ok[0]
    assert (dec.rate[0], dec.length[0]) == (rate, 120)
    assert dec.payload[0] == g[f"decode_r{rate}"].tobytes()
    assert dec.payload[0] == golden_payload(120, 1000 + rate).tobytes()


def test_receiver_on_back_to_back_frames():
    rng = np.random.default_rng(3)
    pay = rng.integers(0, 256, size=(5, 300), dtype=np.uint8)
    f = phy.build_frames(pay, 8)
    x = torch.cat([torch.zeros(77, dtype=f.dtype), f.reshape(-1)])
    starts = phy.detect(x[None])[0]
    assert starts.tolist() == (77 + f.shape[1] * np.arange(5)).tolist()
    dec = phy.decode(x, starts)
    assert dec.crc_ok.all() and dec.payload == [p.tobytes() for p in pay]
    # five data symbols overwritten: the CRC catches what the code cannot
    y = x.clone()
    y[77 + 1000:77 + 1400] = -y[77 + 1000:77 + 1400].flip(0)
    assert not phy.decode(y, starts[:1]).crc_ok[0]


@pytest.mark.parametrize("precision", phy.PRECISIONS)
def test_receiver_precisions(precision):
    """Every working precision decodes noiseless frames; float32's points
    lie within rounding of float64's, bfloat16's much farther."""
    pay = np.random.default_rng(4).integers(0, 256, (3, 200), np.uint8)
    f = phy.build_frames(pay, 8)
    x = torch.cat([torch.zeros(50, dtype=f.dtype), f.reshape(-1),
                   torch.zeros(100, dtype=f.dtype)])
    starts = 50 + f.shape[1] * np.arange(3)
    dec = phy.decode(x, starts, precision)
    assert dec.crc_ok.all() and dec.payload == [p.tobytes() for p in pay]
    st = torch.from_numpy(starts)
    nsym = phy.num_symbols(8, 200)
    want = phy._equalised(x, st, nsym)
    err = (phy._equalised(x, st, nsym, precision).to(want.dtype)
           - want).abs().max()
    bound = {"float64": 0.0, "float32": 1e-5, "bfloat16": 1e-1}[precision]
    assert err <= bound
    if precision == "bfloat16":
        assert err > 1e-3


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; import phybench.reference.phy; "
            "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'fun_ofdm_tpu_torch', 'fun_ofdm_tpu', 'jax', 'jaxlib'}); "
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=Path(__file__).resolve().parents[2])
    assert out.returncode == 0, out.stdout + out.stderr
