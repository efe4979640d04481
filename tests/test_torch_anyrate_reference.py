"""The universal capture (frontend.receive_capture_anyrate_p) against the
benchmark's plain receiver (phybench/reference/phy.py), which reads each
frame's rate and length from its SIGNAL header as fun_ofdm does and shares
no code with the port.

A capture of frames from the plain transmitter, every one of the 11 rates,
lengths spread over 1..max_length, every second frame carrying AWGN at
12.5 dB after its preamble, zeros between them: the port's starts equal
the planted ones and the plain receiver's detections, and per slot its
header_ok, rate_field, hdr_length, crc_ok and payload bytes equal the
plain receiver's decode of the same float32 samples in float64, exactly.

On the CPU max_length is 256: there the port and the plain receiver run
their Viterbi trellises step by step in Python. The test marked
`cuda` runs the full field, max_length 4,095, with a 4,095-byte
RATE_1_2_BPSK frame: the slowest rate's longest frame, 1,368 data symbols
and 32,832 trellis steps, the geometry the decode sizes every slot to.
It imports no jax, so it runs on the card with --noconftest.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from fun_ofdm_tpu_torch.models import frontend
from fun_ofdm_tpu_torch.rates import ALL_RATES
from phybench.reference import phy

CPU_MAX_LENGTH = 256
SNR_DB = 12.5
GAP = 400


def capture(seed: int, max_length: int, per_rate: int = 2, extra=()):
    """One channel: per_rate frames of each rate (lengths spread over
    1..max_length, drawn from the seed), every second one noisy after its
    preamble, then the (rate index, length, noisy) frames of `extra`.
    Returns planar float32 samples (1, n), the planted starts, and
    (rate index, length, payload bytes, noisy) of each frame."""
    rng = np.random.default_rng(seed)
    lengths = np.linspace(1, max_length, per_rate * len(phy.RATES))
    lengths = rng.permutation(lengths.round().astype(int))
    plan = [(k // per_rate, int(n), k % 2 == 1)
            for k, n in enumerate(lengths)] + list(extra)
    sd = math.sqrt(phy.SYMBOL_POWER / 10 ** (SNR_DB / 10) / 2)
    parts, starts, frames, pos = [np.zeros(GAP, np.complex128)], [], [], GAP
    for r, n, noisy in plan:
        pay = rng.integers(0, 256, size=(1, n), dtype=np.uint8)
        f = phy.build_frames(pay, r)[0].numpy()
        if noisy:
            m = f.size - phy.PREAMBLE_LEN
            f[phy.PREAMBLE_LEN:] += sd * (rng.standard_normal(m)
                                          + 1j * rng.standard_normal(m))
        parts += [f, np.zeros(GAP, np.complex128)]
        starts.append(pos)
        frames.append((r, n, pay[0].tobytes(), noisy))
        pos += f.size + GAP
    x = np.concatenate(parts).astype(np.complex64)
    re = torch.from_numpy(x.real.copy())[None]
    im = torch.from_numpy(x.imag.copy())[None]
    return (re, im), np.array(starts), frames


def reference(stream, starts):
    """The plain receiver on the port's float32 samples, in float64:
    its detections and its decode at the planted starts."""
    re, im = (t[0].numpy().astype(np.float64) for t in stream)
    x = torch.from_numpy(re + 1j * im)
    return phy.detect(x[None])[0], phy.decode(x, starts)


def check_against_reference(stream, starts, frames, max_length, device):
    found, ref = reference(stream, starts)
    assert found.tolist() == starts.tolist()
    # the plain receiver decodes every noiseless frame as planted
    for k, (r, n, pay, noisy) in enumerate(frames):
        if not noisy:
            assert (ref.header_ok[k], ref.rate[k], ref.length[k],
                    ref.crc_ok[k], ref.payload[k]) == (True, r, n, True, pay)
    assert not ref.crc_ok.all()       # the noise fails some frames
    planar = tuple(t.to(device) for t in stream)
    out = {k: v.cpu() for k, v in frontend.receive_capture_anyrate_p(
        planar, ALL_RATES, max_length, len(frames) + 4).items()}
    f = len(frames)
    valid = out["valid"][0]
    assert valid[:f].all() and not valid[f:].any()
    assert out["starts"][0, :f].tolist() == starts.tolist()
    hdr_ok = out["header_ok"][0, :f].numpy()
    assert hdr_ok.tolist() == ref.header_ok.tolist()
    fields = out["rate_field"][0, :f].numpy()
    lengths = out["hdr_length"][0, :f].numpy()
    for k in np.flatnonzero(ref.header_ok):
        assert (fields[k], lengths[k]) == (
            phy.RATES[int(ref.rate[k])][1], ref.length[k]), k
    crc_ok = out["crc_ok"][0, :f].numpy()
    assert crc_ok.tolist() == ref.crc_ok.tolist()
    payload = out["payload"][0, :f].to(torch.uint8).numpy()
    for k in np.flatnonzero(crc_ok):
        assert payload[k, :lengths[k]].tobytes() == ref.payload[k], k


@pytest.mark.parametrize("seed", [15, 16])
def test_every_rate_and_length_as_the_plain_receiver(seed):
    stream, starts, frames = capture(seed, CPU_MAX_LENGTH)
    assert sorted({f[0] for f in frames}) == list(range(11))
    assert {1, CPU_MAX_LENGTH} <= {f[1] for f in frames}
    check_against_reference(stream, starts, frames, CPU_MAX_LENGTH, "cpu")


@pytest.mark.cuda
def test_full_length_field_as_the_plain_receiver_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernels have "
                    "no CPU mode)")
    # one frame of each rate, then the slowest rate's longest frame
    stream, starts, frames = capture(4095, 4095, per_rate=1,
                                     extra=[(0, 4095, False)])
    assert frames[-1][:2] == (0, 4095)
    check_against_reference(stream, starts, frames, 4095, "cuda")
