"""BER / PER vs SNR statistical harness.

Counterpart of fun_ofdm_tpu/sim/ber.py. The reference publishes no
error-rate curves and has no channel simulator (examples/test_sim.cpp:43-104
is a noise-free loopback), so this harness establishes the statistical
baseline: packet and bit error rates vs SNR under AWGN, CFO and multipath,
for any rate.

Each repetition is one batch over (SNR point, frame) on the device: random
payloads are built into frames, impaired, decoded, and counted there; only
the counters come back to the host, at the end. Two modes:
  * frame-synchronous (`detect=False`): decode at the known frame offset,
    which isolates the codec and equalizer chain;
  * full chain (`detect=True`): each frame is embedded at a random offset
    in frame_len + 2 * pad zeros and must be found by STS/LTS detection
    (models/frontend.receive_capture over those streams as a (frames, n)
    batch); PER then includes missed detections.

The random numbers come from a torch.Generator seeded with `seed`, so the
draws differ from fun_ofdm_tpu's jax.random ones: the two harnesses agree
in distribution, not frame by frame (tests hold them to a binomial bound,
and hold single trials equal on the same payloads and noise).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..models import frontend, rx as rx_model, tx
from ..rates import Rate
from ..utils.bits import bytes_to_bits
from . import channel


@dataclass(frozen=True)
class ErrorRates:
    """Per-SNR-point error statistics."""

    snr_db: np.ndarray       # (S,)
    per: np.ndarray          # (S,) packet error rate (CRC fail or miss)
    ber: np.ndarray          # (S,) payload bit error rate (sync mode only)
    n_frames: int            # frames per SNR point


def impair(frame, snr_db, cfo_norm: float = 0.0, taps=None,
           generator: torch.Generator | None = None, noise=None):
    """Multipath (taps), then CFO, then AWGN at snr_db (broadcast over the
    frames), in fun_ofdm_tpu's order."""
    if taps is not None:
        frame = channel.multipath(frame, taps)
    if cfo_norm:
        frame = channel.cfo(frame, cfo_norm)
    return channel.awgn(frame, generator, snr_db, noise=noise)


def sync_trial(payload: torch.Tensor, rate: Rate, snr_db,
               cfo_norm: float = 0.0, taps=None, cfo_correct: bool = False,
               generator: torch.Generator | None = None, noise=None):
    """One frame-synchronous trial per payload row.

    payload: (F, length) bytes; snr_db: (F,) or a scalar. Builds, impairs
    and decodes every frame at its known start. Returns ((F,) bool CRC
    failures, (F,) int64 payload bit errors)."""
    length = payload.shape[-1]
    frame = tx.build_frame_p(payload, rate)
    frame = impair(frame, snr_db, cfo_norm, taps, generator, noise)
    out = rx_model.decode_frame_p(frame, rate, length,
                                  cfo_correct=cfo_correct)
    bit_err = (bytes_to_bits(payload) != bytes_to_bits(out["payload"]))
    return ~out["crc_ok"], bit_err.sum(-1)


def detect_trial(payload: torch.Tensor, offsets: torch.Tensor, rate: Rate,
                 snr_db, pad: int = 256, max_frames: int = 4,
                 cfo_norm: float = 0.0, taps=None,
                 generator: torch.Generator | None = None, noise=None):
    """One full-chain trial per payload row.

    payload: (F, length) bytes; offsets: (F,) frame positions in [0, pad)
    inside a stream of frame_len + 2 * pad zeros. Detects and decodes
    every stream; a frame counts as received when some slot has a valid
    CRC and its payload. Returns (F,) bool failures."""
    frames, length = payload.shape
    fre, fim = tx.build_frame_p(payload, rate)
    frame_len = fre.shape[-1]
    n = frame_len + 2 * pad
    idx = offsets.to(torch.int64)[:, None] + torch.arange(
        frame_len, device=fre.device)
    stream = tuple(torch.zeros((frames, n), dtype=f.dtype, device=f.device)
                   .scatter_(1, idx, f) for f in (fre, fim))
    stream = impair(stream, snr_db, cfo_norm, taps, generator, noise)
    out = frontend.receive_capture_p(stream, rate, length, max_frames)
    match = (out["payload"] == payload[:, None, :]).all(-1)
    return ~(out["crc_ok"] & match).any(-1)


def error_rates(rate: Rate, length: int, snr_dbs: Sequence[float],
                n_frames: int = 256, batch: int = 32, seed: int = 0,
                cfo_norm: float = 0.0, taps: Sequence[complex] | None = None,
                cfo_correct: bool = False, detect: bool = False,
                pad: int = 256, max_frames: int = 4,
                device="cuda") -> ErrorRates:
    """Measure PER (and BER in sync mode) across SNR points.

    n_frames per SNR point run in repetitions of `batch` frames at every
    point at once (S * batch frames per device pass). As in fun_ofdm_tpu,
    detect mode reports BER as NaN and takes no cfo_correct (the capture
    receive has none). Runs on `device` ("cuda" unless the caller asks
    for the CPU).
    """
    dev = torch.device(device)
    snr = torch.tensor(list(snr_dbs), dtype=torch.float32, device=dev)
    s = snr.shape[0]
    taps_t = None if taps is None else tuple(complex(t) for t in taps)
    reps = -(-n_frames // batch)
    total = reps * batch
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    snr_rows = snr.repeat_interleave(batch)
    fails = torch.zeros(s, dtype=torch.int64, device=dev)
    bit_err = torch.zeros(s, dtype=torch.int64, device=dev)
    for _ in range(reps):
        payload = torch.randint(0, 256, (s * batch, length), generator=gen,
                                device=dev, dtype=torch.int32)
        if detect:
            offsets = torch.randint(0, pad, (s * batch,), generator=gen,
                                    device=dev)
            f = detect_trial(payload, offsets, rate, snr_rows, pad,
                             max_frames, float(cfo_norm), taps_t, gen)
        else:
            f, b = sync_trial(payload, rate, snr_rows, float(cfo_norm),
                              taps_t, cfo_correct, gen)
            bit_err += b.reshape(s, batch).sum(-1)
        fails += f.reshape(s, batch).sum(-1)
    fails_np = fails.cpu().numpy()
    snr_np = snr.cpu().numpy()
    if detect:
        return ErrorRates(snr_np, fails_np / total, np.full(s, np.nan), total)
    total_bits = total * length * 8
    return ErrorRates(snr_np, fails_np / total,
                      bit_err.cpu().numpy() / total_bits, total)


def binomial_bound(p_a, p_b, n: int):
    """The agreement bound of two PER estimates over n frames each:
    4 * sqrt(2 * p(1 - p) / n) + 2 / n, p the two estimates' mean."""
    p = (np.asarray(p_a) + np.asarray(p_b)) / 2.0
    return 4.0 * np.sqrt(2.0 * p * (1.0 - p) / n) + 2.0 / n

