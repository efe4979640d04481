"""Sliding-window correlators for the RX front end (complex streams).

Counterpart of fun_ofdm_tpu/ops/correlate.py:
  * STS lagged autocorrelation and power over 16-sample windows
    (reference: src/frame_detector.cpp:47-63);
  * plateau events (src/frame_detector.cpp:65-82) as a trailing count;
  * the 64-tap LTS matched filter (src/timing_sync.cpp:74-86).

Every window sum is taken per window (unfold + sum, or a polyphase
product), never as a difference of running sums, whose float32 error
grows along a long stream and can flip the 0.9 detection thresholds.
The LTS filter's polyphase products run in complex128, so a float32
matmul setting that allows TF32 cannot touch them. All functions act on
the last axis and broadcast over leading ones.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import preamble as pre


def _trailing_window_sum(x: torch.Tensor, w: int) -> torch.Tensor:
    """y[n] = sum x[n-w+1 .. n], zeros before the start."""
    padded = torch.cat([torch.zeros(x.shape[:-1] + (w - 1,), dtype=x.dtype,
                                    device=x.device), x], dim=-1)
    return padded.unfold(-1, w, 1).sum(-1)


def _leading_window_sum(x: torch.Tensor, w: int) -> torch.Tensor:
    """y[n] = sum x[n .. n+w-1], zeros past the end."""
    padded = torch.cat([x, torch.zeros(x.shape[:-1] + (w - 1,),
                                       dtype=x.dtype, device=x.device)],
                       dim=-1)
    return padded.unfold(-1, w, 1).sum(-1)


def sts_autocorrelation(x: torch.Tensor, lag: int = 16):
    """corr[n] = sum over the last `lag` samples of x[k]*conj(x[k-lag])
    (x[<0] = 0), power[n] = sum of |x[k]|^2 over the same window.
    Returns (corr complex, power real), shapes of x."""
    delayed = torch.cat([torch.zeros(x.shape[:-1] + (lag,), dtype=x.dtype,
                                      device=x.device), x[..., :-lag]], dim=-1)
    corr = _trailing_window_sum(x * delayed.conj(), lag)
    power = _trailing_window_sum(x.real * x.real + x.imag * x.imag, lag)
    return corr, power


def sts_ratio(x: torch.Tensor, lag: int = 16) -> torch.Tensor:
    """|corr| / power, with zero power giving 0."""
    corr, power = sts_autocorrelation(x, lag)
    mag = torch.sqrt(corr.real * corr.real + corr.imag * corr.imag)
    return torch.where(power > 0, mag / torch.where(power > 0, power, 1.0),
                       0.0)


def sts_end_events(ratio: torch.Tensor, threshold: float,
                   plateau_len: int) -> torch.Tensor:
    """STS_END mask: the first sub-threshold sample after at least
    `plateau_len` consecutive above-threshold samples."""
    above = ratio > threshold
    count = _trailing_window_sum(above.to(torch.int32), plateau_len)
    prev_full = torch.cat([torch.zeros_like(above[..., :1]),
                           count[..., :-1] >= plateau_len], dim=-1)
    return ~above & prev_full


def leading_window_any(mask: torch.Tensor, w: int) -> torch.Tensor:
    """out[n] = any(mask[n : n+w]), False past the end."""
    return _leading_window_sum(mask.to(torch.int32), w) > 0


@functools.lru_cache(maxsize=None)
def _lts_polyphase_taps(segments: int = 1) -> tuple[np.ndarray, np.ndarray]:
    """(A, B): (64, segments*64) complex tap matrices of the polyphase LTS
    filter. With p = 64q + r, y[p] = rows[q] @ A[:, r] + rows[q+1] @ B[:, r]:
    A[c, r] = taps[c - r] for c >= r, B[c, r] = taps[64 + c - r] for c < r.
    With segments > 1 the taps split into contiguous segments, stacked
    side by side (column k*64 + r is segment k at phase r)."""
    taps = np.asarray(pre.LTS_TIME_DOMAIN_CONJ)
    c = np.arange(64)[:, None]
    r = np.arange(64)[None, :]
    lo_idx = np.where(c >= r, c - r, 0)
    hi_idx = np.where(c < r, 64 + c - r, 0)
    seg = 64 // segments
    a = [np.where((c >= r) & (lo_idx // seg == k), taps[lo_idx], 0)
         for k in range(segments)]
    b = [np.where((c < r) & (hi_idx // seg == k), taps[hi_idx], 0)
         for k in range(segments)]
    return np.concatenate(a, axis=1), np.concatenate(b, axis=1)


def lts_correlation(x: torch.Tensor, segments: int = 1) -> torch.Tensor:
    """64-tap LTS matched filter, normalised.

    norm[p] = |sum_s x[p+s] conj(LTS[s])| / sum_s |x[p+s]|^2
    (reference: timing_sync.cpp:77-84); zero where p+63 is past the end.
    With segments > 1 the taps split into `segments` sub-correlations
    whose magnitudes are summed (CFO-tolerant). Returns (..., n) float32.
    """
    if 64 % segments:
        raise ValueError("segments must divide 64")
    n = x.shape[-1]
    q = -(-n // 64)
    pad = torch.zeros(x.shape[:-1] + ((q + 1) * 64 - n,), dtype=x.dtype,
                      device=x.device)
    rows = torch.cat([x, pad], dim=-1).to(torch.complex128).reshape(
        *x.shape[:-1], q + 1, 64)
    a, b = (torch.from_numpy(m).to(x.device)
            for m in _lts_polyphase_taps(segments))
    corr = rows[..., :q, :] @ a + rows[..., 1:, :] @ b  # (..., q, seg*64)
    mag = corr.reshape(*corr.shape[:-1], segments, 64).abs().sum(-2)
    mag = mag.reshape(*x.shape[:-1], q * 64)[..., :n].to(torch.float32)
    power = _leading_window_sum(x.real * x.real + x.imag * x.imag, 64)
    norm = torch.where(power > 0, mag / torch.where(power > 0, power, 1.0),
                       0.0)
    valid = torch.arange(n, device=x.device) <= n - 64
    return torch.where(valid, norm, 0.0)
