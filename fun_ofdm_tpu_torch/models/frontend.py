"""RX front end: frame detection, timing sync and capture decode.

Counterpart of fun_ofdm_tpu/models/frontend.py (the reference's
frame_detector and timing_sync, src/frame_detector.cpp:41-92,
src/timing_sync.cpp:51-139), processing a whole capture at once: STS
autocorrelation ratios, plateau events, the LTS matched filter and peak
pairing are data-parallel, and each STS end yields at most one frame
start. The JAX package vmaps over channels; here streams are (..., n)
with the channels as leading dimensions. Detection has a fixed number
of slots per stream, ordered by position, with a validity mask.
"""

from __future__ import annotations

import torch

from ..config import DEFAULT_PARAMS, ChainParams
from ..ops import correlate
from ..rates import Rate, params_for
from . import rx as rx_model

#: preamble start = LTS CP start - 160
LTS_CP_FROM_START = 160

#: blocked extractor: events kept per 512-sample block; more are dropped
#: and counted (only noise makes >16 LTS-reachable events in 512 samples)
_BLOCK = 512
_BLOCK_CAP = 16
#: streams longer than this take the blocked extractor
_BLOCKED_MIN_N = 1 << 13


def _first_k_true(mask: torch.Tensor, k: int):
    """Positions of the first k True values along the last axis.

    Returns (pos (..., k) int64, n where invalid; valid (..., k) bool;
    dropped (...,) int64, the events lost to the blocked extractor's
    per-block cap, 0 on the exact one-hot path).
    """
    n = mask.shape[-1]
    if n > _BLOCKED_MIN_N:
        blocked = _first_k_true_blocked(mask, k)
        if blocked is not None:
            return blocked
    mi = mask.to(torch.int64)
    slot = torch.where(mask, torch.cumsum(mi, dim=-1) - mi, k)
    slots = torch.arange(k, device=mask.device)
    onehot = slot[..., None, :] == slots[:, None]            # (..., k, n)
    pos = (onehot * torch.arange(n, device=mask.device)).sum(-1)
    valid = slots < mi.sum(-1, keepdim=True)
    return (torch.where(valid, pos, n), valid,
            torch.zeros(mask.shape[:-1], dtype=torch.int64,
                        device=mask.device))


def _first_k_true_blocked(mask: torch.Tensor, k: int):
    """Two-level first k: the first 16 events of each 512-sample block,
    then the first k of those. Exact whenever no block holds more than 16
    events; the events over the cap are counted in `dropped`. Returns
    None when the candidates cannot cover k."""
    n = mask.shape[-1]
    nb = -(-n // _BLOCK)
    if k > nb * _BLOCK_CAP:
        return None
    dev = mask.device
    mb = torch.nn.functional.pad(mask, (0, nb * _BLOCK - n)).reshape(
        *mask.shape[:-1], nb, _BLOCK)
    pos_in = torch.where(mb, torch.arange(_BLOCK, device=dev), _BLOCK)
    p = torch.topk(pos_in, _BLOCK_CAP, dim=-1, largest=False).values
    block_base = _BLOCK * torch.arange(nb, device=dev)[:, None]
    gpos = torch.where(p < _BLOCK, p + block_base, n).reshape(
        *mask.shape[:-1], nb * _BLOCK_CAP)
    pos = torch.topk(gpos, k, dim=-1, largest=False).values  # ascending
    count_b = mb.to(torch.int64).sum(-1)
    dropped = torch.clamp(count_b - _BLOCK_CAP, min=0).sum(-1)
    count = count_b.sum(-1, keepdim=True)
    valid = (torch.arange(k, device=dev) < count) & (pos < n)
    return torch.where(valid, pos, n), valid, dropped


def detect_frames(stream: torch.Tensor, max_frames: int,
                  params: ChainParams = DEFAULT_PARAMS):
    """Find frame starts in (..., n) complex captures.

    Returns (starts (..., max_frames) int64, valid (..., max_frames)
    bool), ordered by position, start = n where invalid. The steps
    mirror the reference:
      1. normalised STS autocorrelation ratio per sample;
      2. STS_END events after a >= 16-sample plateau, kept only where an
         LTS peak pair 64 apart is reachable within params.lts_search;
      3. per event, the top 5 LTS peaks of the next lts_search positions,
         peak 0 paired with the first of peaks 1..4 exactly 64 away
         (timing_sync.cpp:92-117);
      4. frame start = min(pair) - 32 - 160.
    """
    n = stream.shape[-1]
    ratio = correlate.sts_ratio(stream, params.sts_length)
    ends = correlate.sts_end_events(ratio, params.plateau_threshold,
                                    params.sts_plateau_length)
    lts_norm = correlate.lts_correlation(stream, params.lts_segments)
    thr = params.lts_corr_threshold
    peak = lts_norm > thr
    pair = peak & torch.cat([peak[..., 64:], torch.zeros_like(peak[..., :64])],
                            dim=-1)
    ends = ends & correlate.leading_window_any(pair, params.lts_search - 64)

    end_pos, end_valid, _ = _first_k_true(ends, max_frames)

    search = params.lts_search
    lts_padded = torch.cat(
        [lts_norm, torch.zeros(lts_norm.shape[:-1] + (search,),
                               dtype=lts_norm.dtype, device=lts_norm.device)],
        dim=-1)
    # the window start is clamped into the padded stream, as
    # dynamic_slice does in the JAX package
    win_at = torch.clamp(end_pos, 0, n)[..., None] + torch.arange(
        search, device=stream.device)                        # (..., k, search)
    win = torch.gather(lts_padded, -1, win_at.reshape(*lts_padded.shape[:-1], -1)
                       ).reshape(win_at.shape)
    cand = torch.where(win > thr, win, -torch.inf)
    # top 5 in descending order, ties to the lower position (lax.top_k)
    vals, rel = torch.sort(cand, dim=-1, descending=True, stable=True)
    vals, rel = vals[..., :5], rel[..., :5]
    pos = end_pos[..., None] + rel
    hit = ((pos[..., :1] - pos[..., 1:]).abs() == 64) \
        & torch.isfinite(vals[..., 1:]) & torch.isfinite(vals[..., :1])
    first = hit.to(torch.int32).argmax(dim=-1, keepdim=True)
    partner = torch.gather(pos[..., 1:], -1, first)[..., 0]
    lts_offset = torch.minimum(pos[..., 0], partner) - 32
    start = lts_offset - LTS_CP_FROM_START
    ok = end_valid & hit.any(dim=-1) & (lts_offset >= 0) & (start >= 0)
    return torch.where(ok, start, n), ok


def detect_frames_p(stream, max_frames: int,
                    params: ChainParams = DEFAULT_PARAMS):
    """Planar form of detect_frames: stream (re, im) of (..., n)."""
    return detect_frames(torch.complex(*stream), max_frames, params)


def receive_capture(stream: torch.Tensor, rate: Rate, length: int,
                    max_frames: int,
                    params: ChainParams = DEFAULT_PARAMS) -> dict:
    """Detect and decode every frame of a known (rate, length) config.

    stream: (..., n) complex captures, e.g. (channels, n). Every slot of
    every stream is decoded in one batch (one header and one payload
    Viterbi launch). Returns per-slot tensors (..., max_frames): starts,
    valid, payload (..., max_frames, length), crc_ok, header_ok;
    `valid & crc_ok` marks delivered packets.
    """
    n = stream.shape[-1]
    frame_len = params_for(rate).frame_samples(length)
    starts, valid = detect_frames(stream, max_frames, params)
    ok = valid & (starts + frame_len <= n)  # decode only frames that fit
    out = rx_model.decode_frames(stream, rate, length,
                                 torch.where(ok, starts, 0))
    return {
        "starts": starts,
        "valid": ok,
        "payload": out["payload"],
        "crc_ok": out["crc_ok"] & ok,
        "header_ok": out["header_ok"] & ok,
    }


def receive_capture_p(stream, rate: Rate, length: int, max_frames: int,
                      params: ChainParams = DEFAULT_PARAMS) -> dict:
    """Planar form of receive_capture: stream (re, im) of (..., n)."""
    return receive_capture(torch.complex(*stream), rate, length, max_frames,
                           params)
