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
from ..ops import correlate, detect_cuda
from ..rates import Rate, params_for
from ..utils import trace
from . import ppdu as ppdu_model
from . import rx as rx_model

#: preamble start = LTS CP start - 160
LTS_CP_FROM_START = 160

#: blocked extractor: events kept per 512-sample block; more are dropped
#: and counted (only noise makes >16 LTS-reachable events in 512 samples)
_BLOCK = 512
_BLOCK_CAP = 16
#: streams longer than this take the blocked extractor
_BLOCKED_MIN_N = 1 << 13


def _first_k_true(mask: torch.Tensor, k: int,
                  drop_count_limit: int | None = None):
    """Positions of the first k True values along the last axis.

    Returns (pos (..., k) int64, n where invalid; valid (..., k) bool;
    dropped (...,) int64, the events lost to the blocked extractor's
    per-block cap, 0 on the exact one-hot path).
    """
    n = mask.shape[-1]
    if n > _BLOCKED_MIN_N:
        blocked = _first_k_true_blocked(mask, k, drop_count_limit)
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


def _first_k_true_blocked(mask: torch.Tensor, k: int,
                          drop_count_limit: int | None = None):
    """Two-level first k: the first 16 events of each 512-sample block,
    then the first k of those. Exact whenever no block holds more than 16
    events; the events over the cap are counted in `dropped`, only in
    blocks that start below drop_count_limit when it is given (the
    streaming chain re-scans the previous superstep's lead tail and
    counts drops in its owned region only). Returns None when the
    candidates cannot cover k."""
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
    over_b = torch.clamp(count_b - _BLOCK_CAP, min=0)
    if drop_count_limit is not None:
        over_b = torch.where(block_base[:, 0] < drop_count_limit, over_b, 0)
    dropped = over_b.sum(-1)
    count = count_b.sum(-1, keepdim=True)
    valid = (torch.arange(k, device=dev) < count) & (pos < n)
    return torch.where(valid, pos, n), valid, dropped


def detect_frames(stream: torch.Tensor, max_frames: int,
                  params: ChainParams = DEFAULT_PARAMS,
                  return_dropped: bool = False,
                  drop_count_limit: int | None = None):
    """Find frame starts in (..., n) complex captures.

    Returns (starts (..., max_frames) int64, valid (..., max_frames)
    bool), ordered by position, start = n where invalid; with
    return_dropped=True also (...,) int64 `dropped`, the detection events
    lost to the blocked extractor's per-block cap (counted in blocks that
    start below drop_count_limit, when given). The steps mirror the
    reference:
      1. normalised STS autocorrelation ratio per sample;
      2. STS_END events after a >= 16-sample plateau, kept only where an
         LTS peak pair 64 apart is reachable within params.lts_search;
      3. per event, the top 5 LTS peaks of the next lts_search positions,
         peak 0 paired with the first of peaks 1..4 exactly 64 away
         (timing_sync.cpp:92-117);
      4. frame start = min(pair) - 32 - 160.
    A CPU tensor takes the plain version, detect_frames_plain; a CUDA
    tensor (complex64, contiguous) the two kernels of csrc/detect.cu, with
    the same outputs (ops/detect_cuda.py).
    """
    if not stream.is_cuda:
        return detect_frames_plain(stream, max_frames, params, return_dropped,
                                   drop_count_limit)
    out = detect_cuda.detect(stream, max_frames, params,
                             _block_cap(stream.shape[-1], max_frames),
                             drop_count_limit)
    return out if return_dropped else out[:2]


def _block_cap(n: int, max_frames: int) -> int:
    """Events _first_k_true keeps from each _BLOCK-sample block of an
    n-sample stream: _BLOCK_CAP on the blocked path, all on the exact one."""
    if n > _BLOCKED_MIN_N and max_frames <= -(-n // _BLOCK) * _BLOCK_CAP:
        return _BLOCK_CAP
    return _BLOCK


def detect_frames_plain(stream: torch.Tensor, max_frames: int,
                        params: ChainParams = DEFAULT_PARAMS,
                        return_dropped: bool = False,
                        drop_count_limit: int | None = None):
    """The plain version of detect_frames, on any device: the steps of its
    docstring as eager PyTorch ops."""
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

    end_pos, end_valid, dropped = _first_k_true(ends, max_frames,
                                                drop_count_limit)

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
    if return_dropped:
        return torch.where(ok, start, n), ok, dropped
    return torch.where(ok, start, n), ok


def detect_frames_p(stream, max_frames: int,
                    params: ChainParams = DEFAULT_PARAMS,
                    return_dropped: bool = False,
                    drop_count_limit: int | None = None):
    """Planar form of detect_frames: stream (re, im) of (..., n)."""
    return detect_frames(torch.complex(*stream), max_frames, params,
                         return_dropped, drop_count_limit)


def _receive(samples, decode: rx_model.Decode, max_frames: int,
             params: ChainParams, keys: tuple[str, ...],
             frame_len: int | None = None) -> dict:
    """Detect, then decode every slot (rx_model.capture_call: on the card
    a replay of the decode's CUDA graph once its key repeats). samples:
    (..., n) complex or planar (re, im). With frame_len, only frames that
    fit in the stream count as valid and are decoded. Returns starts,
    valid, crc_ok and header_ok (both False where not valid) and `keys` of
    the decode's outputs and of detect_dropped."""
    with trace.span("frontend.receive_capture"):
        with rx_model.capture_call(samples, decode, max_frames) as (stream,
                                                                     run):
            with trace.span("frontend.detect"):
                starts, valid, dropped = detect_frames(stream, max_frames,
                                                       params,
                                                       return_dropped=True)
            if frame_len is not None:
                valid = valid & (starts + frame_len <= stream.shape[-1])
            with trace.span("rx.decode"):
                out = run(valid, starts)
        out["detect_dropped"] = dropped
        return {"starts": starts, "valid": valid,
                "crc_ok": out["crc_ok"] & valid,
                "header_ok": out["header_ok"] & valid,
                **{k: out[k] for k in keys}}


def receive_capture(stream: torch.Tensor, rate: Rate, length: int,
                    max_frames: int,
                    params: ChainParams = DEFAULT_PARAMS) -> dict:
    """Detect and decode every frame of a known (rate, length) config.

    stream: (..., n) complex captures, e.g. (channels, n), or their
    planar (re, im) pair. Every slot of every stream is decoded in one
    batch (one header and one payload Viterbi launch). Returns per-slot tensors (..., max_frames): starts,
    valid, payload (..., max_frames, length), crc_ok, header_ok;
    `valid & crc_ok` marks delivered packets. Only frames that fit in the
    stream are valid.
    """
    return _receive(stream, rx_model.Decode("frames", (rate,), length),
                    max_frames, params, ("payload",),
                    params_for(rate).frame_samples(length))


def receive_capture_p(stream, rate: Rate, length: int, max_frames: int,
                      params: ChainParams = DEFAULT_PARAMS) -> dict:
    """Planar form of receive_capture: stream (re, im) of (..., n), on
    the card written straight into the decode's stream buffer."""
    return receive_capture(stream, rate, length, max_frames, params)


#: samples a SIGNAL header needs from the preamble start (preamble + SIGNAL)
_HEADER_SPAN = 400


def decode_headers(stream: torch.Tensor, max_frames: int,
                   params: ChainParams = DEFAULT_PARAMS,
                   drop_count_limit: int | None = None,
                   hdr_slots: int | None = None,
                   cfo_correct: bool = False) -> dict:
    """Detect frames in (..., n) complex streams and decode only their
    SIGNAL headers, every slot of every stream in one batch.

    Counterpart of fun_ofdm_tpu's decode_headers_p (which takes one 1-D
    stream). Returns dict: starts, valid, rate_field, hdr_length,
    header_ok, each (..., S) with S = hdr_slots if given and smaller than
    max_frames, else max_frames; detect_dropped (...,), the events lost
    to the blocked extractor's cap (counted below drop_count_limit); and
    n_detected (...,), all detections. Slots are ordered by position, so
    the first hdr_slots lose nothing whenever n_detected <= hdr_slots; a
    caller seeing more re-runs without hdr_slots. cfo_correct: derotate
    each header by the coarse + fine cascade's estimate, as the payload
    decode does (a large offset rotates the SIGNAL symbol itself by
    several radians at 8e-3 cycles/sample).
    """
    starts, valid, dropped = detect_frames(stream, max_frames, params,
                                           return_dropped=True,
                                           drop_count_limit=drop_count_limit)
    n_detected = valid.sum(-1)
    if hdr_slots is not None and hdr_slots < max_frames:
        starts, valid = starts[..., :hdr_slots], valid[..., :hdr_slots]
    # pad so that the slices of a header near the end stay aligned
    padded = torch.nn.functional.pad(stream, (0, _HEADER_SPAN))
    lts, syms = rx_model.sync_frames(padded, torch.where(valid, starts, 0),
                                     0, cfo_correct)
    data = rx_model.equalize_and_track(syms, rx_model.channel_estimate(lts))
    rate_field, hdr_length, header_ok = ppdu_model.decode_header(
        data[..., 0, :])
    return {
        "starts": starts,
        "valid": valid,
        "rate_field": rate_field,
        "hdr_length": hdr_length,
        "header_ok": header_ok & valid,
        "detect_dropped": dropped,
        "n_detected": n_detected,
    }


def decode_headers_p(stream, max_frames: int,
                     params: ChainParams = DEFAULT_PARAMS,
                     drop_count_limit: int | None = None,
                     cfo_correct: bool = False,
                     hdr_slots: int | None = None) -> dict:
    """Planar form of decode_headers: stream (re, im) of (..., n)."""
    return decode_headers(torch.complex(*stream), max_frames, params,
                          drop_count_limit, hdr_slots, cfo_correct)


def receive_capture_dynamic_p(stream, rate: Rate, max_length: int,
                              max_frames: int,
                              params: ChainParams = DEFAULT_PARAMS) -> dict:
    """Counterpart of fun_ofdm_tpu's receive_capture_dynamic_p over
    (..., n) planar streams: the rate is configuration, each frame's
    length comes from its SIGNAL header. Returns per-slot starts, valid,
    payload (..., max_frames, max_length), hdr_length, rate_field,
    crc_ok, header_ok, and (...,) detect_dropped. The stream is decoded
    followed by one longest frame of zeros (a frame cut by the capture's
    end reads zeros and fails its CRC)."""
    return _receive(stream, rx_model.Decode("dynamic", (rate,), max_length),
                    max_frames, params,
                    ("detect_dropped", "payload", "hdr_length",
                     "rate_field"))


def receive_capture_anyrate_p(stream, rates: tuple[Rate, ...],
                              max_length: int, max_frames: int,
                              params: ChainParams = DEFAULT_PARAMS) -> dict:
    """Counterpart of fun_ofdm_tpu's receive_capture_anyrate_p over
    (..., n) planar streams: each frame's rate and length come from its
    SIGNAL header. Same outputs as receive_capture_dynamic_p, plus
    rate_match."""
    return _receive(stream,
                    rx_model.Decode("anyrate", tuple(rates), max_length),
                    max_frames, params,
                    ("detect_dropped", "payload", "hdr_length",
                     "rate_field", "rate_match"))
