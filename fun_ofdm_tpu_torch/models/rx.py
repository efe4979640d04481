"""Frame-synchronous RX: decode frames at known start offsets.

Counterpart of fun_ofdm_tpu/models/rx.py (the reference's fft_symbols,
channel_est, phase_tracker and frame_decoder stages). Relative to a
preamble start P the symbol bodies are cut 8 samples early, inside the
cyclic prefix; the LTS channel estimate absorbs that constant rotation
(reference: timing_sync.cpp:36-44):
  LTS1 body = x[P+184 : P+248], LTS2 body = x[P+248 : P+312],
  symbol k  = x[P+328+80k : P+392+80k] (k = 0 is SIGNAL).

cfo_correct=True estimates the carrier offset of every frame with the
coarse (STS, 16-lag) + fine (LTS, 64-lag) cascade and derotates its LTS
and symbol bodies before the channel estimate. The reference's own CFO
loop is dead code (src/timing_sync.cpp:109-112); this is fun_ofdm_tpu's
correction. The JAX module works on planar pairs, the port in complex64;
the derotation angle w * idx is formed in float32 before cos/sin, as
there.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import preamble as pre
from ..ops import fft64, mapper
from ..rates import Rate, params_for
from . import ppdu


def extract_frames(stream: torch.Tensor, starts: torch.Tensor,
                   num_symbols: int):
    """Cut LTS and symbol bodies of many frames out of one stream.

    stream: (..., n) complex; starts: (..., F) preamble starts.
    Returns (lts (..., F, 2, 64), syms (..., F, 1+num_symbols, 64)).
    Like the JAX package's dynamic_slice, each slice's start is clamped
    into the stream (a truncated frame reads edge samples and fails CRC).
    """
    n = stream.shape[-1]
    nsym_total = 1 + num_symbols
    body_len = (nsym_total - 1) * pre.SYMBOL_STRIDE + 64
    p = starts.to(torch.int64)
    j = torch.arange(64, device=stream.device)
    lts_at = torch.stack([torch.clamp(p + pre.LTS1_OFFSET, 0, n - 64),
                          torch.clamp(p + pre.LTS2_OFFSET, 0, n - 64)], -1)
    lts_idx = lts_at[..., None] + j                       # (..., F, 2, 64)
    body_at = torch.clamp(p + pre.SYMBOL0_OFFSET, 0, n - body_len)
    sym_off = (pre.SYMBOL_STRIDE
               * torch.arange(nsym_total, device=stream.device))[:, None] + j
    sym_idx = body_at[..., None, None] + sym_off          # (..., F, S, 64)

    def gather(idx):
        flat = idx.reshape(*stream.shape[:-1], -1)
        return torch.gather(stream, -1, flat).reshape(idx.shape)

    return gather(lts_idx), gather(sym_idx)


def extract_symbols_p(samples, start, num_symbols: int):
    """Planar counterpart of fun_ofdm_tpu's extract_symbols_p.

    samples: (re, im) of (..., n); start: (...,) preamble starts.
    Returns planar (lts (..., 2, 64), syms (..., 1+num_symbols, 64)).
    """
    stream = torch.complex(*samples)
    start = torch.as_tensor(start, device=stream.device)
    start = torch.broadcast_to(start, stream.shape[:-1])[..., None]
    lts, syms = extract_frames(stream, start, num_symbols)
    lts, syms = lts[..., 0, :, :], syms[..., 0, :, :]
    return (lts.real, lts.imag), (syms.real, syms.imag)


def estimate_cfo(lts_time: torch.Tensor) -> torch.Tensor:
    """Fine CFO estimate from the two LTS bodies, rad/sample.

    lts_time: (..., 2, 64) complex. The second body is the first delayed
    by 64 samples, so w = angle(sum x2[n] * conj(x1[n])) / 64, exact
    modulo 2*pi/64."""
    acc = (lts_time[..., 1, :] * lts_time[..., 0, :].conj()).sum(-1)
    return torch.atan2(acc.imag, acc.real) / 64.0


def estimate_cfo_p(lts_time) -> torch.Tensor:
    """Planar form of estimate_cfo (fun_ofdm_tpu's estimate_cfo_p)."""
    return estimate_cfo(torch.complex(*lts_time))


def extract_sts(stream: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """The 160-sample STS regions at starts (..., F) of stream (..., n):
    (..., F, 160), each slice's start clamped into the stream as
    dynamic_slice does."""
    n = stream.shape[-1]
    at = torch.clamp(starts.to(torch.int64), 0, n - 160)
    idx = at[..., None] + torch.arange(160, device=stream.device)
    flat = idx.reshape(*stream.shape[:-1], -1)
    return torch.gather(stream, -1, flat).reshape(idx.shape)


def extract_sts_p(samples, start):
    """Planar counterpart of fun_ofdm_tpu's extract_sts_p: (re, im) of
    (..., n) and (...,) starts -> planar (..., 160)."""
    stream = torch.complex(*samples)
    start = torch.as_tensor(start, device=stream.device)
    start = torch.broadcast_to(start, stream.shape[:-1])[..., None]
    sts = extract_sts(stream, start)[..., 0, :]
    return sts.real, sts.imag


def estimate_cfo_coarse(sts_time: torch.Tensor) -> torch.Tensor:
    """Coarse CFO from the STS, rad/sample: the STS repeats every 16
    samples, so w = angle(sum x[n+16] * conj(x[n])) / 16 over the 144
    products, unambiguous to +-pi/16 (+-1/32 cycles/sample)."""
    acc = (sts_time[..., 16:] * sts_time[..., :-16].conj()).sum(-1)
    return torch.atan2(acc.imag, acc.real) / 16.0


def estimate_cfo_coarse_p(sts_time) -> torch.Tensor:
    """Planar form of estimate_cfo_coarse."""
    return estimate_cfo_coarse(torch.complex(*sts_time))


#: the fine estimate's ambiguity, rad/sample
CFO_PERIOD = 2.0 * np.pi / 64.0


def estimate_cfo_cascade(stream: torch.Tensor, starts: torch.Tensor,
                         lts_time: torch.Tensor) -> torch.Tensor:
    """Coarse (STS) + fine (LTS) CFO of the frames at starts (..., F) of
    stream (..., n), with their LTS bodies (..., F, 2, 64): w = wf +
    round((wc - wf) / (2*pi/64)) * 2*pi/64, the fine accuracy over the
    coarse range (equal to wf at small offsets). Returns (..., F)."""
    wf = estimate_cfo(lts_time)
    wc = estimate_cfo_coarse(extract_sts(stream, starts))
    k = torch.round((wc - wf) / CFO_PERIOD)
    return wf + k * CFO_PERIOD


def estimate_cfo_cascade_p(samples, start, lts_time) -> torch.Tensor:
    """Planar counterpart of fun_ofdm_tpu's estimate_cfo_cascade_p:
    samples (re, im) of (..., n), (...,) starts, planar (..., 2, 64)."""
    stream = torch.complex(*samples)
    start = torch.as_tensor(start, device=stream.device)
    start = torch.broadcast_to(start, stream.shape[:-1])[..., None]
    lts = torch.complex(*lts_time)[..., None, :, :]
    return estimate_cfo_cascade(stream, start, lts)[..., 0]


def derotation_indices(nsym_total: int):
    """(lts_idx (2, 64), sym_idx (nsym_total, 64)) sample indices relative
    to the LTS1 body start, the layout of extract_frames' outputs."""
    lts_idx = 64 * np.arange(2)[:, None] + np.arange(64)[None, :]
    sym_idx = ((pre.SYMBOL0_OFFSET - pre.LTS1_OFFSET)
               + 80 * np.arange(nsym_total)[:, None]
               + np.arange(64)[None, :])
    return lts_idx, sym_idx


def _derotate(x: torch.Tensor, w: torch.Tensor, idx) -> torch.Tensor:
    """x (..., R, 64) complex times e^{-j * w * idx}, w (...,), idx
    (R, 64); the angle is formed in float32."""
    idx = torch.from_numpy(np.asarray(idx, np.float32)).to(w.device)
    ang = w[..., None, None] * idx
    return x * torch.complex(torch.cos(ang), -torch.sin(ang))


def _derotate_p(x, w: torch.Tensor, idx):
    """Planar form of _derotate (fun_ofdm_tpu's _derotate_p)."""
    out = _derotate(torch.complex(*x), w, idx)
    return out.real, out.imag


def sync_frames(stream: torch.Tensor, starts: torch.Tensor,
                num_symbols: int, cfo_correct: bool):
    """extract_frames, then, with cfo_correct, the cascade's derotation of
    the LTS and symbol bodies. The derotation's leftover constant phase
    e^{-j*w*(LTS1 offset)} is common to the LTS and the symbols, so the
    zero-forcing equalizer absorbs it."""
    lts, syms = extract_frames(stream, starts, num_symbols)
    if cfo_correct:
        w = estimate_cfo_cascade(stream, starts, lts)
        lts_idx, sym_idx = derotation_indices(1 + num_symbols)
        lts, syms = _derotate(lts, w, lts_idx), _derotate(syms, w, sym_idx)
    return lts, syms


def channel_estimate(lts_time: torch.Tensor) -> torch.Tensor:
    """Zero-forcing inverse channel from the two LTS bodies.

    lts_time: (..., 2, 64). H_inv[j] = mean over both LTS of
    LTS_ref[j] / LTS_rx[j], zero where LTS_rx[j] = 0 and on inactive bins
    (reference: src/channel_est.cpp:44-58). Returns (..., 64).
    """
    lts_f = fft64.forward(lts_time)
    ref = torch.from_numpy(pre.LTS_FREQ_DOMAIN).to(lts_f.device, lts_f.dtype)
    d = lts_f.real * lts_f.real + lts_f.imag * lts_f.imag
    num = ref * lts_f.conj()
    inv = torch.where(d > 0, num / torch.where(d > 0, d, 1.0), 0.0)
    active = torch.from_numpy(pre.LTS_FREQ_DOMAIN != 0).to(lts_f.device)
    return inv.mean(dim=-2) * active


def channel_estimate_p(lts_time):
    """Planar form of channel_estimate."""
    out = channel_estimate(torch.complex(*lts_time))
    return out.real, out.imag


def equalize_and_track(sym_time: torch.Tensor,
                       h_inv: torch.Tensor) -> torch.Tensor:
    """FFT, equalize, pilot phase-track, keep the 48 data bins.

    sym_time: (..., S, 64) time-domain bodies (index 0 = SIGNAL);
    h_inv: (..., 64). Returns (..., S, 48)
    (reference: src/channel_est.cpp:77-81, src/phase_tracker.cpp:70-105).
    """
    eq = fft64.forward(sym_time) * h_inv[..., None, :]
    nsym = sym_time.shape[-2]
    dev = eq.device
    pilot_ref = torch.from_numpy(
        mapper.polarity_for_symbols(nsym, 0)[:, None] * mapper.PILOT_VALUES
    ).to(dev, eq.real.dtype)                                   # (S, 4)
    pilots = eq[..., torch.from_numpy(mapper.PILOT_IDX).long().to(dev)]
    # the pilot references are real: rx * conj(ref) = rx * ref
    angle = torch.angle((pilots * pilot_ref).mean(dim=-1))
    rot = torch.polar(torch.ones_like(angle), -angle)
    return mapper.demap_symbols(eq) * rot[..., None]


def equalize_and_track_p(sym_time, h_inv):
    """Planar form of equalize_and_track."""
    out = equalize_and_track(torch.complex(*sym_time), torch.complex(*h_inv))
    return out.real, out.imag


def decode_frames(stream: torch.Tensor, rate: Rate, length: int,
                  starts: torch.Tensor, cfo_correct: bool = False) -> dict:
    """Decode the frames at starts (..., F) of stream (..., n).

    All frames go through one header Viterbi and one payload Viterbi.
    cfo_correct: derotate each frame by its estimated carrier offset.
    Returns per-frame payload (..., F, length), crc_ok, header_ok,
    rate_field, hdr_length, service.
    """
    nsym = params_for(rate).num_symbols(length)
    lts, syms = sync_frames(stream, starts, nsym, cfo_correct)
    data = equalize_and_track(syms, channel_estimate(lts))  # (..., F, S, 48)
    rate_field, hdr_length, header_ok = ppdu.decode_header(data[..., 0, :])
    rest = data[..., 1:, :].reshape(*data.shape[:-2], -1)
    payload, crc_ok, service = ppdu.decode_data(rest, rate, length)
    return {
        "payload": payload,
        "crc_ok": crc_ok,
        "header_ok": header_ok,
        "rate_field": rate_field,
        "hdr_length": hdr_length,
        "service": service,
    }


def decode_frame_p(samples, rate: Rate, length: int, start=0,
                   cfo_correct: bool = False) -> dict:
    """Planar counterpart of fun_ofdm_tpu's decode_frame_p: samples
    (re, im) of (..., n) each holding a frame whose preamble starts at
    `start` (broadcast over the batch)."""
    return _one_frame(lambda s, st: decode_frames(s, rate, length, st,
                                                  cfo_correct),
                      samples, start)


def _header_and_rest(stream, starts, nsym_max: int, cfo_correct: bool):
    """Extract (and, with cfo_correct, derotate) and equalize nsym_max
    data symbols at each start; decode the SIGNAL header. Returns (data
    samples (..., F, nsym_max*48), rate_field, hdr_length, header_ok)."""
    lts, syms = sync_frames(stream, starts, nsym_max, cfo_correct)
    data = equalize_and_track(syms, channel_estimate(lts))
    rate_field, hdr_length, header_ok = ppdu.decode_header(data[..., 0, :])
    rest = data[..., 1:, :].reshape(*data.shape[:-2], -1)
    return rest, rate_field, hdr_length, header_ok


def decode_frames_dynamic(stream: torch.Tensor, rate: Rate, max_length: int,
                          starts: torch.Tensor,
                          viterbi_impl: str | None = None,
                          cfo_correct: bool = False) -> dict:
    """Header-driven decode of the frames at starts (..., F) of stream
    (..., n), at one static rate: each payload length comes from the
    frame's SIGNAL field. All frames go through one header Viterbi and
    one payload Viterbi. The stream must cover a max_length frame from
    each start. Returns per-frame payload (..., F, max_length) (first
    hdr_length bytes valid), crc_ok (False on another rate's header or a
    length outside 1..max_length), header_ok, rate_field, hdr_length,
    service, rate_match, viterbi_exact (False only where the block-overlap
    Viterbi's merge guard flagged the frame)."""
    rp = params_for(rate)
    rest, rate_field, hdr_length, header_ok = _header_and_rest(
        stream, starts, rp.num_symbols(max_length), cfo_correct)
    rate_match = rate_field == rp.rate_field
    payload, crc_ok, service, exact = ppdu.decode_data_dynamic_p(
        (rest.real, rest.imag), rate, hdr_length, max_length,
        viterbi_impl=viterbi_impl, return_exact=True)
    return {
        "payload": payload,
        "crc_ok": crc_ok & header_ok & rate_match,
        "header_ok": header_ok,
        "rate_field": rate_field,
        "hdr_length": hdr_length,
        "service": service,
        "rate_match": rate_match,
        "viterbi_exact": exact,
    }


def decode_frames_anyrate(stream: torch.Tensor, rates: tuple[Rate, ...],
                          max_length: int, starts: torch.Tensor,
                          viterbi_impl: str | None = None,
                          cfo_correct: bool = False) -> dict:
    """Universal decode of the frames at starts (..., F) of stream
    (..., n): rate and length both come from each frame's SIGNAL field.
    Symbols are extracted at the slowest configured rate's geometry, so
    the stream must cover that rate's max_length frame from each start.
    Same outputs as decode_frames_dynamic; rate_match is True where the
    header's rate is one of `rates`."""
    rates = tuple(rates)
    nsym_max = max(params_for(r).num_symbols(max_length) for r in rates)
    rest, rate_field, hdr_length, header_ok = _header_and_rest(
        stream, starts, nsym_max, cfo_correct)
    rate_idx = torch.full_like(rate_field, -1)
    for i, r in enumerate(rates):
        rate_idx = torch.where(rate_field == params_for(r).rate_field, i,
                               rate_idx)
    rate_match = rate_idx >= 0
    payload, crc_ok, service, exact = ppdu.decode_data_anyrate_p(
        (rest.real, rest.imag), rates, rate_idx, hdr_length, max_length,
        viterbi_impl=viterbi_impl)
    return {
        "payload": payload,
        "crc_ok": crc_ok & header_ok & rate_match,
        "header_ok": header_ok,
        "rate_field": rate_field,
        "hdr_length": hdr_length,
        "service": service,
        "rate_match": rate_match,
        "viterbi_exact": exact,
    }


def _one_frame(decode, samples, start):
    stream = torch.complex(*samples)
    start = torch.as_tensor(start, device=stream.device)
    start = torch.broadcast_to(start, stream.shape[:-1])[..., None]
    out = decode(stream, start)
    return {k: v[..., 0, :] if k == "payload" else v[..., 0]
            for k, v in out.items()}


def decode_frame_dynamic_p(samples, rate: Rate, max_length: int, start=0,
                           cfo_correct: bool = False,
                           viterbi_impl: str | None = None) -> dict:
    """Planar counterpart of fun_ofdm_tpu's decode_frame_dynamic_p:
    samples (re, im) of (..., n), one frame per stream at `start`
    (broadcast over the batch)."""
    return _one_frame(lambda s, st: decode_frames_dynamic(
        s, rate, max_length, st, viterbi_impl, cfo_correct), samples, start)


def decode_frame_anyrate_p(samples, rates: tuple[Rate, ...],
                           max_length: int, start=0,
                           cfo_correct: bool = False,
                           viterbi_impl: str | None = None) -> dict:
    """Planar counterpart of fun_ofdm_tpu's decode_frame_anyrate_p (see
    decode_frame_dynamic_p)."""
    return _one_frame(lambda s, st: decode_frames_anyrate(
        s, rates, max_length, st, viterbi_impl, cfo_correct), samples,
        start)
