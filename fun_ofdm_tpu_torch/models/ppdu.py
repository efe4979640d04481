"""PPDU codec: PLCP header and payload encode/decode.

Counterpart of fun_ofdm_tpu/models/ppdu.py (reference: src/ppdu.cpp),
with the reference's quirks:
  * header field parity(1)|rate(4)|reserved(1)|length(12)|tail(6),
    sent MSB first (src/ppdu.cpp:86-95);
  * byte-granular LSB-only scrambler, seed 93 (src/ppdu.cpp:140-148);
  * the 6 encoder tail bits are the next bits of the scrambled buffer,
    not forced zeros (src/ppdu.cpp:150-153);
  * CRC-32 little-endian over [service(2) | payload] (src/ppdu.cpp:134-137).
Samples are complex tensors; the `_p` functions take and give planar
(re, im) pairs.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops import (convcode, crc32, interleave, puncture, qam, scramble,
                   softbits_cuda, viterbi)
from ..rates import VALID_RATE_FIELDS, Rate, params_for
from ..utils import tables, trace
from ..utils.bits import bits_to_bytes, bytes_to_bits

HEADER_BITS = 18  # rate(4) + reserved(1) + length(12) + parity(1)
SERVICE_BYTES = 2
CRC_BYTES = 4
TAIL_BITS = 6


def _parity_int(x: int) -> int:
    return bin(x).count("1") & 1


@functools.lru_cache(maxsize=None)
def header_samples_np(rate: Rate, length: int) -> np.ndarray:
    """The 48 BPSK SIGNAL-symbol samples for (rate, length), complex128
    (reference: src/ppdu.cpp:81-110)."""
    rp = params_for(rate)
    field = ((rp.rate_field & 0xF) << 13) | (length & 0xFFF)
    if _parity_int(field):
        field |= 1 << 17
    field <<= 6  # 24-bit word, 6 tail zeros
    bits = [(field >> (23 - i)) & 1 for i in range(HEADER_BITS + TAIL_BITS)]
    sr = 0
    coded = np.zeros(2 * len(bits), np.int32)
    for i, b in enumerate(bits):
        sr = ((sr << 1) | b) & 0x7F
        coded[2 * i] = _parity_int(sr & convcode.POLYS[0])
        coded[2 * i + 1] = _parity_int(sr & convcode.POLYS[1])
    inter = np.zeros_like(coded)
    inter[interleave.PERM] = coded
    return (2.0 * inter - 1.0).astype(np.complex128)


def encode_data(payload: torch.Tensor, rate: Rate,
                dtype=torch.complex64) -> torch.Tensor:
    """(..., length) payload bytes -> (..., num_symbols*48) data-subcarrier
    samples (reference: src/ppdu.cpp:112-165)."""
    rp = params_for(rate)
    length = payload.shape[-1]
    n_bits = rp.num_data_bits(length)
    n_bytes = rp.num_data_bytes(length)
    batch = payload.shape[:-1]
    dev = payload.device

    payload = payload.to(torch.int32)
    service = torch.zeros(batch + (SERVICE_BYTES,), dtype=torch.int32,
                          device=dev)
    crc = crc32.crc32(torch.cat([service, payload], dim=-1))
    crc_le = torch.stack([(crc >> (8 * i)) & 0xFF for i in range(CRC_BYTES)],
                         dim=-1).to(torch.int32)
    pad = torch.zeros(
        batch + (n_bytes + 1 - SERVICE_BYTES - length - CRC_BYTES,),
        dtype=torch.int32, device=dev)
    data = torch.cat([service, payload, crc_le, pad], dim=-1)
    # scramble the first n_bytes bytes; the spill byte stays clear
    data = torch.cat([scramble.scramble_bytes(data[..., :n_bytes]),
                      data[..., n_bytes:]], dim=-1)

    bits = bytes_to_bits(data)[..., :n_bits]  # data bits + in-buffer tail
    coded = convcode.conv_encode(bits)
    inter = interleave.interleave(puncture.puncture(coded, rate))
    return qam.modulate(inter, rate, dtype)


def encode(payload: torch.Tensor, rate: Rate,
           dtype=torch.complex64) -> torch.Tensor:
    """SIGNAL + data samples: (..., (1+nsym)*48)."""
    hdr = torch.from_numpy(header_samples_np(rate, payload.shape[-1])).to(
        payload.device, dtype)
    data = encode_data(payload, rate, dtype)
    return torch.cat([hdr.expand(data.shape[:-1] + (48,)), data], dim=-1)


def _complex_dtype(real_dtype) -> torch.dtype:
    return torch.complex128 if real_dtype == torch.float64 else torch.complex64


def encode_data_p(payload: torch.Tensor, rate: Rate, dtype=torch.float32):
    """Planar form of encode_data."""
    out = encode_data(payload, rate, _complex_dtype(dtype))
    return out.real, out.imag


def encode_p(payload: torch.Tensor, rate: Rate, dtype=torch.float32):
    """Planar form of encode."""
    out = encode(payload, rate, _complex_dtype(dtype))
    return out.real, out.imag


def encode_data_dynamic_p(payload: torch.Tensor, lengths, rate: Rate,
                          dtype=torch.float32):
    """Encode zero-padded payload bytes with per-frame lengths.

    Counterpart of fun_ofdm_tpu's encode_data_dynamic_p, the dual of
    decode_data_dynamic_p. payload: (..., max_length) bytes, zeros past
    each frame's length; lengths: (...,) byte counts. Returns planar
    (re, im) of (..., num_symbols(max_length)*48) samples whose first
    num_symbols(length)*48 are exactly encode_data_p's for that length:
    the scrambler keystream, the conv encoder, the puncture pattern, the
    48-chunk interleave and the QAM grouping are causal and
    position-uniform, so a shorter frame is a prefix of the max-shape
    buffers. Samples past a frame's extent are defined but meaningless;
    the caller slices them away.
    """
    rp = params_for(rate)
    max_length = payload.shape[-1]
    n_bits = rp.num_data_bits(max_length)
    n_bytes = rp.num_data_bytes(max_length)
    batch = payload.shape[:-1]
    dev = payload.device

    payload = payload.to(torch.int32)
    lengths = torch.broadcast_to(
        torch.as_tensor(lengths, device=dev).to(torch.int64), batch)
    end = (SERVICE_BYTES + lengths.clamp(1, max_length))[..., None]

    msg = torch.nn.functional.pad(payload, (SERVICE_BYTES, 0))
    crc = crc32.crc32_dynamic(msg, end[..., 0])
    crc_le = torch.stack([(crc >> (8 * i)) & 0xFF for i in range(CRC_BYTES)],
                         dim=-1).to(torch.int32)

    # [service | payload[:length] | crc_le | zeros]: the CRC lands at its
    # per-frame offset through a gather and a select
    buf_len = n_bytes + 1
    msg_pad = torch.nn.functional.pad(msg, (0, buf_len - msg.shape[-1]))
    crc_off = torch.arange(buf_len, device=dev) - end
    crc_sel = torch.gather(crc_le, -1, crc_off.clamp(0, CRC_BYTES - 1))
    data = torch.where(crc_off < 0, msg_pad,
                       torch.where(crc_off < CRC_BYTES, crc_sel, 0))
    # the whole static extent is scrambled; bytes past a frame's own
    # extent only feed bits that are not sent
    data = torch.cat([scramble.scramble_bytes(data[..., :n_bytes]),
                      data[..., n_bytes:]], dim=-1)

    bits = bytes_to_bits(data)[..., :n_bits]
    coded = convcode.conv_encode(bits)
    inter = interleave.interleave(puncture.puncture(coded, rate))
    return qam.modulate_p(inter, rate, dtype)


def header_samples_dynamic_p(lengths, rate: Rate, dtype=torch.float32):
    """SIGNAL symbol samples for per-frame lengths: planar (re, im) of
    (..., 48), on the device of `lengths`, equal to
    header_samples_np(rate, length) for every length (reference:
    src/ppdu.cpp:81-110). lengths: (...,) byte counts."""
    rp = params_for(rate)
    lengths = torch.as_tensor(lengths).to(torch.int64)
    field = ((rp.rate_field & 0xF) << 13) | (lengths & 0xFFF)
    par = field
    for s in (16, 8, 4, 2, 1):
        par = par ^ (par >> s)
    field = (field | ((par & 1) << 17)) << 6    # 24-bit word, 6 tail zeros
    shifts = torch.arange(23, -1, -1, device=lengths.device)
    bits24 = (field[..., None] >> shifts) & 1
    inter = interleave.interleave(convcode.conv_encode(bits24))
    re = (2.0 * inter - 1.0).to(dtype)
    return re, torch.zeros_like(re)


def encode_dynamic_p(payload: torch.Tensor, lengths, rate: Rate,
                     dtype=torch.float32):
    """SIGNAL + data samples for per-frame lengths, planar
    (..., (1 + num_symbols(max_length))*48); the first
    (1 + num_symbols(length))*48 samples of each frame equal encode_p's
    for that length (see encode_data_dynamic_p)."""
    lengths = torch.broadcast_to(
        torch.as_tensor(lengths, device=payload.device), payload.shape[:-1])
    hdr_re, hdr_im = header_samples_dynamic_p(lengths, rate, dtype)
    data_re, data_im = encode_data_dynamic_p(payload, lengths, rate, dtype)
    return (torch.cat([hdr_re, data_re], dim=-1),
            torch.cat([hdr_im, data_im], dim=-1))


@tables.on_device()
def _valid_rate_fields_on(device: torch.device) -> torch.Tensor:
    return torch.tensor(VALID_RATE_FIELDS, device=device)


def decode_header(samples: torch.Tensor):
    """(..., 48) SIGNAL samples -> (rate_field, length, ok), where ok
    covers parity and a valid rate (reference: src/ppdu.cpp:168-218)."""
    soft = interleave.deinterleave(qam.demodulate(samples, Rate.RATE_1_2_BPSK))
    bits = viterbi.viterbi_decode(soft, HEADER_BITS)
    bits = torch.nn.functional.pad(bits, (0, 24 - HEADER_BITS))
    fb = bits_to_bytes(bits)
    field = (fb[..., 0] << 16) | (fb[..., 1] << 8) | fb[..., 2]
    par = field
    for s in (16, 8, 4, 2, 1):
        par = par ^ (par >> s)
    parity_ok = (par & 1) == 0
    rate_field = (field >> 19) & 0xF
    length = (field >> 6) & 0xFFF
    # one comparison a valid field: torch.isin makes a call that a CUDA
    # graph capture refuses at some sizes (models/rx.capture_call)
    valid = (rate_field[..., None]
             == _valid_rate_fields_on(field.device)).any(-1)
    return rate_field, length, parity_ok & valid


def decode_header_p(samples):
    """Planar form of decode_header."""
    return decode_header(torch.complex(*samples))


def decode_data(samples: torch.Tensor, rate: Rate, length: int):
    """(..., num_symbols*48) equalized samples -> (payload (..., length)
    int32, crc_ok (...,) bool, service (...,) int32)
    (reference: src/ppdu.cpp:223-295)."""
    rp = params_for(rate)
    n_bits = rp.num_data_bits(length)
    n_bytes = rp.num_data_bytes(length)

    soft = interleave.deinterleave(qam.demodulate(samples, rate))
    depunct = puncture.depuncture(soft, rate)
    decoded_bits = viterbi.viterbi_decode(depunct, n_bits - TAIL_BITS)
    decoded_bits = torch.nn.functional.pad(
        decoded_bits, (0, (-decoded_bits.shape[-1]) % 8))
    descrambled = scramble.descramble_bytes(
        bits_to_bytes(decoded_bits)[..., :n_bytes])

    service = descrambled[..., 0] | (descrambled[..., 1] << 8)
    payload = descrambled[..., SERVICE_BYTES:SERVICE_BYTES + length]
    given_crc = descrambled[
        ..., SERVICE_BYTES + length:SERVICE_BYTES + length + CRC_BYTES]
    given = sum(given_crc[..., i].to(torch.int64) << (8 * i)
                for i in range(CRC_BYTES))
    calc = crc32.crc32(descrambled[..., :SERVICE_BYTES + length])
    return payload, given == calc, service


def decode_data_p(samples, rate: Rate, length: int):
    """Planar form of decode_data."""
    return decode_data(torch.complex(*samples), rate, length)


def _descrambled_payload(decoded_bits: torch.Tensor, n_bytes: int,
                         lengths_c: torch.Tensor, max_length: int):
    """Bits of frames with per-frame lengths -> (payload (..., max_length),
    CRC agreement (...,), service (...,)): descramble, then the given CRC
    at byte offset 2 + length and the computed one over the first
    2 + length bytes."""
    decoded_bits = torch.nn.functional.pad(
        decoded_bits, (0, (-decoded_bits.shape[-1]) % 8))
    descrambled = scramble.descramble_bytes(
        bits_to_bytes(decoded_bits)[..., :n_bytes])
    service = descrambled[..., 0] | (descrambled[..., 1] << 8)
    payload = descrambled[..., SERVICE_BYTES:SERVICE_BYTES + max_length]
    off = (SERVICE_BYTES + lengths_c)[..., None] + torch.arange(
        CRC_BYTES, device=lengths_c.device)
    given_b = torch.gather(descrambled, -1,
                           off.clamp(0, descrambled.shape[-1] - 1))
    given = sum(given_b[..., i].to(torch.int64) << (8 * i)
                for i in range(CRC_BYTES))
    calc = crc32.crc32_dynamic(
        descrambled[..., :SERVICE_BYTES + max_length],
        SERVICE_BYTES + lengths_c)
    return payload, given == calc, service


def _frame_nbits(lengths_c: torch.Tensor, dbps) -> torch.Tensor:
    """Data bits of each frame, in-buffer tail included."""
    frame_bits = 16 + 8 * (lengths_c + CRC_BYTES) + TAIL_BITS
    return (frame_bits + dbps - 1) // dbps * dbps


def decode_data_dynamic_p(samples, rate: Rate, lengths, max_length: int,
                          viterbi_impl: str | None = None,
                          return_exact: bool = False):
    """Decode frames of per-frame byte lengths at one static rate.

    Counterpart of fun_ofdm_tpu's decode_data_dynamic_p. samples: (re, im)
    of (..., num_symbols(max_length)*48) equalized data samples (past a
    frame's extent: anything); lengths: (...,) payload byte counts from
    the SIGNAL header. Every transform before the Viterbi is
    position-uniform, so a shorter frame is a prefix of the static
    buffers; the Viterbi stops each frame at its own trellis end and the
    CRC is taken over the frame's own bytes. Returns (payload
    (..., max_length) int32, first `lengths` bytes valid; crc_ok (...,)
    bool, False for a length outside 1..max_length; service (...,)
    int32), and with return_exact=True the Viterbi's exactness flag.
    """
    rp = params_for(rate)
    lengths = torch.as_tensor(lengths, device=samples[0].device).to(
        torch.int64)
    in_range = (lengths >= 1) & (lengths <= max_length)
    lengths_c = lengths.clamp(1, max_length)
    nbits = _frame_nbits(lengths_c, rp.dbps)

    soft = interleave.deinterleave(qam.demodulate_p(samples, rate))
    depunct = puncture.depuncture(soft, rate)
    decoded_bits, exact_ok = viterbi.viterbi_decode(
        depunct, rp.num_data_bits(max_length) - TAIL_BITS,
        impl=viterbi_impl, nbits_dynamic=nbits - TAIL_BITS,
        return_exact=True)
    payload, crc_ok, service = _descrambled_payload(
        decoded_bits, rp.num_data_bytes(max_length), lengths_c, max_length)
    crc_ok = crc_ok & in_range
    if return_exact:
        return payload, crc_ok, service, exact_ok
    return payload, crc_ok, service


@functools.lru_cache(maxsize=None)
def _anyrate_tables(rates: tuple[Rate, ...], max_length: int):
    """Per-rate gather tables of the any-rate decoder (numpy, built once
    per (rates, max_length)); fun_ofdm_tpu's _anyrate_tables.

    For each rate, demap -> deinterleave -> depuncture is a position
    permutation with erasure holes, so it folds into one table:
    tabs[r][m] is the index, in the flattened 13-wide all-modulation soft
    vector of ops/qam.demodulate_all_p, of depunctured coded bit m, or -1
    for a depuncture erasure or a slot past the rate's end (reference
    transforms: src/modulator.cpp:108-163, src/interleaver.cpp:15-37,
    src/puncturer.cpp:98-117).

    Returns (tabs (n_rates, 2*nbits_max) int32, dbps (n_rates,) int32,
    rate_fields (n_rates,) int32, nbits_max, n_bytes_max).
    """
    nbits_max = max(params_for(r).num_data_bits(max_length) for r in rates)
    n_bytes_max = max(params_for(r).num_data_bytes(max_length)
                      for r in rates)
    tabs = np.full((len(rates), 2 * nbits_max), -1, np.int32)
    for i, r in enumerate(rates):
        rp = params_for(r)
        n_coded = 2 * rp.num_data_bits(max_length)
        pat = puncture._pattern(r)
        m_idx = np.arange(n_coded)
        if pat is None:
            k_of_m, valid = m_idx, np.ones(n_coded, bool)
        else:
            group, keep = pat
            g, j = m_idx // group, m_idx % group
            valid = np.isin(j, keep)
            k_of_m = g * len(keep) + np.searchsorted(keep, j)
        kk = np.where(valid, k_of_m, 0)
        # punctured bit k reads demodulated soft position
        # 48*(k//48) + PERM[k%48]; soft bit j of modulation bpsc is lane
        # ALL_SOFT_OFFSET[bpsc] + j%bpsc of sample j//bpsc
        soft_j = 48 * (kk // 48) + interleave.PERM[kk % 48]
        tab = (qam.ALL_SOFT_WIDTH * (soft_j // rp.bpsc)
               + qam.ALL_SOFT_OFFSET[rp.bpsc] + soft_j % rp.bpsc)
        tabs[i, :n_coded] = np.where(valid, tab, -1)
    return (tabs,
            np.array([params_for(r).dbps for r in rates], np.int32),
            np.array([params_for(r).rate_field for r in rates], np.int32),
            nbits_max, n_bytes_max)


@tables.on_device()
def _anyrate_tables_on(rates: tuple[Rate, ...], max_length: int,
                       device: torch.device) -> torch.Tensor:
    """_anyrate_tables' tabs as an int64 tensor on `device`."""
    return torch.from_numpy(_anyrate_tables(rates, max_length)[0]).to(
        device, torch.int64)


@tables.on_device()
def _dbps_on(rates: tuple[Rate, ...], device: torch.device) -> torch.Tensor:
    """(n_rates,) int64 data bits a symbol of each rate, on device."""
    return torch.tensor([params_for(r).dbps for r in rates], device=device)


def _anyrate_coded_gather(samples, rates, ridx, max_length: int):
    """Each frame's depunctured soft stream by one gather: every sample
    demodulated under all four modulations (ops/qam.demodulate_all_p),
    then the table of the frame's rate picks the lanes, -1 giving an
    erasure."""
    soft_all = qam.demodulate_all_p(samples)               # (..., m, 13)
    flat13 = soft_all.reshape(*soft_all.shape[:-2], -1)
    tab = _anyrate_tables_on(rates, max_length, flat13.device)[ridx]
    picked = torch.gather(flat13, -1, tab.clamp(0, flat13.shape[-1] - 1))
    return torch.where(tab >= 0, picked.to(torch.int32), puncture.ERASURE)


def decode_data_anyrate_p(samples, rates: tuple[Rate, ...], rate_idx,
                          lengths, max_length: int,
                          viterbi_impl: str | None = None):
    """Universal payload decode: rate and length are per-frame values.

    Counterpart of fun_ofdm_tpu's decode_data_anyrate_p. samples:
    (re, im) of (..., nsym_max*48), nsym_max the largest num_symbols
    (max_length) over `rates`; rate_idx: (...,) index into `rates` (out
    of range: unknown rate, crc_ok False); lengths: (...,) payload byte
    counts. The soft streams are fun_ofdm_tpu's "gather": every sample
    demodulated once under all modulations, then gathered through the
    rate's table (_anyrate_tables). On the card one kernel builds them
    (ops/softbits_cuda.softbits); CPU tensors take its plain version,
    _anyrate_coded_gather. The FUN_OFDM_ANYRATE variable is not read.
    Returns (payload (..., max_length), crc_ok, service, viterbi_exact).
    On the card it counts anyrate.kernel_slots (utils/trace.py).
    """
    if samples[0].is_cuda:
        trace.count("anyrate.kernel_slots", samples[0].shape[:-1].numel())
    return decode_data_anyrate(samples, tuple(rates), rate_idx, lengths,
                               max_length, viterbi_impl)


def decode_data_anyrate(samples, rates: tuple[Rate, ...], rate_idx, lengths,
                        max_length: int, viterbi_impl: str | None):
    """decode_data_anyrate_p without its counter."""
    nbits_max = max(params_for(r).num_data_bits(max_length) for r in rates)
    n_bytes_max = max(params_for(r).num_data_bytes(max_length)
                      for r in rates)
    dev = samples[0].device
    rate_idx = torch.as_tensor(rate_idx, device=dev).to(torch.int64)
    known = (rate_idx >= 0) & (rate_idx < len(rates))
    ridx = rate_idx.clamp(0, len(rates) - 1)
    lengths = torch.as_tensor(lengths, device=dev).to(torch.int64)
    in_range = (lengths >= 1) & (lengths <= max_length) & known
    lengths_c = lengths.clamp(1, max_length)
    nbits = _frame_nbits(lengths_c, _dbps_on(rates, dev)[ridx])

    with trace.span("ppdu.anyrate_coded"):
        if samples[0].is_cuda:
            lead = samples[0].shape[:-1]
            coded = softbits_cuda.softbits(samples, rates, ridx.expand(lead),
                                           max_length)
        else:
            coded = _anyrate_coded_gather(samples, rates, ridx, max_length)
    decoded_bits, exact_ok = viterbi.viterbi_decode(
        coded, nbits_max - TAIL_BITS, impl=viterbi_impl,
        nbits_dynamic=nbits - TAIL_BITS, return_exact=True)
    payload, crc_ok, service = _descrambled_payload(
        decoded_bits, n_bytes_max, lengths_c, max_length)
    return payload, crc_ok & in_range, service, exact_ok
