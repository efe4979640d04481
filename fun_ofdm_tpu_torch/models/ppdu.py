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

from ..ops import convcode, crc32, interleave, puncture, qam, scramble, viterbi
from ..rates import VALID_RATE_FIELDS, Rate, params_for
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
    valid = torch.isin(rate_field, torch.tensor(VALID_RATE_FIELDS,
                                                device=field.device))
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


def _anyrate_coded_select(samples, rates, ridx, n_coded_max: int):
    """Each frame's depunctured soft stream at the rate of its header: every
    configured rate's own demodulate -> deinterleave -> depuncture, padded
    or cut to n_coded_max with erasures, then selected per frame by
    ridx (...,), an index into rates."""
    acc = None
    for i, r in enumerate(rates):
        soft = interleave.deinterleave(qam.demodulate_p(samples, r))
        cur = puncture.depuncture(soft, r).to(torch.int32)[..., :n_coded_max]
        cur = torch.nn.functional.pad(
            cur, (0, n_coded_max - cur.shape[-1]), value=puncture.ERASURE)
        sel = (ridx == i)[..., None]
        acc = torch.where(sel, cur, puncture.ERASURE if acc is None else acc)
    return acc


def decode_data_anyrate_p(samples, rates: tuple[Rate, ...], rate_idx,
                          lengths, max_length: int,
                          viterbi_impl: str | None = None):
    """Universal payload decode: rate and length are per-frame values.

    Counterpart of fun_ofdm_tpu's decode_data_anyrate_p with its default
    strategy "select" (the "gather" strategy is not ported). samples:
    (re, im) of (..., nsym_max*48), nsym_max the largest num_symbols
    (max_length) over `rates`; rate_idx: (...,) index into `rates` (out
    of range: unknown rate, crc_ok False); lengths: (...,) payload byte
    counts. Returns (payload (..., max_length), crc_ok, service,
    viterbi_exact).
    """
    rates = tuple(rates)
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
    dbps = torch.tensor([params_for(r).dbps for r in rates], device=dev)
    nbits = _frame_nbits(lengths_c, dbps[ridx])

    coded = _anyrate_coded_select(samples, rates, ridx, 2 * nbits_max)
    decoded_bits, exact_ok = viterbi.viterbi_decode(
        coded, nbits_max - TAIL_BITS, impl=viterbi_impl,
        nbits_dynamic=nbits - TAIL_BITS, return_exact=True)
    payload, crc_ok, service = _descrambled_payload(
        decoded_bits, n_bytes_max, lengths_c, max_length)
    return payload, crc_ok & in_range, service, exact_ok
