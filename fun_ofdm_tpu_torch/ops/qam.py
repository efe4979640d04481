"""Gray-coded QAM modulation and exact soft demodulation.

Counterpart of fun_ofdm_tpu/ops/qam.py: the reference's recursive per-axis
PAM (src/qam.h:83-125, src/modulator.cpp:29-163). Soft outputs are
confidences in 0..255 (128 = no information), carried as int32.

Per rate: BPSK is QAM<1>(power 1) on the real axis; QPSK, 16-QAM and
64-QAM are QAM<1>, QAM<2>, QAM<3> (power 0.5) per axis, I bits first.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..rates import Rate, params_for


def _axis_params(num_bits: int, power: float) -> tuple[float, float, int]:
    """(scale_e, scale_d, amp0) for one axis of a 2^num_bits-PAM."""
    nn = 1 << (num_bits - 1)
    sum2 = (4 * nn * nn * nn - nn) // 3
    sf = math.sqrt(power * nn / sum2)
    d_gain = 8 - num_bits
    return sf, (1 << d_gain) / sf, nn << d_gain


_MOD_CFG = {  # bpsc -> (axis_bits, power)
    1: (1, 1.0),
    2: (1, 0.5),
    4: (2, 0.5),
    6: (3, 0.5),
}

#: |pt| beyond this saturates every soft output the same way; clamping
#: first keeps the float -> int conversion in range for any input
_PT_LIMIT = float(1 << 20)


@functools.lru_cache(maxsize=None)
def _encode_lut(axis_bits: int, power: float) -> np.ndarray:
    """Axis bit group (MSB-first index) -> PAM amplitude."""
    sf, _, _ = _axis_params(axis_bits, power)
    out = np.zeros(1 << axis_bits)
    for idx in range(1 << axis_bits):
        pt, flip = 0, 1
        for i in range(axis_bits):
            b = 2 * ((idx >> (axis_bits - 1 - i)) & 1) - 1
            pt = b * flip + 2 * pt
            flip *= -b
        out[idx] = pt * sf
    return out


def modulate(bits: torch.Tensor, rate: Rate,
             dtype=torch.complex64) -> torch.Tensor:
    """(..., n) coded bits -> (..., n/bpsc) complex symbols."""
    bpsc = params_for(rate).bpsc
    axis_bits, power = _MOD_CFG[bpsc]
    real_dtype = torch.float64 if dtype == torch.complex128 else torch.float32
    lut = torch.from_numpy(_encode_lut(axis_bits, power)).to(
        bits.device, real_dtype)
    bits = bits.to(torch.int64)
    if bpsc == 1:  # BPSK: one bit on the real axis
        re = lut[bits]
        return torch.complex(re, torch.zeros_like(re))
    groups = bits.reshape(*bits.shape[:-1], -1, bpsc)
    weights = 1 << torch.arange(axis_bits - 1, -1, -1, device=bits.device)
    i_idx = (groups[..., :axis_bits] * weights).sum(-1)
    q_idx = (groups[..., axis_bits:] * weights).sum(-1)
    return torch.complex(lut[i_idx], lut[q_idx])


def modulate_p(bits: torch.Tensor, rate: Rate, dtype=torch.float32):
    """Planar form of modulate: (re, im) of (..., n/bpsc)."""
    cdtype = torch.complex128 if dtype == torch.float64 else torch.complex64
    sym = modulate(bits, rate, cdtype)
    return sym.real, sym.imag


def _axis_soft_decode(vals: torch.Tensor, axis_bits: int,
                      power: float) -> torch.Tensor:
    """(...,) axis values -> (..., axis_bits) soft confidences 0..255."""
    _, scale_d, amp0 = _axis_params(axis_bits, power)
    # C's double -> int conversion truncates toward zero (qam.h:112); the
    # product is taken in the input's precision, as the reference's is
    scaled = torch.nan_to_num(vals * scale_d, nan=0.0).clamp(
        -_PT_LIMIT, _PT_LIMIT)
    pt = torch.trunc(scaled).to(torch.int32)
    flip = torch.ones_like(pt)
    amp = amp0
    outs = []
    for _ in range(axis_bits):
        outs.append(torch.clamp(flip * pt + 128, 0, 255))
        s = torch.where(pt >= 0, 1, -1).to(torch.int32)
        pt = pt - s * amp
        flip = -s
        amp //= 2
    return torch.stack(outs, dim=-1)


def demodulate(symbols: torch.Tensor, rate: Rate) -> torch.Tensor:
    """(..., m) complex symbols -> (..., m*bpsc) int32 soft bits."""
    bpsc = params_for(rate).bpsc
    axis_bits, power = _MOD_CFG[bpsc]
    re = _axis_soft_decode(symbols.real, axis_bits, power)
    if bpsc == 1:
        return re.reshape(*symbols.shape[:-1], -1)
    im = _axis_soft_decode(symbols.imag, axis_bits, power)
    both = torch.cat([re, im], dim=-1)  # (..., m, bpsc)
    return both.reshape(*symbols.shape[:-1], -1)


def demodulate_p(symbols, rate: Rate) -> torch.Tensor:
    """Planar form of demodulate: (re, im) of (..., m) -> soft bits."""
    return demodulate(torch.complex(*symbols), rate)
