"""The universal decode's soft streams on the card (csrc/softbits.cu),
bound with ctypes.

One kernel behind one C entry point computes, for every slot of the
any-rate decoder, the depunctured soft stream at the slot's rate:
demodulation, the fixed 48-bit deinterleave, depuncturing with the
erasure 127 and the erasures past the rate's end, in one pass. Its output
is models/ppdu._anyrate_coded_gather's, bit for bit; the note at the top of
csrc/softbits.cu has the design and what bounds it. The source is compiled
at first use (ops/nvcc.py); importing this module builds nothing.

The plain version is models/ppdu._anyrate_coded_gather, which
decode_data_anyrate_p runs for CPU tensors; for CUDA tensors it calls
`softbits` here.
`softbits` checks its tensors, launches on the current CUDA stream without
a host synchronisation, raises when the launch fails, and counts its calls
in `launches` (one launch a call; none while a CUDA graph is being
captured, nvcc.count_launch). The per-rate parameters are built on the
host once per (rates, max_length) and passed by value: no copy to the card.
"""

from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import torch

from ..rates import Rate, params_for
from . import nvcc, puncture, qam

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "softbits.cu"
#: rates one call may configure (kMaxRates of the source)
MAX_RATES = 16

#: calls since the last reset_launches()
launches = {"softbits": 0}


class RateParams(ctypes.Structure):
    """One configured rate as the kernel reads it (struct RateParams of
    csrc/softbits.cu, field for field)."""

    _fields_ = [("scale_d", ctypes.c_float),
                ("amp0", ctypes.c_int32),
                ("n_coded", ctypes.c_int32),
                ("bpsc", ctypes.c_uint8),
                ("axis_bits", ctypes.c_uint8),
                ("group", ctypes.c_uint8),
                ("nkeep", ctypes.c_uint8),
                ("rank", ctypes.c_int8 * 8)]


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def library_path() -> Path:
    """Where the built library for the current source and flags lives."""
    return nvcc.library_path(SOURCE, "softbits")


@functools.lru_cache(maxsize=None)
def build() -> ctypes.CDLL:
    """Compile the kernel (once per source version) and load it
    (ops/nvcc.py; the compiler's report is kept beside the library)."""
    lib = nvcc.load(SOURCE, "softbits")
    ptr, cll = ctypes.c_void_p, ctypes.c_longlong
    lib.ofdm_softbits.argtypes = [ptr, ptr, cll, cll, cll, cll, ptr, ptr,
                                  cll, cll, cll, ptr, ctypes.c_int, ptr]
    lib.ofdm_softbits.restype = ctypes.c_int
    lib.ofdm_softbits_params_size.argtypes = []
    lib.ofdm_softbits_params_size.restype = ctypes.c_int
    size = lib.ofdm_softbits_params_size()
    if size != ctypes.sizeof(RateParams):
        raise RuntimeError(f"struct RateParams is {size} bytes in "
                           f"{SOURCE.name}, {ctypes.sizeof(RateParams)} here")
    return lib


@functools.lru_cache(maxsize=None)
def rate_params(rates: tuple[Rate, ...], max_length: int):
    """The kernel's parameter block for `rates` at max_length: a ctypes
    array of RateParams, one per rate in order (built once per
    (rates, max_length))."""
    block = (RateParams * len(rates))()
    for p, r in zip(block, rates):
        rp = params_for(r)
        axis_bits, power = qam._MOD_CFG[rp.bpsc]
        _, scale_d, amp0 = qam._axis_params(axis_bits, power)
        pat = puncture._pattern(r)
        group, keep = (1, [0]) if pat is None else (pat[0], list(pat[1]))
        p.scale_d = scale_d
        p.amp0 = amp0
        p.n_coded = 2 * rp.num_data_bits(max_length)
        p.bpsc, p.axis_bits = rp.bpsc, axis_bits
        p.group, p.nkeep = group, len(keep)
        for j in range(8):
            p.rank[j] = keep.index(j) if j in keep else -1
    return block


def softbits(samples, rates: tuple[Rate, ...], ridx: torch.Tensor,
             max_length: int) -> torch.Tensor:
    """models/ppdu._anyrate_coded_gather on the card.

    samples: planar (re, im) float32 CUDA tensors of (..., nsym_max*48)
    equalised data points, nsym_max the largest num_symbols(max_length)
    over `rates`; any strides (the real and imaginary views of a complex
    tensor are read in place). ridx: (...,) int64 on the same device, the
    index of each slot's rate in `rates`; an index out of range is clamped
    into it, as decode_data_anyrate_p clamps it.
    Returns (..., 2 * nbits_max) int32: each slot's depunctured soft stream
    at its rate, 127 in the puncture holes and past the rate's end.
    """
    re, im = samples
    rates = tuple(rates)
    for name, t in (("re", re), ("im", im), ("ridx", ridx)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if re.dtype != torch.float32 or im.dtype != torch.float32:
        raise TypeError(f"samples must be float32, got {re.dtype} and "
                        f"{im.dtype}")
    if ridx.dtype != torch.int64:
        raise TypeError(f"ridx must be int64, got {ridx.dtype}")
    if not 1 <= len(rates) <= MAX_RATES:
        raise ValueError(f"1 to {MAX_RATES} rates, got {len(rates)}")
    nsym_max = max(params_for(r).num_symbols(max_length) for r in rates)
    lead, points = re.shape[:-1], re.shape[-1]
    if (im.shape != re.shape or ridx.shape != lead
            or points != nsym_max * 48):
        raise ValueError(
            f"samples must be (..., {nsym_max * 48}) and ridx (...): got "
            f"{tuple(re.shape)}, {tuple(im.shape)}, {tuple(ridx.shape)}")
    if im.device != re.device or ridx.device != re.device:
        raise ValueError("samples and ridx must be on one device")
    slots = math.prod(lead)
    row = 2 * max(params_for(r).num_data_bits(max_length) for r in rates)
    out = torch.empty(lead + (row,), dtype=torch.int32, device=re.device)
    if slots == 0:
        return out
    # the leading dimensions as one slot stride: a view where they merge
    re2, im2 = re.reshape(slots, points), im.reshape(slots, points)
    idx = ridx.reshape(slots).contiguous()
    params = rate_params(rates, max_length)
    with torch.cuda.device(re.device):
        err = build().ofdm_softbits(
            re2.data_ptr(), im2.data_ptr(), re2.stride(0), re2.stride(1),
            im2.stride(0), im2.stride(1), idx.data_ptr(), out.data_ptr(),
            slots, points, row, params, len(rates),
            torch.cuda.current_stream(re.device).cuda_stream)
    if err == -1:
        raise ValueError(f"ofdm_softbits takes 1 to {MAX_RATES} rates and "
                         f"rows of a multiple of 4, not {row}")
    nvcc.count_launch(launches, "softbits")
    if err:
        raise RuntimeError(f"ofdm_softbits launch failed: CUDA error {err}")
    return out
