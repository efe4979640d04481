"""TX frame builder: payload bytes -> baseband time-domain frame.

Counterpart of fun_ofdm_tpu/models/tx.py (reference:
src/frame_builder.cpp:53-82): PPDU encode, subcarrier map, batched 64-point
IFFT, cyclic prefix, preamble. Batch over leading dimensions.
"""

from __future__ import annotations

import torch

from .. import preamble as pre
from ..ops import fft64, mapper
from ..rates import Rate
from . import ppdu


def _assemble_frame(samples: torch.Tensor) -> torch.Tensor:
    """(..., S*48) modulated samples (SIGNAL first) -> (..., 320 + 80*S)
    frame: map onto 48 data + 4 pilot + 12 null bins, IFFT, prefix the
    last 16 samples of each symbol, prepend the preamble."""
    batch = samples.shape[:-1]
    syms = samples.reshape(*batch, -1, 48)
    t = fft64.inverse(mapper.map_symbols(syms, start_symbol=0))
    flat = torch.cat([t[..., 48:], t], dim=-1).reshape(*batch, -1)
    preamble = torch.from_numpy(pre.PREAMBLE_SAMPLES).to(
        samples.device, samples.dtype)
    return torch.cat([preamble.expand(batch + (320,)), flat], dim=-1)


def _assemble_frame_p(sam_re: torch.Tensor, sam_im: torch.Tensor, dtype):
    """Planar form of _assemble_frame."""
    cdtype = torch.complex128 if dtype == torch.float64 else torch.complex64
    out = _assemble_frame(torch.complex(sam_re, sam_im).to(cdtype))
    return out.real, out.imag


def build_frame(payload: torch.Tensor, rate: Rate,
                dtype=torch.complex64) -> torch.Tensor:
    """(..., length) payload bytes -> (..., 320 + 80*(1+nsym)) frame."""
    return _assemble_frame(ppdu.encode(payload, rate, dtype))


def build_frame_p(payload: torch.Tensor, rate: Rate, dtype=torch.float32):
    """Planar form of build_frame: (re, im) of the frame samples."""
    cdtype = torch.complex128 if dtype == torch.float64 else torch.complex64
    out = build_frame(payload, rate, cdtype)
    return out.real, out.imag
