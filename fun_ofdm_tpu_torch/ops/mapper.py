"""Subcarrier mapping: 48 data samples <-> 64-bin OFDM symbols.

Counterpart of fun_ofdm_tpu/ops/mapper.py. Bins are in centred order
(index 0 = subcarrier -32, 32 = DC). The active map, pilot positions and
values and the 127-periodic pilot polarity are the reference's
(src/symbol_mapper.cpp:24-61, src/phase_tracker.cpp:23-50); symbol k of a
frame (k = 0 is SIGNAL) uses POLARITY[k % 127].
"""

from __future__ import annotations

import numpy as np
import torch

#: 0 = null, 1 = data, 2 = pilot, per centred subcarrier
ACTIVE_MAP: np.ndarray = np.zeros(64, np.int32)
ACTIVE_MAP[6:59] = 1
ACTIVE_MAP[32] = 0
ACTIVE_MAP[[11, 25, 39, 53]] = 2

DATA_IDX: np.ndarray = np.nonzero(ACTIVE_MAP == 1)[0].astype(np.int32)
PILOT_IDX: np.ndarray = np.nonzero(ACTIVE_MAP == 2)[0].astype(np.int32)
PILOT_VALUES: np.ndarray = np.array([1.0, 1.0, 1.0, -1.0])


def _polarity_sequence() -> np.ndarray:
    """The 802.11a pilot polarity p_0..p_126 (17.3.5.9): the scrambler
    x^7+x^4+1 run from the all-ones state, bit 1 -> -1."""
    state = 0x7F
    out = np.zeros(127)
    for i in range(127):
        bit = ((state >> 6) ^ (state >> 3)) & 1
        state = ((state << 1) & 0x7F) | bit
        out[i] = -1.0 if bit else 1.0
    return out


#: 127-periodic pilot polarity
POLARITY: np.ndarray = _polarity_sequence()


def polarity_for_symbols(num_symbols: int, start: int = 0) -> np.ndarray:
    """POLARITY[(start + k) % 127] for k in range(num_symbols)."""
    return POLARITY[(np.arange(num_symbols) + start) % 127]


def map_symbols(data: torch.Tensor, start_symbol: int = 0) -> torch.Tensor:
    """(..., nsym, 48) complex data -> (..., nsym, 64) symbols with the
    pilots (real, +-1 times the symbol's polarity) and zero nulls."""
    nsym = data.shape[-2]
    dev = data.device
    out = torch.zeros(data.shape[:-1] + (64,), dtype=data.dtype, device=dev)
    out[..., torch.from_numpy(DATA_IDX).long().to(dev)] = data
    pilots = polarity_for_symbols(nsym, start_symbol)[:, None] * PILOT_VALUES
    out[..., torch.from_numpy(PILOT_IDX).long().to(dev)] = torch.from_numpy(
        pilots).to(dev, data.dtype)
    return out


def map_symbols_p(data, start_symbol: int = 0):
    """Planar form of map_symbols."""
    out = map_symbols(torch.complex(*data), start_symbol)
    return out.real, out.imag


def demap_symbols(symbols: torch.Tensor) -> torch.Tensor:
    """(..., 64) symbols -> (..., 48) data bins, ascending index."""
    return symbols[..., torch.from_numpy(DATA_IDX).long().to(symbols.device)]
