"""Bit/byte packing, MSB first (the reference codec's order).

Counterpart of fun_ofdm_tpu/utils/bits.py: one bit per int32 element.
"""

from __future__ import annotations

import torch


def _shifts(device) -> torch.Tensor:
    return torch.arange(7, -1, -1, dtype=torch.int32, device=device)


def bytes_to_bits(data: torch.Tensor) -> torch.Tensor:
    """(..., n) bytes -> (..., 8n) int32 bits, MSB first."""
    data = data.to(torch.int32)
    bits = (data[..., :, None] >> _shifts(data.device)) & 1
    return bits.reshape(*data.shape[:-1], data.shape[-1] * 8)


def bits_to_bytes(bits: torch.Tensor) -> torch.Tensor:
    """(..., 8n) bits -> (..., n) int32 bytes, MSB first."""
    bits = bits.to(torch.int32)
    n = bits.shape[-1] // 8
    grouped = bits[..., : n * 8].reshape(*bits.shape[:-1], n, 8)
    return (grouped << _shifts(bits.device)).sum(-1, dtype=torch.int32)
