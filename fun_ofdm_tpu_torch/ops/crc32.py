"""IEEE CRC-32 (zlib-compatible), batched over frames.

Counterpart of fun_ofdm_tpu/ops/crc32.py `crc32` (reference:
src/ppdu.cpp:134-137, boost::crc_32_type). The byte update
s' = T[(s ^ b) & 0xFF] ^ (s >> 8) is linear over GF(2), so the checksum
of n bytes is the XOR, over positions j, of a per-position table entry
L^(n-1-j)(T[b_j]) (L = one zero-byte shift), XORed with the initial
state's contribution L^n(0xFFFFFFFF). One gather into an (n, 256) table
and a log2(n)-deep XOR tree replace the byte-serial loop.

torch has almost no uint32 arithmetic, so the CRC is carried in int64
and stays within the low 32 bits.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_POLY = 0xEDB88320  # reflected 0x04C11DB7
_MASK = 0xFFFFFFFF


@functools.lru_cache(maxsize=None)
def _byte_table() -> np.ndarray:
    """(256,) uint32: T[b], the CRC of byte b from a zero state."""
    t = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        t = (t >> np.uint32(1)) ^ (np.uint32(_POLY) * (t & np.uint32(1)))
    return t


def _shift_zero_byte(s: np.ndarray) -> np.ndarray:
    """L(s): the state after feeding one zero byte."""
    return _byte_table()[s & np.uint32(0xFF)] ^ (s >> np.uint32(8))


@functools.lru_cache(maxsize=None)
def _position_tables(n: int) -> tuple[np.ndarray, int]:
    """((n, 256) int64 table L^(n-1-j)(T[b]), init contribution)."""
    tab = np.zeros((n, 256), np.uint32)
    cur = _byte_table().copy()
    for j in range(n - 1, -1, -1):
        tab[j] = cur
        cur = _shift_zero_byte(cur)
    init = np.array([_MASK], np.uint32)
    for _ in range(n):
        init = _shift_zero_byte(init)
    return tab.astype(np.int64), int(init[0])


@functools.lru_cache(maxsize=8)
def _device_table(n: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_position_tables(n)[0]).to(device)


def crc32(data: torch.Tensor) -> torch.Tensor:
    """(..., n) bytes -> (...,) int64 CRC-32 in [0, 2^32)."""
    n = data.shape[-1]
    tab = _device_table(n, data.device)
    pos = torch.arange(n, device=data.device)
    vals = tab[pos, data.to(torch.int64)]                    # (..., n)
    width = 1 << max(n - 1, 0).bit_length()
    vals = torch.nn.functional.pad(vals, (0, width - n))
    while width > 1:
        width //= 2
        vals = vals[..., :width] ^ vals[..., width:]
    init = _position_tables(n)[1]
    return vals[..., 0] ^ (init ^ _MASK)
