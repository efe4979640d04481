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


@functools.lru_cache(maxsize=None)
def _init_contrib_table(n_max: int) -> np.ndarray:
    """(n_max + 1,) int64: L^(8n)(0xFFFFFFFF) for n = 0..n_max."""
    out = np.zeros(n_max + 1, np.uint32)
    cur = np.array([_MASK], np.uint32)
    for n in range(n_max + 1):
        out[n] = cur[0]
        cur = _shift_zero_byte(cur)
    return out.astype(np.int64)


def crc32_dynamic(data: torch.Tensor, n_valid) -> torch.Tensor:
    """CRC-32 of the first n_valid bytes of each row.

    Counterpart of fun_ofdm_tpu's crc32_dynamic. data: (..., n_max)
    bytes; n_valid: (...,) lengths <= n_max. Each message is right-aligned
    into the row (leading zero bytes leave a zero state at zero, so the
    per-position table of `crc32` applies unchanged) and the
    length-dependent initial-state contribution comes from a table.
    Returns (...,) int64 in [0, 2^32).
    """
    n_max = data.shape[-1]
    dev = data.device
    n_valid = torch.broadcast_to(
        torch.as_tensor(n_valid, device=dev).to(torch.int64), data.shape[:-1])
    src = torch.arange(n_max, device=dev) - (n_max - n_valid)[..., None]
    shifted = torch.gather(data.to(torch.int64), -1, src.clamp(0, n_max - 1))
    shifted = torch.where(src >= 0, shifted, 0)
    vals = _device_table(n_max, dev)[torch.arange(n_max, device=dev), shifted]
    width = 1 << max(n_max - 1, 0).bit_length()
    vals = torch.nn.functional.pad(vals, (0, width - n_max))
    while width > 1:
        width //= 2
        vals = vals[..., :width] ^ vals[..., width:]
    init = torch.from_numpy(_init_contrib_table(n_max)).to(dev)[n_valid]
    return vals[..., 0] ^ init ^ _MASK
