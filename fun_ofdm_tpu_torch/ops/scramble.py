"""The reference's byte-granular scrambler (x^7+x^4+1, seed 93).

Counterpart of fun_ofdm_tpu/ops/scramble.py: the LFSR advances once per
byte and its feedback bit is XORed into the byte's LSB
(reference: src/ppdu.cpp:140-148), so scrambling is an XOR with a fixed
127-periodic keystream. Self-inverse.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

SEED = 93


@functools.lru_cache(maxsize=None)
def _keystream_period() -> np.ndarray:
    """One 127-byte period of per-byte feedback bits from seed 93."""
    state = SEED
    out = np.zeros(127, dtype=np.int32)
    for i in range(127):
        feedback = ((state >> 6) & 1) ^ ((state >> 3) & 1)
        out[i] = feedback
        state = ((state << 1) & 0x7E) | feedback
    return out


def keystream(n: int) -> np.ndarray:
    """First n per-byte feedback bits (numpy)."""
    return np.resize(_keystream_period(), n)


def scramble_bytes(data: torch.Tensor) -> torch.Tensor:
    """XOR the keystream bit into the LSB of each byte of (..., n)."""
    ks = torch.from_numpy(keystream(data.shape[-1])).to(data.device)
    return data.to(torch.int32) ^ ks


descramble_bytes = scramble_bytes  # self-inverse
