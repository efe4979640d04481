"""The reference's fixed 48-bit interleaver.

Counterpart of fun_ofdm_tpu/ops/interleave.py: the reference always
applies one 48-element permutation in 48-bit chunks, at every rate
(src/interleaver.cpp:18,31): perm[k] = 3*(k % 16) + k // 16 and
out[perm[k]] = in[k].
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import tables

CHUNK = 48

#: PERM[k] = output position of input bit k within a 48-bit chunk
PERM: np.ndarray = (3 * (np.arange(CHUNK) % 16)
                    + np.arange(CHUNK) // 16).astype(np.int32)
#: inverse permutation: out[k] = in[INV_PERM[k]]
INV_PERM: np.ndarray = np.argsort(PERM).astype(np.int32)


@tables.on_device()
def index_on(inverse: bool, device: torch.device) -> torch.Tensor:
    """INV_PERM (inverse=True) or PERM as an int64 tensor on device."""
    return torch.from_numpy(INV_PERM if inverse else PERM).to(device,
                                                             torch.int64)


def _permute(x: torch.Tensor, inverse: bool) -> torch.Tensor:
    chunks = x.reshape(*x.shape[:-1], -1, CHUNK)
    return chunks[..., index_on(inverse, x.device)].reshape(x.shape)


def interleave(bits: torch.Tensor) -> torch.Tensor:
    """(..., n) -> (..., n), n a multiple of 48: out[perm[k]] = in[k]."""
    return _permute(bits, True)


def deinterleave(bits: torch.Tensor) -> torch.Tensor:
    """Inverse of interleave: out[k] = in[perm[k]]."""
    return _permute(bits, False)
