"""Puncturing and depuncturing for coding rates 2/3 and 3/4.

Counterpart of fun_ofdm_tpu/ops/puncture.py, with the reference's
patterns (src/puncturer.cpp:24-123): rate 3/4 keeps {0, 1, 3, 5} of every
6 coded bits, rate 2/3 keeps {0, 2, 3} of every 4. Depuncturing fills the
holes with the soft erasure 127 (src/puncturer.cpp:98-117).
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from ..rates import Rate, params_for
from ..utils import tables

ERASURE = 127

_KEEP = {  # group size -> kept indices
    6: np.array([0, 1, 3, 5]),  # rate-3/4 code
    4: np.array([0, 2, 3]),     # rate-2/3 code
}


def _pattern(rate: Rate) -> tuple[int, np.ndarray] | None:
    """(group_size, kept_indices), or None for rate 1/2."""
    rel = params_for(rate).rel_rate
    if rel == Fraction(1):
        return None
    if rel == Fraction(2, 3):  # rate-3/4 code
        return 6, _KEEP[6]
    if rel == Fraction(3, 4):  # rate-2/3 code
        return 4, _KEEP[4]
    raise ValueError(f"unsupported rel_rate {rel}")


@tables.on_device()
def keep_on(group: int, device: torch.device) -> torch.Tensor:
    """The kept indices of a group of `group` coded bits, int64 on device."""
    return torch.from_numpy(_KEEP[group]).to(device, torch.int64)


def puncture(coded: torch.Tensor, rate: Rate) -> torch.Tensor:
    """(..., n) coded bits -> punctured bits (n a multiple of the group)."""
    pat = _pattern(rate)
    if pat is None:
        return coded
    group, _ = pat
    n = coded.shape[-1]
    groups = coded[..., : n - n % group].reshape(*coded.shape[:-1], -1, group)
    return groups[..., keep_on(group, coded.device)].reshape(
        *coded.shape[:-1], -1)


def depuncture(soft: torch.Tensor, rate: Rate) -> torch.Tensor:
    """(..., m) soft bits -> (..., n) with ERASURE in the holes."""
    pat = _pattern(rate)
    if pat is None:
        return soft
    group, keep = pat
    m = soft.shape[-1]
    groups = soft[..., : m - m % len(keep)].reshape(
        *soft.shape[:-1], -1, len(keep))
    out = torch.full(groups.shape[:-1] + (group,), ERASURE,
                     dtype=soft.dtype, device=soft.device)
    out[..., keep_on(group, soft.device)] = groups
    return out.reshape(*soft.shape[:-1], -1)
