"""The ACS ablation variants' plain version.

Counterpart of the step bodies of tools/viterbi_acs_ab.py (`make_kernel`),
which on the TPU were timing-only kernels with pieces of the ACS step
removed. On the card each variant is a defined function
(csrc/viterbi.cu, `acs_ablate_kernel<Mode>`, bound as
ops/viterbi_cuda.acs_ablate); `acs_ablate_plain` is the same recurrence,
step by step on (B, 64) int32 tensors, with the same outputs. The tests
hold the kernel to it and it to the JAX step bodies; no GPU path calls it.

The kernel's lane layout is kept: lane l (0..31) holds the metrics at
index l ("lo") and 32 + l ("hi"). For every mode except "noshuffle" that
is the natural state order; "noshuffle" feeds each lane its own two
metrics instead of those of butterflies l >> 1 and 16 + (l >> 1), so its
metrics follow the lanes, not the trellis.
"""

from __future__ import annotations

import torch

from .viterbi import _branch_metrics
from .viterbi_cuda import ABLATE_MODES as MODES  # the kernel's AcsMode order


def _pack_words(d: torch.Tensor) -> torch.Tensor:
    """(B, 64) bool decisions -> (B,) int64 words, bit s = d[:, s]."""
    w = d.to(torch.int64) << torch.arange(32, device=d.device).repeat(2)
    return w[:, :32].sum(-1) | (w[:, 32:].sum(-1) << 32)


def _step(m: torch.Tensor, s0: torch.Tensor, s1: torch.Tensor, mode: str):
    """One step of mode on (B, 64) lane-layout metrics; s0, s1: (B,).
    Returns (new metrics, (B, 64) bool decisions)."""
    if mode == "minimal":
        new = torch.clamp_max(m + s0[:, None], 255)
        return new, new <= 128
    lane = torch.arange(32, device=m.device)
    odd = (lane & 1).bool()
    j_lo, j_hi = lane >> 1, 16 + (lane >> 1)
    t = _branch_metrics(s0, s1)                       # (B, 32) by butterfly
    t_a, t_b = t[:, j_lo], t[:, j_hi]
    m_lo, m_hi = m[:, :32], m[:, 32:]
    if mode == "noshuffle":
        lo_a = lo_b = m_lo
        hi_a = hi_b = m_hi
    else:
        lo_a, hi_a = m_lo[:, j_lo], m_hi[:, j_lo]
        lo_b, hi_b = m_lo[:, j_hi], m_hi[:, j_hi]
    c_lo_a = torch.clamp_max(lo_a + torch.where(odd, 63 - t_a, t_a), 255)
    c_hi_a = torch.clamp_max(hi_a + torch.where(odd, t_a, 63 - t_a), 255)
    c_lo_b = torch.clamp_max(lo_b + torch.where(odd, 63 - t_b, t_b), 255)
    c_hi_b = torch.clamp_max(hi_b + torch.where(odd, t_b, 63 - t_b), 255)
    d_a, d_b = c_hi_a <= c_lo_a, c_hi_b <= c_lo_b
    new = torch.cat([torch.where(d_a, c_hi_a, c_lo_a),
                     torch.where(d_b, c_hi_b, c_lo_b)], dim=-1)
    if mode != "norenorm":
        need = new[:, :1] > 210
        new = torch.where(need, new - new.amin(-1, keepdim=True), new)
    return new, torch.cat([d_a, d_b], dim=-1)


def acs_ablate_plain(soft: torch.Tensor, steps: torch.Tensor,
                     init: torch.Tensor, mode: str):
    """The plain version of viterbi_cuda.acs_ablate.

    soft: (B, 2T) int32 soft pairs; steps: (B,) int32 step counts <= T;
    init: (B,) int32, 1 = exact init (index 0 at 0, the rest 63), 0 =
    uniform. Each frame runs steps[b] steps of `mode`. Returns (final
    metrics (B, 64) int32; decision words (T, B) int64, zero at steps >=
    a frame's count, or None for "nostore").
    """
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    bsz, total = soft.shape[0], soft.shape[-1] // 2
    steps = torch.clamp(steps.to(torch.int64), 0, total)
    smax = int(steps.max()) if bsz else 0
    pairs = soft[:, :2 * smax].to(torch.int32).reshape(bsz, smax, 2)
    m = torch.full((bsz, 64), 63, dtype=torch.int32, device=soft.device)
    m[:, 0] = torch.where(init == 1, 0, 63)
    words = torch.zeros((total, bsz), dtype=torch.int64, device=soft.device)
    for i in range(smax):
        new, d = _step(m, pairs[:, i, 0], pairs[:, i, 1], mode)
        live = i < steps
        m = torch.where(live[:, None], new, m)
        words[i] = torch.where(live, _pack_words(d), 0)
    return m, (None if mode == "nostore" else words)
