"""Soft-decision Viterbi decoder, K=7 rate-1/2, polys {121, 91}.

Counterpart of fun_ofdm_tpu/ops/viterbi.py. `viterbi_decode` is the
dispatcher: a tensor on the CPU goes to the plain twin below, a CUDA
tensor to the hand-written kernel (ops/viterbi_cuda.py,
csrc/viterbi.cu), at every size, the 18-bit SIGNAL header included; the
block-overlap decode is ops/viterbi_blocked.py.

The twin is `viterbi_decode_scan`'s arithmetic, exactly (reference:
src/viterbi.cpp:71-459):
  * 64 path metrics with u8 semantics carried in int32: init 63 with
    state 0 at 0 (or all 63, the "uniform" init of a trellis entered
    mid-stream); adds saturate at 255; when new state 0's metric exceeds
    210 the all-state minimum is subtracted;
  * branch metric for soft pair (s0, s1) against expected bits (e0, e1):
    t = ((s0 ^ E0) + (s1 ^ E1) + 1) >> 3, Ek = 255 if ek else 0;
  * butterfly j pairs old states (j, j+32) -> new (2j, 2j+1):
      new[2j]   = min(old[j] + t_j,      old[j+32] + (63 - t_j))
      new[2j+1] = min(old[j] + (63-t_j), old[j+32] + t_j)
    decision bit = 1 iff the j+32 path wins, ties -> 1;
  * the step count is truncated to even (the reference drops a final
    odd step); a frame with fewer steps (`nbits_dynamic`) records zero
    decisions past its end;
  * chainback from state 0 at the last step; bit n is the decision read
    at step n + 6.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

K = 7
NUMSTATES = 64
POLYS = (121, 91)


def _parity(x: int) -> int:
    return bin(x).count("1") & 1


@functools.lru_cache(maxsize=None)
def _branch_bits() -> tuple[np.ndarray, np.ndarray]:
    """(bt0, bt1): expected coded bits of butterfly j's j -> 2j branch,
    parity((2j) & poly) (reference: viterbi.cpp:87-91)."""
    bt0 = np.array([_parity((2 * j) & POLYS[0]) for j in range(32)], np.int32)
    bt1 = np.array([_parity((2 * j) & POLYS[1]) for j in range(32)], np.int32)
    return bt0, bt1


def _branch_metrics(s0: torch.Tensor, s1: torch.Tensor) -> torch.Tensor:
    """(...,) soft pairs -> (..., 32) branch metrics t_j in 0..63."""
    bt0, bt1 = (torch.from_numpy(b).to(s0.device).bool()
                for b in _branch_bits())
    a = torch.where(bt0, 255 - s0[..., None], s0[..., None])
    b = torch.where(bt1, 255 - s1[..., None], s1[..., None])
    return (a + b + 1) >> 3


def _acs_step(metrics: torch.Tensor, t: torch.Tensor):
    """One trellis step: (..., 64) metrics, (..., 32) branch metrics ->
    (new metrics, (..., 64) int32 decisions), states in natural order."""
    tc = 63 - t
    lo, hi = metrics[..., :32], metrics[..., 32:]
    m_even_lo = torch.clamp_max(lo + t, 255)
    m_even_hi = torch.clamp_max(hi + tc, 255)
    m_odd_lo = torch.clamp_max(lo + tc, 255)
    m_odd_hi = torch.clamp_max(hi + t, 255)
    new = torch.stack([torch.minimum(m_even_lo, m_even_hi),
                       torch.minimum(m_odd_lo, m_odd_hi)], dim=-1)
    dec = torch.stack([m_even_hi <= m_even_lo, m_odd_hi <= m_odd_lo], dim=-1)
    new = new.reshape(metrics.shape)
    need = new[..., :1] > 210
    new = torch.where(need, new - new.amin(-1, keepdim=True), new)
    return new, dec.reshape(metrics.shape).to(torch.int32)


def _acs_step_early(metrics: torch.Tensor, off: torch.Tensor,
                    t: torch.Tensor):
    """_acs_step as the CUDA ACS kernel computes it, on metrics in offset
    form: (..., 64) metrics + off, off (..., 1) the renormalisations not
    yet subtracted. Returns (new metrics + new off, new off, decisions).

    The renormalisation's minimum and trigger come from the old metrics:
    every new metric is the smaller of two saturated candidates and each
    old state x feeds two, so min over the new metrics = min(min over x of
    m_x + min(t_j, 63 - t_j), 255), j = x mod 32 its butterfly; new state
    0 is min(m_0 + t_0, m_32 + 63 - t_0), saturated (which cannot change
    its comparison with 210). The subtraction is deferred: the offset
    rises to the new minimum, the saturation is at 255 + off, and the
    decisions, comparisons of two metrics, do not see the offset. Holds
    the same decisions as _acs_step, and metrics - off equal to its.
    """
    lo, hi = metrics[..., :32], metrics[..., 32:]
    cap = 255 + off
    low = torch.minimum((torch.minimum(lo, hi) + torch.minimum(t, 63 - t))
                        .amin(-1, keepdim=True), cap)
    need = torch.minimum(lo[..., :1] + t[..., :1],
                         hi[..., :1] + 63 - t[..., :1]) - off > 210
    c_lo_even = torch.minimum(lo + t, cap)
    c_hi_even = torch.minimum(hi + 63 - t, cap)
    c_lo_odd = torch.minimum(lo + 63 - t, cap)
    c_hi_odd = torch.minimum(hi + t, cap)
    new = torch.stack([torch.minimum(c_lo_even, c_hi_even),
                       torch.minimum(c_lo_odd, c_hi_odd)], dim=-1)
    dec = torch.stack([c_hi_even <= c_lo_even, c_hi_odd <= c_lo_odd], dim=-1)
    return (new.reshape(metrics.shape), torch.where(need, low, off),
            dec.reshape(metrics.shape).to(torch.int32))


def step_counts(nbits: int, nbits_dynamic, batch_shape, device):
    """Per-frame even trellis step counts, (*batch_shape,) int32."""
    steps = ((nbits + K - 1) // 2) * 2
    if nbits_dynamic is None:
        return torch.full(batch_shape, steps, dtype=torch.int32,
                          device=device)
    nb = torch.as_tensor(nbits_dynamic, device=device).to(torch.int32)
    nb = torch.broadcast_to(nb, batch_shape)
    return torch.clamp(((nb + K - 1) // 2) * 2, 0, steps).to(torch.int32)


def acs_plain(soft: torch.Tensor, steps: torch.Tensor,
              init: torch.Tensor) -> torch.Tensor:
    """Forward ACS, the plain version of the CUDA ACS kernel.

    soft: (B, 2T) int32 soft pairs; steps: (B,) int32 even step counts
    <= T; init: (B,) int32, 1 = exact init, 0 = uniform.
    Returns (T, B, 64) uint8 decisions, zero at steps >= a frame's count.
    """
    bsz, total = soft.shape[0], soft.shape[-1] // 2
    smax = int(steps.max()) if bsz else 0
    pairs = soft[:, : 2 * smax].to(torch.int32).reshape(bsz, smax, 2)
    t_all = _branch_metrics(pairs[..., 0].T, pairs[..., 1].T)  # (S, B, 32)
    metrics = torch.full((bsz, NUMSTATES), 63, dtype=torch.int32,
                         device=soft.device)
    metrics[:, 0] = torch.where(init == 1, 0, 63)
    dec = torch.zeros((total, bsz, NUMSTATES), dtype=torch.uint8,
                      device=soft.device)
    for i in range(smax):
        new, d = _acs_step(metrics, t_all[i])
        live = (i < steps)[:, None]
        metrics = torch.where(live, new, metrics)
        dec[i] = (d * live).to(torch.uint8)
    return dec


def acs_early_plain(soft: torch.Tensor, steps: torch.Tensor,
                    init: torch.Tensor) -> torch.Tensor:
    """acs_plain through _acs_step_early, the CUDA ACS kernel's algebra;
    same arguments and result."""
    bsz, total = soft.shape[0], soft.shape[-1] // 2
    smax = int(steps.max()) if bsz else 0
    pairs = soft[:, : 2 * smax].to(torch.int32).reshape(bsz, smax, 2)
    t_all = _branch_metrics(pairs[..., 0].T, pairs[..., 1].T)  # (S, B, 32)
    metrics = torch.full((bsz, NUMSTATES), 63, dtype=torch.int32,
                         device=soft.device)
    metrics[:, 0] = torch.where(init == 1, 0, 63)
    off = torch.zeros((bsz, 1), dtype=torch.int32, device=soft.device)
    dec = torch.zeros((total, bsz, NUMSTATES), dtype=torch.uint8,
                      device=soft.device)
    for i in range(smax):
        new, new_off, d = _acs_step_early(metrics, off, t_all[i])
        live = (i < steps)[:, None]
        metrics = torch.where(live, new, metrics)
        off = torch.where(live, new_off, off)
        dec[i] = (d * live).to(torch.uint8)
    return dec


def chainback_plain(dec: torch.Tensor, nbits: int) -> torch.Tensor:
    """Survivor chainback, the plain version of the CUDA chainback kernel.

    dec: (T, B, 64) decisions with T = nbits + 6. Walks from state 0 at
    step T-1; returns (B, nbits) int32, bit n read at step n + 6.
    """
    total, bsz = dec.shape[0], dec.shape[1]
    state = torch.zeros((bsz, 1), dtype=torch.int64, device=dec.device)
    out = torch.zeros((total, bsz), dtype=torch.int32, device=dec.device)
    for t in range(total - 1, K - 2, -1):
        bit = dec[t].gather(1, state).to(torch.int64)
        out[t] = bit[:, 0]
        state = (state >> 1) | (bit << 5)
    return out[K - 1: K - 1 + nbits].T.contiguous()


def chainback_segmented_plain(dec: torch.Tensor, nbits: int,
                              seg: int) -> torch.Tensor:
    """chainback_plain as the CUDA chainback computes it, in segments.

    dec: (T, B, 64) decisions with T = nbits + 6; seg >= 1 steps a
    segment. The walk over steps T-1 .. 6 is cut into segments
    [6 + k seg, min(6 + (k+1) seg, T)); every segment but the oldest gets
    its map F_k (the state at its first step - 1 from each of the 64
    states at its last step), the maps composed newest first from state 0
    give each segment's start state, and each segment walks once more from
    it, writing its bits. Same result as chainback_plain.
    """
    total, bsz = dec.shape[0], dec.shape[1]
    n_seg = -(-nbits // seg)
    out = torch.zeros((bsz, nbits), dtype=torch.int32, device=dec.device)
    bounds = [(K - 1 + k * seg, min(K - 1 + (k + 1) * seg, total))
              for k in range(n_seg)]

    def walk(state, lo, hi, bits=None):
        for t in range(hi - 1, lo - 1, -1):
            bit = dec[t].gather(1, state).to(torch.int64)
            if bits is not None:
                bits[:, t - (K - 1)] = bit[:, 0]
            state = (state >> 1) | (bit << 5)
        return state

    all_states = torch.arange(NUMSTATES, device=dec.device).expand(bsz, -1)
    maps = [None] + [walk(all_states, lo, hi) for lo, hi in bounds[1:]]
    starts = [None] * n_seg
    state = torch.zeros((bsz, 1), dtype=torch.int64, device=dec.device)
    for k in range(n_seg - 1, -1, -1):
        starts[k] = state
        if k:
            state = maps[k].gather(1, state)
    for k, (lo, hi) in enumerate(bounds):
        walk(starts[k], lo, hi, out)
    return out


def decode_plain(soft: torch.Tensor, steps: torch.Tensor,
                 init: torch.Tensor, nbits: int) -> torch.Tensor:
    """(B, 2*(nbits+6)) soft -> (B, nbits) bits; the twin of
    viterbi_cuda.decode on the same arguments."""
    return chainback_plain(acs_plain(soft, steps, init), nbits)


def viterbi_decode_scan(soft: torch.Tensor, nbits: int,
                        nbits_dynamic=None) -> torch.Tensor:
    """The plain twin of fun_ofdm_tpu's viterbi_decode_scan.

    soft: (..., 2*(nbits+6)) soft coded bits (0..255). Returns
    (..., nbits) int32 bits.
    """
    batch_shape = soft.shape[:-1]
    flat = soft.reshape(-1, soft.shape[-1]).to(torch.int32)
    steps = step_counts(nbits, nbits_dynamic, batch_shape,
                        soft.device).reshape(-1)
    init = torch.ones_like(steps)
    return decode_plain(flat, steps, init, nbits).reshape(
        *batch_shape, nbits)


#: the dispatcher's names for the exact decode and for the block-overlap
#: decode (fun_ofdm_tpu's names, so a caller's setting carries across)
EXACT_IMPLS = (None, "auto", "exact", "scan", "pallas")
BLOCKED_IMPL = "pallas-blocked"

#: below this many data bits the blocked request decodes exactly, as in
#: fun_ofdm_tpu (a header is never split into blocks)
BLOCKED_MIN_NBITS = 64


def viterbi_decode(soft: torch.Tensor, nbits: int, impl: str | None = None,
                   nbits_dynamic=None, return_exact: bool = False):
    """Decode (..., 2*(nbits+6)) soft bits to (..., nbits) int32 bits.

    Counterpart of fun_ofdm_tpu's dispatcher. impl: None, "auto",
    "exact", "scan" and "pallas" all select the exact decode: on a CUDA
    tensor the kernels (one launch pair for the whole flattened batch),
    on a CPU tensor the plain twin. "pallas-blocked" selects the
    block-overlap decode (ops/viterbi_blocked) for trellises of at least
    BLOCKED_MIN_NBITS bits: its kernels on a CUDA tensor; on a CPU tensor
    the exact twin with an all-True flag, as fun_ofdm_tpu does off the
    TPU. Unlike fun_ofdm_tpu, the port reads no FUN_OFDM_VITERBI
    variable: the caller's `impl` alone decides.
    nbits_dynamic: optional (...,) per-frame data-bit counts <= nbits;
    steps past a frame's count record zero decisions, and its bits past
    the count are unspecified.
    return_exact: also return a (...,) bool flag, True where the result
    is exact (always for the exact decode; the merge guard's verdict for
    the block-overlap decode).
    """
    if impl not in EXACT_IMPLS and impl != BLOCKED_IMPL:
        raise ValueError(f"unknown Viterbi impl {impl!r}")
    if soft.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no Viterbi for device {soft.device}")
    batch_shape = soft.shape[:-1]
    if (impl == BLOCKED_IMPL and nbits >= BLOCKED_MIN_NBITS
            and soft.device.type == "cuda"):
        from . import viterbi_blocked

        return viterbi_blocked.viterbi_decode_blocked(
            soft, nbits, nbits_dynamic=nbits_dynamic,
            return_merge_ok=return_exact)
    if soft.device.type == "cpu":
        bits = viterbi_decode_scan(soft, nbits, nbits_dynamic)
    else:
        from . import viterbi_cuda

        flat = soft.reshape(-1, soft.shape[-1]).to(torch.int32).contiguous()
        steps = step_counts(nbits, nbits_dynamic, batch_shape,
                            soft.device).reshape(-1).contiguous()
        bits = viterbi_cuda.decode(flat, steps, torch.ones_like(steps),
                                   nbits).reshape(*batch_shape, nbits)
    if return_exact:
        return bits, torch.ones(batch_shape, dtype=torch.bool,
                                device=soft.device)
    return bits
