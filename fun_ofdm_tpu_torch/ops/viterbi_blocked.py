"""Block-overlap (time-parallel) Viterbi decode and its plain version.

Counterpart of fun_ofdm_tpu/ops/viterbi_pallas.py
`viterbi_decode_pallas_blocked` (`_blocked_decode_impl`). A frame's
trellis of T = nbits + 6 steps is cut into n_blocks spans of tb steps;
block b decodes the window of win = wf + tb + wc steps that starts at
step max(0, b*tb - wf): a wf-step lead-in from uniform metrics (exact
init for block 0), its span, and a wc-step tail whose truncated
chainback merges into the true survivor. Output bit n is taken from
block n // tb. Around every cut the region [b*tb - wf, b*tb + wc) is
decoded by both neighbours; the merge guard compares the two, trimmed by
min(40, (wf + wc) / 4) bits at each end and masked to the frame's live
bits, and clears the frame's flag on any mismatch. A flagged frame must
be re-decoded exactly (the streaming chain does).

A CPU tensor runs the plain version below (windows by torch indexing,
ops/viterbi's plain ACS and chainback, then the splice and the guard);
a CUDA tensor the kernels of csrc/viterbi.cu (ops/viterbi_cuda:
acs_windowed, chainback, splice_guard). The TPU layout of the JAX
function (128-lane padding, TIME_CHUNK padding, the gathered window
stack) is not part of the result and is not reproduced.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from . import viterbi

K = viterbi.K
#: merge-guard bits excluded at each end of a cut's overlap
GUARD_TRIM = 40


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclass(frozen=True)
class Geometry:
    """The block layout of one (nbits, n_blocks, warmup) decode."""

    nbits: int
    n_blocks: int
    #: block span, lead-in and tail (trellis steps, all even)
    tb: int
    wf: int
    wc: int

    @property
    def win(self) -> int:
        """Trellis steps each window decodes (and bits it emits)."""
        return self.wf + self.tb + self.wc

    @property
    def ov(self) -> int:
        """Width of each cut's doubly decoded region."""
        return self.wf + self.wc

    @property
    def trim(self) -> int:
        return min(GUARD_TRIM, self.ov // 4)

    @property
    def offs(self) -> np.ndarray:
        """(n_blocks,) int32 first trellis step of each window."""
        return np.maximum(0, np.arange(self.n_blocks) * self.tb
                          - self.wf).astype(np.int32)

    def splice_index(self) -> tuple[np.ndarray, np.ndarray]:
        """(block, window index) of each output bit, (nbits,) int32 each."""
        n = np.arange(self.nbits)
        b = (n // self.tb).astype(np.int32)
        m = (n - b * self.tb + np.where(b > 0, self.wf, 0)).astype(np.int32)
        return b, m


@functools.lru_cache(maxsize=None)
def geometry(nbits: int, n_blocks: int = 16, warmup: int = 128) -> Geometry:
    """The layout `viterbi_decode_pallas_blocked` uses, with its clamp
    n_blocks = max(1, min(n_blocks, T // (2 * warmup)))."""
    total = nbits + K - 1
    n_blocks = max(1, min(n_blocks, total // max(2 * warmup, 2)))
    wf = _cdiv(warmup, 2) * 2
    return Geometry(nbits=nbits, n_blocks=n_blocks,
                    tb=_cdiv(total, 2 * n_blocks) * 2, wf=wf, wc=wf)


def window_steps(steps: torch.Tensor, geo: Geometry) -> torch.Tensor:
    """(F,) frame step counts -> (F * n_blocks,) window step counts."""
    offs = torch.from_numpy(geo.offs).to(steps.device)
    return torch.clamp(steps[:, None] - offs, 0, geo.win).reshape(-1).to(
        torch.int32)


def acs_windowed_plain(soft: torch.Tensor, steps: torch.Tensor,
                       geo: Geometry) -> torch.Tensor:
    """The plain version of the windowed ACS kernel.

    soft: (F, 2T) int32; steps: (F,) int32 even step counts <= T.
    Returns (win + 6, F * n_blocks, 64) uint8 decisions; lane
    f * n_blocks + b is window b of frame f.
    """
    frames = soft.shape[0]
    offs = torch.from_numpy(geo.offs).to(soft.device, torch.int64)
    padded = torch.nn.functional.pad(soft.to(torch.int32), (0, 2 * geo.win))
    idx = 2 * offs[:, None] + torch.arange(2 * geo.win, device=soft.device)
    lanes = padded[:, idx].reshape(frames * geo.n_blocks, 2 * geo.win)
    lanes = torch.nn.functional.pad(lanes, (0, 2 * (K - 1)))
    init = (torch.arange(geo.n_blocks, device=soft.device) == 0).to(
        torch.int32).repeat(frames)
    return viterbi.acs_plain(lanes, window_steps(steps, geo), init)


def splice_guard_plain(win_bits: torch.Tensor, steps: torch.Tensor,
                       geo: Geometry):
    """The plain version of the splice + merge-guard kernel.

    win_bits: (F * n_blocks, win) bits of every window; steps: (F,) frame
    step counts. Returns ((F, nbits) int32 bits, (F,) bool merge flags).
    """
    frames = steps.shape[0]
    wb = win_bits.reshape(frames, geo.n_blocks, geo.win)
    b_idx, m_idx = (torch.from_numpy(a).to(win_bits.device, torch.int64)
                    for a in geo.splice_index())
    bits = wb[:, b_idx, m_idx].to(torch.int32)
    offs = geo.offs
    live_hi = torch.clamp(steps.to(torch.int64) - (K - 1), min=0).clamp(
        max=geo.nbits)[:, None]
    sl = slice(geo.trim, geo.ov - geo.trim)
    mism = torch.zeros(frames, dtype=torch.bool, device=win_bits.device)
    for b in range(1, geo.n_blocks):
        lo = b * geo.tb - geo.wf
        prev_start = lo - int(offs[b - 1])
        prev = wb[:, b - 1, prev_start:prev_start + geo.ov][:, sl]
        cur = wb[:, b, :geo.ov][:, sl]
        pos = lo + torch.arange(geo.ov, device=win_bits.device)[sl]
        mism |= ((prev != cur) & (pos[None, :] < live_hi)).any(-1)
    return bits, ~mism


def decode_plain(soft: torch.Tensor, steps: torch.Tensor, geo: Geometry):
    """(F, 2T) soft, (F,) steps -> ((F, nbits) bits, (F,) merge flags)."""
    win_bits = viterbi.chainback_plain(acs_windowed_plain(soft, steps, geo),
                                       geo.win)
    return splice_guard_plain(win_bits, steps, geo)


def decode_cuda(soft: torch.Tensor, steps: torch.Tensor, geo: Geometry):
    """The same decode through the kernels: one launch each of the
    windowed ACS, the chainback and the splice + guard."""
    from . import viterbi_cuda

    dec = viterbi_cuda.acs_windowed(soft, steps, geo.n_blocks, geo.tb,
                                    geo.wf, geo.win)
    win_bits = viterbi_cuda.chainback(dec, geo.win)     # (B, win) view
    return viterbi_cuda.splice_guard(win_bits.T, steps, geo.nbits,
                                     geo.n_blocks, geo.tb, geo.wf, geo.ov,
                                     geo.trim)


def viterbi_decode_blocked(soft: torch.Tensor, nbits: int,
                           n_blocks: int = 16, warmup: int = 128,
                           nbits_dynamic=None,
                           return_merge_ok: bool = False):
    """Block-overlap decode of (..., 2*(nbits+6)) soft bits.

    Same contract as fun_ofdm_tpu's viterbi_decode_pallas_blocked:
    returns (..., nbits) int32 bits, and with return_merge_ok=True also
    the (...,) bool merge flags. A CPU tensor runs the plain version, a
    CUDA tensor the kernels.
    """
    batch_shape = soft.shape[:-1]
    flat = soft.reshape(-1, soft.shape[-1]).to(torch.int32).contiguous()
    steps = viterbi.step_counts(nbits, nbits_dynamic, batch_shape,
                                soft.device).reshape(-1).contiguous()
    geo = geometry(nbits, n_blocks, warmup)
    if soft.device.type == "cpu":
        bits, ok = decode_plain(flat, steps, geo)
    elif soft.device.type == "cuda":
        bits, ok = decode_cuda(flat, steps, geo)
    else:
        raise ValueError(f"no Viterbi for device {soft.device}")
    bits = bits.reshape(*batch_shape, nbits)
    if return_merge_ok:
        return bits, ok.reshape(batch_shape)
    return bits
