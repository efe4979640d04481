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
a CUDA tensor the two kernels of csrc/viterbi.cu through one call of
ops/viterbi_cuda.blocked_decode: a warp per window runs the ACS with its
decisions in shared memory, traces the window back on chip in 32-step
segments (each walked from state 0, then corrected from its true entry,
the exit of the segment above, until the paths meet), and writes its span
of the output and the packed words of its overlap regions; a warp per
frame compares those words, trimmed and masked to the live bits. What
bounds it is the serial step chain of one window (~1,012 steps at the
capture's geometry). The kernels' own algebra has plain forms here too
(window_words_plain, span_write_plain, pack_overlaps_plain,
guard_words_plain; decode_words_plain chains them), which the tests
hold to decode_plain. The TPU layout of the JAX function (128-lane
padding, TIME_CHUNK padding, the gathered window stack) is not part of
the result and is not reproduced.
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


#: output bits in one packed word (and trellis steps in one traceback
#: segment of the window kernel)
WORD = 32


def _to_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 with the same 32 bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def window_words_plain(dec: torch.Tensor, win: int) -> torch.Tensor:
    """The window kernel's traceback, in plain form: its bits packed.

    dec: (win + 6, L, 64) decisions of L windows. The bits of a window,
    bit m read at step m + 6, are cut into nw = ceil(win / 32) words;
    word w's segment is steps [32 w + 6, 32 w + 38), the steps past the
    trellis zero. Every segment is walked from state 0 (a guess), keeping
    the state at each read, its bits and its exit. A segment's true entry
    is the exit of the segment above (state 0 for the top one, the
    trellis's state at step win + 5); in rounds, every segment whose
    entry changed is walked again from it until its state meets the kept
    path's at the same read (from there the paths are one), until no
    entry changes. Returns (L, nw) int64, bit i of word w the window's bit
    32 w + i. Equals chainback_plain(dec, win), packed.
    """
    lanes = dec.shape[1]
    nw = _cdiv(win, WORD)
    seg = torch.zeros((nw * WORD, lanes, viterbi.NUMSTATES), dtype=torch.int64,
                      device=dec.device)
    live = dec[K - 1:K - 1 + nw * WORD]
    seg[:live.shape[0]] = live
    # (L, nw, 32 steps, 64 states)
    seg = seg.reshape(nw, WORD, lanes, -1).permute(2, 0, 1, 3)
    # the kept path's state at each read (-1: none yet, so the first walk
    # never meets it) and its bits
    path = torch.full((lanes, nw, WORD), -1, dtype=torch.int64,
                      device=dec.device)
    bits = torch.zeros_like(path)

    def walk(state, active):
        """Walk every active segment from `state` until it meets the kept
        path; returns the states reached and which never met it."""
        for i in range(WORD - 1, -1, -1):
            active = active & (state != path[..., i])
            bit = seg[:, :, i].gather(-1, state[..., None])[..., 0]
            path[..., i] = torch.where(active, state, path[..., i])
            bits[..., i] = torch.where(active, bit, bits[..., i])
            state = torch.where(active, (state >> 1) | (bit << 5), state)
        return state, active

    entry = torch.zeros((lanes, nw), dtype=torch.int64, device=dec.device)
    exits, _ = walk(entry.clone(), torch.ones_like(entry, dtype=torch.bool))
    while True:
        want = torch.nn.functional.pad(exits[:, 1:], (0, 1))
        todo = want != entry
        if not todo.any():
            break
        entry = want
        state, unmet = walk(want.clone(), todo)
        exits = torch.where(unmet, state, exits)
    return (bits << torch.arange(WORD, device=dec.device)).sum(-1)


def span_write_plain(words: torch.Tensor, geo: Geometry) -> torch.Tensor:
    """The window kernel's output write, in plain form: (F * n_blocks, nw)
    packed window bits -> (F, nbits) int32 frame bits. Window b of a
    frame writes output bits [b tb, min((b + 1) tb, nbits)), bit n from
    its index n - b tb (+ wf for b > 0)."""
    frames = words.shape[0] // geo.n_blocks
    b_idx, m_idx = (torch.from_numpy(a).to(words.device, torch.int64)
                    for a in geo.splice_index())
    w = words.reshape(frames, geo.n_blocks, -1)[:, b_idx, m_idx >> 5]
    return ((w >> (m_idx & (WORD - 1))) & 1).to(torch.int32)


def overlap_words(geo: Geometry) -> int:
    """Packed words of one side of a cut's doubly decoded region."""
    return _cdiv(geo.ov, WORD)


def pack_overlaps_plain(words: torch.Tensor, geo: Geometry) -> torch.Tensor:
    """The window kernel's overlap words, in plain form.

    words: (F * n_blocks, nw) packed window bits. Returns (F * n_blocks,
    2, ovw) int32: [.., 0, :] window b's bits [0, ov) (the region of cut
    b, for b > 0), [.., 1, :] its bits [p, p + ov) with p = (b + 1) tb -
    wf - offs[b] (the region of cut b + 1, for b < n_blocks - 1); bit j
    of word k is region bit 32 k + j, zero past ov and on the sides that
    hold no cut.
    """
    lanes = words.shape[0]
    ovw = overlap_words(geo)
    nw = words.shape[1]
    bits = ((words[..., None] >> torch.arange(WORD, device=words.device))
            & 1).reshape(lanes, nw * WORD)
    bits = torch.nn.functional.pad(bits, (0, ovw * WORD))
    blk = torch.arange(lanes, device=words.device) % geo.n_blocks
    offs = torch.from_numpy(geo.offs).to(words.device, torch.int64)[blk]
    tail = (blk + 1) * geo.tb - geo.wf - offs
    i = torch.arange(ovw * WORD, device=words.device)
    keep = i < geo.ov
    head = torch.where(keep & (blk[:, None] > 0), bits[:, :ovw * WORD], 0)
    idx = (tail[:, None] + i).clamp(min=0)
    tail_bits = torch.where(keep & (blk[:, None] < geo.n_blocks - 1),
                            bits.gather(1, idx), 0)
    packed = torch.stack([head, tail_bits], 1).reshape(lanes, 2, ovw, WORD)
    return _to_int32((packed << torch.arange(WORD, device=words.device))
                     .sum(-1))


def _bit_range(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """(...) int64 -> the 32-bit masks of bits [lo, hi) clipped to 0..32,
    as int64 in [0, 2**32)."""
    lo, hi = lo.clamp(0, WORD), hi.clamp(0, WORD)
    one = torch.ones_like(hi)
    mask = (one << hi) - (one << lo)
    return torch.where(hi > lo, mask, 0)


def guard_words_plain(overlaps: torch.Tensor, steps: torch.Tensor,
                      geo: Geometry) -> torch.Tensor:
    """The guard kernel, in plain form: the merge guard on packed overlaps.

    overlaps: (F * n_blocks, 2, ovw) from pack_overlaps_plain; steps: (F,)
    frame step counts. Cut b (1 <= b < n_blocks) XORs window b - 1's tail
    words with window b's head words and keeps the bits i with trim <= i
    < ov - trim and b tb - wf + i < live_hi = min(max(steps - 6, 0),
    nbits); any bit left clears the frame's flag. Returns (F,) bool.
    """
    frames = steps.shape[0]
    ovw = overlaps.shape[-1]
    dev = overlaps.device
    ov = (overlaps.to(torch.int64) & 0xFFFFFFFF).reshape(
        frames, geo.n_blocks, 2, ovw)
    x = ov[:, :-1, 1] ^ ov[:, 1:, 0]                    # (F, cuts, ovw)
    live_hi = torch.clamp(steps.to(torch.int64) - (K - 1), min=0).clamp(
        max=geo.nbits)
    lo = torch.arange(1, geo.n_blocks, device=dev) * geo.tb - geo.wf
    k = torch.arange(ovw, device=dev) * WORD
    end = torch.minimum(torch.full_like(lo, geo.ov - geo.trim)[None],
                        live_hi[:, None] - lo[None])    # (F, cuts)
    mask = _bit_range(geo.trim - k[None, None], end[..., None] - k)
    return ~((x & mask) != 0).flatten(1).any(-1)


def decode_words_plain(soft: torch.Tensor, steps: torch.Tensor,
                       geo: Geometry):
    """The block-overlap decode as the two kernels compute it, in plain
    form: the windowed ACS, the per-window traceback into packed words,
    the span write and the overlap words, then the word-wise guard.
    Returns ((F, nbits) int32 bits, (F,) bool merge flags, (F * n_blocks,
    2, ovw) int32 overlap words); the bits and flags equal decode_plain's.
    """
    words = window_words_plain(acs_windowed_plain(soft, steps, geo),
                               geo.win)
    overlaps = pack_overlaps_plain(words, geo)
    return (span_write_plain(words, geo),
            guard_words_plain(overlaps, steps, geo), overlaps)


def decode_cuda(soft: torch.Tensor, steps: torch.Tensor, geo: Geometry):
    """The same decode through the kernels: one call of
    viterbi_cuda.blocked_decode (the window kernel and the guard kernel)."""
    from . import viterbi_cuda

    bits, ok, _ = viterbi_cuda.blocked_decode(soft, steps, geo)
    return bits, ok


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
