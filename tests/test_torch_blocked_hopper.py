"""The block-overlap decode's Hopper kernels, in plain form, on the CPU.

csrc/viterbi.cu decodes the block-overlap Viterbi with two kernels: a
warp per window runs the ACS into shared memory, traces the window back
in 32-step segments (each walked from state 0, then corrected from its
true entry, the exit of the segment above, until the paths meet), writes
its own span of the output and packs its overlap regions into 32-bit
words; a warp per frame runs the merge guard word-wise. The kernels run
only on the card (tests/test_torch_cuda.py holds them to these forms
there); here the plain forms of their algebra (ops/viterbi_blocked:
window_words_plain, span_write_plain, pack_overlaps_plain,
guard_words_plain, chained by decode_words_plain) are held, with
tolerance 0, to the decode's plain version (decode_plain) and to
fun_ofdm_tpu's `_blocked_decode_impl` in interpret mode, through its
entry `viterbi_decode_pallas_blocked`, as tests/test_torch_dynamic.py
runs it. The same numpy inputs go to both sides.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fun_ofdm_tpu.ops import convcode as j_convcode
from fun_ofdm_tpu.ops import viterbi_pallas
from fun_ofdm_tpu_torch.ops import viterbi, viterbi_blocked, viterbi_cuda
from fun_ofdm_tpu_torch.tools import blocked_variants_ab

torch.set_num_threads(1)

GOLDEN = Path(__file__).resolve().parent / "golden"


def _soft(rng, frames: int, nbits: int, kind: str) -> np.ndarray:
    """(frames, 2 (nbits + 6)) int32 soft pairs of random coded bits:
    "noisy" (uniform noise of +-100), "hard" (0/255) or "erasure"
    (all 127)."""
    if kind == "erasure":
        return np.full((frames, 2 * (nbits + 6)), 127, np.int32)
    bits = rng.integers(0, 2, size=(frames, nbits + 6))
    coded = np.asarray(j_convcode.conv_encode(jnp.asarray(bits)))
    noise = 100 if kind == "noisy" else 0
    return np.clip(coded * 255 + rng.integers(-noise, noise + 1, coded.shape),
                   0, 255).astype(np.int32)


def _check_all(soft: np.ndarray, nbits: int, n_blocks: int, warmup: int,
               nbd=None):
    """decode_words_plain == decode_plain (bits, flags) everywhere, and ==
    JAX's blocked decode on every live bit and every flag. Returns the
    flags."""
    frames = soft.shape[0]
    steps = viterbi.step_counts(
        nbits, None if nbd is None else torch.from_numpy(nbd), (frames,),
        "cpu")
    geo = viterbi_blocked.geometry(nbits, n_blocks, warmup)
    t_soft = torch.from_numpy(soft)
    bits, ok, overlaps = viterbi_blocked.decode_words_plain(t_soft, steps, geo)
    want_bits, want_ok = viterbi_blocked.decode_plain(t_soft, steps, geo)
    assert torch.equal(bits, want_bits)
    assert torch.equal(ok, want_ok)
    assert overlaps.shape == (frames * geo.n_blocks, 2,
                              viterbi_blocked.overlap_words(geo))
    j_bits, j_ok = viterbi_pallas.viterbi_decode_pallas_blocked(
        jnp.asarray(soft), nbits, n_blocks=n_blocks, warmup=warmup,
        interpret=True, nbits_dynamic=None if nbd is None else jnp.asarray(nbd),
        return_merge_ok=True)
    j_bits, j_ok = np.asarray(j_bits), np.asarray(j_ok)
    np.testing.assert_array_equal(ok.numpy(), j_ok)
    lens = np.full(frames, nbits) if nbd is None else nbd
    for f in range(frames):
        np.testing.assert_array_equal(bits[f, :lens[f]].numpy(),
                                      j_bits[f, :lens[f]])
    return ok.numpy()


@pytest.mark.parametrize("kind", ["noisy", "hard", "erasure"])
def test_words_plain_matches_decode_plain_and_jax(kind):
    """Noisy, hard and all-erasure soft pairs, 3 frames of 1,500 bits in 6
    blocks (windows of 444 steps, 14 output words)."""
    rng = np.random.default_rng(len(kind))
    ok = _check_all(_soft(rng, 3, 1500, kind), 1500, 6, 96)
    if kind != "erasure":
        assert ok.all()


def test_words_plain_dynamic_lengths_match_jax():
    """Per-frame lengths: 0, lengths ending inside a window's lead-in (the
    windows after them run 0 steps or a few), inside a span, at a cut, and
    the full frame."""
    nbits, n_blocks, warmup = 1200, 6, 64
    geo = viterbi_blocked.geometry(nbits, n_blocks, warmup)
    lead_in = 2 * geo.tb - geo.wf          # window 2 starts here
    nbd = np.array([0, 1, lead_in - 6 + 10, lead_in + 3, geo.tb,
                    3 * geo.tb - 6, nbits - 1, nbits])
    rng = np.random.default_rng(8)
    _check_all(_soft(rng, nbd.size, nbits, "noisy"), nbits, n_blocks, warmup,
               nbd)


def test_words_plain_guard_flags_forced_splice_failures():
    """Warm-up 2 on near-erasure noise forces splice failures (the JAX
    package's own guard case): the word-wise guard flags what the bit-wise
    guard and JAX flag, and every frame whose bits differ from the exact
    decode."""
    rng = np.random.default_rng(99)
    nbits = 1200
    bits = rng.integers(0, 2, size=(8, nbits + 6))
    coded = np.asarray(j_convcode.conv_encode(jnp.asarray(bits)))
    soft = np.clip(coded * 255 + rng.integers(-127, 128, coded.shape),
                   0, 255).astype(np.int32)
    ok = _check_all(soft, nbits, 8, 2)
    steps = viterbi.step_counts(nbits, None, (8,), "cpu")
    got, _, _ = viterbi_blocked.decode_words_plain(
        torch.from_numpy(soft), steps, viterbi_blocked.geometry(nbits, 8, 2))
    exact = viterbi.viterbi_decode(torch.from_numpy(soft), nbits).numpy()
    differs = (got.numpy() != exact).any(-1)
    assert differs.any(), "the input forced no splice failure"
    assert not (differs & ok).any(), "silent splice failure"


def test_words_plain_two_words_a_lane():
    """Windows longer than 1,024 steps (1,260: 40 output words, so lanes
    0-7 of the kernel's warp own two), 2 blocks."""
    nbits = 2000
    geo = viterbi_blocked.geometry(nbits, 2, 128)
    assert geo.win > 1024
    rng = np.random.default_rng(2000)
    _check_all(_soft(rng, 2, nbits, "noisy"), nbits, 2, 128,
               np.array([nbits, 1700]))


def test_words_plain_flags_the_golden_frame():
    """tests/golden/torch_guard_flag_frame.npz, the frame cut by a stream's
    end (recorded on an H100 by tools/guard_flag_probe.py): the word-wise
    guard flags it, as the bit-wise guard and JAX do."""
    z = np.load(GOLDEN / "torch_guard_flag_frame.npz")
    soft = z["soft"].astype(np.int32)[None]
    steps, nbits, n_blocks, warmup = (int(v) for v in z["meta"])
    ok = _check_all(soft, nbits, n_blocks, warmup, np.array([steps - 6]))
    assert not ok[0]


@pytest.mark.parametrize("win", [2, 30, 32, 34, 1012, 1026, 1270])
def test_window_words_equal_the_chainback(win):
    """The segmented traceback, packed, equals chainback_plain on random
    decision words with dead (zero) steps past each window's count: one
    word or less, a word exactly, a word and a step, the capture's 1,012,
    and windows of two words a lane. On random words survivor paths
    rarely meet within a segment, so the corrections take many rounds
    (the kernel's worst case, a serial walk)."""
    rng = np.random.default_rng(win)
    lanes = 5
    total = win + 6
    dec = torch.from_numpy(rng.integers(0, 2, (total, lanes, 64)).astype(
        np.uint8))
    live = torch.from_numpy(rng.integers(0, total + 1, lanes))
    live[0] = total
    dec[torch.arange(total)[:, None] >= live[None, :]] = 0
    words = viterbi_blocked.window_words_plain(dec, win)
    nw = -(-win // 32)
    assert words.shape == (lanes, nw)
    unpacked = ((words[..., None] >> torch.arange(32)) & 1).reshape(lanes, -1)
    assert torch.equal(unpacked[:, :win].to(torch.int32),
                       viterbi.chainback_plain(dec, win))
    assert not unpacked[:, win:].any()


@pytest.mark.parametrize("nbits,n_blocks,warmup", [
    (1500, 6, 96), (1200, 8, 2), (12090, 16, 128), (64, 16, 128),
    (300, 16, 128)])
def test_span_write_and_overlaps_equal_the_window_bits(nbits, n_blocks,
                                                       warmup):
    """span_write_plain takes each output bit from its window as the
    splice does (geo.splice_index), and pack_overlaps_plain packs each
    window's head region [0, ov) (blocks > 0) and the region of its next
    cut (blocks < n_blocks - 1), zero elsewhere; on random window bits,
    including one-block geometries (64 and 300 bits) whose span is
    shorter than the lead-in."""
    geo = viterbi_blocked.geometry(nbits, n_blocks, warmup)
    frames = 3
    lanes = frames * geo.n_blocks
    nw = -(-geo.win // 32)
    rng = np.random.default_rng(nbits)
    win_bits = torch.from_numpy(rng.integers(0, 2, (lanes, geo.win)))
    padded = torch.nn.functional.pad(win_bits, (0, 32 * nw - geo.win))
    words = (padded.reshape(lanes, nw, 32) << torch.arange(32)).sum(-1)
    bits = viterbi_blocked.span_write_plain(words, geo)
    steps = viterbi.step_counts(nbits, None, (frames,), "cpu")
    want, _ = viterbi_blocked.splice_guard_plain(win_bits, steps, geo)
    assert torch.equal(bits, want)
    ovl = viterbi_blocked.pack_overlaps_plain(words, geo)
    ovw = viterbi_blocked.overlap_words(geo)
    got = ((ovl.to(torch.int64)[..., None] >> torch.arange(32)) & 1).reshape(
        lanes, 2, 32 * ovw)
    assert not got[..., geo.ov:].any()
    for lane in range(lanes):
        b = lane % geo.n_blocks
        head = win_bits[lane, :geo.ov] if b > 0 else torch.zeros(geo.ov)
        assert torch.equal(got[lane, 0, :geo.ov], head.to(torch.int64))
        if b < geo.n_blocks - 1:
            p = (b + 1) * geo.tb - geo.wf - int(geo.offs[b])
            tail = win_bits[lane, p:p + geo.ov]
        else:
            tail = torch.zeros(geo.ov)
        assert torch.equal(got[lane, 1, :geo.ov], tail.to(torch.int64))


def _one_mismatch(geo, frames, cut, i):
    """Window bits of `frames` frames that agree on every cut's doubly
    decoded region, but for region bit i of cut `cut` in window cut."""
    nw = -(-geo.win // 32)
    lanes = frames * geo.n_blocks
    win_bits = torch.zeros((lanes, geo.win), dtype=torch.int64)
    for f in range(frames):
        win_bits[f * geo.n_blocks + cut, i] = 1
    padded = torch.nn.functional.pad(win_bits, (0, 32 * nw - geo.win))
    return win_bits, (padded.reshape(lanes, nw, 32)
                      << torch.arange(32)).sum(-1)


@pytest.mark.parametrize("where", ["trim_low", "trim_high", "live_mask"])
def test_guard_words_trim_and_live_mask(where):
    """One mismatched bit in one cut's region: the word-wise guard flags
    it exactly when it lies in [trim, ov - trim) and its trellis bit below
    the frame's live extent, as the bit-wise guard does. Each case puts the
    bit on both sides of one edge (trim, ov - trim, live_hi), so a guard
    that trims by one bit more or less, or masks the live bits off by one,
    fails it."""
    geo = viterbi_blocked.geometry(1200, 6, 64)       # ov 128, trim 32
    cut = 3
    lo = cut * geo.tb - geo.wf
    if where == "trim_low":
        cases = [(geo.trim - 1, None, True), (geo.trim, None, False)]
    elif where == "trim_high":
        cases = [(geo.ov - geo.trim - 1, None, False),
                 (geo.ov - geo.trim, None, True)]
    else:
        i = geo.ov // 2
        # live_hi = lo + i + 1 keeps bit i, live_hi = lo + i drops it
        cases = [(i, lo + i + 1, False), (i, lo + i, True)]
    for i, live_hi, want_ok in cases:
        frames = 2
        win_bits, words = _one_mismatch(geo, frames, cut, i)
        nbits = geo.nbits if live_hi is None else live_hi
        steps = torch.full((frames,), nbits + 6, dtype=torch.int32)
        ok = viterbi_blocked.guard_words_plain(
            viterbi_blocked.pack_overlaps_plain(words, geo), steps, geo)
        _, bitwise = viterbi_blocked.splice_guard_plain(win_bits, steps, geo)
        assert ok.tolist() == [want_ok] * frames, (where, i, live_hi)
        assert torch.equal(ok, bitwise)


def test_blocked_variants_apply():
    """tools/blocked_variants_ab.py's variants still edit the production
    source: each replaces the window kernel's traceback (the kept path's
    corrections go), and the segment-maps variant also resizes its
    scratch."""
    src = viterbi_cuda.SOURCE.read_text()
    for name, edit in blocked_variants_ab.VARIANTS.items():
        out = edit(src)
        kernel = out.split("blocked_window_kernel(")[1].split(
            "blocked_guard_kernel(")[0]
        assert "exits[w]" not in kernel, name
    assert "kTraceBytes = 72;" in blocked_variants_ab.VARIANTS[
        "segment_maps"](src)


def test_blocked_decode_wrapper_refuses_cpu_tensors():
    """The entry point launches its kernels or raises: a CPU tensor has no
    kernel (viterbi_decode_blocked sends it to decode_plain instead)."""
    geo = viterbi_blocked.geometry(300)
    soft = torch.zeros((2, 2 * 306), dtype=torch.int32)
    steps = torch.full((2,), 306, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        viterbi_cuda.blocked_decode(soft, steps, geo)
