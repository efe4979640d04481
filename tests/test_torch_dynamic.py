"""The port's header-driven receive against fun_ofdm_tpu on the CPU.

Covers the dynamic and any-rate decoders and what they stand on: the
dynamic CRC, the detection drop counter, the Viterbi dispatcher's
impl/return_exact, the block-overlap decode (its plain version against
the Pallas function in interpret mode, merge flags included), the
dynamic and any-rate frame decoders (the latter with the all-modulation
demodulator and the gather tables, against both of JAX's strategies), the
header pass and the two header-driven capture receives. The same numpy inputs go to both sides.
Integer and boolean outputs must match exactly; a payload is compared
where its frame's CRC holds (elsewhere it decodes whatever lies at the
start and is unspecified). JAX inputs are float32 (tests/conftest.py
enables x64).
"""

import functools
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fun_ofdm_tpu.models import frontend as j_frontend
from fun_ofdm_tpu.models import ppdu as j_ppdu
from fun_ofdm_tpu.models import rx as j_rx
from fun_ofdm_tpu.models import tx as j_tx
from fun_ofdm_tpu.ops import convcode as j_convcode
from fun_ofdm_tpu.ops import crc32 as j_crc32
from fun_ofdm_tpu.ops import qam as j_qam
from fun_ofdm_tpu.ops import viterbi as j_viterbi
from fun_ofdm_tpu.ops import viterbi_pallas
from fun_ofdm_tpu_torch.models import frontend, ppdu, rx
from fun_ofdm_tpu_torch.ops import crc32, qam, viterbi, viterbi_blocked
from fun_ofdm_tpu_torch.rates import ALL_RATES, Rate, params_for

torch.set_num_threads(1)

GOLDEN = Path(__file__).resolve().parent / "golden"
MAX_LENGTH = 60
#: one rate per modulation, and both punctured codes
RATES = (Rate.RATE_1_2_BPSK, Rate.RATE_3_4_QPSK, Rate.RATE_3_4_QAM16,
         Rate.RATE_2_3_QAM64)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@functools.lru_cache(maxsize=None)
def _frame(rate: Rate, length: int, seed: int):
    payload = np.random.default_rng(seed).integers(0, 256, length,
                                                   dtype=np.uint8)
    re, im = j_tx.build_frame_p_jit(rate)(jnp.asarray(payload))
    return np.asarray(re, np.float32), np.asarray(im, np.float32), payload


def _stream(plan, n: int):
    """(re, im) float32 of n samples with frames (pos, rate, length) laid
    in; returns the stream and the payloads."""
    re, im = np.zeros(n, np.float32), np.zeros(n, np.float32)
    payloads = []
    for k, (pos, rate, length) in enumerate(plan):
        fr, fi, p = _frame(rate, length, k)
        cut = min(fr.size, n - pos)          # a frame may be cut short
        re[pos:pos + cut], im[pos:pos + cut] = fr[:cut], fi[:cut]
        payloads.append(p)
    return re, im, payloads


def _noisy_soft(rng, batch, nbits, noise=120, lens=None):
    bits = rng.integers(0, 2, size=(batch, nbits + 6))
    if lens is not None:
        for i, ln in enumerate(lens):
            bits[i, ln:] = 0
    coded = np.asarray(j_convcode.conv_encode(jnp.asarray(bits)))
    return np.clip(coded * 255 + rng.integers(-noise, noise + 1, coded.shape),
                   0, 255).astype(np.int32)


# ------------------------------------------------------------ crc32 ----

def test_crc32_dynamic_matches_jax_and_zlib():
    rng = np.random.default_rng(1)
    data = rng.integers(0, 256, size=(6, 45)).astype(np.int32)
    n_valid = np.array([0, 1, 17, 44, 45, 30])
    got = _np(crc32.crc32_dynamic(torch.from_numpy(data),
                                  torch.from_numpy(n_valid)))
    want = np.asarray(j_crc32.crc32_dynamic(jnp.asarray(data),
                                            jnp.asarray(n_valid)))
    np.testing.assert_array_equal(got, want.astype(np.int64))
    for row, n in zip(data, n_valid):
        assert zlib.crc32(row[:n].astype(np.uint8).tobytes()) in got


# -------------------------------------------------------- detection ----

@pytest.mark.parametrize("limit", [None, 512, 1024, 3072])
def test_first_k_true_blocked_drop_limit_matches_jax(limit):
    mask = np.zeros((2, 4096), bool)
    mask[0, 100:130] = True     # 30 events in block 0, cap 16
    mask[0, 600:620] = True     # 20 in block 1
    mask[1, 2600:2640] = True   # 40 in block 5
    mask[1, 3000:3003] = True
    for row in range(2):
        got = frontend._first_k_true_blocked(torch.from_numpy(mask[row]),
                                             64, limit)
        want = j_frontend._first_k_true_blocked(jnp.asarray(mask[row]), 64,
                                                limit)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_np(g), np.asarray(w))
    # the batched form equals the rows
    pos, valid, dropped = frontend._first_k_true_blocked(
        torch.from_numpy(mask), 64, limit)
    for row in range(2):
        want = j_frontend._first_k_true_blocked(jnp.asarray(mask[row]), 64,
                                                limit)
        np.testing.assert_array_equal(_np(dropped[row]), np.asarray(want[2]))


def test_detect_frames_dropped_matches_jax(monkeypatch):
    """Two back-to-back frames in one block with the cap shrunk to 1: the
    second event is dropped and counted, on both sides alike."""
    for mod in (frontend, j_frontend):
        monkeypatch.setattr(mod, "_BLOCK", 4096)
        monkeypatch.setattr(mod, "_BLOCK_CAP", 1)
    f = _frame(Rate.RATE_1_2_BPSK, 16, 0)[0].size
    re, im, _ = _stream([(100, Rate.RATE_1_2_BPSK, 16),
                         (100 + f, Rate.RATE_1_2_BPSK, 16),
                         (9000, Rate.RATE_1_2_BPSK, 16)], 12288)
    for limit in (None, 4096):
        got = frontend.detect_frames_p(
            (torch.from_numpy(re), torch.from_numpy(im)), 3,
            return_dropped=True, drop_count_limit=limit)
        want = j_frontend.detect_frames_p(
            (jnp.asarray(re), jnp.asarray(im)), 3, return_dropped=True,
            drop_count_limit=limit)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_np(g), np.asarray(w))
        assert int(got[2]) == 1


# ----------------------------------------------------------- viterbi ---

def _spy_geometry(nbits, n_blocks, warmup, monkeypatch):
    """The window offsets, lane step counts and inits, window length and
    splice map that fun_ofdm_tpu's blocked decode hands its kernel,
    caught at `_decode_tiles`. Soft pair t of each frame carries t, and
    the spy's bits carry (lane, window index), so the output is the
    splice map."""
    seen = {}

    def spy(s0, s1, sv, iv, nbits_win, **_):
        seen["win"] = nbits_win
        jax.debug.callback(lambda first, sv, iv: seen.update(
            first=np.asarray(first), sv=np.asarray(sv), iv=np.asarray(iv)),
            s0[:, 0], sv, iv)
        lanes = jnp.arange(s0.shape[0], dtype=jnp.int32)[:, None]
        return lanes * (1 << 16) + jnp.arange(nbits_win, dtype=jnp.int32)

    monkeypatch.setattr(viterbi_pallas, "_decode_tiles", spy)
    t = np.arange(nbits + 6, dtype=np.int32)
    soft = np.stack([t, t], -1).reshape(1, -1)
    nbd = np.array([nbits - 1])
    out = np.asarray(viterbi_pallas.viterbi_decode_pallas_blocked(
        jnp.asarray(soft), nbits, n_blocks=n_blocks, warmup=warmup,
        interpret=True, nbits_dynamic=jnp.asarray(nbd)))[0]
    return seen, out >> 16, out & 0xFFFF, nbd


@pytest.mark.parametrize("nbits,n_blocks,warmup", [
    (700, 4, 96), (1200, 8, 2), (12090, 16, 128), (900, 16, 128)])
def test_blocked_geometry_matches_jax(nbits, n_blocks, warmup, monkeypatch):
    seen, b_idx, m_idx, nbd = _spy_geometry(nbits, n_blocks, warmup,
                                            monkeypatch)
    geo = viterbi_blocked.geometry(nbits, n_blocks, warmup)
    nb = geo.n_blocks
    assert seen["win"] == geo.win
    np.testing.assert_array_equal(seen["first"][:nb], geo.offs)
    steps = viterbi.step_counts(nbits, torch.from_numpy(nbd), (1,), "cpu")
    np.testing.assert_array_equal(
        seen["sv"][:nb], _np(viterbi_blocked.window_steps(steps, geo)))
    np.testing.assert_array_equal(seen["iv"][:nb], np.arange(nb) == 0)
    want_b, want_m = geo.splice_index()
    np.testing.assert_array_equal(b_idx, want_b)
    np.testing.assert_array_equal(m_idx, want_m)


def _blocked_both(soft, nbits, n_blocks, warmup, nbd=None):
    got = viterbi_blocked.viterbi_decode_blocked(
        torch.from_numpy(soft), nbits, n_blocks=n_blocks, warmup=warmup,
        nbits_dynamic=None if nbd is None else torch.from_numpy(nbd),
        return_merge_ok=True)
    want = viterbi_pallas.viterbi_decode_pallas_blocked(
        jnp.asarray(soft), nbits, n_blocks=n_blocks, warmup=warmup,
        interpret=True,
        nbits_dynamic=None if nbd is None else jnp.asarray(nbd),
        return_merge_ok=True)
    return [_np(g) for g in got], [np.asarray(w) for w in want]


@pytest.mark.parametrize("nbits,n_blocks", [(700, 4), (1200, 8)])
def test_blocked_plain_matches_jax(nbits, n_blocks):
    """Clean and noisy frames: bits and merge flags equal the Pallas
    function's, and the bits the exact decode's."""
    rng = np.random.default_rng(nbits)
    for noise in (0, 60):
        soft = _noisy_soft(rng, 2, nbits, noise)
        (bits, ok), (j_bits, j_ok) = _blocked_both(soft, nbits, n_blocks, 96)
        np.testing.assert_array_equal(bits, j_bits)
        np.testing.assert_array_equal(ok, j_ok)
        np.testing.assert_array_equal(
            bits, _np(viterbi.viterbi_decode(torch.from_numpy(soft), nbits)))
        assert ok.all()


def test_blocked_guard_matches_jax_and_flags_every_mismatch():
    """tests/test_viterbi_pallas.py's guard case: warmup 2 on near-erasure
    noise forces splice failures; the flags equal JAX's and cover every
    frame whose bits differ from the exact decode."""
    rng = np.random.default_rng(99)
    nbits = 1200
    bits = rng.integers(0, 2, size=(8, nbits + 6))
    coded = np.asarray(j_convcode.conv_encode(jnp.asarray(bits)))
    soft = np.clip(coded * 255 + rng.integers(-127, 128, coded.shape),
                   0, 255).astype(np.int32)
    (got, ok), (j_got, j_ok) = _blocked_both(soft, nbits, 8, 2)
    np.testing.assert_array_equal(got, j_got)
    np.testing.assert_array_equal(ok, j_ok)
    ref = np.asarray(j_viterbi.viterbi_decode_scan(jnp.asarray(soft), nbits))
    differs = (got != ref).any(axis=-1)
    assert not (differs & ok).any(), "silent splice failure"
    assert differs.any(), "test vector failed to force any mismatch"


def test_blocked_guard_flags_a_frame_cut_by_the_streams_end_like_jax():
    """The one frame the merge guard flags on a clean all-rates stream
    (recorded on an H100 by tools/guard_flag_probe.py): 12,096 trellis
    steps whose soft pairs, from step ~4,800 on, are the demodulation of
    the zero samples past the stream's end (128, with the depuncturer's
    127 at every fourth place). With no information the survivor paths
    do not merge within the 128-step warm-up, so the windows disagree
    and the guard flags the frame. fun_ofdm_tpu's guard does the same on
    the same input, and both give the same bits: the flag is the
    reference guard's behaviour (the frame fails its CRC either way)."""
    z = np.load(GOLDEN / "torch_guard_flag_frame.npz")
    soft = z["soft"].astype(np.int32)[None]
    steps, nbits, n_blocks, warmup = (int(v) for v in z["meta"])
    tail = soft[0, 2 * 6000:2 * steps]
    assert set(np.unique(tail)) == {127, 128}
    nbd = np.array([steps - 6])
    (got, ok), (j_got, j_ok) = _blocked_both(soft, nbits, n_blocks, warmup,
                                             nbd)
    assert not ok[0] and not j_ok[0]
    np.testing.assert_array_equal(got[0, :nbd[0]], j_got[0, :nbd[0]])
    exact = _np(viterbi.viterbi_decode(torch.from_numpy(soft), nbits,
                                       nbits_dynamic=torch.from_numpy(nbd)))
    assert (got[0, :nbd[0]] != exact[0, :nbd[0]]).any()
    # the head of the frame, where the samples are real, decodes alike
    np.testing.assert_array_equal(got[0, :4000], exact[0, :4000])


def test_blocked_dynamic_lengths_match_jax():
    rng = np.random.default_rng(42)
    nbits = 900
    lens = np.array([900, 520, 244])
    soft = _noisy_soft(rng, 3, nbits, 50, lens)
    (got, ok), (j_got, j_ok) = _blocked_both(soft, nbits, 6, 96, lens)
    np.testing.assert_array_equal(ok, j_ok)
    ref = _np(viterbi.viterbi_decode(torch.from_numpy(soft), nbits,
                                     nbits_dynamic=torch.from_numpy(lens)))
    for i, ln in enumerate(lens):
        np.testing.assert_array_equal(got[i, :ln], j_got[i, :ln])
        np.testing.assert_array_equal(got[i, :ln], ref[i, :ln])


@pytest.mark.parametrize("impl", [None, "exact", "blocked"])
def test_dispatcher_impls_on_cpu(impl):
    """Every impl name decodes exactly on the CPU with an all-True flag
    (the blocked request runs the exact twin, as fun_ofdm_tpu does off
    the TPU). The port's "blocked" is fun_ofdm_tpu's "pallas-blocked"."""
    rng = np.random.default_rng(5)
    nbits = 300
    soft = _noisy_soft(rng, 3, nbits)
    nbd = np.array([300, 151, 64])
    bits, exact = viterbi.viterbi_decode(
        torch.from_numpy(soft), nbits, impl=impl,
        nbits_dynamic=torch.from_numpy(nbd), return_exact=True)
    j_bits, j_exact = j_viterbi.viterbi_decode(
        jnp.asarray(soft), nbits,
        impl={"blocked": "pallas-blocked"}.get(impl, impl),
        nbits_dynamic=jnp.asarray(nbd), return_exact=True)
    for i, n in enumerate(nbd):
        np.testing.assert_array_equal(_np(bits)[i, :n],
                                      np.asarray(j_bits)[i, :n])
    np.testing.assert_array_equal(_np(exact), np.asarray(j_exact))
    assert _np(exact).all()


@pytest.mark.parametrize("impl", ["auto", "scan", "pallas",
                                  "pallas-blocked"])
def test_dispatcher_rejects_unknown_impl(impl):
    """fun_ofdm_tpu's names and the chain's "auto" are not the
    dispatcher's."""
    with pytest.raises(ValueError, match="impl"):
        viterbi.viterbi_decode(torch.zeros((1, 48), dtype=torch.int32), 18,
                               impl=impl)


# ---------------------------------------------------- frame decoders ---

def _dynamic_plan():
    """Frames at every configured rate and several lengths, a frame whose
    header is another rate's (for the single-rate decoder) and one whose
    length is past MAX_LENGTH."""
    plan, pos = [], 200
    for rate, length in [(Rate.RATE_1_2_BPSK, 1), (Rate.RATE_3_4_QPSK, 37),
                         (Rate.RATE_3_4_QAM16, MAX_LENGTH),
                         (Rate.RATE_2_3_QAM64, 23), (Rate.RATE_3_4_QAM16, 5),
                         (Rate.RATE_1_2_QPSK, 40),
                         (Rate.RATE_3_4_QAM16, MAX_LENGTH + 30)]:
        plan.append((pos, rate, length))
        pos += _frame(rate, length, len(plan) - 1)[0].size + 150
    return plan, pos + 12000


#: header fields, compared where a slot is valid (an invalid slot decodes
#: whatever lies at sample 0)
_SLOT_KEYS = ("rate_field", "hdr_length", "rate_match")


def _compare_frames(got, want, keys):
    valid = np.asarray(want.get("valid", True))
    for key in keys:
        g, w = np.broadcast_arrays(_np(got[key]), np.asarray(want[key]))
        if key in _SLOT_KEYS:
            g, w = g[np.broadcast_to(valid, g.shape)], w[
                np.broadcast_to(valid, w.shape)]
        np.testing.assert_array_equal(g, w, err_msg=key)
    ok = np.asarray(want["crc_ok"])
    np.testing.assert_array_equal(_np(got["payload"])[ok],
                                  np.asarray(want["payload"])[ok])


_FRAME_KEYS = ("crc_ok", "header_ok", "rate_field", "hdr_length", "service",
               "rate_match", "viterbi_exact")


def test_decode_frames_dynamic_matches_jax():
    plan, n = _dynamic_plan()
    re, im, payloads = _stream(plan, n)
    starts = np.array([p for p, _, _ in plan])
    rate = Rate.RATE_3_4_QAM16
    want = jax.jit(jax.vmap(lambda s: j_rx.decode_frame_dynamic_p(
        (jnp.asarray(re), jnp.asarray(im)), rate, MAX_LENGTH, start=s,
        viterbi_impl="pallas-blocked")))(jnp.asarray(starts))
    got = rx.decode_frames_dynamic(torch.complex(torch.from_numpy(re),
                                                 torch.from_numpy(im)),
                                   rate, MAX_LENGTH, torch.from_numpy(starts),
                                   viterbi_impl="blocked")
    _compare_frames(got, want, _FRAME_KEYS)
    # only the in-range frames of the configured rate decode
    crc = _np(got["crc_ok"])
    np.testing.assert_array_equal(crc, [r == rate and ln <= MAX_LENGTH
                                        for _, r, ln in plan])
    for k in np.nonzero(crc)[0]:
        ln = plan[k][2]
        np.testing.assert_array_equal(_np(got["payload"])[k, :ln],
                                      payloads[k])
    # the one-frame planar form agrees with the batched form
    one = rx.decode_frame_dynamic_p((torch.from_numpy(re),
                                     torch.from_numpy(im)), rate, MAX_LENGTH,
                                    start=int(starts[2]))
    np.testing.assert_array_equal(_np(one["payload"]),
                                  _np(got["payload"])[2])
    # CFO correction (tests/test_torch_cfo.py) leaves a clean frame as is
    fixed = rx.decode_frame_dynamic_p((torch.from_numpy(re),
                                       torch.from_numpy(im)), rate,
                                      MAX_LENGTH, start=int(starts[2]),
                                      cfo_correct=True)
    assert bool(fixed["crc_ok"]) == bool(one["crc_ok"])
    np.testing.assert_array_equal(_np(fixed["payload"]), _np(one["payload"]))


def test_decode_frames_anyrate_matches_jax():
    plan, n = _dynamic_plan()
    re, im, payloads = _stream(plan, n)
    starts = np.array([p for p, _, _ in plan])
    want = jax.jit(jax.vmap(lambda s: j_rx.decode_frame_anyrate_p(
        (jnp.asarray(re), jnp.asarray(im)), RATES, MAX_LENGTH,
        start=s)))(jnp.asarray(starts))
    got = rx.decode_frames_anyrate(torch.complex(torch.from_numpy(re),
                                                 torch.from_numpy(im)),
                                   RATES, MAX_LENGTH,
                                   torch.from_numpy(starts))
    _compare_frames(got, want, _FRAME_KEYS)
    # RATE_1_2_QPSK is not configured; the long frame is out of range
    crc = _np(got["crc_ok"])
    np.testing.assert_array_equal(crc, [r in RATES and ln <= MAX_LENGTH
                                        for _, r, ln in plan])
    for k in np.nonzero(crc)[0]:
        np.testing.assert_array_equal(
            _np(got["payload"])[k, :plan[k][2]], payloads[k])


# ------------------------------------------------------- header pass ---

@functools.lru_cache(maxsize=None)
def _jax_headers(max_frames, hdr_slots, limit):
    return jax.jit(jax.vmap(lambda r, i: j_frontend.decode_headers_p(
        (r, i), max_frames, drop_count_limit=limit, hdr_slots=hdr_slots)))


def _two_channel_headers_stream():
    plan, n = _dynamic_plan()
    re0, im0, _ = _stream(plan, n)
    re1, im1, _ = _stream([(p + 333, r, ln) for p, r, ln in plan[:3]], n)
    assert n > frontend._BLOCKED_MIN_N
    return np.stack([re0, re1]), np.stack([im0, im1])


def _compare_headers(got, want):
    assert set(got) == set(want)
    valid = np.asarray(want["valid"])
    for key in want:
        g, w = _np(got[key]), np.asarray(want[key])
        if key in _SLOT_KEYS:
            g, w = g[valid], w[valid]
        np.testing.assert_array_equal(g, w, err_msg=key)


@pytest.mark.parametrize("hdr_slots", [None, 3])
def test_decode_headers_matches_jax(hdr_slots):
    re, im = _two_channel_headers_stream()
    got = frontend.decode_headers_p(
        (torch.from_numpy(re), torch.from_numpy(im)), 10,
        drop_count_limit=9000, hdr_slots=hdr_slots)
    want = _jax_headers(10, hdr_slots, 9000)(jnp.asarray(re),
                                             jnp.asarray(im))
    _compare_headers(got, want)
    assert list(_np(got["n_detected"])) == [7, 3]
    assert _np(got["starts"]).shape == (2, hdr_slots or 10)


def test_decode_headers_counts_dropped_like_jax(monkeypatch):
    """A stream past the blocked extractor's threshold with a shrunk cap:
    detect_dropped agrees, counted only below the limit."""
    for mod in (frontend, j_frontend):
        monkeypatch.setattr(mod, "_BLOCK", 2048)
        monkeypatch.setattr(mod, "_BLOCK_CAP", 1)
    re, im = _two_channel_headers_stream()
    got = frontend.decode_headers_p(
        (torch.from_numpy(re), torch.from_numpy(im)), 8,
        drop_count_limit=4096)
    for ch in range(2):
        want = j_frontend.decode_headers_p(
            (jnp.asarray(re[ch]), jnp.asarray(im[ch])), 8,
            drop_count_limit=4096)
        _compare_headers({k: v[ch] for k, v in got.items()}, want)
    assert _np(got["detect_dropped"]).sum() >= 1


# ------------------------------------------------- capture receives ----

def test_receive_capture_dynamic_matches_jax():
    plan, n = _dynamic_plan()
    re, im, _ = _stream(plan, n)
    rate = Rate.RATE_3_4_QAM16
    got = frontend.receive_capture_dynamic_p(
        (torch.from_numpy(re), torch.from_numpy(im)), rate, MAX_LENGTH, 9)
    want = jax.jit(lambda r, i: j_frontend.receive_capture_dynamic_p(
        (r, i), rate, MAX_LENGTH, 9))(jnp.asarray(re), jnp.asarray(im))
    _compare_frames(got, want, ("starts", "valid", "crc_ok", "header_ok",
                                "rate_field", "hdr_length",
                                "detect_dropped"))
    assert int(_np(got["crc_ok"]).sum()) == 2


def test_receive_capture_anyrate_matches_jax():
    """The any-rate capture is the JAX chain's fuzz oracle; a frame cut by
    the capture's end reads the zero padding and fails its CRC."""
    plan, _ = _dynamic_plan()
    n = plan[4][0] + 300           # cuts frame 4 short
    re, im, _ = _stream(plan[:5], n)
    got = frontend.receive_capture_anyrate_p(
        (torch.from_numpy(re), torch.from_numpy(im)), RATES, MAX_LENGTH, 9)
    want = jax.jit(lambda r, i: j_frontend.receive_capture_anyrate_p(
        (r, i), RATES, MAX_LENGTH, 9))(jnp.asarray(re), jnp.asarray(im))
    _compare_frames(got, want, ("starts", "valid", "crc_ok", "header_ok",
                                "rate_field", "hdr_length", "rate_match",
                                "detect_dropped"))
    assert int(_np(got["crc_ok"]).sum()) == 4


# --------------------------------------------- any-rate soft streams ---

def test_demodulate_all_matches_jax_and_per_rate():
    """tests/test_ops.py's case: the 13-lane vector equals JAX's exactly
    (uint8) and slices to demodulate_p's output for every rate."""
    rng = np.random.default_rng(31)
    sym = (rng.normal(0, 0.5, 96).astype(np.float32),
           rng.normal(0, 0.5, 96).astype(np.float32))
    t_sym = tuple(torch.from_numpy(x) for x in sym)
    all13 = qam.demodulate_all_p(t_sym)
    assert all13.dtype == torch.uint8 and all13.shape == (96, 13)
    want = j_qam.demodulate_all_p(tuple(jnp.asarray(x) for x in sym))
    np.testing.assert_array_equal(_np(all13), np.asarray(want))
    assert qam.ALL_SOFT_OFFSET == j_qam.ALL_SOFT_OFFSET
    assert qam.ALL_SOFT_WIDTH == j_qam.ALL_SOFT_WIDTH
    for rate in ALL_RATES:
        bpsc = params_for(rate).bpsc
        off = qam.ALL_SOFT_OFFSET[bpsc]
        np.testing.assert_array_equal(
            _np(all13)[:, off:off + bpsc],
            _np(qam.demodulate_p(t_sym, rate)).reshape(96, bpsc))


@pytest.mark.parametrize("rates,max_length", [
    (RATES, MAX_LENGTH), (ALL_RATES, 257), (ALL_RATES[4:7], 1500)])
def test_anyrate_tables_equal_jax(rates, max_length):
    got = ppdu._anyrate_tables(tuple(rates), max_length)
    want = j_ppdu._anyrate_tables(tuple(rates), max_length)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert np.asarray(g).dtype == np.asarray(w).dtype


def _anyrate_data_samples(rng, lengths, rate_idx):
    """Planar (F, nsym_max*48) noisy data samples of frames of RATES, each
    from the JAX static encoder, zero past the frame's own symbols."""
    nsym_max = max(params_for(r).num_symbols(MAX_LENGTH) for r in RATES)
    re = np.zeros((len(lengths), nsym_max * 48), np.float32)
    im = np.zeros_like(re)
    payloads = []
    for i, (n, ri) in enumerate(zip(lengths, rate_idx)):
        p = rng.integers(0, 256, n, dtype=np.uint8)
        d_re, d_im = j_ppdu.encode_data_p(jnp.asarray(p), RATES[ri],
                                          dtype=jnp.float32)
        re[i, :d_re.size], im[i, :d_im.size] = d_re, d_im
        payloads.append(p)
    noise = rng.normal(0, 0.02, (2,) + re.shape).astype(np.float32)
    return re + noise[0], im + noise[1], payloads


def test_decode_data_anyrate_gather_equals_select_equals_jax():
    """The port's one path (gather) and both strategies of JAX on the
    same samples: payload (where the CRC holds), crc_ok, service and the
    exactness flag are equal; an unknown rate index and an out-of-range
    length fail alike."""
    rng = np.random.default_rng(17)
    lengths = np.array([1, MAX_LENGTH, 37, 23, 5, 44, 12, MAX_LENGTH + 3])
    rate_idx = np.array([0, 1, 2, 3, 2, 1, -1, 3])
    enc_len = np.minimum(lengths, MAX_LENGTH)
    re, im, payloads = _anyrate_data_samples(rng, enc_len,
                                             np.maximum(rate_idx, 0))
    outs = {"torch": [_np(x) for x in ppdu.decode_data_anyrate_p(
        (torch.from_numpy(re), torch.from_numpy(im)), RATES,
        torch.from_numpy(rate_idx), torch.from_numpy(lengths), MAX_LENGTH)]}
    for strategy in ("select", "gather"):
        outs["jax", strategy] = [np.asarray(x) for x in
                                 j_ppdu.decode_data_anyrate_p(
            (jnp.asarray(re), jnp.asarray(im)), RATES,
            jnp.asarray(rate_idx), jnp.asarray(lengths), MAX_LENGTH,
            strategy=strategy)]
    ref = outs["jax", "select"]
    ok = ref[1]
    np.testing.assert_array_equal(ok, [True] * 6 + [False, False])
    for key, out in outs.items():
        np.testing.assert_array_equal(out[1], ok, err_msg=str(key))
        np.testing.assert_array_equal(out[0][ok], ref[0][ok],
                                      err_msg=str(key))
        np.testing.assert_array_equal(out[2][ok], ref[2][ok],
                                      err_msg=str(key))
        np.testing.assert_array_equal(out[3], ref[3], err_msg=str(key))
    # the port and JAX's gather agree everywhere, not only where the CRC
    # holds: the same coded streams into the same exact decode
    for a, b in zip(outs["torch"], outs["jax", "gather"]):
        np.testing.assert_array_equal(a, b)
    for i in np.nonzero(ok)[0]:
        np.testing.assert_array_equal(ref[0][i, :lengths[i]], payloads[i])


def test_frame_and_capture_gather_equal_select(monkeypatch):
    """decode_frames_anyrate, decode_frame_anyrate_p and
    receive_capture_anyrate_p against fun_ofdm_tpu's functions under its
    "gather" strategy (FUN_OFDM_ANYRATE, read when JAX traces) on the
    dynamic plan's stream; the *_matches_jax tests above hold them to
    JAX's default, "select"."""
    monkeypatch.setenv("FUN_OFDM_ANYRATE", "gather")
    plan, n = _dynamic_plan()
    re, im, _ = _stream(plan, n)
    planar = (torch.from_numpy(re), torch.from_numpy(im))
    j_planar = (jnp.asarray(re), jnp.asarray(im))
    starts = np.array([p for p, _, _ in plan])
    want = jax.jit(jax.vmap(lambda s: j_rx.decode_frame_anyrate_p(
        j_planar, RATES, MAX_LENGTH, start=s)))(jnp.asarray(starts))
    got = rx.decode_frames_anyrate(torch.complex(*planar), RATES,
                                   MAX_LENGTH, torch.from_numpy(starts))
    _compare_frames(got, want, _FRAME_KEYS)
    one = rx.decode_frame_anyrate_p(planar, RATES, MAX_LENGTH,
                                    start=int(starts[2]))
    _compare_frames(one, {k: v[2] for k, v in want.items()}, _FRAME_KEYS)
    c_got = frontend.receive_capture_anyrate_p(planar, RATES, MAX_LENGTH, 9)
    c_want = jax.jit(lambda r, i: j_frontend.receive_capture_anyrate_p(
        (r, i), RATES, MAX_LENGTH, 9))(*j_planar)
    _compare_frames(c_got, c_want, ("starts", "valid", "crc_ok", "header_ok",
                                    "rate_field", "hdr_length", "rate_match",
                                    "detect_dropped"))
    assert int(_np(c_got["crc_ok"]).sum()) == 5
