"""The port's carrier-offset correction against fun_ofdm_tpu, on the CPU.

The same float32 streams (frames from the JAX TX builder, rotated by
fun_ofdm_tpu's channel.cfo, plus seeded numpy noise) go to both packages.
Estimates must agree to 1e-5 rad/sample and the cascade must pick the
same 2*pi/64 branch; derotated samples to atol 1e-4 (float32 cos/sin of
angles up to a few hundred radians); decoded bits, crc_ok and header
fields exactly; the streaming chains' packets and counters exactly. The
offsets are 1.5e-3, 4e-3 and 8e-3 cycles/sample: the last two lie past
the fine estimate's +-1/128 range, so the coarse STS estimate has to
choose the branch. JAX inputs are float32 (tests/conftest.py enables x64).
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fun_ofdm_tpu.models import frontend as j_frontend
from fun_ofdm_tpu.models import rx as j_rx
from fun_ofdm_tpu.models import tx as j_tx
from fun_ofdm_tpu.runtime import chain as j_chain
from fun_ofdm_tpu.sim import channel as j_channel
from fun_ofdm_tpu_torch.config import ChainParams
from fun_ofdm_tpu_torch.models import frontend, rx
from fun_ofdm_tpu_torch.rates import Rate
from fun_ofdm_tpu_torch.runtime import chain

torch.set_num_threads(1)

CFOS = (1.5e-3, 4e-3, 8e-3)
RATE = Rate.RATE_3_4_QAM16
LENGTH = 40
#: ChainStats fields that are host wall times, not counts
_TIMES = ("time_headers_s", "time_decode_s")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@functools.lru_cache(maxsize=None)
def _frame(rate: Rate, length: int, seed: int):
    payload = np.random.default_rng(seed).integers(0, 256, length,
                                                   dtype=np.uint8)
    re, im = j_tx.build_frame_p_jit(rate)(jnp.asarray(payload))
    return np.asarray(re, np.float32), np.asarray(im, np.float32), payload


def _rotated(frames, cfo, n, lead=37, snr_db=24.0, seed=0):
    """(F, n) float32 planar streams: frame k at `lead`, rotated by cfo
    through fun_ofdm_tpu's channel.cfo, plus complex noise at snr_db."""
    re = np.zeros((len(frames), n), np.float32)
    im = np.zeros((len(frames), n), np.float32)
    for k, (fr, fi, _) in enumerate(frames):
        re[k, lead:lead + fr.size], im[k, lead:lead + fi.size] = fr, fi
    rr, ri = j_channel.cfo((jnp.asarray(re), jnp.asarray(im)),
                           np.float32(cfo))
    rng = np.random.default_rng(seed)
    sigma = np.float32(np.sqrt(52 / 4096 / 10 ** (snr_db / 10) / 2))
    rr = np.asarray(rr, np.float32) + sigma * rng.standard_normal(
        re.shape).astype(np.float32)
    ri = np.asarray(ri, np.float32) + sigma * rng.standard_normal(
        im.shape).astype(np.float32)
    return rr, ri


def _frames(n_frames, length=LENGTH, rate=RATE, seed=0):
    return [_frame(rate, length, seed + k) for k in range(n_frames)]


@pytest.mark.parametrize("cfo", CFOS)
def test_estimators_match_jax(cfo):
    frames = _frames(3)
    re, im = _rotated(frames, cfo, frames[0][0].size + 100, seed=1)
    start = np.full(3, 37, np.int32)
    j_lts, _ = j_rx.extract_symbols_p((jnp.asarray(re), jnp.asarray(im)),
                                      jnp.asarray(start), 1)
    lts, _ = rx.extract_symbols_p((torch.from_numpy(re),
                                   torch.from_numpy(im)),
                                  torch.from_numpy(start), 1)
    np.testing.assert_array_equal(_np(lts[0]), np.asarray(j_lts[0]))
    wf = _np(rx.estimate_cfo_p(lts))
    j_wf = np.asarray(j_rx.estimate_cfo_p(j_lts))
    np.testing.assert_allclose(wf, j_wf, rtol=0, atol=1e-5)
    sts = rx.extract_sts_p((torch.from_numpy(re), torch.from_numpy(im)),
                           torch.from_numpy(start))
    j_sts = j_rx.extract_sts_p((jnp.asarray(re), jnp.asarray(im)),
                               jnp.asarray(start))
    np.testing.assert_array_equal(_np(sts[1]), np.asarray(j_sts[1]))
    wc = _np(rx.estimate_cfo_coarse_p(sts))
    j_wc = np.asarray(j_rx.estimate_cfo_coarse_p(j_sts))
    np.testing.assert_allclose(wc, j_wc, rtol=0, atol=1e-5)
    w = _np(rx.estimate_cfo_cascade_p(
        (torch.from_numpy(re), torch.from_numpy(im)),
        torch.from_numpy(start), lts))
    j_w = np.asarray(j_rx.estimate_cfo_cascade_p(
        (jnp.asarray(re), jnp.asarray(im)), jnp.asarray(start), j_lts))
    # the same branch of the fine estimate on both sides, away from a
    # rounding boundary, and the true offset within the estimate's noise
    period = 2 * np.pi / 64
    k, j_k = np.round((wc - wf) / period), np.round((j_wc - j_wf) / period)
    np.testing.assert_array_equal(k, j_k)
    assert np.all(np.abs((j_wc - j_wf) / period - j_k) < 0.4)
    np.testing.assert_allclose(w, j_w, rtol=0, atol=1e-5)
    assert np.all(np.abs(w - 2 * np.pi * cfo) < 2e-4)


def test_derotation_matches_jax():
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(3, 7, 64)).astype(np.float32),
         rng.normal(size=(3, 7, 64)).astype(np.float32))
    w = rng.uniform(-0.06, 0.06, 3).astype(np.float32)
    j_li, j_si = j_rx.derotation_indices(7)
    li, si = rx.derotation_indices(7)
    np.testing.assert_array_equal(li, j_li)
    np.testing.assert_array_equal(si, j_si)
    got = rx._derotate_p(tuple(torch.from_numpy(a) for a in x),
                         torch.from_numpy(w), si)
    want = j_rx._derotate_p(tuple(jnp.asarray(a) for a in x),
                            jnp.asarray(w), j_si)
    for g, h in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(h), rtol=0, atol=1e-4)


def _assert_decodes_equal(got, want, crc_key="crc_ok"):
    for key in ("crc_ok", "header_ok", "rate_field", "hdr_length",
                "service"):
        np.testing.assert_array_equal(_np(got[key]).astype(np.int64),
                                      np.asarray(want[key]).astype(np.int64),
                                      err_msg=key)
    ok = np.asarray(want[crc_key]).astype(bool)
    np.testing.assert_array_equal(_np(got["payload"])[ok],
                                  np.asarray(want["payload"])[ok])


@pytest.mark.parametrize("cfo", CFOS)
def test_decode_frame_cfo_correct_matches_jax(cfo):
    frames = _frames(3, seed=10)
    n = frames[0][0].size + 100
    re, im = _rotated(frames, cfo, n, seed=2)
    start = np.full(3, 37, np.int32)
    got = rx.decode_frame_p((torch.from_numpy(re), torch.from_numpy(im)),
                            RATE, LENGTH, torch.from_numpy(start),
                            cfo_correct=True)
    want = j_rx.decode_frame_p((jnp.asarray(re), jnp.asarray(im)), RATE,
                               LENGTH, jnp.asarray(start), cfo_correct=True)
    _assert_decodes_equal(got, want)
    np.testing.assert_array_equal(_np(got["payload"]),
                                  np.stack([f[2] for f in frames]))
    assert _np(got["crc_ok"]).all()


@pytest.mark.parametrize("cfo", CFOS)
def test_decode_frame_dynamic_and_anyrate_cfo_match_jax(cfo):
    """Header-driven decodes of frames of two rates and lengths below
    max_length, derotated: the same bits and header fields as JAX."""
    max_length = 48
    frames = [_frame(RATE, 40, 20), _frame(Rate.RATE_1_2_QPSK, 25, 21)]
    n = 320 + 80 * (1 + 27) + 200          # the slowest rate's max frame
    re, im = _rotated(frames, cfo, n, seed=3)
    start = np.full(2, 37, np.int32)
    t_in = (torch.from_numpy(re), torch.from_numpy(im))
    j_in = (jnp.asarray(re), jnp.asarray(im))
    got = rx.decode_frame_dynamic_p(t_in, RATE, max_length,
                                    torch.from_numpy(start),
                                    cfo_correct=True)
    want = j_rx.decode_frame_dynamic_p(j_in, RATE, max_length,
                                       jnp.asarray(start), cfo_correct=True)
    _assert_decodes_equal(got, want)
    assert list(_np(got["crc_ok"])) == [True, False]    # the QPSK frame
    rates = (RATE, Rate.RATE_1_2_QPSK)
    got = rx.decode_frame_anyrate_p(t_in, rates, max_length,
                                    torch.from_numpy(start),
                                    cfo_correct=True)
    want = j_rx.decode_frame_anyrate_p(j_in, rates, max_length,
                                       jnp.asarray(start), cfo_correct=True)
    _assert_decodes_equal(got, want)
    assert _np(got["crc_ok"]).all()
    assert bytes(_np(got["payload"])[1, :25].astype(np.uint8)) == \
        frames[1][2].tobytes()


def test_decode_headers_cfo_lts_segments_matches_jax():
    """Detection with lts_segments=4 and the derotated header pass on a
    stream at 8e-3 cycles/sample: the same slots and header fields."""
    f1, f2 = _frame(RATE, 60, 30), _frame(Rate.RATE_2_3_QAM64, 30, 31)
    n = 6000
    re, im = np.zeros((1, n), np.float32), np.zeros((1, n), np.float32)
    for (fr, fi, _), pos in ((f1, 300), (f2, 3400)):
        re[0, pos:pos + fr.size], im[0, pos:pos + fi.size] = fr, fi
    rr, ri = j_channel.cfo((jnp.asarray(re[0]), jnp.asarray(im[0])),
                           np.float32(8e-3))
    rng = np.random.default_rng(4)
    sigma = np.float32(np.sqrt(52 / 4096 / 10 ** 2.4 / 2))
    rr = np.asarray(rr) + sigma * rng.standard_normal(n).astype(np.float32)
    ri = np.asarray(ri) + sigma * rng.standard_normal(n).astype(np.float32)
    params = ChainParams(lts_segments=4)
    got = frontend.decode_headers_p((torch.from_numpy(rr),
                                     torch.from_numpy(ri)), 6, params,
                                    cfo_correct=True)
    want = j_frontend.decode_headers_p((jnp.asarray(rr), jnp.asarray(ri)),
                                       6, params, cfo_correct=True)
    for key in ("starts", "valid", "rate_field", "hdr_length", "header_ok",
                "detect_dropped", "n_detected"):
        np.testing.assert_array_equal(_np(got[key]).astype(np.int64),
                                      np.asarray(want[key]).astype(np.int64),
                                      err_msg=key)
    ok = _np(got["header_ok"]).astype(bool)
    assert sorted(_np(got["starts"])[ok].tolist()) == [300, 3400]
    assert sorted(_np(got["hdr_length"])[ok].tolist()) == [30, 60]


def _heavy_offset_stream(cfo: float, rng):
    """test_runtime.test_chain_cfo_cascade_heavy_offset's stream: two
    80-byte RATE_3_4_QAM16 frames at 600 and 9000 of 16384 samples,
    rotated by cfo, 24 dB SNR."""
    payload = np.random.default_rng(17).integers(0, 256, 80, dtype=np.uint8)
    fr, fi, _ = _frame_of(payload)
    f = fr + 1j * fi
    n = 16384
    base = np.zeros(n, np.complex64)
    for p in (600, 9000):
        base[p:p + f.size] = f
    prms = np.sqrt(np.mean(np.abs(f) ** 2))
    sigma = prms / np.sqrt(2 * 10 ** (24 / 10))
    rot = base * np.exp(2j * np.pi * cfo * np.arange(n))
    rot = (rot + sigma * (rng.normal(size=n) + 1j * rng.normal(size=n))
           ).astype(np.complex64)
    return rot, payload


def _frame_of(payload):
    re, im = j_tx.build_frame_p_jit(RATE)(jnp.asarray(payload))
    return np.asarray(re, np.float32), np.asarray(im, np.float32), payload


def test_chain_cfo_matches_jax_chain():
    """The heavy-offset chain case through both chains: the same packets
    and the same counters, both frames delivered at 4e-3 and 8e-3."""
    rng = np.random.default_rng(17)
    rng.integers(0, 256, 80, dtype=np.uint8)     # the JAX test's payload draw
    for cfo in (4e-3, 8e-3):
        stream, payload = _heavy_offset_stream(cfo, rng)
        kw = dict(rates=(RATE,), max_length=80,
                  params=ChainParams(lts_segments=4), cfo_correct=True)
        mine = chain.ReceiverChain(device="cpu", **kw)
        ref = j_chain.ReceiverChain(**kw)
        got = mine.process_samples(stream) + mine.flush()
        want = ref.process_samples(stream) + ref.flush()
        assert [(p.payload, int(p.rate), p.length, p.start, p.channel)
                for p in got] == [(p.payload, int(p.rate), p.length, p.start,
                                   p.channel) for p in want]
        assert sorted(p.start for p in got) == [600, 9000], cfo
        assert all(p.payload == payload.tobytes() for p in got)
        a, b = dataclasses.asdict(mine.stats), dataclasses.asdict(ref.stats)
        for key in _TIMES:
            a.pop(key), b.pop(key)
        assert a == b
