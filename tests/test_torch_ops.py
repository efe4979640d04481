"""The PyTorch port's ops and models against fun_ofdm_tpu, on the CPU.

Every case makes its input with numpy from a seed and feeds the same
arrays to the JAX function and its port. Integer outputs (bits, bytes,
CRCs, soft values, masks, positions) must match exactly. Float outputs
match to atol=1e-4 (a float32 FFT against a float32 matmul DFT on O(1)
values) and the normalised correlator outputs to atol=1e-5. JAX inputs
are pinned to float32: tests/conftest.py enables jax x64, and float64 on
the JAX side would show false mismatches against the float32 port.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fun_ofdm_tpu.models import frontend as j_frontend
from fun_ofdm_tpu.models import ppdu as j_ppdu
from fun_ofdm_tpu.models import rx as j_rx
from fun_ofdm_tpu.ops import (convcode as j_convcode, correlate as j_correlate,
                              crc32 as j_crc32, fft64 as j_fft64,
                              interleave as j_interleave, mapper as j_mapper,
                              puncture as j_puncture, qam as j_qam,
                              scramble as j_scramble, viterbi as j_viterbi)
from fun_ofdm_tpu.utils import bits as j_bits
from fun_ofdm_tpu_torch.models import frontend, ppdu, rx
from fun_ofdm_tpu_torch.ops import (convcode, correlate, crc32, fft64,
                                    interleave, mapper, puncture, qam,
                                    scramble, viterbi)
from fun_ofdm_tpu_torch.rates import Rate, params_for
from fun_ofdm_tpu_torch.utils import bits

torch.set_num_threads(1)

FLOAT_ATOL = 1e-4
CORR_ATOL = 1e-5
#: one rate per modulation and puncture pattern
RATES = [Rate.RATE_1_2_BPSK, Rate.RATE_3_4_BPSK, Rate.RATE_2_3_QPSK,
         Rate.RATE_3_4_QAM16, Rate.RATE_2_3_QAM64]


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _f32_pair(rng, shape, scale=1.0):
    return (rng.normal(0, scale, shape).astype(np.float32),
            rng.normal(0, scale, shape).astype(np.float32))


def _assert_pair_close(got, want, atol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=0, atol=atol)


def test_tables_equal_jax():
    np.testing.assert_array_equal(interleave.PERM, j_interleave.PERM)
    np.testing.assert_array_equal(interleave.INV_PERM, j_interleave.INV_PERM)
    for name in ("ACTIVE_MAP", "DATA_IDX", "PILOT_IDX", "PILOT_VALUES",
                 "POLARITY"):
        np.testing.assert_array_equal(getattr(mapper, name),
                                      getattr(j_mapper, name))
    np.testing.assert_array_equal(mapper.polarity_for_symbols(300, 5),
                                  j_mapper.polarity_for_symbols(300, 5))
    for rate in Rate:
        mine, ref = puncture._pattern(rate), j_puncture._pattern(rate)
        assert (mine is None) == (ref is None)
        if mine is not None:
            assert mine[0] == ref[0]
            np.testing.assert_array_equal(mine[1], ref[1])
    np.testing.assert_array_equal(scramble.keystream(1000),
                                  j_scramble.keystream(1000))
    for mine, ref in zip(viterbi._branch_bits(), j_viterbi._branch_bits()):
        np.testing.assert_array_equal(mine, ref)
    np.testing.assert_array_equal(crc32._byte_table(), j_crc32._byte_table())
    np.testing.assert_array_equal(convcode._TAPS, j_convcode._TAPS)
    # the centred DFT the port's FFTs compute, as the JAX package's
    # matrices (out = x @ M)
    eye = torch.eye(64, dtype=torch.complex128)
    for inv, fn in ((False, fft64.forward), (True, fft64.inverse)):
        c, s = j_fft64._matrices(inv, "float64")
        np.testing.assert_allclose(fn(eye).numpy(), c + 1j * s, atol=1e-12)
    for segments in (1, 4):
        a, b = correlate._lts_polyphase_taps(segments)
        ref = j_correlate._lts_polyphase_taps(segments)
        np.testing.assert_array_equal(a.real.astype(np.float32), ref["a_re"])
        np.testing.assert_array_equal(a.imag.astype(np.float32), ref["a_im"])
        np.testing.assert_array_equal(b.real.astype(np.float32), ref["b_re"])
        np.testing.assert_array_equal(b.imag.astype(np.float32), ref["b_im"])


def test_bits_bytes():
    data = np.random.default_rng(0).integers(0, 256, (3, 41), dtype=np.uint8)
    got = bits.bytes_to_bits(_t(data))
    np.testing.assert_array_equal(
        _np(got), np.asarray(j_bits.bytes_to_bits(jnp.asarray(data))))
    np.testing.assert_array_equal(
        _np(bits.bits_to_bytes(got)),
        np.asarray(j_bits.bits_to_bytes(jnp.asarray(_np(got)))))


def test_scramble_and_conv_encode():
    rng = np.random.default_rng(1)
    data = rng.integers(0, 256, (2, 300), dtype=np.int32)
    np.testing.assert_array_equal(
        _np(scramble.scramble_bytes(_t(data))),
        np.asarray(j_scramble.scramble_bytes(jnp.asarray(data))))
    b = rng.integers(0, 2, (2, 3, 130), dtype=np.int32)
    np.testing.assert_array_equal(
        _np(convcode.conv_encode(_t(b))),
        np.asarray(j_convcode.conv_encode(jnp.asarray(b))))


@pytest.mark.parametrize("rate", [Rate.RATE_1_2_QPSK, Rate.RATE_2_3_QAM16,
                                  Rate.RATE_3_4_QAM64])
def test_puncture_depuncture(rate):
    rng = np.random.default_rng(int(rate))
    coded = rng.integers(0, 2, (2, 288), dtype=np.int32)
    got = puncture.puncture(_t(coded), rate)
    np.testing.assert_array_equal(
        _np(got), np.asarray(j_puncture.puncture(jnp.asarray(coded), rate)))
    soft = rng.integers(0, 256, (2, got.shape[-1]), dtype=np.int32)
    np.testing.assert_array_equal(
        _np(puncture.depuncture(_t(soft), rate)),
        np.asarray(j_puncture.depuncture(jnp.asarray(soft), rate)))


def test_interleave_deinterleave():
    x = np.random.default_rng(2).integers(0, 256, (3, 96), dtype=np.int32)
    np.testing.assert_array_equal(
        _np(interleave.interleave(_t(x))),
        np.asarray(j_interleave.interleave(jnp.asarray(x))))
    np.testing.assert_array_equal(
        _np(interleave.deinterleave(_t(x))),
        np.asarray(j_interleave.deinterleave(jnp.asarray(x))))


@pytest.mark.parametrize("n", [1, 7, 106, 1506])
def test_crc32(n):
    data = np.random.default_rng(n).integers(0, 256, (3, n), dtype=np.int32)
    got = _np(crc32.crc32(_t(data)))
    want = np.asarray(j_crc32.crc32(jnp.asarray(data))).astype(np.int64)
    np.testing.assert_array_equal(got, want)
    assert got[0] == zlib.crc32(data[0].astype(np.uint8).tobytes())


@pytest.mark.parametrize("rate", RATES)
def test_modulate_demodulate(rate):
    rng = np.random.default_rng(int(rate))
    nbits = 48 * params_for(rate).bpsc
    b = rng.integers(0, 2, (2, nbits), dtype=np.int32)
    _assert_pair_close(qam.modulate_p(_t(b), rate),
                       j_qam.modulate_p(jnp.asarray(b), rate), FLOAT_ATOL)
    # identical float32 inputs: the truncated soft values match exactly
    sym = _f32_pair(rng, (2, 48), 0.7)
    np.testing.assert_array_equal(
        _np(qam.demodulate_p((_t(sym[0]), _t(sym[1])), rate)),
        np.asarray(j_qam.demodulate_p(
            (jnp.asarray(sym[0]), jnp.asarray(sym[1])), rate)))


def test_mapper_and_fft64():
    rng = np.random.default_rng(3)
    data = _f32_pair(rng, (2, 5, 48))
    tdata = (_t(data[0]), _t(data[1]))
    jdata = (jnp.asarray(data[0]), jnp.asarray(data[1]))
    _assert_pair_close(mapper.map_symbols_p(tdata, 2),
                       j_mapper.map_symbols_p(jdata, 2), 0)
    sym = _f32_pair(rng, (2, 5, 64))
    np.testing.assert_array_equal(
        _np(mapper.demap_symbols(_t(sym[0]))),
        np.asarray(j_mapper.demap_symbols(jnp.asarray(sym[0]))))
    tsym = (_t(sym[0]), _t(sym[1]))
    jsym = (jnp.asarray(sym[0]), jnp.asarray(sym[1]))
    _assert_pair_close(fft64.forward_p(tsym), j_fft64.forward_p(jsym),
                       FLOAT_ATOL)
    _assert_pair_close(fft64.inverse_p(tsym), j_fft64.inverse_p(jsym),
                       FLOAT_ATOL)


def _noisy_frames(rng, n_pad=300):
    """Two planar float32 streams: frames at known offsets plus noise."""
    from fun_ofdm_tpu_torch.models import tx

    payload = rng.integers(0, 256, (2, 60), dtype=np.uint8)
    fr, fi = (_np(x) for x in tx.build_frame_p(_t(payload),
                                                Rate.RATE_1_2_QPSK))
    z = np.zeros((2, n_pad), np.float32)
    re = np.concatenate([z, fr, z, fr, z], axis=-1)
    im = np.concatenate([z, fi, z, fi, z], axis=-1)
    re = re + rng.normal(0, 0.01, re.shape).astype(np.float32)
    im = im + rng.normal(0, 0.01, im.shape).astype(np.float32)
    return re, im


def test_correlators():
    rng = np.random.default_rng(4)
    re, im = _noisy_frames(rng)
    x = torch.complex(_t(re), _t(im))
    jx = (jnp.asarray(re), jnp.asarray(im))

    corr, power = correlate.sts_autocorrelation(x)
    jcorr, jpower = j_correlate.sts_autocorrelation(jx)
    _assert_pair_close((corr.real, corr.imag), jcorr, FLOAT_ATOL)
    np.testing.assert_allclose(_np(power), np.asarray(jpower), atol=FLOAT_ATOL)

    ratio = correlate.sts_ratio(x)
    jratio = np.asarray(j_correlate.sts_ratio(jx))
    np.testing.assert_allclose(_np(ratio), jratio, atol=CORR_ATOL)
    # the same ratios in: identical events out
    np.testing.assert_array_equal(
        _np(correlate.sts_end_events(_t(jratio), 0.9, 16)),
        np.asarray(j_correlate.sts_end_events(jnp.asarray(jratio), 0.9, 16)))
    mask = rng.random((2, 700)) < 0.02
    np.testing.assert_array_equal(
        _np(correlate.leading_window_any(_t(mask), 64)),
        np.asarray(j_correlate.leading_window_any(jnp.asarray(mask), 64)))
    for segments in (1, 4):
        np.testing.assert_allclose(
            _np(correlate.lts_correlation(x, segments)),
            np.asarray(j_correlate.lts_correlation(jx, segments)),
            atol=CORR_ATOL)


@pytest.mark.parametrize("n,k,density", [(3000, 6, 0.003),
                                         (20000, 40, 0.002),
                                         (20000, 40, 0.05)])
def test_first_k_true(n, k, density):
    mask = np.random.default_rng(n + k).random((2, n)) < density
    for row in range(2):
        want = j_frontend._first_k_true(jnp.asarray(mask[row]), k)
        got = frontend._first_k_true(_t(mask[row]), k)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_np(g), np.asarray(w))
    # the port's batched form equals its per-row form
    got_b = frontend._first_k_true(_t(mask), k)
    for row in range(2):
        for g, gb in zip(frontend._first_k_true(_t(mask[row]), k), got_b):
            np.testing.assert_array_equal(_np(g), _np(gb[row]))


@pytest.mark.parametrize("rate", RATES)
def test_ppdu_encode_decode(rate):
    rng = np.random.default_rng(int(rate) + 10)
    payload = rng.integers(0, 256, (2, 50), dtype=np.uint8)
    got = ppdu.encode_p(_t(payload), rate)
    want = jax.jit(j_ppdu.encode_p, static_argnums=1)(jnp.asarray(payload),
                                                       rate)
    _assert_pair_close(got, want, FLOAT_ATOL)
    np.testing.assert_allclose(ppdu.header_samples_np(rate, 50),
                               j_ppdu.header_samples_np(rate, 50), atol=0)

    # identical noisy float32 samples through both decoders
    re = _np(got[0]) + rng.normal(0, 0.05, got[0].shape).astype(np.float32)
    im = _np(got[1]) + rng.normal(0, 0.05, got[1].shape).astype(np.float32)
    hdr_t = ppdu.decode_header_p((_t(re[:, :48]), _t(im[:, :48])))
    hdr_j = jax.jit(j_ppdu.decode_header_p)((jnp.asarray(re[:, :48]),
                                             jnp.asarray(im[:, :48])))
    for g, w in zip(hdr_t, hdr_j):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    assert _np(hdr_t[2]).all()
    dat_t = ppdu.decode_data_p((_t(re[:, 48:]), _t(im[:, 48:])), rate, 50)
    dat_j = jax.jit(j_ppdu.decode_data_p, static_argnums=(1, 2))(
        (jnp.asarray(re[:, 48:]), jnp.asarray(im[:, 48:])), rate, 50)
    for g, w in zip(dat_t, dat_j):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    assert _np(dat_t[1]).all()
    np.testing.assert_array_equal(_np(dat_t[0]), payload)


def test_rx_stages():
    rng = np.random.default_rng(6)
    re, im = _noisy_frames(rng, n_pad=150)
    frame_len = (re.shape[-1] - 3 * 150) // 2
    starts = np.array([150, 300 + frame_len], np.int32)
    nsym = params_for(Rate.RATE_1_2_QPSK).num_symbols(60)
    lts_t, syms_t = rx.extract_symbols_p((_t(re), _t(im)), _t(starts), nsym)
    lts_j, syms_j = j_rx.extract_symbols_p(
        (jnp.asarray(re), jnp.asarray(im)), jnp.asarray(starts), nsym)
    _assert_pair_close(lts_t, lts_j, 0)
    _assert_pair_close(syms_t, syms_j, 0)
    # a start near the end: every slice is clamped into the stream
    near_end = np.array([re.shape[-1] - 100, 0], np.int32)
    _assert_pair_close(
        rx.extract_symbols_p((_t(re), _t(im)), _t(near_end), nsym)[1],
        j_rx.extract_symbols_p((jnp.asarray(re), jnp.asarray(im)),
                               jnp.asarray(near_end), nsym)[1], 0)

    h_t = rx.channel_estimate_p(lts_t)
    h_j = j_rx.channel_estimate_p(lts_j)
    _assert_pair_close(h_t, h_j, FLOAT_ATOL)
    _assert_pair_close(rx.equalize_and_track_p(syms_t, h_t),
                       j_rx.equalize_and_track_p(syms_j, h_j), FLOAT_ATOL)

    out_t = rx.decode_frame_p((_t(re), _t(im)), Rate.RATE_1_2_QPSK, 60,
                              start=_t(starts))
    out_j = j_rx.decode_frame_p_jit(Rate.RATE_1_2_QPSK, 60)(
        (jnp.asarray(re), jnp.asarray(im)), start=jnp.asarray(starts))
    assert set(out_t) <= set(out_j)
    for key in out_t:
        np.testing.assert_array_equal(_np(out_t[key]), np.asarray(out_j[key]),
                                      err_msg=key)
    assert _np(out_t["crc_ok"]).all()


def test_viterbi_acs_step_decisions():
    """One ACS step: metrics and decision bits equal the JAX step's."""
    rng = np.random.default_rng(8)
    metrics = rng.integers(0, 256, (5, 64), dtype=np.int32)
    metrics[0, 0] = 211      # forces the renormalisation
    s0, s1 = (rng.integers(0, 256, 5, dtype=np.int32) for _ in range(2))
    new_t, dec_t = viterbi._acs_step(
        _t(metrics), viterbi._branch_metrics(_t(s0), _t(s1)))
    new_j, dec_j = j_viterbi._acs_step(jnp.asarray(metrics), jnp.asarray(s0),
                                       jnp.asarray(s1))
    np.testing.assert_array_equal(_np(new_t), np.asarray(new_j))
    np.testing.assert_array_equal(_np(dec_t), np.asarray(dec_j))


def test_jax_stays_float32_here():
    """Guard for this file's premise: float32 in, float32 out on the JAX
    side even with x64 on."""
    x = np.ones((1, 64), np.float32)
    out = j_fft64.forward_p((jnp.asarray(x), jnp.asarray(x)))
    assert out[0].dtype == jnp.float32
    assert jax.config.jax_enable_x64
