"""The port's channel simulator and BER/PER harness against fun_ofdm_tpu,
on the CPU.

Channel functions take the same float32 inputs on both sides and must
agree to atol 1e-5 (AWGN on JAX's own normal draws). A sync trial and a
detect trial go through both packages on the same payloads, offsets and
noise and must count the same failures (and bit errors). The port's
error_rates, whose torch.Generator draws differ from jax.random's, is
held to docs/ber_data.json (tools/ber_baseline.py's artifact of the JAX
harness) within 4 * sqrt(2 p (1 - p) / n) + 2 / n at a few points. JAX
inputs are float32 (tests/conftest.py enables x64).
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fun_ofdm_tpu.models import frontend as j_frontend
from fun_ofdm_tpu.models import rx as j_rx
from fun_ofdm_tpu.models import tx as j_tx
from fun_ofdm_tpu.sim import channel as j_channel
from fun_ofdm_tpu.utils.bits import bytes_to_bits as j_bytes_to_bits
from fun_ofdm_tpu_torch.rates import Rate, params_for
from fun_ofdm_tpu_torch.sim import ber, channel

torch.set_num_threads(1)

ATOL = 1e-5
BER_DATA = Path(__file__).resolve().parent.parent / "docs" / "ber_data.json"


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _pair(rng, shape, scale=0.1):
    return (rng.normal(0, scale, shape).astype(np.float32),
            rng.normal(0, scale, shape).astype(np.float32))


def _both(x):
    return (tuple(torch.from_numpy(a) for a in x),
            tuple(jnp.asarray(a) for a in x))


def _close(got, want, atol=ATOL):
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=0, atol=atol)


@pytest.mark.parametrize("freq", [2e-4, 4e-3, -8e-3])
def test_cfo_matches_jax(freq):
    t, j = _both(_pair(np.random.default_rng(1), (3, 6000)))
    _close(channel.cfo(t, freq), j_channel.cfo(j, np.float32(freq)))


def test_phase_scale_delay_multipath_match_jax():
    t, j = _both(_pair(np.random.default_rng(2), (2, 500)))
    _close(channel.phase(t, 0.7), j_channel.phase(j, np.float32(0.7)))
    _close(channel.scale(t, 1.3), j_channel.scale(j, np.float32(1.3)))
    got, want = channel.delay(t, 17), j_channel.delay(j, 17)
    assert got[0].shape == (2, 517)
    _close(got, want)
    for taps in ((1.0, 0.25 + 0.15j), (1.0, 0.0, 0.25 + 0.2j, 0.0, 0.1j),
                 (0.5j,)):
        _close(channel.multipath(t, taps), j_channel.multipath(j, taps))


@pytest.mark.parametrize("snr", [0.0, 12.5, [3.0, 25.0]])
def test_awgn_on_jax_draws_matches_jax(snr):
    """The port's awgn given the standard normals that fun_ofdm_tpu's
    awgn draws from its key gives fun_ofdm_tpu's output."""
    t, j = _both(_pair(np.random.default_rng(3), (2, 400)))
    key = jax.random.PRNGKey(5)
    k1, k2 = jax.random.split(key)
    noise = tuple(np.array(jax.random.normal(k, (2, 400), jnp.float32))
                  for k in (k1, k2))
    snr_j = jnp.asarray(snr, jnp.float32)
    want = j_channel.awgn(j, key, snr_j)
    got = channel.awgn(t, None, torch.tensor(snr), noise=noise)
    _close(got, want)
    assert channel.DEFAULT_SIGNAL_POWER == j_channel.DEFAULT_SIGNAL_POWER


def test_awgn_generator_power_and_rayleigh_taps():
    z = torch.zeros(64, 4096)
    g = torch.Generator().manual_seed(0)
    re, im = channel.awgn((z, z), g, 10.0)
    var = float((re.square() + im.square()).mean())
    assert abs(var / (channel.DEFAULT_SIGNAL_POWER / 10) - 1) < 0.02
    re2, _ = channel.awgn((z, z), torch.Generator().manual_seed(0), 10.0)
    assert torch.equal(re, re2)
    taps = channel.rayleigh_taps(torch.Generator().manual_seed(1), 5)
    assert taps.shape == (5,) and taps.dtype == np.complex128
    assert abs(np.sum(np.abs(taps) ** 2) - 1) < 1e-12


def _jax_impair(frame, snr, cfo_norm, taps, noise):
    """fun_ofdm_tpu's sim.ber._impair with the AWGN draws given."""
    if taps is not None:
        frame = j_channel.multipath(frame, taps)
    if cfo_norm:
        frame = j_channel.cfo(frame, np.float32(cfo_norm))
    sigma = jnp.sqrt(j_channel.DEFAULT_SIGNAL_POWER
                     / 10.0 ** (jnp.asarray(snr, jnp.float32) / 10.0)
                     / 2.0)[:, None]
    return (frame[0] + sigma * noise[0], frame[1] + sigma * noise[1])


@pytest.mark.parametrize("cfo_norm,taps,cfo_correct", [
    (0.0, None, False), (2e-4, (1.0, 0.25 + 0.15j), True)])
def test_sync_trial_matches_jax(cfo_norm, taps, cfo_correct):
    rate, length, frames = Rate.RATE_3_4_QAM16, 60, 12
    rng = np.random.default_rng(6)
    payload = rng.integers(0, 256, (frames, length)).astype(np.int32)
    snr = np.linspace(8.0, 20.0, frames).astype(np.float32)
    n = params_for(rate).frame_samples(length)
    noise = _pair(rng, (frames, n), 1.0)
    fails, bit_err = ber.sync_trial(torch.from_numpy(payload), rate,
                                    torch.from_numpy(snr), cfo_norm, taps,
                                    cfo_correct, noise=noise)
    frame = j_tx.build_frame_p(jnp.asarray(payload), rate)
    frame = _jax_impair(frame, snr, cfo_norm, taps,
                        tuple(jnp.asarray(a) for a in noise))
    out = j_rx.decode_frame_p(frame, rate, length, cfo_correct=cfo_correct)
    want_fails = ~np.asarray(out["crc_ok"])
    want_err = np.asarray(j_bytes_to_bits(jnp.asarray(payload))
                          != j_bytes_to_bits(out["payload"])).sum(-1)
    np.testing.assert_array_equal(_np(fails), want_fails)
    np.testing.assert_array_equal(_np(bit_err), want_err)
    assert 0 < int(_np(fails).sum()) < frames     # both outcomes occur


def test_detect_trial_matches_jax():
    rate, length, frames, pad = Rate.RATE_1_2_QPSK, 40, 8, 64
    rng = np.random.default_rng(7)
    payload = rng.integers(0, 256, (frames, length)).astype(np.int32)
    offsets = rng.integers(0, pad, frames)
    snr = np.linspace(-2.0, 12.0, frames).astype(np.float32)
    flen = params_for(rate).frame_samples(length)
    n = flen + 2 * pad
    noise = _pair(rng, (frames, n), 1.0)
    fails = ber.detect_trial(torch.from_numpy(payload),
                             torch.from_numpy(offsets), rate,
                             torch.from_numpy(snr), pad, 4, noise=noise)
    fre, fim = (np.asarray(f, np.float32) for f in
                j_tx.build_frame_p(jnp.asarray(payload), rate))
    re, im = np.zeros((frames, n), np.float32), np.zeros((frames, n),
                                                         np.float32)
    for k, o in enumerate(offsets):
        re[k, o:o + flen], im[k, o:o + flen] = fre[k], fim[k]
    stream = _jax_impair((jnp.asarray(re), jnp.asarray(im)), snr, 0.0, None,
                         tuple(jnp.asarray(a) for a in noise))
    want = []
    for k in range(frames):
        out = j_frontend.receive_capture_p((stream[0][k], stream[1][k]),
                                           rate, length, 4)
        match = np.all(np.asarray(out["payload"]) == payload[k][None, :],
                       axis=-1)
        want.append(not bool(np.any(np.asarray(out["crc_ok"]) & match)))
    np.testing.assert_array_equal(_np(fails), np.array(want))
    assert 0 < sum(want) < frames


def _artifact(mode, channel_name, rate):
    data = json.loads(BER_DATA.read_text())
    for c in data["curves"]:
        if (c["mode"], c["channel"], c["rate"]) == (mode, channel_name,
                                                    rate):
            return c, c.get("snr_db", data["snr_db"])
    raise KeyError((mode, channel_name, rate))


@pytest.mark.parametrize("rate,snrs", [
    (Rate.RATE_1_2_BPSK, (0, 2, 4)), (Rate.RATE_3_4_QAM16, (12, 14))])
def test_error_rates_agree_with_artifact(rate, snrs):
    """The port's harness at a few points of the JAX artifact's sync AWGN
    curves (200-byte frames), 64 frames per point."""
    curve, grid = _artifact("sync", "awgn", rate.name)
    res = ber.error_rates(rate, 200, snrs, n_frames=64, batch=32, seed=3,
                          device="cpu")
    assert res.n_frames == 64 and res.ber.shape == (len(snrs),)
    for s, p in zip(snrs, res.per):
        ref = curve["per"][grid.index(s)]
        bound = ber.binomial_bound(p, ref, 64)
        assert abs(p - ref) <= bound, (rate.name, s, p, ref, bound)


def test_error_rates_detect_mode_shape():
    res = ber.error_rates(Rate.RATE_1_2_BPSK, 16, (-5.0, 30.0), n_frames=4,
                          batch=4, detect=True, pad=32, device="cpu")
    assert np.isnan(res.ber).all()
    assert res.per[0] >= 0.75 and res.per[1] == 0.0
