"""The port's main path against fun_ofdm_tpu on the CPU: TX frames and
the dense capture receive.

TX frames are float32 and match the JAX frames to atol=1e-4. The capture
receive compares the integer outputs exactly: frame starts, validity,
crc_ok, header_ok, and the payloads of the valid slots (an invalid slot
decodes whatever lies at sample 0, and its payload is unspecified). The
JAX side is `jax.vmap(frontend.receive_capture_p)` over the channels; the
port takes the (channels, n) streams directly. Streams on both sides of
8192 samples cover both slot extractors; the AWGN noise is drawn with
numpy and added to both inputs.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fun_ofdm_tpu.models import frontend as j_frontend
from fun_ofdm_tpu.models import tx as j_tx
from fun_ofdm_tpu.sim.channel import DEFAULT_SIGNAL_POWER
from fun_ofdm_tpu_torch.models import frontend, tx
from fun_ofdm_tpu_torch.rates import Rate

torch.set_num_threads(1)

FLOAT_ATOL = 1e-4
RATE = Rate.RATE_3_4_QAM16
LENGTH = 100
CHANNELS = 2
FRAMES = 3
MAX_FRAMES = 5
GAP = 300
#: the high-SNR point of tests/test_channel_sim.py
SNR_DB = 25.0


@pytest.mark.parametrize("rate", list(Rate))
def test_tx_frames_match_jax(rate):
    payload = np.random.default_rng(int(rate)).integers(
        0, 256, size=(2, LENGTH), dtype=np.uint8)
    got = tx.build_frame_p(torch.from_numpy(payload), rate)
    want = j_tx.build_frame_p_jit(rate)(jnp.asarray(payload))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=FLOAT_ATOL)


@functools.lru_cache(maxsize=None)
def _jax_capture():
    return jax.jit(jax.vmap(lambda r, i: j_frontend.receive_capture_p(
        (r, i), RATE, LENGTH, MAX_FRAMES)))


def _streams(lead: int, seed: int = 0):
    """(CHANNELS, n) float32 planar streams: `lead` zeros, then FRAMES
    frames of one payload per channel, each followed by GAP zeros."""
    payload = np.random.default_rng(seed).integers(
        0, 256, size=(CHANNELS, LENGTH), dtype=np.uint8)
    fre, fim = (np.asarray(x)
                for x in j_tx.build_frame_p_jit(RATE)(jnp.asarray(payload)))

    def lay_out(f):
        unit = np.concatenate([f, np.zeros((CHANNELS, GAP), np.float32)], 1)
        return np.concatenate(
            [np.zeros((CHANNELS, lead), np.float32)] + [unit] * FRAMES,
            axis=1).astype(np.float32)

    return lay_out(fre), lay_out(fim), payload


def _compare(s_re, s_im, payload):
    want = _jax_capture()(jnp.asarray(s_re), jnp.asarray(s_im))
    got = frontend.receive_capture_p(
        (torch.from_numpy(s_re), torch.from_numpy(s_im)), RATE, LENGTH,
        MAX_FRAMES)
    for key in ("starts", "valid", "crc_ok", "header_ok"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    valid = np.asarray(want["valid"])
    np.testing.assert_array_equal(got["payload"].numpy()[valid],
                                  np.asarray(want["payload"])[valid])
    crc_ok = got["crc_ok"].numpy()
    assert crc_ok.sum() == CHANNELS * FRAMES
    for c in range(CHANNELS):
        for slot in np.nonzero(crc_ok[c])[0]:
            np.testing.assert_array_equal(got["payload"][c, slot].numpy(),
                                          payload[c])
    return got


@pytest.mark.parametrize("lead", [100, 5000])
def test_capture_matches_jax(lead):
    s_re, s_im, payload = _streams(lead)
    # one stream on each side of the blocked extractor's threshold
    assert (s_re.shape[-1] > frontend._BLOCKED_MIN_N) == (lead == 5000)
    got = _compare(s_re, s_im, payload)
    starts = got["starts"].numpy()
    frame_len = (s_re.shape[-1] - lead) // FRAMES - GAP
    want_starts = [lead + k * (frame_len + GAP) for k in range(FRAMES)]
    assert (starts[:, :FRAMES] == want_starts).all()


def test_capture_awgn_matches_jax():
    s_re, s_im, payload = _streams(5000, seed=1)
    rng = np.random.default_rng(25)
    sigma = np.sqrt(DEFAULT_SIGNAL_POWER / 10 ** (SNR_DB / 10) / 2)
    s_re = (s_re + sigma * rng.standard_normal(s_re.shape)).astype(np.float32)
    s_im = (s_im + sigma * rng.standard_normal(s_im.shape)).astype(np.float32)
    _compare(s_re, s_im, payload)
