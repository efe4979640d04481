"""Frame detection on the card: the two kernels of csrc/detect.cu
(ops/detect_cuda.py, taken by models/frontend.detect_frames for a CUDA
tensor) against the plain version, frontend.detect_frames_plain, on the
same card and the same input.

starts, valid and dropped must be equal; the LTS correlation equal to
float32 rounding (the kernel sums its float64 products in another order
and its float32 powers per window, as the plain version does, so the two
differ by an ulp or two). These need an NVIDIA GPU with the CUDA toolkit
and skip elsewhere; they import no jax:

    python -m pytest --noconftest tests/test_torch_detect_hopper.py -q
"""

import numpy as np
import pytest
import torch

from fun_ofdm_tpu_torch.config import ChainParams
from fun_ofdm_tpu_torch.models import frontend, tx
from fun_ofdm_tpu_torch.ops import correlate, detect_cuda
from fun_ofdm_tpu_torch.rates import Rate, params_for

pytestmark = pytest.mark.cuda

RATE = Rate.RATE_3_4_QAM16
#: the frames' mean sample power (52 used subcarriers of a 64-point IFFT)
SIGNAL_POWER = 52 / 4096
#: the K=1 chain's header window: a 4,096-sample read, its halo of one
#: longest frame and the detection lead (runtime/chain.py)
K1_WINDOW = 11216
K1_STEP = 4096
#: thresholds at which AWGN alone makes detection events, more than 16 in
#: many 512-sample blocks
NOISY_PARAMS = ChainParams(plateau_threshold=0.25, sts_plateau_length=2,
                           lts_corr_threshold=0.04)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernels have "
                    "no CPU mode)")
    return torch.device("cuda")


def _frames(rng, count, length):
    """(count, frame_samples) complex64 frames of random payloads."""
    payload = torch.from_numpy(rng.integers(0, 256, (count, length),
                                            dtype=np.uint8))
    fre, fim = tx.build_frame_p(payload, RATE)
    return fre.numpy() + 1j * fim.numpy()


def _awgn(rng, shape, snr_db):
    sigma = np.sqrt(SIGNAL_POWER / 10 ** (snr_db / 10) / 2)
    return sigma * (rng.standard_normal(shape)
                    + 1j * rng.standard_normal(shape))


def _layout(frames, gap, lead=0):
    """The frames back to back, each followed by `gap` zeros, after `lead`
    zeros: a 1-D complex64 stream."""
    parts = [np.zeros(lead)]
    for f in frames:
        parts += [f, np.zeros(gap)]
    return np.concatenate(parts).astype(np.complex64)


def _compare(device, x, k, params=ChainParams(), drop_count_limit=None):
    """Kernels vs plain version on one (..., n) complex64 input; returns
    the kernels' (starts, valid, dropped)."""
    xd = torch.from_numpy(np.ascontiguousarray(x, np.complex64)).to(device)
    before = detect_cuda.launches["detect_frames"]
    got = frontend.detect_frames(xd, k, params, True, drop_count_limit)
    assert detect_cuda.launches["detect_frames"] == before + 1
    want = frontend.detect_frames_plain(xd, k, params, True,
                                        drop_count_limit)
    for name, g, w in zip(("starts", "valid", "dropped"), got, want):
        assert g.shape == w.shape, name
        assert torch.equal(g, w), name
    lts = detect_cuda.detect(xd, k, params,
                             frontend._block_cap(x.shape[-1], k),
                             drop_count_limit, return_lts=True)[3]
    torch.testing.assert_close(
        lts, correlate.lts_correlation(xd, params.lts_segments),
        rtol=1e-5, atol=1e-6)
    return got


def test_capture_like_test_sim(cuda_device):
    """fun_ofdm's test_sim recording, shortened: 100 1500-byte frames back
    to back, every second one with AWGN at 12.5 dB over its SIGNAL and data
    symbols, then a zero pad of 100 frame lengths (the blocked extractor);
    every frame found."""
    rng = np.random.default_rng(14)
    frames = _frames(rng, 100, 1500)
    frames[1::2, 320:] += _awgn(rng, frames[1::2, 320:].shape, 12.5)
    x = np.concatenate([frames.reshape(-1),
                        np.zeros(100 * frames.shape[1])]).astype(np.complex64)
    _, valid, dropped = _compare(cuda_device, x, 100)
    assert int(valid.sum()) == 100 and int(dropped) == 0


def test_k1_windows_with_drop_limit(cuda_device):
    """The K=1 chain's header windows over lone frames with 20,000-sample
    gaps, half of them noisy, at several read offsets; and over AWGN alone
    at thresholds low enough that blocks overflow, the drops counted only
    below the owned region's end."""
    rng = np.random.default_rng(1)
    frames = _frames(rng, 4, 1500)
    frames[1::2] += _awgn(rng, frames[1::2].shape, 12.5)
    x = _layout(frames, 20000, lead=3000)
    found = 0
    for off in range(0, x.size - K1_WINDOW, 5 * K1_STEP // 2):
        _, valid, _ = _compare(cuda_device, x[off:off + K1_WINDOW], 8,
                               drop_count_limit=K1_STEP)
        found += int(valid.sum())
    assert found > 0
    noise = _awgn(rng, (K1_WINDOW,), 0.0).astype(np.complex64)
    for limit in (K1_STEP, None):
        _, _, dropped = _compare(cuda_device, noise, 8, NOISY_PARAMS, limit)
        assert int(dropped) > 0


@pytest.mark.parametrize("n", [frontend._BLOCKED_MIN_N - 1,
                               frontend._BLOCKED_MIN_N,
                               frontend._BLOCKED_MIN_N + 1,
                               frontend._BLOCKED_MIN_N + 700])
def test_both_sides_of_the_blocked_threshold(cuda_device, n):
    """The exact first k below and at _BLOCKED_MIN_N, the blocked one
    above it; frames and noisy events both; and a k past the blocked
    extractor's candidates, which takes the exact path at any n."""
    rng = np.random.default_rng(n)
    x = _layout(_frames(rng, 3, 200), 900, lead=37)[:n]
    x = np.pad(x, (0, n - x.size))
    _compare(cuda_device, x, 5)
    noise = _awgn(rng, (n,), 0.0).astype(np.complex64)
    _compare(cuda_device, noise, 12, NOISY_PARAMS)
    _compare(cuda_device, noise, 16 * (-(-n // 512)) + 1, NOISY_PARAMS)


def test_leading_dims(cuda_device):
    """(2, 2, n) streams, each its own frames at its own offset."""
    rng = np.random.default_rng(22)
    rows = [_layout(_frames(rng, 3, 300), 700 + 100 * i, lead=50 * i)
            for i in range(4)]
    n = max(r.size for r in rows) + 300
    x = np.stack([np.pad(r, (0, n - r.size)) for r in rows]).reshape(2, 2, n)
    starts, valid, dropped = _compare(cuda_device, x, 5)
    assert valid.shape == (2, 2, 5) and dropped.shape == (2, 2)
    assert int(valid.sum()) == 12


def test_cfo_segments(cuda_device):
    """A carrier offset of 4e-3 cycles/sample, where the coherent filter
    collapses and lts_segments=4 keeps the frames."""
    rng = np.random.default_rng(4)
    x = _layout(_frames(rng, 6, 500), 400, lead=123)
    x = (x * np.exp(2j * np.pi * 4e-3 * np.arange(x.size))
         + _awgn(rng, x.shape, 24.0)).astype(np.complex64)
    starts, valid, _ = _compare(cuda_device, x, 8,
                                ChainParams(lts_segments=4))
    # every frame found (the rotated data can make a false start too)
    period = params_for(RATE).frame_samples(500) + 400
    assert {123 + period * i for i in range(6)} <= set(starts[valid].tolist())
    _compare(cuda_device, x, 8)


@pytest.mark.parametrize("segments", [1, 2, 8, 16, 32, 64])
def test_every_segmentation(cuda_device, segments):
    rng = np.random.default_rng(segments)
    x = _layout(_frames(rng, 3, 100), 600, lead=10)
    x = (x + _awgn(rng, x.shape, 20.0)).astype(np.complex64)
    _compare(cuda_device, x, 4, ChainParams(lts_segments=segments))


@pytest.mark.parametrize("lts_search,threshold", [(96, 0.9), (128, 0.5),
                                                  (300, 0.9), (1000, 0.7)])
def test_search_and_thresholds(cuda_device, lts_search, threshold):
    rng = np.random.default_rng(lts_search)
    x = _layout(_frames(rng, 4, 200), 1500, lead=7)
    x = (x + _awgn(rng, x.shape, 14.0)).astype(np.complex64)
    params = ChainParams(lts_search=lts_search, plateau_threshold=threshold,
                         lts_corr_threshold=threshold)
    _compare(cuda_device, np.tile(x, 3), 12, params)


def test_noise_overflows_blocks(cuda_device):
    """AWGN alone over 100,000 samples, thresholds low enough that many
    512-blocks hold more than 16 events: the drops counted, everywhere and
    below a limit, and the slots filled from the first 16 of each block."""
    rng = np.random.default_rng(5)
    noise = _awgn(rng, (100000,), 0.0).astype(np.complex64)
    for limit in (None, 40000, 0):
        _, _, dropped = _compare(cuda_device, noise, 64, NOISY_PARAMS, limit)
        assert (int(dropped) > 0) == (limit != 0)


def test_frames_cut_at_either_end(cuda_device):
    """The stream starts inside a frame's preamble and ends inside another
    frame's LTS and inside its plateau."""
    rng = np.random.default_rng(6)
    x = _layout(_frames(rng, 5, 300), 500)
    length = params_for(RATE).frame_samples(300) + 500
    for lo, hi in ((100, 4 * length + 200), (170, 4 * length + 100),
                   (0, 4 * length + 60)):
        _compare(cuda_device, x[lo:hi], 6)
        _compare(cuda_device, np.tile(x[lo:hi], 3), 20)


def test_equal_lts_values_take_the_lower_position(cuda_device):
    """An STS plateau followed by the LTS repeated 6 times: the filter's
    peaks 64 apart are equal to the last bit on both sides, so the top 5
    is decided by the tie rule (the lower position first)."""
    from fun_ofdm_tpu_torch import preamble

    sts = np.tile(preamble.STS_TIME_DOMAIN, 10)
    lts = np.tile(preamble.LTS_TIME_DOMAIN, 6)
    unit = np.concatenate([np.zeros(300), sts, lts, np.zeros(300)])
    x = np.tile(unit, 20).astype(np.complex64)
    xd = torch.from_numpy(x).to(cuda_device)
    norm = correlate.lts_correlation(xd).cpu().numpy()
    peaks = norm[300 + 160:300 + 160 + 6 * 64:64]
    assert np.all(peaks == peaks[0]) and peaks[0] > 0.9
    _compare(cuda_device, x, 24)
    _compare(cuda_device, x, 24, ChainParams(lts_search=400))


def test_wrapper_refuses_what_it_does_not_take(cuda_device):
    x = torch.zeros(4096, dtype=torch.complex64, device=cuda_device)
    with pytest.raises(TypeError):
        frontend.detect_frames(x.to(torch.complex128), 4)
    with pytest.raises(TypeError):
        frontend.detect_frames(x.real.to(torch.float64), 4)
    with pytest.raises(ValueError):
        frontend.detect_frames(torch.zeros((4096, 2), dtype=torch.complex64,
                                           device=cuda_device).T, 4)
    with pytest.raises(ValueError):
        frontend.detect_frames(x, 4, ChainParams(lts_segments=3))


def test_every_receive_path_launches_the_kernels(cuda_device):
    """The capture receive, the dynamic and any-rate receive and the K=1
    header pass each detect through the kernels, once a call."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy(_layout(_frames(rng, 2, 100), 300, lead=40))
    planar = (x.real.contiguous().to(cuda_device),
              x.imag.contiguous().to(cuda_device))
    detect_cuda.reset_launches()
    out = frontend.receive_capture_p(planar, RATE, 100, 4)
    assert int(out["crc_ok"].sum()) == 2
    frontend.receive_capture_dynamic_p(planar, RATE, 100, 4)
    frontend.receive_capture_anyrate_p(planar, (RATE,), 100, 4)
    frontend.decode_headers_p(planar, 4, drop_count_limit=1000)
    assert detect_cuda.launches == {"detect_frames": 4}
