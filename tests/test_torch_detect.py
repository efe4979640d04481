"""Frame detection's CUDA route on the CPU: what the kernels of
csrc/detect.cu hard-code equals what the port computes, and a CPU tensor
takes the plain version without building or launching anything (the
kernels themselves run in tests/test_torch_detect_hopper.py, on a card)."""

import re

import numpy as np
import pytest
import torch

from fun_ofdm_tpu_torch import preamble
from fun_ofdm_tpu_torch.config import ChainParams
from fun_ofdm_tpu_torch.models import frontend, tx
from fun_ofdm_tpu_torch.ops import detect_cuda
from fun_ofdm_tpu_torch.rates import Rate

SOURCE = detect_cuda.SOURCE.read_text()


def _cu_array(name):
    body = re.search(rf"__constant__ double {name}\[64\] = \{{([^}}]*)\}};",
                     SOURCE).group(1)
    return np.array([float(v) for v in body.replace("\n", " ").split(",")
                     if v.strip()])


def test_taps_are_the_conjugate_lts():
    taps = np.asarray(preamble.LTS_TIME_DOMAIN_CONJ)
    np.testing.assert_array_equal(_cu_array("kLtsRe"), taps.real)
    np.testing.assert_array_equal(_cu_array("kLtsIm"), taps.imag)


def test_block_is_the_extractors_block():
    block = int(re.search(r"constexpr int kBlock = (\d+);", SOURCE).group(1))
    assert block == detect_cuda.BLOCK == frontend._BLOCK
    # the cap comes from frontend at each call; a block holds every event
    # of the exact path
    assert frontend._BLOCK_CAP < block
    assert frontend._BLOCKED_MIN_N % block == 0


def _stream(seed, n):
    rng = np.random.default_rng(seed)
    payload = torch.from_numpy(rng.integers(0, 256, (2, 60), dtype=np.uint8))
    fre, fim = tx.build_frame_p(payload, Rate.RATE_3_4_QAM16)
    x = torch.complex(fre, fim).reshape(-1)
    return torch.nn.functional.pad(x, (100, n - 100 - x.numel()))


@pytest.mark.parametrize("n,dropped_limit", [(4000, None), (9000, 3000)])
def test_cpu_tensor_takes_the_plain_version(n, dropped_limit):
    """detect_frames on a CPU tensor is detect_frames_plain, and neither
    builds the library nor counts a launch."""
    detect_cuda.reset_launches()
    x = _stream(n, n)
    got = frontend.detect_frames(x, 4, ChainParams(), True, dropped_limit)
    want = frontend.detect_frames_plain(x, 4, ChainParams(), True,
                                        dropped_limit)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(got[1].sum()) == 2
    assert detect_cuda.launches == {"detect_frames": 0}
    assert detect_cuda.build.cache_info().currsize == 0


def test_wrapper_refuses_a_cpu_tensor():
    with pytest.raises(ValueError, match="CUDA"):
        detect_cuda.detect(_stream(0, 2000), 4, ChainParams(), 512)


@pytest.mark.parametrize("n,max_frames,cap", [
    (frontend._BLOCKED_MIN_N, 4, frontend._BLOCK),
    (frontend._BLOCKED_MIN_N + 1, 4, frontend._BLOCK_CAP),
    (frontend._BLOCKED_MIN_N + 1, 17 * frontend._BLOCK_CAP,
     frontend._BLOCK_CAP),
    (frontend._BLOCKED_MIN_N + 1, 17 * frontend._BLOCK_CAP + 1,
     frontend._BLOCK)])
def test_block_cap_follows_the_extractor(n, max_frames, cap):
    """The cap the kernels take is the rule _first_k_true picks its
    extractor by: blocked above _BLOCKED_MIN_N while its candidates cover
    max_frames."""
    assert frontend._block_cap(n, max_frames) == cap
    mask = torch.zeros(n, dtype=torch.bool)
    blocked = frontend._first_k_true_blocked(mask, max_frames)
    assert (blocked is not None and n > frontend._BLOCKED_MIN_N) == (
        cap == frontend._BLOCK_CAP)
