"""The port on the card: the CUDA Viterbi and the capture receive.

These need an NVIDIA GPU with the CUDA toolkit and skip elsewhere. They
import no jax (a GPU machine need not have it), so run them without the
repository's conftest, which does:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

The plain twin, itself held bit-exact against fun_ofdm_tpu on the CPU
(tests/test_torch_viterbi.py), is the reference here.
"""

import numpy as np
import pytest
import torch

from fun_ofdm_tpu_torch.models import frontend, tx
from fun_ofdm_tpu_torch.ops import convcode, viterbi, viterbi_cuda
from fun_ofdm_tpu_torch.rates import Rate

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernels have "
                    "no CPU mode)")
    return torch.device("cuda")


def _noisy_soft(rng, batch, nbits):
    bits = torch.from_numpy(rng.integers(0, 2, size=(batch, nbits + 6)))
    coded = convcode.conv_encode(bits).numpy()
    soft = coded * 255 + rng.integers(-120, 120, coded.shape)
    return torch.from_numpy(np.clip(soft, 0, 255).astype(np.int32))


@pytest.mark.parametrize("nbits,init", [(18, 1), (811, 1), (811, 0)])
def test_kernel_matches_twin(cuda_device, nbits, init):
    """Mixed per-frame lengths, exact or uniform init: decisions and bits
    equal the twin's."""
    rng = np.random.default_rng(nbits + init)
    soft = _noisy_soft(rng, 40, nbits).to(cuda_device)
    nbd = torch.from_numpy(rng.integers(0, nbits + 1, 40)).to(cuda_device)
    steps = viterbi.step_counts(nbits, nbd, (40,), cuda_device)
    init_t = torch.full((40,), init, dtype=torch.int32, device=cuda_device)
    words = viterbi_cuda.acs(soft, steps, init_t)
    bits = viterbi_cuda.chainback(words, nbits)
    dec = viterbi.acs_plain(soft, steps, init_t)
    unpacked = (words[..., None] >> torch.arange(64, device=cuda_device)) & 1
    assert torch.equal(unpacked.to(torch.uint8).cpu(), dec.cpu())
    assert torch.equal(bits.cpu(), viterbi.chainback_plain(dec, nbits).cpu())


def test_capture_on_card_matches_cpu(cuda_device):
    """A noisy 2-channel capture (past the blocked extractor's threshold)
    decodes the same on the card, through the kernels, as on the CPU."""
    rate, length = Rate.RATE_3_4_QAM16, 100
    rng = np.random.default_rng(3)
    payload = torch.from_numpy(rng.integers(0, 256, (2, length),
                                            dtype=np.uint8))
    fre, fim = tx.build_frame_p(payload, rate)
    gap = torch.zeros((2, 300))
    unit_re = torch.cat([fre, gap], dim=1)
    unit_im = torch.cat([fim, gap], dim=1)
    lead = torch.zeros((2, 5000))
    s_re = torch.cat([lead] + [unit_re] * 3, dim=1)
    s_im = torch.cat([lead] + [unit_im] * 3, dim=1)
    sigma = float(np.sqrt(52 / 4096 / 10 ** 2.5 / 2))   # 25 dB SNR
    s_re = s_re + sigma * torch.from_numpy(
        rng.standard_normal(s_re.shape).astype(np.float32))
    s_im = s_im + sigma * torch.from_numpy(
        rng.standard_normal(s_im.shape).astype(np.float32))

    want = frontend.receive_capture_p((s_re, s_im), rate, length, 5)
    before = dict(viterbi_cuda.launches)
    got = frontend.receive_capture_p(
        (s_re.to(cuda_device), s_im.to(cuda_device)), rate, length, 5)
    assert all(viterbi_cuda.launches[k] == before[k] + 2 for k in before)
    for key in ("starts", "valid", "crc_ok", "header_ok"):
        assert torch.equal(got[key].cpu(), want[key]), key
    valid = want["valid"]
    assert torch.equal(got["payload"].cpu()[valid], want["payload"][valid])
    assert int(want["crc_ok"].sum()) == 6
