"""The port on the card: the CUDA Viterbi (its ablation variants
included), the capture receive, the streaming chain with and without CFO
correction, and the BER harness.

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

from fun_ofdm_tpu_torch.config import ChainParams
from fun_ofdm_tpu_torch.models import frontend, tx
from fun_ofdm_tpu_torch.ops import (convcode, viterbi, viterbi_ab,
                                    viterbi_blocked, viterbi_cuda)
from fun_ofdm_tpu_torch.rates import Rate
from fun_ofdm_tpu_torch.runtime import chain

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


@pytest.mark.parametrize("kind", ["erasure", "hard", "uniform_init"])
def test_acs_extremes_match_plain(cuda_device, kind):
    """All-127 and hard 0/255 inputs (saturation, frequent
    renormalisation) and the uniform init, 37 frames of mixed lengths:
    decision words equal the plain version's."""
    rng = np.random.default_rng(23)
    soft = _noisy_soft(rng, 37, 600)
    if kind == "erasure":
        soft = torch.full_like(soft, 127)
    elif kind == "hard":
        soft = torch.where(soft >= 128, 255, 0).to(torch.int32)
    soft = soft.to(cuda_device)
    nbd = torch.from_numpy(rng.integers(0, 601, 37)).to(cuda_device)
    steps = viterbi.step_counts(600, nbd, (37,), cuda_device)
    init = torch.full((37,), 0 if kind == "uniform_init" else 1,
                      dtype=torch.int32, device=cuda_device)
    words = viterbi_cuda.acs(soft, steps, init)
    unpacked = (words[..., None] >> torch.arange(64, device=cuda_device)) & 1
    assert torch.equal(unpacked.to(torch.uint8).cpu(),
                       viterbi.acs_plain(soft, steps, init).cpu())


@pytest.mark.parametrize("batch,nbits", [(37, 18), (19, 250), (19, 256),
                                         (19, 257), (33, 1000), (16, 515)])
def test_chainback_segments_match_plain(cuda_device, batch, nbits):
    """The segmented chainback on random decision words: below one
    segment (the 18-bit header), exactly one, one plus a 1-step segment,
    a batch that is not a multiple of the frame group, and dead steps
    (zero words past each frame's count)."""
    rng = np.random.default_rng(batch * 1000 + nbits)
    total = nbits + 6
    words = torch.from_numpy(rng.integers(-2**63, 2**63 - 1, (total, batch),
                                          dtype=np.int64))
    live = torch.from_numpy(rng.integers(0, total + 1, batch))
    words[torch.arange(total)[:, None] >= live[None, :]] = 0
    words = words.to(cuda_device)
    before = viterbi_cuda.launches["viterbi_chainback"]
    bits = viterbi_cuda.chainback(words, nbits)
    assert viterbi_cuda.launches["viterbi_chainback"] == before + 1
    dec = (words[..., None] >> torch.arange(64, device=cuda_device)) & 1
    assert torch.equal(bits.cpu(),
                       viterbi.chainback_plain(dec.to(torch.uint8), nbits)
                       .cpu())


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
    # one header and one payload launch of the exact pair, no blocked one
    assert {k: viterbi_cuda.launches[k] - before[k] for k in before} == {
        "viterbi_acs": 2, "viterbi_chainback": 2,
        "viterbi_acs_windowed": 0, "viterbi_splice_guard": 0,
        "viterbi_acs_ablate": 0}
    for key in ("starts", "valid", "crc_ok", "header_ok"):
        assert torch.equal(got[key].cpu(), want[key]), key
    valid = want["valid"]
    assert torch.equal(got["payload"].cpu()[valid], want["payload"][valid])
    assert int(want["crc_ok"].sum()) == 6


@pytest.mark.parametrize("frames,nbits,warmup", [(4, 12090, 128),
                                                 (8, 1200, 2)])
def test_blocked_kernels_match_plain(cuda_device, frames, nbits, warmup):
    """The block-overlap decode through its kernels equals its plain
    version on the same card: bits and merge flags, mixed lengths (and,
    at warm-up 2, forced splice failures)."""
    rng = np.random.default_rng(frames)
    soft = _noisy_soft(rng, frames, nbits).to(cuda_device)
    nbd = torch.from_numpy(rng.integers(nbits // 2, nbits + 1, frames))
    steps = viterbi.step_counts(nbits, nbd, (frames,), cuda_device)
    geo = viterbi_blocked.geometry(nbits, 16, warmup)
    before = dict(viterbi_cuda.launches)
    bits, ok = viterbi_blocked.decode_cuda(soft.contiguous(), steps, geo)
    assert viterbi_cuda.launches["viterbi_acs_windowed"] == \
        before["viterbi_acs_windowed"] + 1
    assert viterbi_cuda.launches["viterbi_splice_guard"] == \
        before["viterbi_splice_guard"] + 1
    want_bits, want_ok = viterbi_blocked.decode_plain(soft, steps, geo)
    assert torch.equal(bits.cpu(), want_bits.cpu())
    assert torch.equal(ok.cpu(), want_ok.cpu())


def test_dense_chain_on_card_matches_cpu(cuda_device):
    """A ReceiverChain on the card delivers the same packets as the same
    chain on the CPU, and its small buckets go through the block-overlap
    kernels."""
    rate, length = Rate.RATE_3_4_QAM16, 100
    rng = np.random.default_rng(5)
    payload = torch.from_numpy(rng.integers(0, 256, (6, length),
                                            dtype=np.uint8))
    fre, fim = (f.numpy() for f in tx.build_frame_p(payload, rate))
    n, pos = 40000, 300
    s_re, s_im = np.zeros(n, np.float32), np.zeros(n, np.float32)
    for k in range(6):
        s_re[pos:pos + fre.shape[1]], s_im[pos:pos + fim.shape[1]] = \
            fre[k], fim[k]
        pos += fre.shape[1] + 3000 + 500 * k

    def run(device):
        c = chain.ReceiverChain(rates=(rate,), max_length=length,
                                params=ChainParams(chunk_size=4096,
                                                   strides_per_step=2),
                                ingest_dtype="int12", device=device)
        pkts = []
        for i in range(0, n, 5000):
            pkts += c.process_samples((s_re[i:i + 5000], s_im[i:i + 5000]))
        return [(p.payload, p.rate, p.start) for p in pkts + c.flush()], c

    want, _ = run("cpu")
    before = viterbi_cuda.launches["viterbi_acs_windowed"]
    got, c = run(cuda_device)
    assert got == want and len(got) == 6
    assert viterbi_cuda.launches["viterbi_acs_windowed"] > before
    assert c.stats.crc_ok == 6


@pytest.mark.parametrize("mode", viterbi_ab.MODES)
def test_ablation_kernel_matches_plain(cuda_device, mode):
    """Every ablation variant: final metrics and decision words equal the
    plain version's, mixed lengths and both inits; "full" also equals
    the production ACS kernel's words."""
    rng = np.random.default_rng(11)
    soft = _noisy_soft(rng, 24, 700).to(cuda_device)
    steps = torch.from_numpy(rng.integers(0, 707, 24) // 2 * 2).to(
        cuda_device, torch.int32)
    init = torch.from_numpy(rng.integers(0, 2, 24)).to(cuda_device,
                                                       torch.int32)
    before = viterbi_cuda.launches["viterbi_acs_ablate"]
    final, dec = viterbi_cuda.acs_ablate(soft, steps, init, mode)
    assert viterbi_cuda.launches["viterbi_acs_ablate"] == before + 1
    want_final, want_dec = viterbi_ab.acs_ablate_plain(soft, steps, init,
                                                       mode)
    assert torch.equal(final.cpu(), want_final.cpu())
    assert (dec is None) == (want_dec is None) == (mode == "nostore")
    if dec is not None:
        assert torch.equal(dec.cpu(), want_dec.cpu())
    if mode == "full":
        assert torch.equal(dec, viterbi_cuda.acs(soft, steps, init))


def test_cfo_chain_on_card_matches_cpu(cuda_device):
    """A stream rotated by 8e-3 cycles/sample through the CFO chain
    (lts_segments=4, cfo_correct=True): the card delivers what the CPU
    delivers, both frames."""
    rate, length = Rate.RATE_3_4_QAM16, 80
    rng = np.random.default_rng(17)
    payload = torch.from_numpy(rng.integers(0, 256, (1, length),
                                            dtype=np.uint8))
    fre, fim = (f.numpy()[0] for f in tx.build_frame_p(payload, rate))
    n = 16384
    base = np.zeros(n, np.complex64)
    for p in (600, 9000):
        base[p:p + fre.size] = fre + 1j * fim
    sigma = np.sqrt(np.mean(fre ** 2 + fim ** 2) / (2 * 10 ** 2.4))
    rot = base * np.exp(2j * np.pi * 8e-3 * np.arange(n))
    rot = (rot + sigma * (rng.normal(size=n) + 1j * rng.normal(size=n))
           ).astype(np.complex64)

    def run(device):
        c = chain.ReceiverChain(rates=(rate,), max_length=length,
                                params=ChainParams(lts_segments=4),
                                cfo_correct=True, device=device)
        return [(p.payload, p.start) for p in
                c.process_samples(rot) + c.flush()]

    want = run("cpu")
    assert run(cuda_device) == want and [s for _, s in want] == [600, 9000]


def test_error_rates_on_card(cuda_device):
    """The BER harness runs on the card through the kernels: no errors at
    30 dB, all frames lost at -5 dB, in both modes."""
    from fun_ofdm_tpu_torch.sim import ber

    before = viterbi_cuda.launches["viterbi_acs"]
    r = ber.error_rates(Rate.RATE_1_2_QPSK, 100, (-5.0, 30.0), n_frames=32,
                        device=cuda_device)
    assert list(r.per) == [1.0, 0.0] and r.ber[1] == 0.0
    d = ber.error_rates(Rate.RATE_1_2_QPSK, 100, (-5.0, 30.0), n_frames=16,
                        batch=16, detect=True, device=cuda_device)
    assert d.per[0] > 0.9 and d.per[1] == 0.0
    assert viterbi_cuda.launches["viterbi_acs"] > before
