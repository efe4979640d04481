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
from fun_ofdm_tpu_torch.models import frontend, rx, tx
from fun_ofdm_tpu_torch.ops import (convcode, viterbi, viterbi_ab,
                                    viterbi_blocked, viterbi_cuda)
from fun_ofdm_tpu_torch.rates import Rate
from fun_ofdm_tpu_torch.runtime import chain
from fun_ofdm_tpu_torch.utils import trace

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


@pytest.mark.parametrize("nbits,init", [(18, 1), (811, 1), (811, 0),
                                        (16194, 1), (16074, 1)])
def test_kernel_matches_twin(cuda_device, nbits, init):
    """Mixed per-frame lengths, exact or uniform init: decisions and bits
    equal the twin's. 16,194 and 16,074 bits are the any-rate trellises of
    the two length classes of an all-rates chain at max_length 2000."""
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
        "viterbi_blocked_decode": 0, "viterbi_acs_ablate": 0}
    for key in ("starts", "valid", "crc_ok", "header_ok"):
        assert torch.equal(got[key].cpu(), want[key]), key
    valid = want["valid"]
    assert torch.equal(got["payload"].cpu()[valid], want["payload"][valid])
    assert int(want["crc_ok"].sum()) == 6


@pytest.mark.parametrize("frames,nbits,n_blocks,warmup,kind", [
    (4, 12090, 16, 128, "mixed"), (16, 12090, 16, 128, "mixed"),
    (64, 12090, 16, 128, "mixed"), (8, 1200, 16, 2, "mixed"),
    (64, 16194, 16, 128, "mixed"), (16, 16074, 16, 128, "mixed"),
    (16, 12090, 16, 128, "zero"), (16, 12090, 16, 128, "noinfo"),
    (4, 210, 16, 128, "mixed"), (4, 12090, 2, 128, "mixed")])
def test_blocked_kernels_match_plain(cuda_device, frames, nbits, n_blocks,
                                     warmup, kind):
    """The block-overlap decode through its kernels equals its plain
    version on the same card: bits and merge flags, mixed lengths (and,
    at warm-up 2, forced splice failures), every frame of length 0, and
    uniform soft pairs that carry no information (survivor paths meet
    late, so the traceback's corrections take several rounds); the overlap
    words equal their plain form. 4, 16 and 64 frames of 12,090 bits are
    the streaming chain's small buckets at 1500 bytes; 16,194 and 16,074
    bits the windows of an all-rates chain at max_length 2000; 210 bits
    (one 54 Mbit/s symbol) one block whose span is shorter than its
    lead-in; 2 blocks of 12,090 bits a window of 6,304 steps, whose
    shared memory (62 KB) is past the 48 KB default. One call is one
    launch of viterbi_blocked_decode."""
    rng = np.random.default_rng(frames + nbits)
    soft = _noisy_soft(rng, frames, nbits)
    if kind == "noinfo":
        soft = torch.from_numpy(rng.integers(0, 256, tuple(soft.shape),
                                             dtype=np.int32))
    soft = soft.to(cuda_device)
    nbd = {"mixed": torch.from_numpy(rng.integers(nbits // 2, nbits + 1,
                                                  frames)),
           "zero": torch.zeros(frames, dtype=torch.int64),
           "noinfo": None}[kind]
    steps = viterbi.step_counts(nbits, nbd, (frames,), cuda_device)
    geo = viterbi_blocked.geometry(nbits, n_blocks, warmup)
    before = dict(viterbi_cuda.launches)
    bits, ok, overlaps = viterbi_cuda.blocked_decode(soft.contiguous(), steps,
                                                     geo)
    assert {k: viterbi_cuda.launches[k] - before[k] for k in before} == {
        "viterbi_acs": 0, "viterbi_chainback": 0,
        "viterbi_blocked_decode": 1, "viterbi_acs_ablate": 0}
    want_bits, want_ok = viterbi_blocked.decode_plain(soft, steps, geo)
    assert torch.equal(bits.cpu(), want_bits.cpu())
    assert torch.equal(ok.cpu(), want_ok.cpu())
    _, _, want_overlaps = viterbi_blocked.decode_words_plain(soft, steps, geo)
    assert torch.equal(overlaps.cpu(), want_overlaps.cpu())
    if kind == "zero":
        assert ok.all() and not bits.any()


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
    before = viterbi_cuda.launches["viterbi_blocked_decode"]
    got, c = run(cuda_device)
    assert got == want and len(got) == 6
    assert viterbi_cuda.launches["viterbi_blocked_decode"] > before
    assert c.stats.crc_ok == 6


def test_viterbi_spans_on_the_card(cuda_device):
    """With the tracer on, the CUDA Viterbi's entry points record their
    spans: viterbi.exact inside the capture's rx.decode, viterbi.blocked
    inside the chain's; the chain's waits are chain.wait spans. The
    packets equal the untraced run's. The traced capture call is its
    shape's first, which decodes eagerly and then captures the decode's
    CUDA graph (models/rx.capture_call): it counts rx.decode_eager and
    rx.graph_captures; the chain counts its decode buckets
    (chain.decode_*)."""
    rate, length = Rate.RATE_3_4_QAM16, 100
    payload = torch.from_numpy(np.random.default_rng(8).integers(
        0, 256, (2, length), dtype=np.uint8))
    fre, fim = (f.numpy() for f in tx.build_frame_p(payload, rate))
    n = 16384
    s_re, s_im = np.zeros(n, np.float32), np.zeros(n, np.float32)
    for k, pos in enumerate((700, 9000)):
        s_re[pos:pos + fre.shape[1]], s_im[pos:pos + fim.shape[1]] = \
            fre[k], fim[k]

    def run():
        cap = frontend.receive_capture_p(
            (torch.from_numpy(s_re[None]).to(cuda_device),
             torch.from_numpy(s_im[None]).to(cuda_device)), rate, length, 4)
        c = chain.ReceiverChain(rates=(rate,), max_length=length,
                                params=ChainParams(chunk_size=4096,
                                                   strides_per_step=1),
                                ingest_dtype="int10", device=cuda_device)
        pkts = []
        for i in range(0, n, 4096):
            pkts += c.process_samples((s_re[i:i + 4096], s_im[i:i + 4096]))
        pkts += c.flush()
        return ((cap["valid"] & cap["crc_ok"]).sum().item(),
                [(p.payload, p.start) for p in pkts])

    trace.disable()
    trace.take()
    want = run()
    assert want[0] == 2 and [s for _, s in want[1]] == [700, 9000]
    rx._graphs.clear()
    trace.enable()
    try:
        got = run()
    finally:
        trace.disable()
    spans, counters = trace.take()
    assert got == want
    # the chain's dispatch: two lone frames, one bucket of 4 slots each
    assert counters == {"dropped": 0, "rx.decode_eager": 1,
                        "rx.graph_captures": 1, "chain.decode_jobs": 2,
                        "chain.decode_slots": 8, "chain.decode_frames": 2}

    def parent(s):
        return spans[s.parent].name if s.parent >= 0 else None

    exact = [s for s in spans if s.name == "viterbi.exact"]
    blocked = [s for s in spans if s.name == "viterbi.blocked"]
    # the capture: one header and one payload decode, in its rx.decode
    assert [parent(s) for s in exact[:2]] == ["rx.decode"] * 2
    assert spans[exact[0].parent].parent >= 0
    # the chain's header pass takes the exact kernel inside
    # frontend.decode_headers, its payload decodes (a SIGNAL header, then
    # the payload) inside rx.decode
    chained = {parent(s) for s in exact[2:]}
    assert "frontend.decode_headers" in chained
    assert chained <= {"frontend.decode_headers", "rx.decode",
                       "viterbi.redecode_exact"}
    assert len(blocked) == 2
    assert {parent(s) for s in blocked} == {"rx.decode"}
    waits = [s for s in spans if s.name == "chain.wait"]
    assert waits and {parent(s) for s in waits} <= {
        "chain.drain", "chain.collect", "viterbi.redecode_exact"}


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


def test_mixed_burst_equals_build_frame_on_the_card(cuda_device):
    """Transmitter.send_burst with mixed lengths and per-frame rates: each
    frame's samples equal build_frame_p's for its length and rate, bit for
    bit, on the card."""
    from fun_ofdm_tpu_torch.api import CaptureSink, Transmitter

    rng = np.random.default_rng(61)
    lengths = [1, 300, 77, 2000, 640]
    rates = [Rate.RATE_3_4_QAM16, Rate.RATE_1_2_BPSK, Rate.RATE_2_3_QAM64,
             Rate.RATE_3_4_QAM16, Rate.RATE_1_2_BPSK]
    payloads = [rng.integers(0, 256, n, dtype=np.uint8) for n in lengths]
    sink = CaptureSink()
    sent = Transmitter(sink, device=cuda_device).send_burst(
        [p.tobytes() for p in payloads], rates)
    want = [tx.build_frame_p(torch.from_numpy(p).to(cuda_device), r)
            for p, r in zip(payloads, rates)]
    assert sent == sum(w[0].numel() for w in want)
    np.testing.assert_array_equal(
        sink.re, np.concatenate([w[0].cpu().numpy() for w in want]))
    np.testing.assert_array_equal(
        sink.im, np.concatenate([w[1].cpu().numpy() for w in want]))


def test_receiver_loopback_on_the_card(cuda_device):
    """Transmitter -> LoopbackRadio -> Receiver with the defaults (all
    rates, universal decode) on the card: every payload once, in order,
    with its rate; the RX thread and stop()'s flush share the chain."""
    import time

    from fun_ofdm_tpu_torch.api import Receiver, Transmitter
    from fun_ofdm_tpu_torch.rates import ALL_RATES
    from fun_ofdm_tpu_torch.runtime.io import LoopbackRadio

    rng = np.random.default_rng(67)
    lengths = rng.integers(1, 1501, 33)
    payloads = [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
                for n in lengths]
    rates = [ALL_RATES[k % 11] for k in range(33)]
    radio = LoopbackRadio()
    received = []
    rx = Receiver(received.extend, source=radio, device=cuda_device)
    try:
        Transmitter(radio, device=cuda_device).send_burst(payloads, rates)
        deadline = time.time() + 60
        while len(received) < 33 and time.time() < deadline:
            time.sleep(0.02)
    finally:
        rx.stop()
        radio.close()
    assert [(p.payload, p.rate) for p in received] == list(zip(payloads,
                                                                rates))
    assert rx.chain.stats.crc_fail == 0
