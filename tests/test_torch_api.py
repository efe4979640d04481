"""The port's user API (api.Transmitter / api.Receiver) on the CPU.

Mirrors tests/test_runtime.py's facade cases with device="cpu", holds the
port's Transmitter against fun_ofdm_tpu's on inputs where the reference is
right (samples at atol=1e-4, sample counts and delivered packets exactly),
checks that the reference's two send_burst faults are absent (a numpy
integer rate; the sink swapped during a per-frame-rate burst), that a
"cuda" facade without a GPU raises, that stop() never flushes beside a
running RX thread, and passes a capture file between the two packages in
both directions.
"""

import dataclasses
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fun_ofdm_tpu_torch
from fun_ofdm_tpu import api as j_api
from fun_ofdm_tpu.models import tx as j_tx
from fun_ofdm_tpu.runtime import chain as j_chain
from fun_ofdm_tpu.runtime import io as j_io
from fun_ofdm_tpu_torch import api
from fun_ofdm_tpu_torch.api import CaptureSink, Receiver, Transmitter
from fun_ofdm_tpu_torch.config import ChainParams
from fun_ofdm_tpu_torch.models import tx
from fun_ofdm_tpu_torch.rates import ALL_RATES, Rate
from fun_ofdm_tpu_torch.runtime import io
from fun_ofdm_tpu_torch.runtime.chain import ReceiverChain

torch.set_num_threads(1)

FLOAT_ATOL = 1e-4
QPSK = Rate.RATE_1_2_QPSK


def _payloads(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            for n in lengths]


def _static_frames(payloads, rates):
    """build_frame of the port, frame by frame (complex64)."""
    return np.concatenate([
        tx.build_frame(torch.from_numpy(np.frombuffer(p, np.uint8).copy()),
                       r).numpy() for p, r in zip(payloads, rates)])


def _chain_decode(samples, rates, max_length=64):
    chain = ReceiverChain(rates=rates, max_length=max_length, device="cpu")
    stream = np.concatenate([samples, np.zeros(8000, np.complex64)])
    return chain.process_samples(stream) + chain.flush()


def _jax_burst(payloads, rate):
    """What fun_ofdm_tpu's Transmitter puts on its bus for the burst."""
    bus = j_io.LoopbackRadio(j_io.RadioParams(), pace_idle=False)
    try:
        sent = j_api.Transmitter(sink=bus).send_burst(payloads, rate)
        re, im = bus.get_samples(sent)
    finally:
        bus.close()
    return sent, re + 1j * im


# --------------------------------------------------------- Transmitter ----

def test_lazy_top_level_names():
    assert fun_ofdm_tpu_torch.Transmitter is Transmitter
    assert fun_ofdm_tpu_torch.Receiver is Receiver
    assert fun_ofdm_tpu_torch.ReceiverChain is ReceiverChain
    for name in ("DecodedPacket", "LoopbackRadio", "RadioParams",
                 "FileSource", "FileSink"):
        assert getattr(fun_ofdm_tpu_torch, name) is not None
    with pytest.raises(AttributeError):
        fun_ofdm_tpu_torch.no_such_name
    assert Transmitter.BURST_BATCH_BUCKETS == \
        j_api.Transmitter.BURST_BATCH_BUCKETS
    assert Transmitter.BURST_LEN_BUCKETS == \
        j_api.Transmitter.BURST_LEN_BUCKETS


def test_send_frame_matches_jax_and_build_frame():
    payload = _payloads(3, [48])[0]
    sink = CaptureSink()
    sent = Transmitter(sink, device="cpu").send_frame(payload,
                                                      Rate.RATE_3_4_QAM16)
    ref = _static_frames([payload], [Rate.RATE_3_4_QAM16])
    assert sent == ref.size == api.tx_len(None, payload, Rate.RATE_3_4_QAM16)
    np.testing.assert_array_equal(sink.re + 1j * sink.im, ref)
    want = np.asarray(j_tx.build_frame(
        jnp.asarray(np.frombuffer(payload, np.uint8)), Rate.RATE_3_4_QAM16))
    np.testing.assert_allclose(sink.re + 1j * sink.im, want, rtol=0,
                               atol=FLOAT_ATOL)
    assert Transmitter(sink, device="cpu").send_burst([], QPSK) == 0


def test_transmitter_mixed_length_burst_roundtrip():
    payloads = _payloads(11, (10, 57, 31))
    bus = io.LoopbackRadio(io.RadioParams(), pace_idle=False)
    try:
        sent = Transmitter(sink=bus, device="cpu").send_burst(payloads, QPSK)
        re, im = bus.get_samples(sent)
    finally:
        bus.close()
    got = re + 1j * im
    ref = _static_frames(payloads, [QPSK] * 3)
    assert sent == ref.size
    np.testing.assert_array_equal(got, ref)       # frame by frame, exact
    j_sent, j_got = _jax_burst(payloads, QPSK)
    assert sent == j_sent
    np.testing.assert_allclose(got, j_got, rtol=0, atol=FLOAT_ATOL)
    pkts = _chain_decode(got, (QPSK,))
    assert [p.payload for p in pkts] == payloads


def test_transmitter_burst_past_the_buckets():
    """More frames and a longer payload cap than the largest buckets:
    the burst is padded to its own size."""
    txr = Transmitter(CaptureSink(), device="cpu")
    txr.BURST_BATCH_BUCKETS, txr.BURST_LEN_BUCKETS = (2,), (8,)
    payloads = _payloads(12, (3, 20, 9))
    sent = txr.send_burst(payloads, QPSK)
    ref = _static_frames(payloads, [QPSK] * 3)
    assert sent == ref.size
    np.testing.assert_array_equal(txr.sink.re + 1j * txr.sink.im, ref)


def test_transmitter_per_frame_rates_burst():
    payloads = _payloads(73, (20, 44, 31, 20))
    rates = [QPSK, Rate.RATE_3_4_QAM16, QPSK, Rate.RATE_2_3_QAM64]
    sink = CaptureSink()
    sent = Transmitter(sink=sink, device="cpu").send_burst(payloads, rates)
    got = sink.re + 1j * sink.im
    ref = _static_frames(payloads, rates)
    assert sent == ref.size and len(sink._re) == 1      # one send
    np.testing.assert_array_equal(got, ref)
    j_sent, j_got = _jax_burst(payloads, rates)
    assert sent == j_sent
    np.testing.assert_allclose(got, j_got, rtol=0, atol=FLOAT_ATOL)
    pkts = _chain_decode(got, tuple(sorted(set(rates))))
    assert [(p.payload, p.rate) for p in pkts] == list(zip(payloads, rates))
    with pytest.raises(ValueError, match="per-frame rates"):
        Transmitter(sink, device="cpu").send_burst(payloads, rates[:2])


@pytest.mark.parametrize("rate", [np.int64(int(QPSK)), np.int32(int(QPSK)),
                                  int(QPSK), np.array(int(QPSK))],
                         ids=["int64", "int32", "int", "array0d"])
def test_send_burst_takes_any_integer_rate(rate):
    """The reference refuses a numpy integer (its isinstance test sends it
    down the per-frame path, where iterating it fails); the port takes any
    integer."""
    payloads = _payloads(5, (12, 12))
    sink = CaptureSink()
    Transmitter(sink, device="cpu").send_burst(payloads, rate)
    np.testing.assert_array_equal(sink.re + 1j * sink.im,
                                  _static_frames(payloads, [QPSK] * 2))
    per_frame = CaptureSink()
    Transmitter(per_frame, device="cpu").send_burst(
        payloads, np.array([int(QPSK), int(Rate.RATE_3_4_QAM16)]))
    np.testing.assert_array_equal(
        per_frame.re + 1j * per_frame.im,
        _static_frames(payloads, [QPSK, Rate.RATE_3_4_QAM16]))


def test_failed_per_frame_rate_burst_leaves_the_sink_alone(monkeypatch):
    """A build that raises half way through a per-frame-rate burst: the
    Transmitter's sink is still the caller's and was sent nothing (the
    reference swaps self.sink for the duration of each group's build)."""
    sink = CaptureSink()
    txr = Transmitter(sink, device="cpu")
    real = tx.build_frame_p
    seen = []

    def build(payload, rate, *a, **kw):
        seen.append((rate, txr.sink))
        if rate == Rate.RATE_3_4_QAM16:
            raise RuntimeError("the build failed")
        return real(payload, rate, *a, **kw)

    monkeypatch.setattr(tx, "build_frame_p", build)
    with pytest.raises(RuntimeError, match="the build failed"):
        txr.send_burst(_payloads(6, (8, 8)), [QPSK, Rate.RATE_3_4_QAM16])
    assert txr.sink is sink and sink.re.size == 0
    assert [r for r, _ in seen] == [QPSK, Rate.RATE_3_4_QAM16]
    assert all(s is sink for _, s in seen)


def test_concurrent_per_frame_rate_bursts_keep_their_order():
    """Two threads sending per-frame-rate bursts through one Transmitter:
    each burst arrives whole (the builds share no state)."""
    class Sink:
        def __init__(self):
            self.lock, self.bursts = threading.Lock(), []

        def send_burst(self, samples):
            with self.lock:
                self.bursts.append(samples[0] + 1j * samples[1])

    sink = Sink()
    txr = Transmitter(sink, device="cpu")
    rates = [QPSK, Rate.RATE_3_4_QAM16, QPSK]
    bursts = [_payloads(s, (9, 17, 5)) for s in (1, 2)]
    errors = []

    def send(payloads):
        try:
            for _ in range(5):
                txr.send_burst(payloads, rates)
        except Exception as exc:       # reported below
            errors.append(exc)

    threads = [threading.Thread(target=send, args=(b,)) for b in bursts]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and not any(t.is_alive() for t in threads)
    refs = [_static_frames(b, rates) for b in bursts]
    assert len(sink.bursts) == 10
    for got in sink.bursts:
        assert any(np.array_equal(got, r) for r in refs)


# ------------------------------------------------------------ Receiver ----

def test_transmitter_receiver_loopback_with_pause_resume():
    radio = io.LoopbackRadio()
    received = []
    done = threading.Event()

    def callback(packets):
        received.extend(packets)
        if len(received) >= 3:
            done.set()

    rx = Receiver(callback, source=radio, rates=(QPSK,), max_length=64,
                  device="cpu")
    try:
        txer = Transmitter(radio, device="cpu")
        msgs = [f"loopback packet {i}".encode().ljust(64, b".")
                for i in range(3)]
        txer.send_frame(msgs[0], QPSK)
        rx.pause()
        txer.send_frame(msgs[1], QPSK)      # queued while paused
        rx.resume()
        txer.send_burst([msgs[2]], QPSK)
        assert done.wait(timeout=120)
    finally:
        rx.stop()
        radio.close()
    assert [p.payload for p in received] == msgs
    assert [(p.rate, p.length) for p in received] == [(QPSK, 64)] * 3
    assert rx.chain.stats.crc_fail == 0
    rx.stop()       # a second stop is a no-op flush of an empty chain


def test_receiver_all_rates_mixed_burst_delivered_once():
    """The Receiver's defaults (all 11 rates, universal decode): a
    mixed-length burst at per-frame rates comes back once each, in order,
    with rate and length."""
    lengths = [1, 40, 17, 64, 33, 8, 50, 21, 5, 60, 12]
    payloads = _payloads(21, lengths)
    radio = io.LoopbackRadio()
    received = []
    rx = Receiver(received.extend, source=radio, max_length=64, device="cpu")
    try:
        Transmitter(radio, device="cpu").send_burst(payloads,
                                                    list(ALL_RATES))
        deadline = time.time() + 120
        while len(received) < len(payloads) and time.time() < deadline:
            time.sleep(0.05)
    finally:
        rx.stop()
        radio.close()
    assert [(p.payload, p.rate, p.length) for p in received] == \
        list(zip(payloads, ALL_RATES, lengths))
    assert rx.chain.stats.crc_fail == 0


class _ListSource:
    """get_samples from a fixed stream, zeros after it; counts the calls."""

    def __init__(self, stream):
        self.stream, self.pos, self.calls = stream, 0, 0

    def get_samples(self, n):
        self.calls += 1
        x = self.stream[self.pos:self.pos + n]
        self.pos += n
        x = np.concatenate([x, np.zeros(n - x.size, np.complex64)])
        return (np.ascontiguousarray(x.real, np.float32),
                np.ascontiguousarray(x.imag, np.float32))


def test_receiver_stop_flushes_the_tail_to_the_callback():
    """A frame still inside the chain's window when the RX thread stops is
    delivered by stop()'s flush, from the caller's thread."""
    payload = _payloads(9, [30])[0]
    frame = _static_frames([payload], [QPSK])
    src = _ListSource(np.concatenate([np.zeros(100, np.complex64), frame]))
    threads = []

    def callback(packets):
        threads.append((threading.current_thread().name,
                        [p.payload for p in packets]))

    rx = Receiver(callback, source=src, rates=(QPSK,), max_length=64,
                  start=False, device="cpu")
    re, im = src.get_samples(100 + frame.size)
    assert rx.chain.process_samples((re, im)) == []
    rx.stop()
    assert threads == [(threading.current_thread().name, [payload])]


def test_receiver_stop_raises_rather_than_flush_beside_the_rx_thread():
    entered, release = threading.Event(), threading.Event()

    class Blocking:
        def get_samples(self, n):
            entered.set()
            release.wait(timeout=60)
            z = np.zeros(n, np.float32)
            return z, z

    flushed = []
    rx = Receiver(lambda p: None, source=Blocking(), rates=(QPSK,),
                  max_length=64, device="cpu")
    rx.chain.flush = lambda: flushed.append(1) or []
    try:
        assert entered.wait(timeout=30)
        with pytest.raises(RuntimeError, match="did not end"):
            rx.stop(timeout=0.2)
        assert not flushed
    finally:
        release.set()
    rx.stop(timeout=30)
    assert flushed == [1]


def test_receiver_stop_raises_what_ended_the_rx_thread():
    class Broken:
        def get_samples(self, n):
            raise OSError("the source failed")

    rx = Receiver(lambda p: None, source=Broken(), rates=(QPSK,),
                  max_length=64, device="cpu")
    rx._thread.join(timeout=30)
    with pytest.raises(OSError, match="the source failed"):
        rx.stop()


def test_cuda_facades_raise_without_a_gpu():
    """The default device is "cuda", and neither facade moves to the CPU
    when there is no GPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Receiver(lambda p: None, rates=(QPSK,), max_length=64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Receiver(lambda p: None, device="cuda:0")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Transmitter(CaptureSink())
    with pytest.raises(ValueError):
        Transmitter(CaptureSink(), device="meta")
    with pytest.raises(Exception):
        ReceiverChain(rates=(QPSK,), max_length=64)


def test_receiver_passes_its_arguments_to_the_chain():
    rx = Receiver(lambda p: None, source=_ListSource(np.zeros(0)),
                  chain_params=ChainParams(chunk_size=2048,
                                           strides_per_step=2),
                  rates=(QPSK, Rate.RATE_3_4_QAM16), max_length=100,
                  cfo_correct=True, start=False, ingest_dtype="int16",
                  viterbi_impl="exact", decode_mode="per-rate", device="cpu")
    c = rx.chain
    assert (c.rates, c.max_length, c.cfo_correct, c.ingest_dtype,
            c.viterbi_impl, c.decode_mode, c.step, c.device.type) == (
        (QPSK, Rate.RATE_3_4_QAM16), 100, True, "int16", "exact",
        "per-rate", 4096, "cpu")
    assert rx._chunk == 2048
    rx.stop()


def test_chain_gather_strategy_delivers_the_same_packets():
    """The universal chain, whose soft streams come from the one gather
    path, delivers the planted burst, and the JAX chain on the same stream
    delivers the same packets with the same counts."""
    rates = (Rate.RATE_1_2_BPSK, Rate.RATE_3_4_QPSK, Rate.RATE_3_4_QAM16,
             Rate.RATE_2_3_QAM64)
    lengths = [5, 64, 30, 47, 1, 22]
    payloads = _payloads(31, lengths)
    per_frame = [rates[i % 4] for i in range(len(lengths))]
    sink = CaptureSink()
    Transmitter(sink, device="cpu").send_burst(payloads, per_frame)
    stream = np.concatenate([np.zeros(500, np.complex64),
                             sink.re + 1j * sink.im,
                             np.zeros(6000, np.complex64)])
    chain = ReceiverChain(rates=rates, max_length=64, device="cpu")
    assert chain.decode_mode == "universal"
    pkts = chain.process_samples(stream) + chain.flush()
    assert [(p.payload, p.rate) for p in pkts] == \
        list(zip(payloads, per_frame))
    j = j_chain.ReceiverChain(rates=rates, max_length=64)
    j_pkts = j.process_samples(stream) + j.flush()

    def key(ps):
        return [(p.payload, p.rate, p.length, p.start) for p in ps]
    assert key(pkts) == key(j_pkts)
    want = {k: v for k, v in dataclasses.asdict(j.stats).items()
            if not k.startswith("time_")}
    assert chain.stats.as_dict() == want


# ------------------------------------------------------- cross-backend ----

@pytest.mark.parametrize("fmt", ["complex64", "int16"])
def test_capture_file_from_jax_decodes_through_the_port(tmp_path, fmt):
    payloads = _payloads(41, (48, 20))
    path = str(tmp_path / "from_jax")
    sink = j_io.FileSink(path, fmt=fmt)
    try:
        j_api.Transmitter(sink).send_burst(payloads, Rate.RATE_3_4_QAM16)
        sink.send_burst(np.zeros(512, np.complex64))
    finally:
        sink.close()
    src = io.FileSource(path, fmt=fmt)
    received = []
    rx = Receiver(received.extend, source=src,
                  rates=(Rate.RATE_3_4_QAM16,), max_length=48, device="cpu")
    try:
        deadline = time.time() + 60
        while not src.exhausted and time.time() < deadline:
            time.sleep(0.02)
    finally:
        rx.stop()
        src.close()
    assert [p.payload for p in received] == payloads


def test_capture_file_from_the_port_decodes_through_jax(tmp_path):
    payloads = _payloads(43, (48, 20))
    path = str(tmp_path / "from_port")
    sink = io.FileSink(path)
    try:
        Transmitter(sink, device="cpu").send_burst(payloads,
                                                   Rate.RATE_3_4_QAM16)
        sink.send_burst(np.zeros(512, np.complex64))
    finally:
        sink.close()
    src = j_io.FileSource(path)
    received = []
    rx = j_api.Receiver(received.extend, source=src,
                        rates=(Rate.RATE_3_4_QAM16,), max_length=48)
    try:
        deadline = time.time() + 300
        while not src.exhausted and time.time() < deadline:
            time.sleep(0.05)
    finally:
        rx.stop(timeout=300)
        src.close()
    assert [p.payload for p in received] == payloads


# ---------------------------------------------------- live over UDP ----

#: RadioStats fields that depend on the network and the stream alone (a
#: dry read's `underruns` and `fill_samples` depend on thread timing)
_UDP_COUNTERS = ("overruns", "dropped_samples", "reordered", "lost_samples",
                 "malformed", "resyncs")


def _live_udp(mod_api, mod_io, payloads, radio, **device):
    """A live Receiver on a UdpSource while a Transmitter sends over a
    UdpSink, the way examples rx and tx --pace are used: each frame, then a
    3000-sample gap, the sender kept to the radio's sample clock. Returns
    the delivered (payload, rate, length) and the source's counters."""
    received = []
    src = mod_io.UdpSource(("127.0.0.1", 0), radio)
    sink = rx = None
    try:
        rx = mod_api.Receiver(received.extend, source=src, params=radio,
                              rates=(QPSK,), max_length=64, **device)
        sink = mod_io.UdpSink(("127.0.0.1", src.addr[1]), radio)
        txer = mod_api.Transmitter(sink, radio, **device)
        gap = np.zeros(3000, np.complex64)
        t0, sent = time.perf_counter(), 0
        for p in payloads:
            sent += txer.send_frame(p, QPSK) + gap.size
            sink.send_burst(gap)
            ahead = sent / radio.sample_rate - (time.perf_counter() - t0)
            if ahead > 0:
                time.sleep(ahead)
        sink.flush()
        deadline = time.time() + 120
        while len(received) < len(payloads) and time.time() < deadline:
            time.sleep(0.05)
    finally:
        if rx is not None:
            rx.stop()
        if sink is not None:
            sink.close()
        src.close()
    stats = src.stats.as_dict()
    return ([(p.payload, int(p.rate), p.length) for p in received],
            {k: stats[k] for k in _UDP_COUNTERS})


def test_live_udp_receiver_delivers_what_the_jax_package_delivers():
    """Both packages, live over UDP on 127.0.0.1 at the same pace (a 100
    kS/s radio clock, so that a read runs dry only after 41 ms without a
    datagram): every frame delivered once, in order, and the same network
    counters, all 0."""
    payloads = _payloads(61, [64] * 6)
    radio = io.RadioParams(sample_rate=1e5)
    j_radio = j_io.RadioParams(sample_rate=1e5)
    got, counters = _live_udp(api, io, payloads, radio, device="cpu")
    want, j_counters = _live_udp(j_api, j_io, payloads, j_radio)
    assert got == [(p, int(QPSK), 64) for p in payloads]
    assert got == want
    assert counters == j_counters == dict.fromkeys(_UDP_COUNTERS, 0)
