"""The port's tracer (fun_ofdm_tpu_torch/utils/trace.py): off it records
nothing; on, spans nest with their parents and ids; the chain and the
capture entry give the span trees their docstring names, and deliver the
same packets and counters traced as untraced."""

from __future__ import annotations

import functools
import threading

import numpy as np
import pytest
import torch

from fun_ofdm_tpu_torch.config import ChainParams
from fun_ofdm_tpu_torch.models import frontend, tx
from fun_ofdm_tpu_torch.rates import Rate
from fun_ofdm_tpu_torch.runtime import chain
from fun_ofdm_tpu_torch.utils import trace

torch.set_num_threads(1)

RATE = Rate.RATE_1_2_QPSK
LENGTH = 60
READ = 4096


@pytest.fixture
def tracer():
    """The tracer, off and empty before and after the test."""
    trace.disable()
    trace.take()
    yield trace
    trace.disable()
    trace.take()


def _children(spans, i):
    return [s for s in spans if s.parent == i]


def _names(spans, i):
    return sorted({s.name for s in _children(spans, i)})


# --- the tracer itself -------------------------------------------------------


def test_off_returns_the_shared_noop_and_records_nothing(tracer):
    a, b = tracer.span("chain.ingest", 5), tracer.span("rx.decode")
    assert a is b
    with a:
        with b:
            pass
    assert tracer.take() == ([], {"dropped": 0})


def test_off_span_lets_exceptions_through(tracer):
    with pytest.raises(KeyError):
        with tracer.span("x"):
            raise KeyError("inside")


def test_spans_nest_with_parents_and_ids(tracer):
    tracer.enable()
    with tracer.span("root"):                    # first root of its name: 0
        with tracer.span("a", 7):
            with tracer.span("b"):               # inherits 7
                pass
        with tracer.span("c"):                   # inherits the root's 0
            pass
    with tracer.span("root"):                    # second root: 1
        pass
    with tracer.span("other", 3):
        pass
    spans, counters = tracer.take()
    assert counters == {"dropped": 0}
    got = [(s.name, s.id, s.parent) for s in spans]
    assert got == [("root", 0, -1), ("a", 7, 0), ("b", 7, 1), ("c", 0, 0),
                   ("root", 1, -1), ("other", 3, -1)]
    for s in spans:
        assert s.t0_ns <= s.t1_ns
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.t0_ns <= s.t0_ns and s.t1_ns <= p.t1_ns
    # take() cleared the spans and the root counts
    with tracer.span("root"):
        pass
    assert [(s.name, s.id) for s in tracer.take()[0]] == [("root", 0)]


def test_span_closes_on_exception(tracer):
    tracer.enable()
    with pytest.raises(ValueError):
        with tracer.span("outer"):
            with tracer.span("inner"):
                raise ValueError("x")
    with tracer.span("after"):
        pass
    spans, _ = tracer.take()
    assert [(s.name, s.parent) for s in spans] == [
        ("outer", -1), ("inner", 0), ("after", -1)]


def test_disable_keeps_what_was_recorded(tracer):
    tracer.enable()
    with tracer.span("kept"):
        pass
    tracer.disable()
    with tracer.span("not kept"):
        pass
    assert [s.name for s in tracer.take()[0]] == ["kept"]


def test_spans_past_the_limit_are_counted(tracer, monkeypatch):
    monkeypatch.setattr(trace, "LIMIT", 3)
    tracer.enable()
    for _ in range(5):
        with tracer.span("s"):
            pass
    spans, counters = tracer.take()
    assert len(spans) == 3 and counters == {"dropped": 2}
    with tracer.span("s"):                       # room again after take()
        pass
    assert len(tracer.take()[0]) == 1


def test_open_span_at_take_is_not_returned(tracer):
    tracer.enable()
    with tracer.span("open"):
        with tracer.span("closed"):
            pass
        spans, _ = tracer.take()
    assert [(s.name, s.parent) for s in spans] == [("closed", -1)]
    assert tracer.take()[0] == []                # its record went with take()


def test_threads_keep_their_own_parents(tracer):
    tracer.enable()
    ready, done = threading.Event(), threading.Event()

    def worker():
        with tracer.span("thread.root"):
            ready.set()
            done.wait(10)

    t = threading.Thread(target=worker)
    with tracer.span("main.root"):
        t.start()
        assert ready.wait(10)
        with tracer.span("main.child"):
            pass
        done.set()
        t.join(10)
    assert not t.is_alive()
    spans, _ = tracer.take()
    by = {s.name: s for s in spans}
    assert by["thread.root"].parent == -1
    assert spans[by["main.child"].parent].name == "main.root"


def test_summary_self_time():
    S = trace.Span
    spans = [S("root", 0, -1, 0, 10_000_000), S("a", 0, 0, 1_000_000,
                                                 4_000_000),
             S("b", 0, 1, 2_000_000, 3_000_000), S("a", 1, 0, 5_000_000,
                                                    6_000_000)]
    got = trace.summary(spans)
    assert got["root"] == pytest.approx((1, 10.0, 6.0))
    assert got["a"] == pytest.approx((2, 4.0, 3.0))
    assert got["b"] == pytest.approx((1, 1.0, 1.0))


def test_profiler_sees_spans_as_annotations(tracer):
    from torch.profiler import ProfilerActivity, profile

    tracer.enable()
    x = torch.ones(8)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracer.span("chain.ingest", 4):
            with tracer.span("wire.pack"):
                (x * 2).sum()
    names = {e.name for e in prof.events()}
    assert {"chain.ingest", "wire.pack"} <= names
    ann = {e.name: e for e in prof.events()
           if e.name in ("chain.ingest", "wire.pack")}
    outer, inner = ann["chain.ingest"].time_range, ann["wire.pack"].time_range
    assert outer.start <= inner.start and inner.end <= outer.end
    assert [s.name for s in tracer.take()[0]] == ["chain.ingest", "wire.pack"]


# --- the program's spans -----------------------------------------------------


@functools.lru_cache(maxsize=None)
def _frames():
    """Two RATE_1_2_QPSK frames of LENGTH bytes (port TX), at 1,000 and
    9,000 in a 20,480-sample float32 stream on the int10 grid."""
    n = 5 * READ
    re, im = np.zeros(n, np.float32), np.zeros(n, np.float32)
    payloads = []
    for k, pos in enumerate((1000, 9000)):
        pay = np.random.default_rng(k).integers(0, 256, LENGTH,
                                                 dtype=np.uint8)
        fr, fi = tx.build_frame_p(torch.from_numpy(pay), RATE)
        re[pos:pos + fr.numel()] = fr.numpy()
        im[pos:pos + fi.numel()] = fi.numpy()
        payloads.append(pay.tobytes())
    grid = np.float32(128)
    return (np.round(re * grid) / grid, np.round(im * grid) / grid), payloads


def _run_chain():
    (re, im), _ = _frames()
    c = chain.ReceiverChain(rates=(RATE,), max_length=LENGTH,
                            params=ChainParams(chunk_size=READ,
                                               strides_per_step=1),
                            ingest_dtype="int10", device="cpu")
    pkts = []
    for i in range(0, re.size, READ):
        pkts += c.process_samples((re[i:i + READ], im[i:i + READ]))
    pkts += c.flush()
    return [(p.payload, p.start) for p in pkts], c.stats.as_dict()


def test_chain_tree_and_same_packets(tracer):
    want_pkts, want_stats = _run_chain()
    _, payloads = _frames()
    assert want_pkts == [(payloads[0], 1000), (payloads[1], 9000)]
    tracer.enable()
    got_pkts, got_stats = _run_chain()
    spans, counters = tracer.take()
    assert (got_pkts, got_stats) == (want_pkts, want_stats)
    # the dispatch's counters: two lone frames, one bucket of 4 slots
    # each; a single-rate chain counts no anyrate.* (universal mode only)
    assert counters == {"dropped": 0, "chain.decode_jobs": 2,
                        "chain.decode_slots": 8, "chain.decode_frames": 2}
    assert "time_headers_s" not in got_stats
    assert "time_decode_s" not in got_stats

    roots = [i for i, s in enumerate(spans) if s.parent == -1]
    assert [spans[i].name for i in roots] == \
        ["chain.process_samples"] * 5 + ["chain.flush"]
    for i in roots[:-1]:
        assert _names(spans, i) == ["chain.drain", "native.chunk"]
    ingests = [i for i, s in enumerate(spans) if s.name == "chain.ingest"]
    # one dispatch a read, then the flush's until the halo is owned
    assert len(ingests) >= 5
    gpos = [spans[i].id for i in ingests]
    assert gpos == sorted(gpos)
    assert np.all(np.diff(gpos) == READ)
    dispatched = set()
    for i in ingests:
        s = spans[i]
        assert spans[s.parent].name in ("native.chunk", "chain.flush")
        kids = _names(spans, i)
        if s.id + READ <= 0:                 # warm-up: no header pass
            assert kids == ["chain.h2d", "wire.pack"]
        else:
            assert kids == ["chain.h2d", "frontend.decode_headers",
                            "wire.pack"]
            dispatched.add(s.id)
        for k in _children(spans, i):
            assert k.id == s.id
    assert len(dispatched) == got_stats["windows"]
    # every dispatch's header result is waited for under chain.drain
    hdr_waits = {s.id for s in spans if s.name == "chain.wait"
                 and spans[s.parent].name == "chain.drain"}
    assert hdr_waits == dispatched
    # the two frames: a decode dispatch and a collection each, under
    # chain.drain, with the id of the dispatch that owns the frame
    decodes = [s for s in spans if s.name == "rx.decode"]
    collects = [i for i, s in enumerate(spans) if s.name == "chain.collect"]
    assert len(decodes) == len(collects) == 2
    for s in decodes:
        assert spans[s.parent].name == "chain.drain" and s.id in dispatched
    owners = [max(g for g in dispatched if g <= start)
              for _, start in got_pkts]
    assert sorted(spans[i].id for i in collects) == owners
    for i in collects:
        assert spans[spans[i].parent].name == "chain.drain"
        assert _names(spans, i) == ["chain.wait"]
        assert _children(spans, i)[0].id == spans[i].id
    names = {s.name for s in spans}
    assert "viterbi.redecode_exact" not in names      # clean frames
    assert "chain.header_overflow" not in names


def test_chain_header_overflow_span(tracer):
    """header_slots=2 with three frames in one dispatch re-runs the
    full-capacity header pass inside chain.header_overflow."""
    n = 2 * READ
    re, im = np.zeros(n, np.float32), np.zeros(n, np.float32)
    for k, pos in enumerate((300, 1500, 2700)):
        pay = np.random.default_rng(10 + k).integers(0, 256, 20,
                                                      dtype=np.uint8)
        fr, fi = tx.build_frame_p(torch.from_numpy(pay), RATE)
        re[pos:pos + fr.numel()] = fr.numpy()
        im[pos:pos + fi.numel()] = fi.numpy()
    c = chain.ReceiverChain(rates=(RATE,), max_length=20,
                            params=ChainParams(chunk_size=READ,
                                               strides_per_step=1,
                                               header_slots=2),
                            device="cpu")
    tracer.enable()
    pkts = c.process_samples((re, im)) + c.flush()
    spans, _ = tracer.take()
    assert [p.start for p in pkts] == [300, 1500, 2700]
    assert c.stats.header_overflows == 1
    over = [i for i, s in enumerate(spans)
            if s.name == "chain.header_overflow"]
    assert len(over) == 1
    s = spans[over[0]]
    assert spans[s.parent].name == "chain.drain"
    assert _names(spans, over[0]) == ["chain.wait"]
    assert _children(spans, over[0])[0].id == s.id
    assert s.id in {x.id for x in spans if x.name == "chain.ingest"}


def test_capture_tree(tracer):
    (re, im), payloads = _frames()
    stream = (torch.from_numpy(re[None]), torch.from_numpy(im[None]))
    want = frontend.receive_capture_p(stream, RATE, LENGTH, 4)
    tracer.enable()
    got = [frontend.receive_capture_p(stream, RATE, LENGTH, 4)
           for _ in range(2)]
    spans, _ = tracer.take()
    for out in got:
        for k in want:
            assert torch.equal(out[k], want[k]), k
    ok = (want["valid"] & want["crc_ok"])[0]
    assert ok.sum() == 2
    assert want["starts"][0, ok].tolist() == [1000, 9000]
    roots = [i for i, s in enumerate(spans) if s.parent == -1]
    assert [(spans[i].name, spans[i].id) for i in roots] == [
        ("frontend.receive_capture", 0), ("frontend.receive_capture", 1)]
    for i in roots:
        kids = _children(spans, i)
        assert [k.name for k in kids] == ["frontend.detect", "rx.decode"]
        assert all(k.id == spans[i].id for k in kids)


# --- the universal capture's spans and counters ------------------------------


def test_count_is_a_noop_when_off(tracer):
    tracer.count("anyrate.slots", 5)
    assert tracer.take() == ([], {"dropped": 0})
    tracer.enable()
    tracer.count("anyrate.slots", 5)
    tracer.count("anyrate.slots", 2)
    tracer.disable()
    tracer.count("anyrate.slots", 100)
    assert tracer.take() == ([], {"dropped": 0, "anyrate.slots": 7})
    assert tracer.take() == ([], {"dropped": 0})     # cleared


def test_anyrate_capture_tree_and_counters(tracer):
    """receive_capture_anyrate_p opens receive_capture's spans, the
    universal decode its two stages inside rx.decode, and counts its slots
    and their symbols at the slowest rate's geometry; traced and untraced
    give the same outputs."""
    from fun_ofdm_tpu_torch.rates import ALL_RATES, params_for

    (re, im), _ = _frames()
    stream = (torch.from_numpy(re[None]), torch.from_numpy(im[None]))
    slots = 4

    def call():
        return frontend.receive_capture_anyrate_p(
            stream, ALL_RATES, LENGTH, slots)
    want = call()
    tracer.enable()
    got = [call() for _ in range(2)]
    spans, counters = tracer.take()
    for out in got:
        for k in want:
            assert torch.equal(out[k], want[k]), k
    ok = (want["valid"] & want["crc_ok"])[0]
    assert want["starts"][0, ok].tolist() == [1000, 9000]
    roots = [i for i, s in enumerate(spans) if s.parent == -1]
    assert [(spans[i].name, spans[i].id) for i in roots] == [
        ("frontend.receive_capture", 0), ("frontend.receive_capture", 1)]
    for i in roots:
        assert [k.name for k in _children(spans, i)] == [
            "frontend.detect", "rx.decode"]
        dec = next(j for j, s in enumerate(spans)
                   if s.parent == i and s.name == "rx.decode")
        # on the CPU the Viterbi is the plain twin: no viterbi.exact span
        assert [k.name for k in _children(spans, dec)] == [
            "rx.anyrate_sync", "ppdu.anyrate_coded"]
        assert all(k.id == spans[i].id for k in _children(spans, dec))
    nsym_max = params_for(Rate.RATE_1_2_BPSK).num_symbols(LENGTH)
    assert counters == {"dropped": 0, "anyrate.slots": 2 * slots,
                        "anyrate.symbols": 2 * slots * nsym_max}


def test_anyrate_kernel_slots_not_counted_on_the_cpu(tracer):
    """On the CPU the universal decode's soft streams come from the plain
    version: anyrate.kernel_slots is never counted, and the payload
    decode counts nothing else (rx counts the slots)."""
    from fun_ofdm_tpu_torch.models import ppdu
    from fun_ofdm_tpu_torch.rates import ALL_RATES, params_for

    nsym_max = max(params_for(r).num_symbols(LENGTH) for r in ALL_RATES)
    z = torch.zeros(3, nsym_max * 48)
    tracer.enable()
    ppdu.decode_data_anyrate_p((z, z), ALL_RATES, [0, 5, 10], [LENGTH] * 3,
                               LENGTH)
    _, counters = tracer.take()
    assert counters == {"dropped": 0}
