"""The capture decode's constant tables and graph keys, on the CPU.

Every table the decode reads is a cached device tensor
(utils/tables.on_device): each equals its numpy source, and a second call
gives the same tensor back; tables.held() collects the tables a captured
decode reads. The graph key of models/rx.capture_call tells apart every
field that fixes a decode's shapes or code path, and the cache of
replayed decodes keeps at most GRAPHS_KEPT keys. A CPU capture call never
counts rx.decode_eager or rx.graph_* (it never takes a graph) and gives
the outputs of detection followed by the eager decode, as before
replayed decodes existed. A decode's host-known counters are counted once
a call, outside the decode. With torch.cuda's graph and stream calls
replaced by recorders, a _Replayed captures on a stream of its buffers'
device with that device current, and runs eager-and-capture, then
replays. The card's side is tests/test_torch_capture_graph_hopper.py.
"""

from __future__ import annotations

import contextlib
import sys
import threading

import numpy as np
import pytest
import torch

from fun_ofdm_tpu_torch import preamble as pre
from fun_ofdm_tpu_torch.models import frontend, ppdu, rx, tx
from fun_ofdm_tpu_torch.ops import (crc32, interleave, mapper, puncture,
                                    scramble)
from fun_ofdm_tpu_torch.rates import ALL_RATES, VALID_RATE_FIELDS, Rate
from fun_ofdm_tpu_torch.rates import params_for
from fun_ofdm_tpu_torch.utils import tables, trace

torch.set_num_threads(1)

CPU = torch.device("cpu")
RATE = Rate.RATE_1_2_QPSK
LENGTH = 60
RATES3 = (Rate.RATE_1_2_BPSK, Rate.RATE_3_4_QAM16, Rate.RATE_3_4_QAM64)

#: (cached table, its arguments, its numpy source)
TABLES = {
    "interleave.perm": (interleave.index_on, (False, CPU),
                        interleave.PERM),
    "interleave.inv_perm": (interleave.index_on, (True, CPU),
                            interleave.INV_PERM),
    "mapper.data_index": (mapper.data_index_on, (CPU,), mapper.DATA_IDX),
    "mapper.pilot_index": (mapper.pilot_index_on, (CPU,), mapper.PILOT_IDX),
    "mapper.pilot_reference": (
        mapper.pilot_reference_on, (130, torch.float32, CPU),
        (mapper.POLARITY[np.arange(130) % 127][:, None]
         * mapper.PILOT_VALUES).astype(np.float32)),
    "puncture.keep_3_4": (puncture.keep_on, (6, CPU), np.array([0, 1, 3, 5])),
    "puncture.keep_2_3": (puncture.keep_on, (4, CPU), np.array([0, 2, 3])),
    "scramble.keystream": (scramble.keystream_on, (300, CPU),
                           scramble.keystream(300)),
    "crc32.position_table": (crc32._device_table, (37, CPU),
                             crc32._position_tables(37)[0]),
    "crc32.init_contributions": (crc32._init_contrib_on, (37, CPU),
                                 crc32._init_contrib_table(37)),
    "ppdu.valid_rate_fields": (ppdu._valid_rate_fields_on, (CPU,),
                               np.array(VALID_RATE_FIELDS)),
    "ppdu.dbps": (ppdu._dbps_on, (RATES3, CPU),
                  np.array([params_for(r).dbps for r in RATES3])),
    "ppdu.anyrate_tables": (ppdu._anyrate_tables_on, (RATES3, 50, CPU),
                            ppdu._anyrate_tables(RATES3, 50)[0]),
    "rx.lts_reference": (rx._lts_reference_on, (torch.complex64, CPU),
                         (pre.LTS_FREQ_DOMAIN.astype(np.complex64),
                          pre.LTS_FREQ_DOMAIN != 0)),
    "rx.derotation_indices": (rx._derotation_indices_on, (9, CPU),
                              tuple(a.astype(np.float32) for a in
                                    rx.derotation_indices(9))),
}


@pytest.mark.parametrize("name", list(TABLES))
def test_device_table_equals_its_source_and_is_made_once(name):
    fn, args, source = TABLES[name]
    got = fn(*args)
    want = source if isinstance(source, tuple) else (source,)
    parts = got if isinstance(got, tuple) else (got,)
    assert len(parts) == len(want)
    for g, w in zip(parts, want):
        w = np.asarray(w)
        assert g.device == CPU
        assert g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), w)
    assert fn(*args) is got


def test_held_collects_the_tables_fetched_on_its_thread():
    other = []
    with tables.held() as outer:
        a = interleave.index_on(False, CPU)
        with tables.held() as inner:
            b = mapper.data_index_on(CPU)
        t = threading.Thread(
            target=lambda: other.append(puncture.keep_on(6, CPU)))
        t.start()
        t.join()
    assert [x is a for x in outer] == [True]
    assert [x is b for x in inner] == [True]
    assert len(other) == 1
    with tables.held() as after:
        pass
    assert after == []


def test_a_decode_holds_every_table_it_reads():
    """The eager decode fetches its tables through the caches: held()
    around a CPU decode collects the interleaver, mapper, scrambler, CRC,
    rate-field and channel-estimate tables."""
    (re, im), _ = _recording()
    stream = torch.complex(torch.from_numpy(re), torch.from_numpy(im))[None]
    with tables.held() as kept:
        rx.decode_frames(stream, RATE, LENGTH,
                         torch.tensor([[1000, 9000]]))
    ids = {id(t) for t in kept}
    for t in (interleave.index_on(False, CPU), mapper.data_index_on(CPU),
              scramble.keystream_on(params_for(RATE).num_data_bytes(LENGTH),
                                    CPU),
              ppdu._valid_rate_fields_on(CPU),
              rx._lts_reference_on(torch.complex64, CPU),
              crc32._device_table(2 + LENGTH, CPU)):
        assert id(t) in ids


# --- graph keys and the cache of replayed decodes -------------------------


BASE = dict(decode=rx.Decode("anyrate", RATES3, 4095), shape=(1, 7832000),
            dtype=torch.complex64, device="cuda:0", stream=0,
            max_frames=100)
VARIANTS = {
    "stream_length": dict(shape=(1, 7832001)),
    "channels": dict(shape=(2, 7832000)),
    "dtype": dict(dtype=torch.complex128),
    "device": dict(device="cuda:1"),
    "cuda_stream": dict(stream=1234),
    "max_frames": dict(max_frames=101),
    "max_length": dict(decode=rx.Decode("anyrate", RATES3, 4094)),
    "rates": dict(decode=rx.Decode("anyrate", RATES3[:2], 4095)),
    "kind_dynamic": dict(decode=rx.Decode("dynamic", RATES3[:1], 4095)),
    "cfo_correct": dict(decode=rx.Decode("anyrate", RATES3, 4095,
                                         cfo_correct=True)),
    "viterbi_impl": dict(decode=rx.Decode("anyrate", RATES3, 4095,
                                          viterbi_impl="blocked")),
    "frames_rate": dict(decode=rx.Decode("frames", (Rate.RATE_1_2_BPSK,),
                                         4095)),
}


@pytest.mark.parametrize("field", list(VARIANTS))
def test_graph_key_tells_the_field_apart(field):
    base = rx.graph_key(**BASE)
    assert rx.graph_key(**BASE) == base
    other = rx.graph_key(**{**BASE, **VARIANTS[field]})
    assert other != base
    assert hash(other) is not None


def test_frames_keys_tell_rate_and_length_apart():
    keys = {rx.graph_key(**{**BASE, "decode": rx.Decode("frames", (r,), n)})
            for r in (Rate.RATE_1_2_BPSK, Rate.RATE_3_4_QAM16)
            for n in (1500, 1501)}
    assert len(keys) == 4


def test_the_cache_keeps_the_most_recently_used_keys(monkeypatch):
    monkeypatch.setattr(rx, "_graphs", type(rx._graphs)())
    dec = rx.Decode("dynamic", (RATE,), LENGTH)
    entries = [rx._replayed(("k", i), dec, (1, 1000), 4, CPU)
               for i in range(rx.GRAPHS_KEPT)]
    assert rx._replayed(("k", 0), dec, (1, 1000), 4, CPU) is entries[0]
    rx._replayed(("k", "new"), dec, (1, 1000), 4, CPU)
    assert len(rx._graphs) == rx.GRAPHS_KEPT
    assert ("k", 1) not in rx._graphs          # the least recently used
    assert rx._graphs[("k", 0)] is entries[0]
    e = entries[0]
    pad = params_for(RATE).frame_samples(LENGTH)
    assert e.stream.shape == (1, 1000 + pad)
    assert e.samples.shape == (1, 1000)
    assert e.starts.shape == (1, 4)
    assert not bool(e.stream.abs().any())


@pytest.mark.parametrize("kind", ["frames", "dynamic", "anyrate"])
def test_decode_runs_its_rx_function_over_its_pad(kind):
    (re, im), _ = _recording()
    stream = torch.complex(torch.from_numpy(re), torch.from_numpy(im))[None]
    starts = torch.tensor([[1000, 9000]])
    rates = (RATE,) if kind != "anyrate" else RATES3 + (RATE,)
    dec = rx.Decode(kind, rates, LENGTH)
    if kind == "frames":
        assert dec.pad() == 0
        want = rx.decode_frames(stream, RATE, LENGTH, starts)
    else:
        assert dec.pad() == max(params_for(r).frame_samples(LENGTH)
                                for r in rates)
        stream = torch.nn.functional.pad(stream, (0, dec.pad()))
        fn = (rx.decode_frames_dynamic if kind == "dynamic" else
              lambda s, r, n, st: rx.decode_frames_anyrate(s, rates, n, st))
        want = fn(stream, RATE, LENGTH, starts)
    got = dec(stream, starts)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert bool(got["crc_ok"].all())


# --- CPU capture calls -----------------------------------------------------


def _recording():
    """Two RATE_1_2_QPSK frames of LENGTH bytes at 1,000 and 9,000 in a
    12,000-sample float32 stream."""
    n = 12000
    re, im = np.zeros(n, np.float32), np.zeros(n, np.float32)
    payloads = []
    for k, pos in enumerate((1000, 9000)):
        pay = np.random.default_rng(k).integers(0, 256, LENGTH,
                                                 dtype=np.uint8)
        fr, fi = tx.build_frame_p(torch.from_numpy(pay), RATE)
        re[pos:pos + fr.numel()] = fr.numpy()
        im[pos:pos + fi.numel()] = fi.numpy()
        payloads.append(pay)
    return (re, im), payloads


def _by_hand(stream, decode, max_frames, frame_len=None):
    """A capture call as detection followed by the eager decode."""
    starts, valid, dropped = frontend.detect_frames(
        stream, max_frames, return_dropped=True)
    if frame_len is not None:
        valid = valid & (starts + frame_len <= stream.shape[-1])
    padded = torch.nn.functional.pad(stream, (0, decode.pad()))
    out = decode(padded, torch.where(valid, starts, 0))
    return {**out, "starts": starts, "valid": valid,
            "crc_ok": out["crc_ok"] & valid,
            "header_ok": out["header_ok"] & valid,
            "detect_dropped": dropped}


CAPTURES = {
    "receive_capture_p": (
        lambda s: frontend.receive_capture_p(s, RATE, LENGTH, 4),
        rx.Decode("frames", (RATE,), LENGTH),
        params_for(RATE).frame_samples(LENGTH)),
    "receive_capture": (
        lambda s: frontend.receive_capture(torch.complex(*s), RATE, LENGTH,
                                           4),
        rx.Decode("frames", (RATE,), LENGTH),
        params_for(RATE).frame_samples(LENGTH)),
    "receive_capture_dynamic_p": (
        lambda s: frontend.receive_capture_dynamic_p(s, RATE, LENGTH, 4),
        rx.Decode("dynamic", (RATE,), LENGTH), None),
    "receive_capture_anyrate_p": (
        lambda s: frontend.receive_capture_anyrate_p(s, ALL_RATES, LENGTH,
                                                     4),
        rx.Decode("anyrate", tuple(ALL_RATES), LENGTH), None),
}


@pytest.mark.parametrize("name", list(CAPTURES))
def test_cpu_capture_takes_no_graph_and_decodes_as_before(name, monkeypatch):
    monkeypatch.setattr(rx, "_graphs", type(rx._graphs)())
    call, decode, frame_len = CAPTURES[name]
    (re, im), payloads = _recording()
    samples = (torch.from_numpy(re)[None], torch.from_numpy(im)[None])
    trace.disable()
    trace.take()
    trace.enable()
    try:
        got = [call(samples) for _ in range(3)]
        _, counters = trace.take()
    finally:
        trace.disable()
    assert not [k for k in counters if k.startswith("rx.")]
    assert len(rx._graphs) == 0
    want = _by_hand(torch.complex(*samples), decode, 4, frame_len)
    for out in got:
        for k in out:
            assert torch.equal(out[k], want[k]), k
    ok = (want["valid"] & want["crc_ok"])[0]
    assert want["starts"][0, ok].tolist() == [1000, 9000]
    for j, pay in enumerate(payloads):
        assert want["payload"][0, j, :LENGTH].tolist() == pay.tolist()


# --- counting, and the capture's stream, without a card -------------------


@pytest.mark.parametrize("kind", ["frames", "dynamic", "anyrate"])
@pytest.mark.parametrize("on_card", [False, True])
def test_decode_counts_its_host_known_counters_once(kind, on_card):
    """Decode.count counts the universal decode's anyrate.* counters (the
    other kinds count none), and calling a Decode counts nothing, so a
    capture call counts them once whether it runs eagerly or replays."""
    (re, im), _ = _recording()
    rates = (RATE,) if kind != "anyrate" else RATES3 + (RATE,)
    dec = rx.Decode(kind, rates, LENGTH)
    stream = torch.nn.functional.pad(
        torch.complex(torch.from_numpy(re), torch.from_numpy(im))[None],
        (0, dec.pad()))
    trace.disable()
    trace.take()
    trace.enable()
    try:
        dec(stream, torch.tensor([[1000, 9000]]))
        _, silent = trace.take()
        trace.enable()
        dec.count(6, on_card)
        _, counters = trace.take()
    finally:
        trace.disable()
    assert silent == {"dropped": 0}
    want = {"dropped": 0}
    if kind == "anyrate":
        nsym = max(params_for(r).num_symbols(LENGTH) for r in rates)
        want.update({"anyrate.slots": 6, "anyrate.symbols": 6 * nsym})
        if on_card:
            want["anyrate.kernel_slots"] = 6
    assert counters == want


class _FakeCuda:
    """torch.cuda's Stream, CUDAGraph, graph and device as recorders, so
    that _Replayed's capture and replay run on the CPU: a "capture" runs
    the decode eagerly (its outputs stand for the graph's), a "replay"
    counts itself and leaves the outputs as they are."""

    def __init__(self, monkeypatch):
        self.current = []           # the devices made current, innermost last
        self.streams = []           # every Stream made
        self.captures = []          # (stream, current device) of each capture
        self.graphs = []
        fake = self

        class Stream:
            def __init__(self, device=None):
                self.device = torch.device(device)
                fake.streams.append(self)

        class CUDAGraph:
            def __init__(self):
                self.replays = 0
                fake.graphs.append(self)

            def replay(self):
                self.replays += 1

        @contextlib.contextmanager
        def device(dev):
            self.current.append(torch.device(dev))
            try:
                yield
            finally:
                self.current.pop()

        @contextlib.contextmanager
        def graph(g, pool=None, stream=None, capture_error_mode="global"):
            assert isinstance(g, CUDAGraph)
            self.captures.append((stream, self.current[-1]
                                  if self.current else None))
            yield

        for name, obj in (("Stream", Stream), ("CUDAGraph", CUDAGraph),
                          ("graph", graph), ("device", device)):
            monkeypatch.setattr(torch.cuda, name, obj)


def test_capture_runs_on_a_stream_of_the_buffers_device(monkeypatch):
    """The capture passes torch.cuda.graph a stream made on the device of
    the decode's buffers, with that device current: PyTorch's default
    capture stream lies on the device current at a process's first
    capture, and a capture there records nothing of another card's work
    (the graph then replays nothing, and every replay would hand back the
    capture pass's outputs)."""
    fake = _FakeCuda(monkeypatch)
    e = rx._Replayed(rx.Decode("frames", (RATE,), LENGTH), (1, 12000), 4,
                     CPU)
    e._capture()
    assert len(fake.streams) == 1 and len(fake.captures) == 1
    stream, current = fake.captures[0]
    assert stream is fake.streams[0]
    assert stream.device == e.stream.device == current
    assert e.graph is fake.graphs[0]
    assert fake.current == []


def test_run_decodes_and_captures_then_replays(monkeypatch):
    """A _Replayed's first run decodes eagerly and captures; every later
    run replays the graph once and returns clones of its outputs, fresh
    tensors each call. The counters: rx.decode_eager and
    rx.graph_captures on the first run, rx.graph_replays on each later
    one, the decode's anyrate.* on every run; no launch counter moves."""
    from fun_ofdm_tpu_torch.ops import softbits_cuda, viterbi_cuda

    fake = _FakeCuda(monkeypatch)
    (re, im), payloads = _recording()
    dec = rx.Decode("anyrate", (RATE,), LENGTH)
    e = rx._Replayed(dec, (1, 12000), 4, CPU)
    torch.complex(torch.from_numpy(re)[None], torch.from_numpy(im)[None],
                  out=e.samples)
    valid = torch.tensor([[True, True, False, False]])
    starts = torch.tensor([[1000, 9000, 5, 6]])
    launched = (dict(viterbi_cuda.launches), dict(softbits_cuda.launches))
    trace.disable()
    trace.take()
    trace.enable()
    try:
        first = e.run(valid, starts)
        _, c1 = trace.take()
        trace.enable()
        later = [e.run(valid, starts) for _ in range(3)]
        _, c3 = trace.take()
    finally:
        trace.disable()
    nsym = params_for(RATE).num_symbols(LENGTH)
    anyrate = {"anyrate.slots": 4, "anyrate.symbols": 4 * nsym,
               "anyrate.kernel_slots": 4}
    assert c1 == {"dropped": 0, "rx.decode_eager": 1, "rx.graph_captures": 1,
                  **anyrate}
    assert c3 == {"dropped": 0, "rx.graph_replays": 3,
                  **{k: 3 * v for k, v in anyrate.items()}}
    assert len(fake.graphs) == 1 and fake.graphs[0].replays == 3
    assert (dict(viterbi_cuda.launches),
            dict(softbits_cuda.launches)) == launched
    assert e.starts.tolist() == [[1000, 9000, 0, 0]]
    for j, pay in enumerate(payloads):
        assert first["payload"][0, j, :LENGTH].tolist() == pay.tolist()
    ptrs = {v.data_ptr() for v in e.out.values()}
    for out in later:
        assert out.keys() == first.keys()
        for k in out:
            assert torch.equal(out[k], first[k]), k
            assert out[k].data_ptr() not in ptrs
    assert len({later[0]["payload"].data_ptr(),
                later[1]["payload"].data_ptr()}) == 2


# --- shared state under threads ----------------------------------------------


def _threads(n: int, target) -> None:
    """Run target(i) on n threads at once, with a short switch interval."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        barrier = threading.Barrier(n)

        def run(i):
            barrier.wait(timeout=30)
            target(i)
        ts = [threading.Thread(target=run, args=(i,)) for i in range(n)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)


def test_concurrent_lookups_give_one_entry_a_key(monkeypatch):
    monkeypatch.setattr(rx, "_graphs", type(rx._graphs)())
    dec = rx.Decode("frames", (RATE,), LENGTH)
    seen = [[] for _ in range(16)]

    def look(i):
        for j in range(200):
            key = ("k", (i + j) % rx.GRAPHS_KEPT)
            seen[i].append((key, rx._replayed(key, dec, (1, 64), 2, CPU)))
    _threads(16, look)
    entries: dict = {}
    for key, e in (x for s in seen for x in s):
        assert entries.setdefault(key, e) is e
    assert len(entries) == len(rx._graphs) == rx.GRAPHS_KEPT

    def churn(i):
        for j in range(50):
            rx._replayed(("c", i, j), dec, (1, 64), 2, CPU)
    _threads(16, churn)
    assert len(rx._graphs) == rx.GRAPHS_KEPT
