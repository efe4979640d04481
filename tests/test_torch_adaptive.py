"""The port's adaptive superstep ladder (ChainParams.latency_target_ms)
against fun_ofdm_tpu's, on the CPU.

The ladder dispatches by the host clock: pending samples go out in
ladder rungs once the oldest is half the latency target old. Two targets
make that deterministic, and there both chains are held to the same
packets (payload, rate, length, start, channel, in delivery order) and
the same ChainStats counters: 0.0 (every call pumps its whole backlog in
the largest rungs that fit) and 1e9 (nothing but full supersteps, fixed
mode's dispatches). The ports of fun_ofdm_tpu's clock-driven adaptive
tests (tests/test_runtime.py) run the port alone, with their
assertions. fun_ofdm_tpu's adaptive multi-channel flush() fails (it rolls
1-D zeros into the (C, window) window and leaves the pending samples);
the port's is held to a fixed-mode chain instead. Streams are tiny
(chunk_size 1024, payloads <= 48 bytes); frames come from the JAX TX
builder as float32.
"""

import dataclasses
import functools
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fun_ofdm_tpu.config import ChainParams as JChainParams
from fun_ofdm_tpu.models import tx as j_tx
from fun_ofdm_tpu.runtime import chain as j_chain
from fun_ofdm_tpu_torch.config import ChainParams
from fun_ofdm_tpu_torch.rates import Rate
from fun_ofdm_tpu_torch.runtime import chain
from fun_ofdm_tpu_torch.runtime.wire import pack10

torch.set_num_threads(1)

Q = Rate.RATE_1_2_QPSK
#: the JAX chain's ChainStats fields that are host wall times, not counts
#: (the port times its stages with spans instead: utils/trace.py)
_TIMES = ("time_headers_s", "time_decode_s")


@functools.lru_cache(maxsize=None)
def _frame(length: int, seed: int, rate: Rate = Q):
    payload = np.random.default_rng(seed).integers(0, 256, length,
                                                   dtype=np.uint8)
    f = np.asarray(j_tx.build_frame(jnp.asarray(payload), rate))
    return f.astype(np.complex64), payload.tobytes()


def _key(pkts):
    return [(p.payload, p.rate, p.length, p.start, p.channel) for p in pkts]


def _counts(stats):
    return {k: v for k, v in dataclasses.asdict(stats).items()
            if k not in _TIMES}


def _chains(target, **kw):
    """The JAX chain and the port's on the CPU, one configuration."""
    params = kw.pop("params")
    j = j_chain.ReceiverChain(**kw, params=JChainParams(
        **{**dataclasses.asdict(params), "latency_target_ms": target}))
    t = chain.ReceiverChain(**kw, params=dataclasses.replace(
        params, latency_target_ms=target), device="cpu")
    return j, t


def _run(c, rounds, flush=True):
    """rounds: a list of piece lists, each ending in a non-terminal flush
    but the last (which ends in a terminal one when flush is set)."""
    pkts = []
    for i, pieces in enumerate(rounds):
        for p in pieces:
            pkts += c.process_samples(p)
        last = i == len(rounds) - 1
        if flush or not last:
            pkts += c.flush(terminal=last)
    return pkts


def _planar(x):
    return (np.ascontiguousarray(x.real, np.float32),
            np.ascontiguousarray(x.imag, np.float32))


def _q16(x):
    return tuple(np.clip(np.rint(p * 8192), -32767, 32767).astype(np.int16)
                 for p in _planar(x))


# --- the streams of fun_ofdm_tpu's adaptive tests (tests/test_runtime.py)

def _sparse():
    """test_runtime.py:993: a frame mid-stream, idle pieces, a second
    frame, far less than a 16-stride superstep in all."""
    f, _ = _frame(48, 23)
    s1 = np.zeros(6 * 1024, np.complex64)
    s1[1500:1500 + f.size] = f
    s2 = np.zeros(3 * 1024, np.complex64)
    s2[100:100 + f.size] = f
    idle = np.zeros(1024, np.complex64)
    return dict(rates=(Q,), max_length=48,
                params=ChainParams(chunk_size=1024, strides_per_step=16)), \
        [[s1, idle, idle, s2, idle, idle, idle]]


def _dense():
    """test_runtime.py:1031: six frames in 24 strides, fed in 3000-sample
    pieces."""
    f, _ = _frame(40, 29)
    s = np.zeros(24 * 1024, np.complex64)
    for st in (50, 1100, 2248, 8192, 12000, 20000):
        s[st:st + f.size] += f
    return dict(rates=(Q,), max_length=40, params=ChainParams(
        chunk_size=1024, strides_per_step=8)), \
        [[s[i:i + 3000] for i in range(0, s.size, 3000)]]


def _header_budget():
    """Back-to-back frames (1100 samples apart), in 4096-sample pieces,
    with a budget of 2 headers a dispatch: a 4-stride rung detects 3
    frames or more and re-runs its header pass at its own capacity."""
    f, _ = _frame(40, 31)
    s = np.zeros(24 * 1024, np.complex64)
    for st in range(100, s.size - f.size, 1100):
        s[st:st + f.size] = f
    return dict(rates=(Q,), max_length=40, params=ChainParams(
        chunk_size=1024, strides_per_step=8, header_slots=2)), \
        [[s[i:i + 4096] for i in range(0, s.size, 4096)]]


def _int16_two_streams():
    """test_runtime.py:1187: int16 wire buffers, two streams through one
    chain with a non-terminal flush between them."""
    f, _ = _frame(32, 53)
    s = np.zeros(5000, np.complex64)
    s[900:900 + f.size] = f
    idle = (np.zeros(512, np.int16), np.zeros(512, np.int16))
    return dict(rates=(Q,), max_length=32, ingest_dtype="int16",
                params=ChainParams(chunk_size=1024, strides_per_step=8)), \
        [[_q16(s), idle, idle], [_q16(s), idle, idle]]


def _packed_int10():
    """test_runtime.py:1217: packed int10 bytes, unpacked into the pending
    buffer and packed again per dispatch."""
    f, _ = _frame(24, 61)
    s = np.zeros(6000, np.complex64)
    s[800:800 + f.size] = f
    idle = pack10(np.zeros(1024, np.float32))
    return dict(rates=(Q,), max_length=24, ingest_dtype="int10",
                params=ChainParams(chunk_size=1024, strides_per_step=8)), \
        [[tuple(pack10(p) for p in _planar(s)), (idle, idle), (idle, idle)]]


def _multichannel(channels=3):
    """test_runtime.py:1381: one frame per channel at its own offset, then
    idle pieces."""
    f, _ = _frame(28, 83)
    s = np.zeros((channels, 5 * 1024), np.complex64)
    for c in range(channels):
        s[c, 700 + 31 * c:700 + 31 * c + f.size] = f
    idle = np.zeros((channels, 1024), np.complex64)
    return dict(rates=(Q,), max_length=28, channels=channels,
                params=ChainParams(chunk_size=1024, strides_per_step=16)), \
        [[_planar(s), _planar(idle), _planar(idle[:, :700])]]


_STREAMS = {"sparse": _sparse, "dense": _dense,
            "header_budget": _header_budget,
            "int16_two_streams": _int16_two_streams,
            "packed_int10": _packed_int10}


# ------------------------------------------------------------ parity ----

@pytest.mark.parametrize("target", [0.0, 1e9])
@pytest.mark.parametrize("stream", sorted(_STREAMS))
def test_deterministic_targets_match_jax(stream, target):
    kw, rounds = _STREAMS[stream]()
    j, t = _chains(target, **kw)
    want, got = _run(j, rounds), _run(t, rounds)
    assert _key(got) == _key(want) and got
    assert _counts(t.stats) == _counts(j.stats)
    if target == 0.0:
        # rungs below a superstep went out
        assert t.stats.windows > -(-t._t_real // t.step)
    if stream == "header_budget":
        assert t.stats.header_overflows > 0 and t.stats.crc_ok == 22 \
            and not t.stats.crc_fail


@pytest.mark.parametrize("target", [0.0, 1e9])
def test_multichannel_matches_jax_before_flush(target):
    # fun_ofdm_tpu's adaptive multi-channel flush fails, so the two
    # chains are compared on what the pieces alone deliver: at 0.0 each
    # frame, at 1e9 nothing (no superstep filled)
    kw, rounds = _multichannel()
    j, t = _chains(target, **kw)
    want, got = _run(j, rounds, flush=False), _run(t, rounds, flush=False)
    # force the in-flight results out of both pipelines
    want += j._drain(force=True)
    got += t._drain(force=True)
    assert _key(got) == _key(want)
    assert len(got) == (3 if target == 0.0 else 0)
    assert _counts(t.stats) == _counts(j.stats)


@pytest.mark.parametrize("target", [0.0, 1e9])
def test_multichannel_flush_equals_fixed_mode(target):
    kw, rounds = _multichannel()
    fixed = chain.ReceiverChain(**kw, device="cpu")
    adaptive = chain.ReceiverChain(**{**kw, "params": dataclasses.replace(
        kw["params"], latency_target_ms=target)}, device="cpu")
    want, got = _run(fixed, rounds), _run(adaptive, rounds)
    assert sorted(_key(got)) == sorted(_key(want))
    assert sorted((p.channel, p.start) for p in got) == \
        [(c, 700 + 31 * c) for c in range(3)]
    # a tail under one stride, padded to the smallest rung
    assert adaptive._t_real % adaptive.stride


def test_capacity_and_ladder_match_jax():
    cases = [dict(rates=(Q,), max_length=48,
                  params=ChainParams(chunk_size=1024, strides_per_step=16)),
             dict(max_length=1500, params=ChainParams(
                 strides_per_step=512, min_frame_samples=4000,
                 header_slots=384)),
             dict(rates=(Q, Rate.RATE_2_3_QAM64), max_length=64, channels=2,
                  params=ChainParams(chunk_size=2048, strides_per_step=300,
                                     max_frames_per_chunk=3,
                                     header_slots=5)),
             dict(rates=(Q,), max_length=100,
                  params=ChainParams(strides_per_step=1))]
    for kw in cases:
        j, t = _chains(40.0, **kw)
        assert t._ladder == j._ladder
        for rung in t._ladder:
            k = rung * t.stride
            assert t._capacity(k) == j._capacity(k), (kw, rung)
            hs = kw["params"].header_slots
            assert t._header_slots(t._capacity(k)) == (
                j._capacity(k) if hs is None
                else max(2, min(hs, j._capacity(k))))
        assert t._capacity(t.step) == t.max_frames == j.max_frames


# ------------------------------------- fun_ofdm_tpu's clock-driven tests ----

def _until(c, idle, pkts, want: int, deadline_s: float = 20.0):
    """Feed idle pieces until `want` packets came back (or the deadline)."""
    deadline = time.time() + deadline_s
    while len(pkts) < want and time.time() < deadline:
        time.sleep(0.02)
        pkts += c.process_samples(idle)
    return pkts


def test_adaptive_sparse_delivery():
    """test_runtime.py:993: delivered before a full superstep is pending,
    exactly once across mixed dispatch sizes."""
    f, payload = _frame(48, 23)
    c = chain.ReceiverChain(rates=(Q,), max_length=48, params=ChainParams(
        chunk_size=1024, strides_per_step=16, latency_target_ms=30.0),
        device="cpu")
    stream = np.zeros(6 * 1024, np.complex64)
    stream[1500:1500 + f.size] = f
    idle = np.zeros(1024, np.complex64)
    pkts = _until(c, idle, list(c.process_samples(stream)), 1)
    assert [(p.start, p.payload) for p in pkts] == [(1500, payload)]
    stream2 = np.zeros(3 * 1024, np.complex64)
    stream2[100:100 + f.size] = f
    base = c._t_real
    pkts2 = _until(c, idle, list(c.process_samples(stream2)), 1)
    pkts2 += [p for p in c.flush() if p.start >= base]
    assert [(p.start, p.payload) for p in pkts2] == [(base + 100, payload)]


def test_adaptive_dense_stream_exactly_once():
    """test_runtime.py:1031."""
    f, payload = _frame(40, 29)
    c = chain.ReceiverChain(rates=(Q,), max_length=40, params=ChainParams(
        chunk_size=1024, strides_per_step=8, latency_target_ms=50.0),
        device="cpu")
    starts = [50, 1100, 2248, 8192, 12000, 20000]
    stream = np.zeros(24 * 1024, np.complex64)
    for st in starts:
        stream[st:st + f.size] += f
    pkts = []
    for i in range(0, stream.size, 3000):
        pkts += c.process_samples(stream[i:i + 3000])
    pkts += c.flush()
    assert sorted(p.start for p in pkts) == starts
    assert all(p.payload == payload for p in pkts)


def test_adaptive_int16_ingest_and_nonterminal_flush():
    """test_runtime.py:1187."""
    f, payload = _frame(32, 53)
    c = chain.ReceiverChain(rates=(Q,), max_length=32, params=ChainParams(
        chunk_size=1024, strides_per_step=8, latency_target_ms=20.0),
        ingest_dtype="int16", device="cpu")
    idle = (np.zeros(512, np.int16), np.zeros(512, np.int16))
    for stream_round in range(2):
        stream = np.zeros(5000, np.complex64)
        stream[900:900 + f.size] = f
        pkts = _until(c, idle, list(c.process_samples(_q16(stream))), 1)
        pkts += c.flush(terminal=False)
        assert [(p.start, p.payload) for p in pkts] == [(900, payload)], \
            stream_round


def test_adaptive_packed_int10_buffers():
    """test_runtime.py:1217: bytes are unpacked, not taken as samples."""
    f, payload = _frame(24, 61)
    c = chain.ReceiverChain(rates=(Q,), max_length=24, params=ChainParams(
        chunk_size=1024, strides_per_step=8, latency_target_ms=15.0),
        ingest_dtype="int10", device="cpu")
    stream = np.zeros(6000, np.complex64)
    stream[800:800 + f.size] = f
    pkts = list(c.process_samples(tuple(pack10(p) for p in _planar(stream))))
    assert c.stats.samples_in == 6000
    idle = pack10(np.zeros(1024, np.float32))
    pkts = _until(c, (idle, idle), pkts, 1)
    assert [(p.start, p.payload) for p in pkts] == [(800, payload)]
    with pytest.raises(ValueError, match="multiple of 5 bytes"):
        c.process_samples((idle[:7], idle[:7]))


def test_adaptive_multichannel_sparse_delivery():
    """test_runtime.py:1381: with correct channel tags."""
    f, payload = _frame(28, 83)
    c = chain.ReceiverChain(rates=(Q,), max_length=28, params=ChainParams(
        chunk_size=1024, strides_per_step=16, latency_target_ms=25.0),
        channels=3, device="cpu")
    stream = np.zeros((3, 5 * 1024), np.complex64)
    for ch in range(3):
        stream[ch, 700 + 31 * ch:700 + 31 * ch + f.size] = f
    idle = _planar(np.zeros((3, 1024), np.complex64))
    pkts = _until(c, idle, list(c.process_samples(_planar(stream))), 3)
    assert sorted((p.channel, p.start) for p in pkts) == \
        [(ch, 700 + 31 * ch) for ch in range(3)]
    assert all(p.payload == payload for p in pkts)


def test_receiver_takes_a_latency_target():
    """api.Receiver hands its chain_params to the chain: with a target no
    backlog reaches, a frame waits in the pending buffer and stop()'s
    flush delivers it."""
    from fun_ofdm_tpu_torch.api import Receiver

    f, payload = _frame(48, 23)
    got = []
    rx = Receiver(got.extend, source=None, rates=(Q,), max_length=48,
                  chain_params=ChainParams(chunk_size=1024,
                                           strides_per_step=16,
                                           latency_target_ms=1e9),
                  start=False, device="cpu")
    try:
        assert rx.chain.adaptive and rx.chain._ladder == [1, 4, 16]
        stream = np.concatenate([np.zeros(300, np.complex64), f])
        assert rx.chain.process_samples(stream) == []
        assert rx.chain._pend_n == stream.size and not rx.chain.stats.windows
    finally:
        rx.stop()
        rx.source.close()
    assert [(p.start, p.payload) for p in got] == [(300, payload)]
