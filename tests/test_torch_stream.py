"""The port's streaming ReceiverChain against fun_ofdm_tpu's, on the CPU.

Each case feeds the same stream, in the same pieces, to the JAX
`ReceiverChain` and to the port's on `device="cpu"`, and requires the same
packets (payload, rate, length, start, channel, in delivery order) after
`flush()` and the same ChainStats counters (the two host wait times
aside). Streams are small (payloads <= 120 bytes, <= 30k samples per
channel); frames come from the JAX TX builder as float32. The port's
own tests at the end cover what has no JAX twin: the merge-guard
re-decode, the viterbi_impl knob, the required device, the parts not
ported, and that the chain imports no jax.
"""

import dataclasses
import functools
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fun_ofdm_tpu.config import ChainParams
from fun_ofdm_tpu.models import frontend as j_frontend
from fun_ofdm_tpu.models import tx as j_tx
from fun_ofdm_tpu.runtime import chain as j_chain
from fun_ofdm_tpu_torch.models import frontend
from fun_ofdm_tpu_torch.rates import ALL_RATES, Rate
from fun_ofdm_tpu_torch.runtime import chain

torch.set_num_threads(1)

#: ChainStats fields that are host wall times, not counts
_TIMES = ("time_headers_s", "time_decode_s")


@functools.lru_cache(maxsize=None)
def _frame(rate: Rate, length: int, seed: int):
    payload = np.random.default_rng(seed).integers(0, 256, length,
                                                   dtype=np.uint8)
    re, im = j_tx.build_frame_p_jit(rate)(jnp.asarray(payload))
    return (np.asarray(re, np.float32) + 1j * np.asarray(im, np.float32),
            payload)


def _stream(plan, n: int, channels: int | None = None):
    """Complex64 stream of n samples ((channels, n) when given) with
    frames laid in; plan entries are (pos, rate, length) or
    (channel, pos, rate, length). A frame may be cut by the end."""
    s = np.zeros(n if channels is None else (channels, n), np.complex64)
    for k, entry in enumerate(plan):
        *ch, pos, rate, length = entry
        f, _ = _frame(rate, length, k)
        cut = min(f.size, n - pos)
        s[(*ch, slice(pos, pos + cut))] = f[:cut]
    return s


def _feed(c, pieces, terminal=True):
    pkts = []
    for p in pieces:
        pkts += c.process_samples(p)
    return pkts + c.flush(terminal=terminal)


def _key(pkts):
    return [(p.payload, p.rate, p.length, p.start, p.channel) for p in pkts]


def _counts(stats):
    return {k: v for k, v in dataclasses.asdict(stats).items()
            if k not in _TIMES}


def _both(pieces_list, **kw):
    """Run both chains over one or more streams (non-terminal flush
    between them); return the port's packets per stream and chain."""
    j, t = j_chain.ReceiverChain(**kw), chain.ReceiverChain(**kw,
                                                            device="cpu")
    got = []
    for i, pieces in enumerate(pieces_list):
        last = i == len(pieces_list) - 1
        want_p = _feed(j, pieces, terminal=last)
        got_p = _feed(t, pieces, terminal=last)
        assert _key(got_p) == _key(want_p)
        got.append(got_p)
    assert _counts(t.stats) == _counts(j.stats)
    return got, t


def _chunks(stream, sizes):
    out, i = [], 0
    for sz in sizes:
        out.append(stream[..., i:i + sz])
        i += sz
    return out


# ------------------------------------------------------------ parity ----

@pytest.mark.parametrize("sizes", [[20000],
                                   [1000, 3000, 123, 8000, 5000, 2877]])
def test_mixed_rates_and_boundaries_match_jax(sizes):
    """The universal default rates; a frame straddles the 4096-sample
    chunk boundary; ragged pieces."""
    plan = [(500, Rate.RATE_3_4_QAM16, 100), (4000, Rate.RATE_1_2_BPSK, 57),
            (9100, Rate.RATE_2_3_QAM64, 120)]
    (pkts,), c = _both([_chunks(_stream(plan, 20000), sizes)],
                       max_length=120)
    assert c.decode_mode == "universal" and c.rates == ALL_RATES
    assert [(p.start, p.rate) for p in pkts] == [(p, r) for p, r, _ in plan]
    assert all(p.payload == _frame(r, ln, k)[1].tobytes()
               for k, (p, (_, r, ln)) in enumerate(zip(pkts, plan)))


def test_per_rate_counters_match_jax():
    """A per-rate chain: an unconfigured rate's frame, a frame longer than
    max_length, a corrupted frame (CRC failure) and six short frames in
    one superstep (a larger decode bucket)."""
    q = Rate.RATE_1_2_QPSK
    plan = [(100, q, 60), (1500, Rate.RATE_3_4_QAM16, 40), (2600, q, 90)]
    plan += [(6000 + 620 * i, q, 2) for i in range(6)]
    plan += [(11000, q, 60)]
    s = _stream(plan, 14000)
    s[11000 + 700:11000 + 800] = 0       # corrupt the last frame's payload
    (pkts,), c = _both([_chunks(s, [3000] * 5)], rates=(q,), max_length=64,
                       verbose=True)
    assert [p.start for p in pkts] == [100] + [6000 + 620 * i
                                               for i in range(6)]
    assert (c.stats.unknown_rate, c.stats.length_overflow,
            c.stats.crc_fail) == (1, 1, 1)


@pytest.mark.parametrize("ingest", ["int16", "int12", "int10"])
def test_quantized_ingest_matches_jax(ingest):
    """Wire formats, both through whole-superstep buffers already in the
    format (the fast path, unpacked on the device) and through ragged
    float pieces (quantized on the host)."""
    params = ChainParams(chunk_size=1024, strides_per_step=4)  # step 4096
    rates = (Rate.RATE_3_4_QAM64,) if ingest != "int16" \
        else (Rate.RATE_3_4_QAM16,)
    plan = [(700, rates[0], 90), (6000, rates[0], 33)]
    s = _stream(plan, 16384)
    np_dtype, scale = chain.INGEST_FORMATS[ingest]
    if ingest in chain.PACKED_FORMATS:
        gb, gs = chain.PACKED_FORMATS[ingest]
        wire = [chain._pack_np(x.astype(np.float32), ingest, scale)
                for x in (s.real, s.imag)]
        step = 4096 * gb // gs
    else:
        wire = [np.clip(np.rint(x * scale), -32767, 32767).astype(np_dtype)
                for x in (s.real, s.imag)]
        step = 4096
    whole = [(wire[0][i:i + step], wire[1][i:i + step])
             for i in range(0, wire[0].size, step)]
    ragged = _chunks(s, [700] * 24)
    for pieces in (whole, ragged):
        (pkts,), _ = _both([pieces], rates=rates, max_length=100,
                           params=params, ingest_dtype=ingest)
        assert [p.start for p in pkts] == [700, 6000]


def test_header_slots_overflow_matches_jax():
    """Eight frames in one superstep against a budget of three header
    slots: the full-capacity pass re-runs, nothing is lost."""
    q16 = Rate.RATE_3_4_QAM16
    plan = [(200 + i * 900, q16, 20) for i in range(8)]
    s = _stream(plan, 16384)
    params = ChainParams(chunk_size=4096, strides_per_step=4, header_slots=3)
    (pkts,), c = _both([[s]], rates=(q16,), max_length=24, params=params)
    assert [p.start for p in pkts] == [p for p, _, _ in plan]
    assert c.stats.header_overflows >= 1


def test_multichannel_matches_jax():
    """channels=3, mixed rates, one start shared by two channels, a frame
    in every superstep position and one cut short by the end of the last
    channel (the flattened window's far edge)."""
    rates = (Rate.RATE_1_2_QPSK, Rate.RATE_3_4_QAM16)
    n = 12000
    plan = [(0, 300, rates[0], 40), (0, 5000, rates[1], 40),
            (1, 1200, rates[1], 40), (2, 300, rates[0], 40),
            (2, 7000, rates[0], 40), (2, n - 400, rates[1], 40)]
    s = _stream(plan, n, channels=3)
    (pkts,), c = _both([_chunks(s, [2500] * 5)], rates=rates, max_length=40,
                       channels=3)
    assert sorted((p.channel, p.start) for p in pkts) == sorted(
        (ch, pos) for ch, pos, _, _ in plan[:5])
    assert c.stats.crc_fail == 1


def test_nonterminal_flush_serves_two_streams_like_jax():
    q = Rate.RATE_1_2_QPSK
    s1 = _stream([(700, q, 60)], 9000)
    s2 = _stream([(1234, q, 44)], 7000)
    (p1, p2), c = _both([[s1], _chunks(s2, [1000] * 7)], rates=(q,),
                        max_length=80)
    assert [p.start for p in p1] == [700] and [p.start for p in p2] == [1234]
    assert c.stats.crc_ok == 2


def test_detect_dropped_reaches_stats_like_jax(monkeypatch):
    """The blocked extractor's cap shrunk to one event per 4096 samples:
    the second of two back-to-back frames is dropped and counted, on both
    sides alike."""
    for mod in (frontend, j_frontend):
        monkeypatch.setattr(mod, "_BLOCKED_MIN_N", 0)
        monkeypatch.setattr(mod, "_BLOCK", 4096)
        monkeypatch.setattr(mod, "_BLOCK_CAP", 1)
    b = Rate.RATE_1_2_BPSK
    f = _frame(b, 16, 0)[0].size
    s = _stream([(100, b, 16), (100 + f, b, 16)], 12288)
    # params of their own: the JAX step function is traced anew under
    # the patched geometry
    params = ChainParams(chunk_size=6144, strides_per_step=1,
                         max_frames_per_chunk=2, lts_search=127)
    (pkts,), c = _both([[s]], rates=(b,), max_length=16, params=params)
    assert [p.start for p in pkts] == [100]
    assert c.stats.detect_dropped >= 1


def test_fuzz_matches_jax_and_anyrate_capture():
    """Random frames (rates, lengths, gaps) in random piece sizes: both
    chains deliver what the one-shot any-rate capture finds."""
    rng = np.random.default_rng(100)
    rates = (Rate.RATE_1_2_BPSK, Rate.RATE_1_2_QPSK, Rate.RATE_3_4_QAM16,
             Rate.RATE_2_3_QAM64)
    n, plan, pos = 24000, [], int(rng.integers(40, 400))
    while True:
        r = rates[rng.integers(len(rates))]
        ln = int(rng.integers(4, 65))
        size = _frame(r, ln, len(plan))[0].size
        if pos + size + 600 > n:
            break
        plan.append((pos, r, ln))
        pos += size + int(rng.integers(80, 700))
    s = _stream(plan, n)
    sizes = [int(x) for x in rng.integers(1, 6000, 20)]
    (pkts,), _ = _both([_chunks(s, sizes + [n])], rates=rates, max_length=64)
    oracle = frontend.receive_capture_anyrate_p(
        (torch.from_numpy(s.real.copy()), torch.from_numpy(s.imag.copy())),
        rates, 64, max_frames=len(plan) + 4)
    ok = oracle["crc_ok"].numpy()
    want = sorted((int(st), bytes(p[:ln].astype(np.uint8)))
                  for st, ln, p in zip(oracle["starts"].numpy()[ok],
                                       oracle["hdr_length"].numpy()[ok],
                                       oracle["payload"].numpy()[ok]))
    assert len(want) == len(plan)
    assert sorted((p.start, p.payload) for p in pkts) == want


def test_static_tables_match_jax():
    """Superstep geometry, detection capacity, header budget and the
    length classes of the any-rate decode equal fun_ofdm_tpu's."""
    cases = [dict(), dict(max_length=120),
             dict(rates=(Rate.RATE_3_4_QAM16,), max_length=1500),
             dict(max_length=1500, params=ChainParams(
                 strides_per_step=512, min_frame_samples=4000,
                 header_slots=384)),
             dict(rates=(Rate.RATE_1_2_QPSK, Rate.RATE_2_3_QAM64),
                  max_length=64, channels=3,
                  params=ChainParams(chunk_size=2048, strides_per_step=2,
                                     max_frames_per_chunk=3))]
    for kw in cases:
        j = j_chain.ReceiverChain(**kw)
        t = chain.ReceiverChain(**kw, device="cpu")
        for attr in ("step", "halo", "window", "max_frames", "decode_mode",
                     "_classes", "_field_class", "_valid_fields"):
            assert getattr(t, attr) == getattr(j, attr), (attr, kw)
        assert chain.length_classes(t.rates, t.max_length) == j._classes
        assert t._n_hdr == (j.max_frames if j.params.header_slots is None
                            else max(2, min(j.params.header_slots,
                                            j.max_frames)))
    assert chain.DECODE_BUCKETS == j_chain.DECODE_BUCKETS
    assert chain._impl_for_bucket("auto", 64) == \
        j_chain._impl_for_bucket("auto", 64) == "pallas-blocked"
    assert chain._impl_for_bucket("auto", 256) is None


# ---------------------------------------------------------- the port ----

def test_merge_guard_fallback_redecodes_exactly(monkeypatch):
    """A primary decode that reports viterbi_exact = 0 is re-decoded with
    the exact Viterbi and counted; the packet comes from the re-decode
    (the port's version of test_chain_viterbi_merge_guard_fallback)."""
    orig = chain._build_decode_fn

    def patched(rate, bucket, max_length, impl, cfo_correct=False):
        fn = orig(rate, bucket, max_length, impl, cfo_correct)
        if impl == "exact":
            return fn

        def wrap(wr, wi, starts):
            out = fn(wr, wi, starts).clone()
            out[:, :max_length] = 0xAB          # garbage payload
            out[:, max_length] = 0              # crc_ok False
            out[:, max_length + 3] = 0          # the guard tripped
            return out
        return wrap

    monkeypatch.setattr(chain, "_build_decode_fn", patched)
    q = Rate.RATE_1_2_QPSK
    s = _stream([(150, q, 60)], 10000)
    c = chain.ReceiverChain(rates=(q,), max_length=60, device="cpu")
    pkts = _feed(c, [s])
    assert c.stats.viterbi_fallbacks == 1
    assert [(p.start, p.payload) for p in pkts] == [
        (150, _frame(q, 60, 0)[1].tobytes())]


@pytest.mark.parametrize("impl", ["scan", "exact", "pallas-blocked"])
def test_viterbi_impl_knob(impl):
    q = Rate.RATE_1_2_QPSK
    s = _stream([(90, q, 30)], 8192)
    c = chain.ReceiverChain(rates=(q,), max_length=30, viterbi_impl=impl,
                            device="cpu")
    assert c.viterbi_impl == impl
    assert [(p.start, p.payload) for p in _feed(c, [s])] == [
        (90, _frame(q, 30, 0)[1].tobytes())]


def test_device_is_required_and_unported_parts_raise():
    # the device defaults to the card, and the chain never moves off it
    assert inspect.signature(chain.ReceiverChain).parameters[
        "device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            c = chain.ReceiverChain(prewarm_exact=False)
            c.process_samples(np.zeros(8192, np.complex64))
            c.flush()
    with pytest.raises(ValueError, match="no chain"):
        chain.ReceiverChain(device="meta")
    assert chain.ReceiverChain(cfo_correct=True, device="cpu").cfo_correct
    with pytest.raises(NotImplementedError, match="adaptive"):
        chain.ReceiverChain(params=ChainParams(latency_target_ms=20.0),
                            device="cpu")
    with pytest.raises(ValueError, match="64-QAM"):
        chain.ReceiverChain(ingest_dtype="int8", device="cpu")
    c = chain.ReceiverChain(rates=(Rate.RATE_1_2_QPSK,), max_length=16,
                            device="cpu")
    assert c.strides_per_step == 1 and c.flush() == [] \
        and c.stats.windows == 0

