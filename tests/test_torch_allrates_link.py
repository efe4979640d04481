"""The all-rates live link: a K=1 ReceiverChain over all 11 rates on the
int10 wire, fed 4,096-sample reads as fun_ofdm's receiver reads its radio,
decoding every frame at the rate and length its SIGNAL header gives
(the chain's universal mode: length classes, one any-rate decode a class,
buckets of 4, the block-overlap Viterbi and its guard).

The stream holds lone frames from the benchmark's plain transmitter
(phybench/reference/phy.py, which shares no code with the port), the 11
rates in the order of fun_ofdm's rates.h, twice, each frame followed by
zeros; every second frame carries AWGN at 12.5 dB after its preamble, so
every rate comes once clean and once noisy. Every sample lies on the
int10 grid (scale 128), as the wire delivers it. Every noiseless frame
comes back once with its start, rate, length and payload exact; every
noisy one as the plain receiver's float64 decode of the same samples
gives it (delivered when its CRC holds there, with the same bytes); and
nothing else comes back.

On the CPU, max_length is cut from the Receiver's default 1,500 to 120 and
every frame is 120 bytes: the port's blocked Viterbi and the plain
receiver's trellis run step by step in Python there, and the halo (the
slowest rate's longest frame) falls from 40,640 samples to 3,840. The
gap between frames, 4,200 zeros, keeps one frame to a 4,096-sample
dispatch, so each decoded frame is one bucket of 4 slots.

The tracer's counters of the universal dispatch (chain.decode_jobs,
chain.decode_slots, chain.decode_frames, anyrate.symbols_needed) equal
their values computed from the plain receiver's headers, and nothing is
counted with the tracer off. The test marked `cuda` runs the same stream
through a chain on the card and holds its packets and counters to the
CPU chain's. The file imports no jax, so it runs on the card with
--noconftest:

    python -m pytest --noconftest tests/test_torch_allrates_link.py -q
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from fun_ofdm_tpu_torch.config import ChainParams
from fun_ofdm_tpu_torch.rates import ALL_RATES, Rate, params_for
from fun_ofdm_tpu_torch.runtime.chain import ReceiverChain, length_classes
from fun_ofdm_tpu_torch.utils import trace
from phybench.reference import phy

MAX_LENGTH = 120
READ = 4096
GAP = 4200
SNR_DB = 12.5
CYCLES = 2
WIRE_SCALE, WIRE_TOP = 128, 512
SEED = 19
#: the chain's counters of the universal dispatch
COUNTERS = ("chain.decode_jobs", "chain.decode_slots", "chain.decode_frames",
            "anyrate.symbols_needed")


def lone_frames(seed: int = SEED):
    """Planar float32 samples on the int10 grid, and (start, rate index,
    payload bytes, noisy) of each frame: CYCLES x the 11 rates in turn,
    every second frame noisy after its preamble, GAP zeros after each."""
    rng = np.random.default_rng(seed)
    sd = math.sqrt(phy.SYMBOL_POWER / 10 ** (SNR_DB / 10) / 2)
    parts, frames, pos = [], [], 0
    for i in range(CYCLES * len(phy.RATES)):
        r, noisy = i % len(phy.RATES), i % 2 == 1
        pay = rng.integers(0, 256, size=(1, MAX_LENGTH), dtype=np.uint8)
        f = phy.build_frames(pay, r)[0].numpy()
        if noisy:
            m = f.size - phy.PREAMBLE_LEN
            f[phy.PREAMBLE_LEN:] += sd * (rng.standard_normal(m)
                                          + 1j * rng.standard_normal(m))
        parts += [f, np.zeros(GAP, np.complex128)]
        frames.append((pos, r, pay[0].tobytes(), noisy))
        pos += f.size + GAP
    x = np.concatenate(parts)

    def grid(v):
        return (np.clip(np.round(v * WIRE_SCALE), -WIRE_TOP, WIRE_TOP - 1)
                / WIRE_SCALE).astype(np.float32)
    return (grid(x.real), grid(x.imag)), frames


def run_chain(stream, device, traced: bool):
    """The K=1 all-rates int10 chain over the stream in READ-sample reads,
    then flush(): its packets as (start, rate name, length, payload), its
    stats, and the tracer's counters (with the tracer on, else what take()
    returns after the run)."""
    chain = ReceiverChain(rates=ALL_RATES, max_length=MAX_LENGTH,
                          params=ChainParams(chunk_size=READ,
                                             strides_per_step=1),
                          ingest_dtype="int10", device=device)
    re, im = stream
    trace.take()
    if traced:
        trace.enable()
    try:
        pkts = []
        for i in range(0, re.size, READ):
            pkts += chain.process_samples((re[i:i + READ], im[i:i + READ]))
        pkts += chain.flush()
    finally:
        trace.disable()
    _, counters = trace.take()
    rows = sorted((p.start, p.rate.name, p.length, p.payload) for p in pkts)
    return rows, chain.stats, counters


@pytest.fixture(scope="module")
def link():
    stream, frames = lone_frames()
    rows, stats, counters = run_chain(stream, "cpu", traced=True)
    return stream, frames, rows, stats, counters


def reference(stream, frames):
    """The plain receiver over the same wire samples in float64: each
    frame's header (rate index or -1, length, ok) and its answer (start,
    rate name, length, payload) when its header and CRC hold, else None."""
    x = torch.from_numpy(stream[0].astype(np.float64)
                         + 1j * stream[1].astype(np.float64))
    starts = np.array([f[0] for f in frames])
    rate, length, ok = phy.decode_headers(x, starts)
    dec = phy.decode(x, starts)
    answers = [(int(s), phy.RATES[int(dec.rate[k])][0], int(dec.length[k]),
                dec.payload[k])
               if dec.header_ok[k] and dec.crc_ok[k] else None
               for k, s in enumerate(starts)]
    return list(zip(rate, length, ok)), answers


def test_the_stream_covers_every_rate_clean_and_noisy():
    _, frames = lone_frames()
    seen = {(r, noisy) for _, r, _, noisy in frames}
    assert seen == {(r, n) for r in range(11) for n in (False, True)}
    assert [f[1] for f in frames[:11]] == [int(r) for r in ALL_RATES]
    # one frame to a dispatch: no two starts within one read
    starts = np.array([f[0] for f in frames])
    assert np.diff(starts).min() > READ


def test_every_noiseless_frame_comes_back_exact(link):
    stream, frames, rows, _, _ = link
    by_start = {r[0]: r for r in rows}
    for start, r, pay, noisy in frames:
        if not noisy:
            assert by_start.get(start) == (
                start, phy.RATES[r][0], MAX_LENGTH, pay), (start, r)
    assert len(by_start) == len(rows)           # nothing delivered twice


def test_every_noisy_frame_as_the_plain_receiver_decodes_it(link):
    stream, frames, rows, _, _ = link
    _, answers = reference(stream, frames)
    by_start = {r[0]: r for r in rows}
    for (start, r, pay, noisy), ref in zip(frames, answers):
        if noisy:
            assert by_start.get(start) == ref, (start, r)
        else:
            assert ref == (start, phy.RATES[r][0], MAX_LENGTH, pay)
    # nothing but the planted frames
    assert set(by_start) <= {f[0] for f in frames}
    # the noisy frames test both outcomes at this SNR
    noisy = [a for f, a in zip(frames, answers) if f[3]]
    assert any(a is None for a in noisy) and any(a for a in noisy)


def check_counters(stream, frames, stats, counters):
    """The tracer's counters of a traced run against their values from the
    plain receiver's headers and the chain's stats."""
    headers, _ = reference(stream, frames)
    decoded = [(int(r), int(n)) for r, n, ok in headers
               if ok and n <= MAX_LENGTH]
    assert counters["chain.decode_jobs"] == len(decoded)
    assert counters["chain.decode_slots"] == 4 * len(decoded)
    assert counters["chain.decode_frames"] == len(decoded)
    assert counters["anyrate.symbols_needed"] == sum(
        phy.num_symbols(r, n) for r, n in decoded)
    assert stats.crc_ok + stats.crc_fail == len(decoded)
    # each bucket extracts its class's slowest symbol count a slot; a
    # guard's exact re-decode extracts its own bucket again
    nsym = {int(r): max(params_for(q).num_symbols(MAX_LENGTH) for q in cls)
            for cls in length_classes(tuple(ALL_RATES), MAX_LENGTH)
            for r in cls}
    first = sum(4 * nsym[r] for r, _ in decoded)
    assert counters["anyrate.slots"] == 4 * (len(decoded)
                                             + stats.viterbi_fallbacks)
    assert first <= counters["anyrate.symbols"] <= first + 4 * max(
        nsym.values()) * stats.viterbi_fallbacks


def test_the_dispatch_counters_equal_their_hand_values(link):
    stream, frames, _, stats, counters = link
    check_counters(stream, frames, stats, counters)
    # on the CPU the blocked decode is the exact one, its flag all True
    assert stats.viterbi_fallbacks == 0


def test_nothing_is_counted_with_the_tracer_off(link):
    stream, _, rows, _, _ = link
    off_rows, _, counters = run_chain(stream, "cpu", traced=False)
    assert counters == {"dropped": 0}
    assert off_rows == rows


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernels have "
                    "no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_the_chain_on_the_card_matches_the_cpu_chain(cuda_device, link):
    """The same packets, stats and dispatch counters. Only the card runs
    the block-overlap kernels: a frame their merge guard flags (a noisy
    one whose neighbouring blocks disagree) is decoded again exactly,
    which counts in viterbi_fallbacks and in anyrate.slots and
    anyrate.symbols; on the CPU the blocked decode is the exact one."""
    stream, frames, rows, stats, counters = link
    got, card_stats, card_counters = run_chain(stream, cuda_device,
                                               traced=True)
    assert got == rows
    cpu, card = stats.as_dict(), card_stats.as_dict()
    assert cpu.pop("viterbi_fallbacks") == 0
    card.pop("viterbi_fallbacks")
    assert card == cpu
    for name in COUNTERS:
        assert card_counters[name] == counters[name], name
    check_counters(stream, frames, card_stats, card_counters)
    # the soft-stream kernel runs only on the card
    assert card_counters["anyrate.kernel_slots"] == \
        card_counters["anyrate.slots"]


def test_rates_are_the_reference_order():
    assert [r.name for r in ALL_RATES] == [phy.RATES[i][0] for i in range(11)]
    assert all(Rate[phy.RATES[i][0]] == i for i in range(11))
