"""Entry `chain_open_allrates`: runtime.chain.ReceiverChain over every rate
of the configuration's decode_rates, open loop.

chain_open's driver (its fixed schedule, its delivery latency, its window
and its profiled slice; see entries/chain_open.py) on a recording that
this entry builds itself, since phybench/generator.py plants one rate a
configuration: the traffic's `frames` lone frames of the configuration's
`length`, the decode_rates in turn, each followed by `gap` zeros, every
`noisy_every`-th one with AWGN at checked_snr_db after its preamble, on
the configuration's wire grid. The payloads and the noisy frames are the
generator's own draw (generator.payloads, generator.noisy_mask), the
frames come from the plain transmitter through the generator's helpers,
one batch a rate, each with noise from a seed of its own. The frames the
generator planted for the run go unused.

The chain decodes every frame at the rate and length its SIGNAL header
gives (ReceiverChain(rates=decode_rates), the universal mode). Warm-up
feeds one whole cycle of the rates, so that both length classes'
decodes have run, then resets the stream. A frame's latency runs from
when its own last sample was due. The check is chain_open's with each
frame's own rate and frame size: a noiseless frame delivered with another
rate, length or payload is wrong; a noisy frame answers as the float64
plain receiver decodes it; the sampled noiseless frames go through the
plain receiver at their own rate and length.

After the profiled slice of a --trace 1 run, finish() feeds
traffic["trace_seconds"] more of the stream, on the same schedule, with
the program's tracer on (fun_ofdm_tpu_torch/utils/trace.py; never under
the profiler, and outside the benchmark's spans) and keeps its span
summary and counters for the per-layer metrics, then flushes the chain.
A program whose tracer has no such counters leaves those metrics out.
"""

from __future__ import annotations

import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from phybench import check, generator, tracing
from phybench.entries import _stream, chain_open
from phybench.reference import phy


class Recording(NamedTuple):
    """The cell's recording: lone frames of several rates, one length (a
    NamedTuple: the harness loads an entry as a file, outside
    sys.modules, where a dataclass cannot resolve its annotations)."""

    rates: np.ndarray           # (N,) reference rate index of each frame
    length: int                 # payload bytes of every frame
    payloads: np.ndarray        # (N, length) uint8
    noisy: np.ndarray           # (N,) bool, the frames at the checked SNR
    frame_lens: np.ndarray      # (N,) samples of each frame
    stream: tuple               # (re, im) host float32
    stream_starts: np.ndarray   # (N,)


def make(config: dict, traffic: dict, seed: int, device) -> Recording:
    """The recording of the cell, from the seed alone."""
    rates = [phy.RATE_BY_NAME[n] for n in config["decode_rates"]]
    length = int(config["length"])
    n, gap = int(traffic["frames"]), int(traffic["gap"])
    pay = generator.payloads(seed, n, length)
    noisy = generator.noisy_mask(n, traffic.get("noisy_every"))
    turn = np.arange(n) % len(rates)
    frames: list = [None] * n
    for k, r in enumerate(rates):
        idx = np.flatnonzero(turn == k)
        if not idx.size:
            continue
        own = int(np.random.SeedSequence([seed, 19, k]).generate_state(
            1, np.uint64)[0])
        batch = generator._frames(pay[idx], r, device, noisy[idx],
                                  config.get("checked_snr_db"), own)
        for i, f in zip(idx, batch):
            frames[i] = torch.nn.functional.pad(f, (0, gap))
    x = generator.on_wire(torch.cat(frames), config).cpu()
    lens = np.array([phy.frame_samples(rates[k], length) for k in turn])
    starts = np.concatenate([[0], np.cumsum(lens + gap)[:-1]])
    return Recording(rates=np.array([rates[k] for k in turn]),
                     length=length, payloads=pay, noisy=noisy,
                     frame_lens=lens,
                     stream=(x.real.numpy().copy(), x.imag.numpy().copy()),
                     stream_starts=starts)


class Looped(_stream.Looped):
    """The recording replayed end to end, each frame with its own rate
    and frame size."""

    def __init__(self, recording: Recording, piece: int):
        super().__init__(recording, piece)
        self.index = {int(s): j for j, s in
                      enumerate(recording.stream_starts)}

    def frames(self, upto: int, whole: bool = True):
        t = self.t
        for r in range(upto // self.n + 1):
            for j, s in enumerate(t.stream_starts):
                start = r * self.n + int(s)
                if start < upto and \
                        (start + int(t.frame_lens[j]) <= upto) == whole:
                    yield start, j

    def frame_at(self, start: int) -> int:
        """The recording's index of the frame at stream position start."""
        return self.index[start % self.n]

    def end(self, start: int) -> int:
        """The stream position just past the frame at start."""
        return start + int(self.t.frame_lens[self.frame_at(start)])

    def answer(self, j: int) -> tuple:
        t = self.t
        return (t.payloads[j].tobytes(), phy.RATES[int(t.rates[j])][0],
                t.length)

    def region(self, start: int):
        j = self.frame_at(start)
        local = start % self.n
        idx = np.arange(local - check.GUARD,
                        local + int(self.t.frame_lens[j]) + check.GUARD)
        re, im = (np.take(x, idx, mode="wrap") for x in self.t.stream)
        if start < check.GUARD:
            re[:check.GUARD - start] = 0
            im[:check.GUARD - start] = 0
        return (re, im), check.GUARD


def make_chain(ctx):
    from fun_ofdm_tpu_torch.config import ChainParams
    from fun_ofdm_tpu_torch.rates import Rate
    from fun_ofdm_tpu_torch.runtime.chain import ReceiverChain

    cfg, tr = ctx.config, ctx.traffic
    params = ChainParams(chunk_size=int(cfg["read_samples"]),
                         strides_per_step=tr.get("strides_per_step"))
    return ReceiverChain(rates=tuple(Rate[n] for n in cfg["decode_rates"]),
                         max_length=int(cfg["max_length"]), params=params,
                         ingest_dtype=cfg["ingest_dtype"], device=ctx.device)


class Driver(chain_open.Driver):
    def __init__(self, ctx):
        self.ctx = ctx
        self.recording = make(ctx.config, ctx.traffic, ctx.seed, ctx.device)
        self.looped = Looped(self.recording, int(ctx.config["read_samples"]))
        self.rate = float(ctx.traffic["rate_msps"]) * 1e6
        self.chain = make_chain(ctx)
        piece, rec = self.looped.piece, self.recording
        cycle = len(ctx.config["decode_rates"])
        warm = int(rec.stream_starts[cycle]) \
            if cycle < len(rec.stream_starts) else self.looped.n
        for k in range(-(-warm // piece)):      # warm: one cycle of rates
            self.chain.process_samples(self.looped[k])
        self.chain.flush(terminal=False)
        self.pkts: list = []
        self.delivered: dict = {}
        self.i = 0
        self.late: list = []
        self.t0 = None
        self._slice: dict = {}
        self._program: dict = {}

    def window(self, seconds: float, spans, close: bool) -> dict:
        # chain_open's window, each frame's latency from its own end
        piece, looped = self.looped.piece, self.looped
        w0 = self.chain.stats.windows
        self.t0 = time.perf_counter()
        n_due = int(seconds * self.rate) // piece
        while self.i < n_due:
            self._step(spans)
        due = [s for s, _ in looped.frames(n_due * piece)]
        clean = [s for s, j in looped.frames(n_due * piece)
                 if not self.recording.noisy[j]]
        close_t = self.t0 + seconds
        while (any(s not in self.delivered for s in clean)
               and time.perf_counter() < close_t + chain_open.LATE_LIMIT_S):
            self._step(spans)
        windows = self.chain.stats.windows - w0
        lat = [(self.delivered[s] - self.t0 - looped.end(s) / self.rate)
               * 1e3 for s in due if s in self.delivered]
        if close:
            chain_open.Driver.finish(self, spans)
        late = np.array(self.late) * 1e3
        self.schedule = {
            "pieces_due": n_due, "pieces_fed": self.i,
            "late_ms_p50": float(np.percentile(late, 50)),
            "late_ms_p99": float(np.percentile(late, 99)),
            "late_ms_max": float(late.max()),
            "late_ms_last_quarter": float(late[3 * len(late) // 4:].mean()),
            "late_ms_second_quarter": float(
                late[len(late) // 4:len(late) // 2].mean()),
            "frames_due": len(due), "frames_delivered": len(lat),
            "latency_ms_p50": float(np.percentile(lat, 50)) if lat else None}
        print("schedule:", self.schedule, file=sys.stderr)
        p95 = float(np.percentile(lat, 95)) if lat else float("nan")
        return {"delivery_p95_ms": p95, "_calls": self.i,
                "_windows": windows, "_schedule": self.schedule,
                "_wall_s": time.perf_counter() - self.t0}

    def traced(self, spans) -> None:
        n0, fail0 = len(self.pkts), self.chain.stats.crc_fail
        super().traced(spans)
        self._slice["payload_steps"] = self.slice_steps(
            self.pkts[n0:], self.chain.stats.crc_fail - fail0)

    def slice_steps(self, delivered: list, failed: int) -> float:
        """Payload trellis steps of the frames whose decodes the slice
        collected: each delivered one at its own rate and length; each
        whose CRC failed, of which the chain keeps no rate, at the mean of
        the decode_rates' steps at the configuration's length (at 1,500
        bytes every rate's steps lie within 12,024-12,096)."""
        rates = [phy.RATE_BY_NAME[n] for n in self.ctx.config["decode_rates"]]
        length = int(self.ctx.config["length"])
        mean = sum(phy.trellis_steps(r, length) for r in rates) / len(rates)
        return failed * mean + sum(
            phy.trellis_steps(phy.RATE_BY_NAME[p.rate.name], p.length)
            for p in delivered)

    def finish(self, spans) -> None:
        from fun_ofdm_tpu_torch.utils import trace

        quiet = tracing.Spans(enabled=False)
        trace.take()
        trace.enable()
        try:
            end = time.perf_counter() + float(self.ctx.traffic[
                "trace_seconds"])
            while time.perf_counter() < end:
                self._step(quiet)
        finally:
            trace.disable()
        recorded, counters = trace.take()
        self._program = {"program_spans": trace.summary(recorded),
                         "program_counters": counters}
        super().finish(spans)

    def counters(self) -> dict:
        return {**self._slice, **self._program}

    def outcome(self, rng, device):
        self.ctx.stats = self.chain.stats.as_dict()
        self.chain = None
        return outcome(self.looped, self.pkts, self.i * self.looped.piece,
                       rng, device)


def outcome(looped: Looped, pkts: list, fed: int, rng, device):
    """_stream.outcome with each frame's own rate: (attempted, failed,
    numbers) of the stream, every frame fed whole due."""
    t = looped.t
    noisy_at = {s for whole in (True, False)
                for s, j in looped.frames(fed, whole) if t.noisy[j]}
    rows, got_noisy, repeats = [], {}, 0
    for row in _stream.packet_rows(pkts):
        if row[0] == 0 and row[1] in noisy_at:
            repeats += row[1] in got_noisy
            got_noisy[row[1]] = row[2:]
        else:
            rows.append(row)
    planted = looped.planted(fed)
    numbers = {"frames_wrong": repeats + check.compare_frames(
        rows, planted, looped.planted(fed, whole=False))}
    program: dict = {}
    for s, j in looped.frames(fed):
        if t.noisy[j]:
            program.setdefault(j, []).append(got_noisy.get(s))
    distinct = sorted(program)
    ref = dict(zip(distinct, check.answers(
        [looped.region(int(t.stream_starts[j])) for j in distinct], device)))
    numbers["noisy_vs_ref"] = check.noisy_vs_ref(program, ref)
    got = {(r[0], r[1]): r[2] for r in rows}
    keys = sorted(planted)
    pick = sorted(rng.choice(len(keys), size=min(32, len(keys)),
                             replace=False)) if keys else []
    regions = [looped.region(keys[i][1]) for i in pick]
    expected = [(planted[keys[i]][0],
                 int(t.rates[looped.frame_at(keys[i][1])]), t.length)
                for i in pick]
    sampled = [got.get(keys[i]) for i in pick]
    numbers.update(check.reference_sample(regions, expected, sampled,
                                          device) if pick else {})
    failed = sum(1 for k, v in planted.items() if got.get(k) != v[0])
    failed += sum(1 for j, answers in program.items()
                  for a in answers if a != ref[j])
    return sum(len(v) for v in program.values()) + len(planted), failed, \
        numbers
