"""The metric arithmetic: a rate over the whole window, a 95th percentile
over every frame, each frame timed from when its last sample was due;
the device timeline's busy time, idle gaps and the rooflines."""

from __future__ import annotations

import types
from types import SimpleNamespace

import numpy as np
import pytest

from phybench import tracing
from phybench.entries import chain_open
from phybench.metrics import _work
from phybench.reference import phy


class Clock:
    """A virtual clock for the open-loop driver: sleep advances it."""

    def __init__(self):
        self.t = 100.0

    def perf_counter(self):
        return self.t

    def sleep(self, dt):
        self.t += max(dt, 0.0)


class FakeChain:
    """Delivers each frame on the call after the one that completes it,
    and costs `cost` seconds a call on the virtual clock."""

    def __init__(self, clock, starts, frame_len, piece, cost):
        self.clock, self.cost, self.piece = clock, cost, piece
        self.ends = {s + frame_len: s for s in starts}
        self.fed, self.pending = 0, []
        self.stats = SimpleNamespace(windows=0, crc_ok=0, crc_fail=0,
                                     as_dict=dict)

    def process_samples(self, samples):
        self.clock.t += self.cost
        out, self.pending = self.pending, []
        self.fed += self.piece
        self.stats.windows += 1
        self.pending = [SimpleNamespace(start=s) for e, s in self.ends.items()
                        if self.fed - self.piece < e <= self.fed]
        return out

    def flush(self, terminal=True):
        out, self.pending = self.pending, []
        return out


def open_driver(monkeypatch, rate, cost, frame_len=1000, gap=3096,
                piece=4096, frames=8, noisy=()):
    clock = Clock()
    monkeypatch.setattr(chain_open, "time",
                        types.SimpleNamespace(perf_counter=clock.perf_counter,
                                              sleep=clock.sleep))
    starts = (frame_len + gap) * np.arange(frames)
    inputs = SimpleNamespace(
        frame_len=frame_len, stream_starts=starts,
        stream=(np.zeros(frames * (frame_len + gap), np.float32),) * 2,
        payloads=np.zeros((frames, 1), np.uint8), rate_name="R", length=1,
        noisy=np.isin(np.arange(frames), noisy))
    period = frame_len + gap
    # a noisy frame's CRC fails: the chain never delivers it
    chain = FakeChain(clock, [int(s) + k * frames * period for k in range(50)
                              for j, s in enumerate(starts)
                              if j not in noisy], frame_len, piece, cost)
    monkeypatch.setattr(chain_open._stream, "make_chain", lambda ctx: chain)
    ctx = SimpleNamespace(inputs=inputs, config={"read_samples": piece},
                          traffic={"rate_msps": rate / 1e6, "gap": gap},
                          spans=tracing.Spans(False))
    d = chain_open.Driver(ctx)
    chain.fed, chain.pending = 0, []
    return d, clock, starts


def test_open_loop_latency_from_due_time(monkeypatch):
    rate, piece, fl = 1e6, 4096, 1000
    d, clock, starts = open_driver(monkeypatch, rate, cost=0.001)
    out = d.window(0.1, tracing.Spans(False), close=True)
    # every frame is delivered on the call after the piece holding its last
    # sample: due of that next piece + the call's cost - due of the sample
    lat = []
    for s in (s for s, _ in d.looped.frames(int(0.1 * rate) // piece
                                            * piece)):
        end = s + fl
        nxt = -(-end // piece) + 1          # pieces up to and after it
        lat.append((nxt * piece / rate + 0.001 - end / rate) * 1e3)
    assert out["delivery_p95_ms"] == pytest.approx(np.percentile(lat, 95))
    assert d.schedule["late_ms_max"] == pytest.approx(0.0, abs=1e-9)


def test_open_loop_schedule_never_waits(monkeypatch):
    # each call costs twice a piece's period: the feed falls behind, and
    # the latency counts the wait from when each sample was due
    rate, piece = 1e6, 4096
    d, clock, _ = open_driver(monkeypatch, rate, cost=2 * piece / rate)
    out = d.window(0.05, tracing.Spans(False), close=True)
    late = d.schedule
    assert late["late_ms_last_quarter"] > late["late_ms_second_quarter"] > 0
    assert out["delivery_p95_ms"] > 2 * piece / rate * 1e3


def test_open_loop_tail_over_delivered_frames(monkeypatch):
    # frames 1 and 5 are noisy and fail their CRC: the window does not wait
    # for them, and the tail is over the frames delivered
    rate, piece, fl = 1e6, 4096, 1000
    d, clock, starts = open_driver(monkeypatch, rate, cost=0.001,
                                   noisy=(1, 5))
    out = d.window(0.1, tracing.Spans(False), close=True)
    assert out["_wall_s"] < 0.2
    lat = []
    for s, j in d.looped.frames(int(0.1 * rate) // piece * piece):
        if j in (1, 5):
            continue
        end = s + fl
        nxt = -(-end // piece) + 1
        lat.append((nxt * piece / rate + 0.001 - end / rate) * 1e3)
    assert d.schedule["frames_delivered"] == len(lat)
    assert out["delivery_p95_ms"] == pytest.approx(np.percentile(lat, 95))


def test_rates_cover_the_whole_window(small_root):
    from phybench.run import run

    res, window = run("capture-sim", 9, 0.5, False, root=small_root,
                      device="cpu")
    calls, wall = window["_calls"], window["_wall_s"]
    assert wall >= 0.5
    per = res["metrics"]["capture_msps"]["value"] * 1e6 * wall / calls
    assert per == pytest.approx(round(per))     # whole calls' samples


def test_busy_union_and_idle_gaps():
    t = tracing.Trace(
        device=[("k1", 0, 10), ("copy", 5, 20), ("k2", 30, 40),
                ("k3", 70, 75)],
        host=[("outer", 0, 100), ("readback", 20, 60)], wall_s=100e-6)
    assert t.busy_s == pytest.approx(35e-6)
    # gaps 20..30 and 40..70 open inside "readback", 75..100 inside "outer";
    # the longest first
    assert t.idle_gaps() == [["readback", pytest.approx(30e-6)],
                             ["outer", pytest.approx(25e-6)],
                             ["readback", pytest.approx(10e-6)]]
    assert t.top_ops(2) == [["copy", pytest.approx(15e-6)],
                            ["k1", pytest.approx(10e-6)]]


def test_kernel_names_match_whole():
    m = _work.kernel_matcher("acs_kernel")
    assert m("(anonymous namespace)::acs_kernel(int const*, int)")
    assert not m("(anonymous namespace)::acs_ablate_kernel<0>(int)")
    assert not m("(anonymous namespace)::acs_windowed_kernel(int)")


def test_roofline_arithmetic():
    peaks = {"sms": 132, "int32_lanes_per_sm": 64, "boost_clock_hz": 1.98e9,
             "byte_ops_per_int32_lane": 4, "hbm_bytes_per_s": 3.35e12}
    steps = phy.trellis_steps(8, 1500)
    assert steps == 12096
    least = _work.least_s(512 * (steps + 24), peaks)
    assert least == pytest.approx(512 * 12120 * 256 / 66.908e12, rel=1e-3)
    run = SimpleNamespace(
        trace=tracing.Trace(
            device=[("x::acs_kernel(int)", 0, 2 * least * 1e6)],
                            wall_s=1.0),
        counters={"frames_decoded": 512}, peaks=peaks,
        inputs=SimpleNamespace(rate=8, length=1500))
    assert _work.roofline(run, "acs_kernel", steps + 24) == pytest.approx(50)
    run.trace.device = []
    assert _work.roofline(run, "acs_kernel", steps + 24) is None
    assert _work.idle_share(run) is None
