"""Entry `chain_open`: runtime.chain.ReceiverChain, open loop.

Pieces are due on a fixed schedule, traffic["rate_msps"] million samples
a second: piece i is due when its last sample arrives, at (i + 1) * piece
/ rate seconds after the start, and is fed then or, when the chain is
behind, as soon as the previous call returns. The schedule never waits for
the chain. A frame's delivery latency runs from when its last sample was
due to the return of the call that delivers it. The window's frames are
those whose last sample was due inside it; after its close the stream
goes on at the same schedule until each noiseless one is delivered or
LATE_LIMIT_S has passed, then the chain is flushed. The tail is taken
over every frame of the window delivered by then: each noiseless one (one
never delivered is a wrong answer) and each noisy one whose CRC held (one
whose CRC fails is not delivered, as the plain receiver judges it).
"""

from __future__ import annotations

import sys
import time

import numpy as np

from phybench.entries import _stream

#: how long after the window's close a due frame may still be delivered
LATE_LIMIT_S = 60.0


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.looped = _stream.Looped(ctx.inputs,
                                     int(ctx.config["read_samples"]))
        self.rate = float(ctx.traffic["rate_msps"]) * 1e6
        self.chain = _stream.make_chain(ctx)
        fl, piece = ctx.inputs.frame_len, self.looped.piece
        period = fl + int(ctx.traffic["gap"])
        for k in range(-(-2 * period // piece)):     # warm: two frames
            self.chain.process_samples(self.looped[k])
        self.chain.flush(terminal=False)
        self.pkts: list = []
        self.delivered: dict = {}       # stream start -> return time
        self.i = 0
        self.late: list = []            # how late each piece was fed, s
        self.t0 = None
        self._slice: dict = {}

    def _due(self, i: int) -> float:
        return self.t0 + (i + 1) * self.looped.piece / self.rate

    def _step(self, spans) -> None:
        due = self._due(self.i)
        now = time.perf_counter()
        if now < due:
            time.sleep(due - now)
            now = time.perf_counter()
        self.late.append(now - due)
        with spans("process_samples"):
            got = self.chain.process_samples(self.looped[self.i])
        back = time.perf_counter()
        for p in got:
            self.delivered.setdefault(p.start, back)
        self.pkts += got
        self.i += 1

    def finish(self, spans) -> None:
        with spans("flush"):
            got = self.chain.flush()
        back = time.perf_counter()
        for p in got:
            self.delivered.setdefault(p.start, back)
        self.pkts += got

    def window(self, seconds: float, spans, close: bool) -> dict:
        piece = self.looped.piece
        w0 = self.chain.stats.windows
        self.t0 = time.perf_counter()
        n_due = int(seconds * self.rate) // piece     # pieces due inside
        while self.i < n_due:
            self._step(spans)
        fl = self.ctx.inputs.frame_len
        due = [s for s, _ in self.looped.frames(n_due * piece)]
        clean = [s for s, j in self.looped.frames(n_due * piece)
                 if not self.ctx.inputs.noisy[j]]
        close_t = self.t0 + seconds
        while (any(s not in self.delivered for s in clean)
               and time.perf_counter() < close_t + LATE_LIMIT_S):
            self._step(spans)
        windows = self.chain.stats.windows - w0
        lat = [(self.delivered[s] - self.t0 - (s + fl) / self.rate) * 1e3
               for s in due if s in self.delivered]
        if close:
            self.finish(spans)
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
        w0 = self.chain.stats.windows
        ok0 = self.chain.stats.crc_ok + self.chain.stats.crc_fail
        i0 = self.i
        end = time.perf_counter() + float(self.ctx.traffic["trace_seconds"])
        while time.perf_counter() < end:
            self._step(spans)
        stats = self.chain.stats
        self._slice = {"calls": self.i - i0,
                       "windows": stats.windows - w0,
                       "frames_decoded": stats.crc_ok + stats.crc_fail - ok0}

    def counters(self) -> dict:
        return self._slice

    def outcome(self, rng, device):
        self.ctx.stats = self.chain.stats.as_dict()
        self.chain = None
        return _stream.outcome(self.looped, self.pkts,
                               self.i * self.looped.piece, rng, device)
