"""Entry `chain_closed`: runtime.chain.ReceiverChain, closed loop.

A recording replayed as fast as the chain drains it: pieces of the
traffic's size go to process_samples back to back, and the window ends
with flush(). Set-up builds the chain once and warms every shape the
window meets: full supersteps, and the flush's supersteps with few frames
(each decode bucket).
"""

from __future__ import annotations

import time

from phybench.entries import _stream

#: frames fed before each warm-up flush: one per decode bucket a flush can
#: meet (4, 16, 64, 256 frames)
WARM_FRAMES = (2, 10, 40, 150)


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.looped = _stream.Looped(ctx.inputs,
                                     int(ctx.config["read_samples"]))
        self.chain = _stream.make_chain(ctx)
        fl, piece = ctx.inputs.frame_len, self.looped.piece
        for k in range(3 * self.chain.step // piece):
            self.chain.process_samples(self.looped[k])
        self.chain.flush(terminal=False)
        for frames in WARM_FRAMES:
            for k in range(-(-frames * fl // piece)):
                self.chain.process_samples(self.looped[k])
            self.chain.flush(terminal=False)
        self.pkts: list = []
        self.i = 0
        self._slice: dict = {}

    def _step(self, spans) -> None:
        with spans("process_samples"):
            self.pkts += self.chain.process_samples(self.looped[self.i])
        self.i += 1

    def finish(self, spans) -> None:
        with spans("flush"):
            self.pkts += self.chain.flush()

    def window(self, seconds: float, spans, close: bool) -> dict:
        w0 = self.chain.stats.windows
        t0 = time.perf_counter()
        end = t0 + seconds
        while time.perf_counter() < end:
            self._step(spans)
        if close:
            self.finish(spans)
        wall = time.perf_counter() - t0
        fed = self.i * self.looped.piece
        return {"stream_msps": fed / wall / 1e6, "_calls": self.i,
                "_wall_s": wall, "_windows": self.chain.stats.windows - w0}

    def traced(self, spans) -> None:
        w0 = self.chain.stats.windows
        i0 = self.i
        for _ in range(int(self.ctx.traffic["trace_steps"])):
            self._step(spans)
        self._slice = {"calls": self.i - i0,
                       "windows": self.chain.stats.windows - w0}

    def counters(self) -> dict:
        return self._slice

    def outcome(self, rng, device):
        self.ctx.stats = self.chain.stats.as_dict()
        self.chain = None
        return _stream.outcome(self.looped, self.pkts,
                               self.i * self.looped.piece, rng, device)
