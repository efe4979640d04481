"""Entry `capture`: models.frontend.receive_capture_p, closed loop.

Calls run back to back over the traffic's distinct recordings, which
set-up built on the device; each call ends with its outputs on the host,
as a user reads them (starts, valid, payload, crc_ok, header_ok). The
outputs of CHECK_CALLS calls drawn from the seed over the whole window (a
reservoir sample), and of the window's last calls, one for each
recording, are kept for the check; the others are dropped once read, as a
user who has consumed them would.
"""

from __future__ import annotations

import collections
import time

import numpy as np

from phybench import check

KEYS = ("starts", "valid", "payload", "crc_ok", "header_ok")
#: calls whose outputs the check reads, drawn from the seed over the window
CHECK_CALLS = 12


class Driver:
    def __init__(self, ctx):
        from fun_ofdm_tpu_torch.models import frontend
        from fun_ofdm_tpu_torch.rates import Rate

        self.ctx = ctx
        self.t = ctx.inputs
        self.receive = frontend.receive_capture_p
        self.rate = Rate[self.t.rate_name]
        self.frames = int(ctx.config["frames_per_channel"])
        self.samples = self.t.captures[0][0].numel()
        self.sample: list = []
        self.draw = None
        self.recent = collections.deque(maxlen=len(self.t.captures))
        self.calls = 0
        for i in range(len(self.t.captures)):     # warm: the one shape
            self._call(i, ctx.spans)
        self.draw = np.random.default_rng([ctx.seed, 2])
        self.recent.clear()
        self.calls = 0
        self._slice: dict = {}

    def _call(self, i: int, spans) -> None:
        with spans("receive_capture_p"):
            out = self.receive(self.t.captures[i], self.rate, self.t.length,
                               self.frames)
        with spans("readback"):
            host = {k: out[k].cpu().numpy() for k in KEYS}
        kept = (self.calls, (i, host))
        self.recent.append(kept)
        if self.draw is not None:
            if len(self.sample) < CHECK_CALLS:
                self.sample.append(kept)
            else:
                k = int(self.draw.integers(0, self.calls + 1))
                if k < CHECK_CALLS:
                    self.sample[k] = kept
        self.calls += 1

    def _step(self, spans) -> None:
        self._call(self.calls % len(self.t.captures), spans)

    def window(self, seconds: float, spans, close: bool) -> dict:
        t0 = time.perf_counter()
        end = t0 + seconds
        while time.perf_counter() < end:
            self._step(spans)
        wall = time.perf_counter() - t0
        return {"capture_msps": self.calls * self.samples / wall / 1e6,
                "_calls": self.calls, "_wall_s": wall}

    def traced(self, spans) -> None:
        from fun_ofdm_tpu_torch.ops import viterbi_cuda

        viterbi_cuda.reset_launches()
        n0 = self.calls
        for _ in range(int(self.ctx.traffic["trace_steps"])):
            self._step(spans)
        calls = self.calls - n0
        self._slice = {"calls": calls,
                       "frames_decoded": calls * self.t.capture_starts[0].size,
                       "launches": dict(viterbi_cuda.launches)}

    def finish(self, spans) -> None:
        pass

    def counters(self) -> dict:
        return self._slice

    def outcome(self, rng, device):
        stream = [(re.cpu().numpy(), im.cpu().numpy())
                  for re, im in self.t.captures]
        self.t.captures = None
        self.receive = None
        t = self.t
        starts = t.capture_starts
        caps, ch, per = starts.shape
        pay = t.payloads.reshape(caps, ch, per, -1)
        noisy = t.noisy.reshape(caps, ch, per)
        checked = [v for _, v in sorted(dict(self.sample + list(self.recent))
                                        .items())]
        wrong = 0
        program: dict = {}
        for i, out in checked:
            placed = out["valid"] & (out["starts"] == starts[i])
            ok = (placed & out["crc_ok"] & out["header_ok"]
                  & (out["payload"] == pay[i]).all(-1))
            wrong += int((~np.where(noisy[i], placed, ok)).sum())
            for c, f in zip(*np.nonzero(noisy[i])):
                got = (out["crc_ok"][c, f] and out["header_ok"][c, f]
                       and placed[c, f])
                program.setdefault((i, c, f), []).append(
                    (out["payload"][c, f].astype(np.uint8).tobytes(),
                     t.rate_name, t.length) if got else None)
        distinct = sorted(program)
        ref = dict(zip(distinct, check.answers(
            [check.region(stream[i][0][c], stream[i][1][c],
                          int(starts[i, c, f]), t.frame_len)
             for i, c, f in distinct], device)))
        numbers = {"frames_wrong": wrong,
                   "noisy_vs_ref": check.noisy_vs_ref(program, ref)}
        differ = sum(1 for k, got in program.items()
                     for a in got if a != ref[k])
        # the plain receiver on a sample of the noiseless frames decoded,
        # at the samples of their recording
        clean = [(n, c, f) for n in range(len(checked))
                 for c, f in zip(*np.nonzero(~noisy[checked[n][0]]))]
        pick = rng.choice(len(clean), size=min(32, len(clean)),
                          replace=False)
        regions, expected, sampled = [], [], []
        for p in sorted(pick):
            n, c, f = clean[p]
            i, out = checked[n]
            re, im = (s[c] for s in stream[i])
            regions.append(check.region(re, im, int(starts[i, c, f]),
                                        t.frame_len))
            expected.append((pay[i, c, f].tobytes(), t.rate, t.length))
            got = (out["valid"][c, f] and out["crc_ok"][c, f]
                   and out["header_ok"][c, f])
            sampled.append(out["payload"][c, f].astype(np.uint8).tobytes()
                           if got else None)
        numbers.update(check.reference_sample(regions, expected, sampled,
                                              device))
        return len(checked) * ch * per, wrong + differ, numbers
