"""The yardstick of the rooflines: the work the Viterbi algorithm needs on
the frames a traced slice decoded, and the least time the card could take
for it, from the published peaks in _peaks.json.

Work, the same whatever kernel does it:
  * a trellis step of the K=7 code has 64 states, each with 2 incoming
    branches: 2 additions, 1 comparison and 1 selection, so 256 byte
    operations (the reference keeps 8-bit saturating path metrics; the
    branch metrics' few operations a step are left out, so the count stays
    a lower bound);
  * each step reads one soft pair (2 bytes) and yields one decoded bit
    (1/8 byte), each counted once.
A payload of L bytes at rate r takes num_symbols(r, L) * dbps(r) steps
(phybench/reference/phy.trellis_steps), its SIGNAL header 24.

Peaks: 132 SMs x 64 INT32 lanes x 1.98 GHz = 16.7 T 32-bit operations a
second (derived: NVIDIA publishes the lanes, the SMs and the clock, not an
integer rate), times 4 byte operations a lane; 3.35 TB/s of HBM. The share
is the least time over the kernel's device time in the trace, in percent,
with the card's power limit printed beside it by the run.
"""

from __future__ import annotations

import re

from phybench.reference import phy

OPS_PER_STEP = 64 * 4
BYTES_PER_STEP = 2 + 1 / 8
HEADER_STEPS = 24


def least_s(steps: float, peaks: dict) -> float:
    ops = steps * OPS_PER_STEP
    rate = (peaks["sms"] * peaks["int32_lanes_per_sm"]
            * peaks["boost_clock_hz"] * peaks["byte_ops_per_int32_lane"])
    return max(ops / rate, steps * BYTES_PER_STEP / peaks["hbm_bytes_per_s"])


def kernel_matcher(kernel: str):
    """Accepts the profiler's name of `kernel` (a __global__ function of
    csrc/viterbi.cu, shown with its namespace and arguments) and no other."""
    pat = re.compile(rf"(^|::){kernel}\b")
    return lambda name: bool(pat.search(name))


def roofline(run, kernel: str, steps_per_frame: int):
    """Percent of the least time for the frames decoded in the traced
    slice over `kernel`'s device time there; None when it did not run."""
    t = run.trace.kernel_s(kernel_matcher(kernel))
    frames = run.counters.get("frames_decoded", 0)
    if t <= 0 or frames <= 0:
        return None
    return 100.0 * least_s(frames * steps_per_frame, run.peaks) / t


def payload_steps(run) -> int:
    return phy.trellis_steps(run.inputs.rate, run.inputs.length)


def idle_share(run):
    if not run.trace.device or run.trace.wall_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.wall_s)


def device_ms_per(run, counter: str):
    n = run.counters.get(counter, 0)
    if not run.trace.device or not n:
        return None
    return run.trace.busy_s * 1e3 / n
