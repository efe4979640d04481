"""The exact ACS kernel (csrc/viterbi.cu acs_kernel) against the least time
for the Viterbi work of the frames the universal capture's traced slice
decoded: every planted payload's own trellis steps and its SIGNAL header's
(see _work.py). Steps the kernel runs past a frame's end, out to the
longest frame the decode is sized for, count as waste."""

from phybench.metrics import _work


def read(run):
    return _work.roofline(run, "acs_kernel",
                          _work.payload_steps(run) + _work.HEADER_STEPS)
