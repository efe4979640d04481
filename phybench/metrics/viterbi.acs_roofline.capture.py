"""The exact ACS kernel (csrc/viterbi.cu acs_kernel) against the least time
for the Viterbi work of the frames the traced slice decoded: every payload
and its SIGNAL header (see _work.py)."""

from phybench.metrics import _work


def read(run):
    return _work.roofline(run, "acs_kernel",
                          _work.payload_steps(run) + _work.HEADER_STEPS)
