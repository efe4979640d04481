"""The block-overlap window kernel (csrc/viterbi.cu blocked_window_kernel)
against the least time for the payload Viterbi work of the frames the
traced slice decoded (see _work.py); the SIGNAL headers take the exact
kernel."""

from phybench.metrics import _work


def read(run):
    return _work.roofline(run, "blocked_window_kernel",
                          _work.payload_steps(run))
