"""The block-overlap window kernel (csrc/viterbi.cu blocked_window_kernel)
against the least time for the payload Viterbi work of the frames the
all-rates link's traced slice decoded, each at its own rate and length
(the entry's payload_steps; see _work.py); the SIGNAL headers take the
exact kernel. None where the kernel did not run or no frame was
decoded."""

from phybench.metrics import _work


def read(run):
    t = run.trace.kernel_s(_work.kernel_matcher("blocked_window_kernel"))
    steps = run.counters.get("payload_steps", 0)
    if t <= 0 or steps <= 0:
        return None
    return 100.0 * _work.least_s(steps, run.peaks) / t
