"""Device time (kernels, copies, memsets) of one universal capture call:
the busy seconds of the traced slice over its calls of
receive_capture_anyrate_p."""

from phybench.metrics import _work


def read(run):
    return _work.device_ms_per(run, "calls")
