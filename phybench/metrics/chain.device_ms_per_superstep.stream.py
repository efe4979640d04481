"""Device time of one superstep of the streaming chain: the busy seconds of
the traced slice over the supersteps it dispatched (ChainStats.windows)."""

from phybench.metrics import _work


def read(run):
    return _work.device_ms_per(run, "windows")
