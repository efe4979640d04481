"""The share of the all-rates link's traced slice in which the device ran
nothing: 1 - busy / wall, in percent."""

from phybench.metrics import _work


def read(run):
    return _work.idle_share(run)
