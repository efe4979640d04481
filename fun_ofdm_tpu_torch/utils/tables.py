"""Constant tables on the device, made once per device.

`on_device` caches a function that builds a constant tensor (or a tuple
of them) on a device: functools.lru_cache over its arguments, the device
among them. A decode then reads each table where it already lies; a copy
of a numpy table to a CUDA device on every call would block the host
until the card caught up (PyTorch synchronises after a copy from pageable
memory) and cannot be captured into a CUDA graph.

A CUDA graph records the addresses of the tables it reads, not the
tables: `held()` collects every table fetched while it is open, and the
captured decode keeps them (models/rx.py), so a bounded cache that drops
a table cannot free memory a graph still reads.
"""

from __future__ import annotations

import contextlib
import functools
import threading

_local = threading.local()      # .held: the list of the open held(), if any


def on_device(maxsize: int | None = None):
    """Decorator: cache build(*args) (lru, maxsize entries; None keeps
    all), its last argument the device the result lies on."""
    def wrap(build):
        cached = functools.lru_cache(maxsize=maxsize)(build)

        @functools.wraps(build)
        def table(*args):
            t = cached(*args)
            held_ = getattr(_local, "held", None)
            if held_ is not None:
                held_.append(t)
            return t

        table.cache_clear = cached.cache_clear
        table.cache_info = cached.cache_info
        return table
    return wrap


@contextlib.contextmanager
def held():
    """Yield a list of every table fetched on this thread while open."""
    outer = getattr(_local, "held", None)
    _local.held = got = []
    try:
        yield got
    finally:
        _local.held = outer
