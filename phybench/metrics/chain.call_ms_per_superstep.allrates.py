"""Host wall time inside process_samples per superstep of the all-rates
link, over the measured window of a traced run (the benchmark's own span
around each call, before the profiled slice) and the supersteps it
dispatched (ChainStats.windows)."""


def read(run):
    windows = run.window.get("_windows", 0)
    if not windows:
        return None
    return run.spans.total_s("process_samples") * 1e3 / windows
