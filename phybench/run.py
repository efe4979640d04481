"""phybench: the benchmark of fun_ofdm_tpu_torch.

    python3 phybench/run.py --workload NAME --seed N --seconds S --trace 0|1

runs one cell of BENCHMARK.json once, on the card of the machine it starts
on, from the root of a checkout, and prints one JSON object as the last line
of its standard output: correct, attempted, failed, metrics (the cell's
end-to-end metrics, or with --trace 1 its per-layer metrics), device, with
--trace 1 a breakdown, and last the numbers that decided `correct`, each
beside its limit (also the last lines of standard error).

Everything is found by name. A cell (BENCHMARK.json "workloads") names its
configuration (a file under phybench/configs/, named in "configs") and its
traffic (phybench/traffic/<traffic>.json); the traffic names the entry
driver that runs it (phybench/entries/<entry>.py, see entries/__init__.py);
a per-layer metric is read by phybench/metrics/<name>.py, whose read(run)
returns a number or None. The inputs come from phybench/generator.py and
the plain transmitter of phybench/reference, from --seed alone.

A run: set-up (importing torch, the CUDA context, the program's kernels
from its build directory inside the checkout, the cell's inputs, the
program's objects and a warm-up of the cell's shapes), timed from the
process's start as setup_s; the measured window of --seconds; with --trace
1 a further slice under torch.profiler; then, with the program's state
freed, the comparison of what the window produced with the planted frames
and with the plain receiver (phybench/check.py).

It exits nonzero and prints no result without a CUDA device, with fewer
devices than the cell asks for, without the program, or when jax, jaxlib,
flax or fun_ofdm_tpu (whole top-level names) were loaded by the time the
window closed.
"""

from __future__ import annotations

import time

#: as near the process's start as Python lets a script read the clock
T_START = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "fun_ofdm_tpu")


def prepare_process(root: Path) -> None:
    """Before torch is imported: every kernel cache a library could keep at
    fixed paths inside the checkout (the program's own build directory,
    csrc/build/, already is one)."""
    cache = root / ".bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def finite(v):
    return v if isinstance(v, int) or math.isfinite(v) else None


def card_power_limit() -> str | None:
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return None
    out = subprocess.run(
        [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=False)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def run(workload: str, seed: int, seconds: float, trace: bool,
        root: Path = ROOT, device="cuda", log=sys.stderr,
        traffic_overrides: dict | None = None):
    """One run of a cell. Returns the result object, or None when the run
    must print nothing (a forbidden module was loaded), and the window's
    own record. traffic_overrides replaces keys of the traffic file (the
    sweep's rates)."""
    import numpy as np
    import torch

    from phybench import check, generator, tracing

    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((root / "phybench" / "traffic"
                          / f"{cell['traffic']}.json").read_text())
    traffic.update(traffic_overrides or {})
    cuda = torch.device(device).type == "cuda"
    spans = tracing.Spans(enabled=bool(trace))
    seed = int(seed) % 2**63
    inputs = generator.make(config, traffic, seed, device)
    ctx = SimpleNamespace(config=config, traffic=traffic, inputs=inputs,
                          device=device, seed=seed, spans=spans, stats=None)
    entry = load(root / "phybench" / "entries" / f"{traffic['entry']}.py",
                 f"phybench_entry_{traffic['entry']}")
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    driver = entry.Driver(ctx)
    if cuda:
        torch.cuda.synchronize()
    # what set-up made lives through the window: out of the collector's way
    gc.collect()
    gc.freeze()
    setup_s = time.time() - T_START

    window = driver.window(seconds, spans, close=not trace)
    found = forbidden_modules()
    if found:
        print(f"loaded by the window's close: {', '.join(found)}", file=log)
        return None, window
    traced = None
    if trace:
        traced = tracing.profile(lambda: driver.traced(spans), spans, cuda)
        driver.finish(spans)
    peak = 0
    if cuda:
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    counters = driver.counters()
    attempted, failed, numbers = driver.outcome(
        np.random.default_rng([seed, 7]), device)
    stats = ctx.stats
    del driver
    gc.unfreeze()
    gc.collect()
    correct = attempted > 0 and check.judge(numbers)
    found = forbidden_modules()
    if found:
        print(f"loaded: {', '.join(found)}", file=log)
        return None, window

    if cuda:
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": 1, "memory_peak_bytes": int(peak)}
        card = card_power_limit()
        if card:
            dev["card"] = card
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0}
    result = {"correct": bool(correct), "attempted": int(attempted),
              "failed": int(failed)}
    if not trace:
        metrics = {}
        for m in bench["end_to_end"]:
            if workload not in m.get("workloads", [workload]):
                continue
            value = setup_s if m["name"] == "setup_s" else window[m["name"]]
            metrics[m["name"]] = {"value": finite(value), "unit": m["unit"]}
        result["metrics"] = metrics
    else:
        peaks = json.loads((root / "phybench" / "metrics"
                            / "_peaks.json").read_text())
        reading = SimpleNamespace(
            cell=workload, trace=traced, counters=counters, spans=spans,
            window=window, config=config, traffic=traffic, inputs=inputs,
            peaks=peaks, stats=stats)
        metrics = {}
        reported = {m["name"] for m in bench["end_to_end"]
                    if workload in m.get("workloads", [workload])}
        for m in bench["per_layer"]:
            if workload not in m.get("workloads", [workload]) \
                    or m["moves"] not in reported:
                continue
            reader = load(root / "phybench" / "metrics" / f"{m['name']}.py",
                          "phybench_metric_" + m["name"].replace(".", "_"))
            value = reader.read(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["metrics"] = metrics
        dev["busy_s"] = traced.busy_s
        dev["window_s"] = traced.wall_s
        result["breakdown"] = {"device_ops": traced.top_ops(),
                               "idle_gaps": traced.idle_gaps()}
    result["device"] = dev
    print(f"window: {json.dumps(window, default=str)}", file=log)
    if stats is not None:
        print(f"chain stats: {json.dumps(stats)}", file=log)
    result["checks"] = {k: {"value": finite(v), "limit": check.LIMITS[k]}
                        for k, v in numbers.items()}
    for k, v in numbers.items():
        print(f"check {k}: {v} (limit {check.LIMITS[k]})", file=log)
    return result, window


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    prepare_process(ROOT)
    sys.path.insert(0, str(ROOT))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = next(w["chips"] for w in bench["workloads"]
                 if w["name"] == args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    result, _ = run(args.workload, args.seed, args.seconds, bool(args.trace))
    if result is None:
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
