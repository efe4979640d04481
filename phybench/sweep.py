"""The open-loop sweep that fixes stream-k1-sparse's offered rate.

    python3 phybench/sweep.py [--seconds 8] [--seed 5] [--write]

Offers the cell's traffic at rising fixed rates (Msample/s), each for
--seconds on a fresh chain in this one process, and reads how late the
schedule ran. A rate is sustained when no backlog builds: 99% of the reads
were fed less than one read's period late, and the run's last quarter was
on average no later than its second (above capacity the backlog, and with
it the lateness, grows all through the run; just below it, it builds to
hundreds of milliseconds and drains again). After the coarse pass,
BISECTIONS halvings between the highest sustained rate and the next refine
it. The cell runs at FRACTION of the highest sustained rate; with
--write that rate goes into the cell's traffic file. One JSON line per rate
and a last one with the choice go to standard output.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))

from phybench import run as bench  # noqa: E402

CELL = "stream-k1-sparse"
COARSE = (0.2, 0.25, 0.3, 0.35, 0.4, 0.45, 0.5, 0.6, 0.8, 1.0)
BISECTIONS = 2
#: how much later the last quarter may run than the second, ms
GROWTH_MS = 1.0
FRACTION = 0.8


def read_samples() -> int:
    b = json.loads((bench.ROOT / "BENCHMARK.json").read_text())
    w = next(x for x in b["workloads"] if x["name"] == CELL)
    c = next(x for x in b["configs"] if x["name"] == w["config"])
    return int(json.loads((bench.ROOT / c["file"]).read_text())
               ["read_samples"])


def sustained(rate: float, seconds: float, seed: int, read: int) -> bool:
    result, window = bench.run(CELL, seed, seconds, False, log=sys.stderr,
                               traffic_overrides={"rate_msps": rate})
    s = window["_schedule"]
    read_ms = read / (rate * 1e6) * 1e3
    ok = (s["late_ms_p99"] < read_ms and s["late_ms_last_quarter"]
          <= s["late_ms_second_quarter"] + GROWTH_MS)
    print(json.dumps({"rate_msps": rate, "sustained": ok,
                      "correct": result["correct"] if result else None,
                      "delivery_p95_ms": window["delivery_p95_ms"], **s}),
          flush=True)
    return ok


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--seed", type=int, default=5)
    p.add_argument("--write", action="store_true")
    args = p.parse_args()
    bench.prepare_process(bench.ROOT)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    read = read_samples()
    best, above = None, None
    for rate in COARSE:
        if sustained(rate, args.seconds, args.seed, read):
            best = rate
        else:
            above = rate
            break
    if best is None:
        print("no rate sustained", file=sys.stderr)
        return 1
    for _ in range(BISECTIONS if above else 0):
        mid = round((best + above) / 2, 4)
        if sustained(mid, args.seconds, args.seed, read):
            best = mid
        else:
            above = mid
    chosen = round(FRACTION * best, 3)
    print(json.dumps({"highest_sustained_msps": best,
                      "first_unsustained_msps": above,
                      "chosen_rate_msps": chosen,
                      "card": bench.card_power_limit()}), flush=True)
    if args.write:
        f = HERE / "traffic" / "open-lone-frames.json"
        data = json.loads(f.read_text())
        data["rate_msps"] = chosen
        f.write_text(json.dumps(data, indent=2) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
