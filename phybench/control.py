"""Readings that set the limits of `correct` (phybench/check.py).

    python3 phybench/control.py --cell NAME --program-seeds 1,2,... \
        --control-seeds 7,8,9 [--seconds 2]

For each program seed, one run of the cell (the harness's own run(), a
short window) and the numbers it compared. For each control seed, the
control at the cell's own size: the plain receiver computed in bfloat16,
the step below the float32 the configurations state, put in the program's
place. It decodes every frame of the cell's traffic at its start, and its
answers are judged by the same numbers: the noiseless frames against what
was planted (frames_wrong), the distinct noisy frames against the float64
plain receiver (noisy_vs_ref).

One JSON line per reading on standard output. Needs a CUDA device, or
--device cpu for a test at a small size.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))

from phybench import check, generator  # noqa: E402
from phybench import run as bench  # noqa: E402

PRECISION = "bfloat16"


def frame_regions(t) -> list:
    """check.region of every frame of the traffic, in payload order."""
    if t.captures:
        caps, ch, per = t.capture_starts.shape
        planes = [(re.cpu().numpy(), im.cpu().numpy()) for re, im in
                  t.captures]
        return [check.region(planes[i][0][c], planes[i][1][c],
                             int(t.capture_starts[i, c, f]), t.frame_len)
                for i in range(caps) for c in range(ch) for f in range(per)]
    re, im = t.stream
    return [check.region(re, im, int(s), t.frame_len)
            for s in t.stream_starts]


def control_reading(cell: str, seed: int, root: Path, device) -> dict:
    bench_json = json.loads((root / "BENCHMARK.json").read_text())
    w = next(x for x in bench_json["workloads"] if x["name"] == cell)
    conf = next(c for c in bench_json["configs"] if c["name"] == w["config"])
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((root / "phybench" / "traffic"
                          / f"{w['traffic']}.json").read_text())
    t = generator.make(config, traffic, seed, device)
    regions = frame_regions(t)
    low = check.answers(regions, device, PRECISION)
    noisy = [k for k in range(len(regions)) if t.noisy[k]]
    ref = dict(zip(noisy, check.answers([regions[k] for k in noisy],
                                        device)))
    wrong = sum(1 for k in range(len(regions)) if not t.noisy[k]
                and low[k] != (t.payloads[k].tobytes(), t.rate_name,
                               t.length))
    return {"frames_wrong": wrong,
            "noisy_vs_ref": check.noisy_vs_ref(
                {k: [low[k]] for k in noisy}, ref)}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cell", required=True)
    p.add_argument("--program-seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--root", default=str(bench.ROOT))
    args = p.parse_args()
    bench.prepare_process(bench.ROOT)
    root = Path(args.root)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    for s in filter(None, args.program_seeds.split(",")):
        result, _ = bench.run(args.cell, int(s), args.seconds, False,
                              root=root, device=args.device)
        print(json.dumps({"cell": args.cell, "side": "program",
                          "seed": int(s), "correct": result["correct"],
                          "checks": result["checks"]}), flush=True)
    for s in filter(None, args.control_seeds.split(",")):
        numbers = control_reading(args.cell, int(s), root, args.device)
        print(json.dumps({"cell": args.cell, "side": "control",
                          "seed": int(s), "numbers": numbers,
                          "correct": check.judge(numbers)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
