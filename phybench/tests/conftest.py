"""A small copy of the benchmark for CPU tests: the repository's phybench
tree with its configurations and traffic cut to a few 100-byte frames, in
a directory of its own, run by the harness's run() with device="cpu".
make_small_root(dest, sizes) cuts to other sizes instead."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

SMALL = {
    "configs/sim1-r36-1500.json": dict(length=100, frames_per_channel=6,
                                       pad_frames=2),
    "configs/link1-r36-1500.json": dict(length=100, max_length=100),
    "traffic/closed-captures.json": dict(captures=2, trace_steps=2),
    "traffic/closed-recording.json": dict(units=2, frames_per_unit=3,
                                          unit_tail=256, trace_steps=4),
    "traffic/open-lone-frames.json": dict(frames=10, gap=3000,
                                          rate_msps=0.2, trace_seconds=0.5),
}


def make_small_root(dest: Path, sizes: dict = SMALL) -> Path:
    shutil.copytree(REPO / "phybench", dest / "phybench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", dest / "BENCHMARK.json")
    for rel, changes in sizes.items():
        f = dest / "phybench" / rel
        data = json.loads(f.read_text())
        data.update(changes)
        f.write_text(json.dumps(data))
    return dest


@pytest.fixture(scope="session")
def small_root(tmp_path_factory) -> Path:
    return make_small_root(tmp_path_factory.mktemp("phybench_small"))
