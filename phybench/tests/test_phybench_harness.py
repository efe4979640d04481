"""The harness end to end on the CPU at a small size: every cell correct;
a cell, a traffic mix and a metric added as files alone; the imports; the
control and the planted faults coming out as not correct."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from phybench import check, run as bench

REPO = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads(
    (REPO / "BENCHMARK.json").read_text())["workloads"]]


def run(root, cell, trace=False, seconds=0.5, seed=2**31 + 11):
    result, window = bench.run(cell, seed, seconds, trace, root=root,
                               device="cpu")
    return result


@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct_on_the_cpu(small_root, cell):
    res = run(small_root, cell)
    assert res["correct"] and res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) >= {"setup_s"}


def test_cell_traffic_and_metric_added_as_files(small_root, tmp_path):
    from conftest import make_small_root

    root = make_small_root(tmp_path)
    b = json.loads((root / "BENCHMARK.json").read_text())
    conf = json.loads((root / "phybench/configs/link1-r36-1500.json")
                      .read_text())
    conf.update(rate="RATE_1_2_QPSK", length=60, max_length=60)
    (root / "phybench/configs/fixture-qpsk.json").write_text(
        json.dumps(conf))
    (root / "phybench/traffic/fixture-mix.json").write_text(json.dumps(
        {"entry": "chain_closed", "layout": "back_to_back", "units": 2,
         "frames_per_unit": 2, "unit_tail": 300, "strides_per_step": 1,
         "trace_steps": 3}))
    (root / "phybench/metrics/fixture.calls.py").write_text(
        "def read(run):\n    return float(run.counters['calls'])\n")
    b["configs"].append({"name": "fixture-qpsk", "source": "fixture",
                         "file": "phybench/configs/fixture-qpsk.json",
                         "reduced": [], "why": "fixture"})
    b["workloads"].append({"name": "fixture-cell", "config": "fixture-qpsk",
                           "traffic": "fixture-mix", "chips": 1,
                           "why": "fixture"})
    b["end_to_end"].append({"name": "stream_msps", "unit": "Msample/s",
                            "better": "higher", "bound": 0.25,
                            "source": "host_clock",
                            "workloads": ["fixture-cell"]})
    b["per_layer"].append({"name": "fixture.calls", "unit": "calls",
                           "better": "higher", "source": "program_counter",
                           "layer": "runtime.chain", "moves": "stream_msps",
                           "workloads": ["fixture-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    res = run(root, "fixture-cell")
    assert res["correct"] and set(res["metrics"]) == {"stream_msps",
                                                      "setup_s"}
    res = run(root, "fixture-cell", trace=True)
    assert res["correct"]
    assert res["metrics"]["fixture.calls"]["value"] == 3.0


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "fun_ofdm_tpu_torch_fake", sys)
    assert bench.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib_like.x", sys)
    assert bench.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "fun_ofdm_tpu.rates", sys)
    assert bench.forbidden_modules() == ["fun_ofdm_tpu"]


def test_a_run_loads_no_jax():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from phybench import run, generator, check, tracing, control\n"
        "from phybench.entries import _stream, capture, chain_open, "
        "chain_closed\n"
        "import fun_ofdm_tpu_torch.models.frontend, "
        "fun_ofdm_tpu_torch.runtime.chain\n"
        "sys.exit(1 if run.forbidden_modules() else 0)\n" % str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True)
    assert out.returncode == 0, out.stderr


def test_without_a_card_no_result():
    out = subprocess.run(
        [sys.executable, "phybench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=REPO,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout == ""


def test_without_the_program_no_result(tmp_path):
    from conftest import make_small_root

    root = make_small_root(tmp_path)
    code = ("import sys; from pathlib import Path; from phybench import run; "
            "r = run.run(%r, 1, 0.2, False, root=Path('.'), device='cpu'); "
            "print(r)" % CELLS[0])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=root, env={"PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout == ""
    assert "No module named 'fun_ofdm_tpu_torch'" in out.stderr


# --- the control, at a size a test can hold -------------------------------

#: 1500-byte frames as the cells send them, 256 of them (128 at the checked
#: SNR): at fewer, or at 100 bytes, the bfloat16 receiver's answers differ
#: from float64 ones on too few frames to be told from float32 rounding
CONTROL_SIZE = {
    "configs/sim1-r36-1500.json": dict(frames_per_channel=256,
                                       pad_frames=1),
    "traffic/closed-captures.json": dict(captures=1),
    "traffic/open-lone-frames.json": dict(frames=256, gap=400),
}


@pytest.mark.parametrize("cell", ["capture-sim", "stream-k1-sparse"])
def test_control_fails_the_limits(tmp_path, cell):
    from conftest import make_small_root

    from phybench import control

    root = make_small_root(tmp_path, CONTROL_SIZE)
    numbers = control.control_reading(cell, 5, root, "cpu")
    assert numbers["frames_wrong"] == 0, numbers
    assert not check.judge(numbers), numbers


def test_the_program_agrees_with_float64_on_noisy_frames(tmp_path):
    """The program's capture entry, at the control's size, gives every
    noisy frame the float64 plain receiver's answer: its float32 differs
    from float64 by rounding alone."""
    from conftest import make_small_root

    root = make_small_root(tmp_path, CONTROL_SIZE)
    res = run(root, "capture-sim", seconds=0.1)
    assert res["checks"]["noisy_vs_ref"]["value"] == 0, res["checks"]
    assert res["correct"], res["checks"]


# --- faults planted under the timed path ----------------------------------

def stale_capture(monkeypatch):
    from fun_ofdm_tpu_torch.models import frontend

    real, last = frontend.receive_capture_p, {}

    def stale(*a, **k):
        out = last.get("out") or real(*a, **k)
        last["out"] = out
        return out
    monkeypatch.setattr(frontend, "receive_capture_p", stale)


def half_capture(monkeypatch):
    from fun_ofdm_tpu_torch.models import frontend

    real = frontend.receive_capture_p

    def half(stream, *a, **k):
        out = real(stream, *a, **k)
        out["valid"][..., : out["valid"].shape[-1] // 2] = False
        return out
    monkeypatch.setattr(frontend, "receive_capture_p", half)


def altered_capture(monkeypatch):
    from fun_ofdm_tpu_torch.models import frontend

    real = frontend.receive_capture_p

    def altered(*a, **k):
        out = real(*a, **k)
        out["payload"][0, 0, 7] ^= 1
        return out
    monkeypatch.setattr(frontend, "receive_capture_p", altered)


def stale_chain(monkeypatch):
    from fun_ofdm_tpu_torch.runtime.chain import ReceiverChain

    real, state = ReceiverChain.process_samples, {"n": 0}

    def stale(self, samples):
        state["n"] += 1
        # after the warm-up, the chain keeps its state and ingests nothing
        return [] if state["n"] > 40 else real(self, samples)
    monkeypatch.setattr(ReceiverChain, "process_samples", stale)


def half_chain(monkeypatch):
    from fun_ofdm_tpu_torch.runtime.chain import ReceiverChain

    real = ReceiverChain.process_samples

    def half(self, samples):
        out = real(self, samples)
        return out[: len(out) // 2] if len(out) > 1 else \
            [p for p in out if p.start % 2 == 0]
    monkeypatch.setattr(ReceiverChain, "process_samples", half)


def altered_chain(monkeypatch):
    import dataclasses

    from fun_ofdm_tpu_torch.runtime.chain import ReceiverChain

    real = ReceiverChain.process_samples

    def altered(self, samples):
        out = real(self, samples)
        return [dataclasses.replace(p, payload=b"\\x00" + p.payload[1:])
                for p in out]
    monkeypatch.setattr(ReceiverChain, "process_samples", altered)


FAULTS = {
    "capture-sim": (stale_capture, half_capture, altered_capture),
    "stream-k1-sparse": (stale_chain, half_chain, altered_chain),
}


@pytest.mark.parametrize("cell,fault", [(c, f) for c, fs in FAULTS.items()
                                        for f in fs],
                         ids=lambda x: getattr(x, "__name__", x))
def test_planted_fault_is_not_correct(small_root, cell, fault, monkeypatch):
    fault(monkeypatch)
    res = run(small_root, cell, seconds=1.0)
    assert not res["correct"], res["checks"]


# --- on the card ------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "phybench/run.py", "--workload", cell, "--seed",
         "77", "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, cwd=REPO, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert np.isfinite(list(res["metrics"].values())[0]["value"])


def test_altered_noisy_answers_are_not_correct(small_root, monkeypatch):
    """Noisy frames' payloads altered where they are produced: only the
    comparison with the float64 plain receiver can see it."""
    import dataclasses

    from fun_ofdm_tpu_torch.runtime.chain import ReceiverChain

    from phybench.reference import phy

    traffic = json.loads((small_root / "phybench/traffic/"
                          "open-lone-frames.json").read_text())
    period = phy.frame_samples(phy.RATE_BY_NAME["RATE_3_4_QAM16"],
                               100) + traffic["gap"]
    real = ReceiverChain.process_samples

    def altered(self, samples):
        return [dataclasses.replace(p, payload=b"\x00" + p.payload[1:])
                if (p.start // period) % 2 == 1 else p
                for p in real(self, samples)]
    monkeypatch.setattr(ReceiverChain, "process_samples", altered)
    res = run(small_root, "stream-k1-sparse", seconds=3.0)
    assert res["checks"]["frames_wrong"]["value"] == 0, res["checks"]
    assert not res["correct"], res["checks"]
