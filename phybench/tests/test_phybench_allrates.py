"""The all-rates live link cell (stream-k1-allrates,
entries/chain_open_allrates.py) on the CPU at the small size: correct; a
frame delivered with another rate, or one dropped, not correct; a traced
run reading the program's counters; the recording it builds; its readers
giving None where their inputs are missing.

The small copy of the benchmark (conftest.SMALL) gains the cut of this
cell's files at import, so that every test of the directory that takes
`small_root` runs it at the size of stream-k1-sparse's cut: 100-byte
frames, max_length 100, 3,000-sample gaps, 22 frames (two cycles of the
11 rates), 0.5 s traced. test_phybench_harness.py's
test_cell_is_correct_on_the_cpu[stream-k1-allrates] runs it at that size
too.
"""

from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from phybench import run as bench
from phybench import tracing
from phybench.entries import chain_open_allrates
from phybench.reference import phy

CELL = "stream-k1-allrates"
CUT = {
    "configs/link1-allrates-1500.json": dict(length=100, max_length=100),
    "traffic/open-lone-frames-allrates.json": dict(
        frames=22, gap=3000, rate_msps=0.2, trace_seconds=0.5),
}
# this directory's conftest, as pytest imports it when the directory is
# collected on its own (collected with tests/, whose conftest.py shares
# its name, it is not importable: run phybench/tests by itself)
_conftest = sys.modules.get("conftest")
if Path(getattr(_conftest, "__file__", "")).parent == Path(__file__).parent:
    _conftest.SMALL.update(CUT)

REPO = Path(__file__).resolve().parents[2]
READERS = ("chain.call_ms_per_superstep.allrates",
           "device.idle_share.allrates",
           "viterbi.blocked_roofline.allrates",
           "rx.anyrate_extract_factor.allrates")


def run(root, trace=False, seconds=0.5, seed=2**31 + 23):
    result, _ = bench.run(CELL, seed, seconds, trace, root=root,
                          device="cpu")
    return result


def small_inputs(root):
    config = json.loads((root / "phybench/configs/"
                         "link1-allrates-1500.json").read_text())
    traffic = json.loads((root / "phybench/traffic/"
                          "open-lone-frames-allrates.json").read_text())
    return config, traffic


def test_the_cell_is_cut_in_the_small_copy(small_root):
    config, traffic = small_inputs(small_root)
    assert (config["length"], config["max_length"]) == (100, 100)
    assert len(config["decode_rates"]) == 11
    assert (traffic["frames"], traffic["gap"]) == (22, 3000)


def test_the_full_size_traffic_is_as_named():
    config, traffic = small_inputs(REPO)
    assert [phy.RATE_BY_NAME[n] for n in config["decode_rates"]] == \
        list(range(11))
    assert (config["length"], config["max_length"]) == (1500, 1500)
    assert (traffic["frames"], traffic["gap"], traffic["noisy_every"],
            traffic["strides_per_step"]) == (264, 20000, 2, 1)
    # 24 cycles of the 11 rates: 9,701,760 samples, 48.5 s at 0.2 MS/s
    lens = [phy.frame_samples(r % 11, 1500) + 20000 for r in range(264)]
    assert sum(lens) == 9_701_760
    assert sum(lens) / (traffic["rate_msps"] * 1e6) > 40


def test_the_recording(small_root):
    config, traffic = small_inputs(small_root)
    rec = chain_open_allrates.make(config, traffic, 2**31 + 5, "cpu")
    again = chain_open_allrates.make(config, traffic, 2**31 + 5, "cpu")
    assert np.array_equal(rec.stream[0], again.stream[0])
    assert rec.rates.tolist() == [i % 11 for i in range(22)]
    assert rec.noisy.tolist() == [i % 2 == 1 for i in range(22)]
    assert rec.frame_lens.tolist() == [phy.frame_samples(i % 11, 100)
                                       for i in range(22)]
    assert rec.stream_starts.tolist() == np.concatenate(
        [[0], np.cumsum(rec.frame_lens + 3000)[:-1]]).tolist()
    assert rec.stream[0].size == (rec.frame_lens + 3000).sum()
    # on the int10 grid, and every clean frame the plain transmitter's
    assert np.array_equal(rec.stream[0] * 128, np.round(rec.stream[0] * 128))
    for j in (0, 2, 10):
        f = phy.build_frames(rec.payloads[j:j + 1], int(rec.rates[j]))[0]
        f = f.numpy()
        s, n = int(rec.stream_starts[j]), int(rec.frame_lens[j])
        want = np.clip(np.round(f.real * 128), -512, 511) / 128
        assert np.allclose(rec.stream[0][s:s + n], want, atol=1e-6)
        assert not rec.stream[0][s + n:s + n + 3000].any()


def test_the_cell_is_correct_on_the_cpu(small_root):
    res = run(small_root)
    assert res["correct"] and res["attempted"] > 0 and res["failed"] == 0
    assert res["checks"]["frames_wrong"]["value"] == 0
    assert set(res["metrics"]) == {"delivery_p95_ms", "setup_s"}


def test_a_traced_run_reads_the_programs_counters(small_root):
    res = run(small_root, trace=True)
    assert res["correct"], res["checks"]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    # no device: the device-trace metrics find nothing to read
    assert set(m) == {"chain.call_ms_per_superstep.allrates",
                      "rx.anyrate_extract_factor.allrates"}
    assert m["chain.call_ms_per_superstep.allrates"] > 0
    # each lone frame a bucket of 4 slots at its class's symbol count
    assert 4 <= m["rx.anyrate_extract_factor.allrates"] < 4 * 36 / 5


def _another_rate(p):
    from fun_ofdm_tpu_torch.rates import Rate

    other = Rate.RATE_2_3_BPSK if p.rate != Rate.RATE_2_3_BPSK \
        else Rate.RATE_1_2_BPSK
    return [dataclasses.replace(p, rate=other)]


FAULTS = {"another_rate": _another_rate, "dropped": lambda p: []}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_fault_is_not_correct(small_root, fault, monkeypatch):
    """The noiseless frame at stream position 0 is delivered with another
    rate, or not at all: `correct` turns false. The window waits 2 s, not
    60, for the frame that never comes."""
    from fun_ofdm_tpu_torch.runtime.chain import ReceiverChain
    from phybench.entries import chain_open

    monkeypatch.setattr(chain_open, "LATE_LIMIT_S", 2.0)

    real = ReceiverChain.process_samples

    def altered(self, samples):
        out = []
        for p in real(self, samples):
            out += FAULTS[fault](p) if p.start == 0 else [p]
        return out
    monkeypatch.setattr(ReceiverChain, "process_samples", altered)
    res = run(small_root)
    assert res["checks"]["frames_wrong"]["value"] > 0, res["checks"]
    assert not res["correct"], res["checks"]


def _load(name):
    return bench.load(REPO / "phybench" / "metrics" / f"{name}.py",
                      "test_metric_" + name.replace(".", "_"))


@pytest.mark.parametrize("counters", [
    {},                                          # nothing traced
    {"calls": 0, "windows": 0, "frames_decoded": 0, "payload_steps": 0},
    # a program whose tracer has no such counters (the parent's chain)
    {"calls": 3, "windows": 3, "frames_decoded": 1, "payload_steps": 12096,
     "program_spans": {}, "program_counters": {"dropped": 0,
                                               "anyrate.symbols": 756}}])
@pytest.mark.parametrize("name", READERS)
def test_readers_give_none_without_their_inputs(name, counters):
    run_ = SimpleNamespace(trace=tracing.Trace(), counters=counters,
                           window={}, spans=tracing.Spans(False),
                           peaks=json.loads((REPO / "phybench/metrics/"
                                             "_peaks.json").read_text()))
    assert _load(name).read(run_) is None


def test_readers_arithmetic():
    peaks = json.loads((REPO / "phybench/metrics/_peaks.json").read_text())
    trace = tracing.Trace(device=[
        ("void (anonymous namespace)::blocked_window_kernel<7>(int*)",
         0.0, 50.0),
        ("void (anonymous namespace)::blocked_guard_kernel(int*)", 50.0,
         60.0)], wall_s=1e-3)
    spans = tracing.Spans(True)
    spans.items = [("process_samples", 0.0, 0.012, False),
                   ("process_samples", 1.0, 1.006, False),
                   ("process_samples", 2.0, 2.5, True)]
    run_ = SimpleNamespace(
        trace=trace, spans=spans, window={"_windows": 3}, peaks=peaks,
        counters={"payload_steps": 12096 + 12096,
                  "program_counters": {"anyrate.symbols": 4 * 189 + 4 * 503,
                                       "anyrate.symbols_needed": 56 + 503}})
    from phybench.metrics import _work

    assert _load("chain.call_ms_per_superstep.allrates").read(run_) == \
        pytest.approx(6.0)
    assert _load("device.idle_share.allrates").read(run_) == \
        pytest.approx(94.0)
    assert _load("viterbi.blocked_roofline.allrates").read(run_) == \
        pytest.approx(100.0 * _work.least_s(24192, peaks) / 50e-6)
    assert _load("rx.anyrate_extract_factor.allrates").read(run_) == \
        pytest.approx(2768 / 559)


def test_slice_steps_counts_each_frame_at_its_own_rate(small_root):
    """The frames whose decodes the slice collected: each delivered one at
    its own rate and length, each whose CRC failed at the mean of the
    decode_rates' steps."""
    config, _ = small_inputs(small_root)
    drv = SimpleNamespace(ctx=SimpleNamespace(config=config))
    steps = chain_open_allrates.Driver.slice_steps
    names = config["decode_rates"]
    delivered = [SimpleNamespace(rate=SimpleNamespace(name=n), length=length)
                 for n, length in (("RATE_1_2_BPSK", 100),
                                   ("RATE_3_4_QAM64", 100),
                                   ("RATE_3_4_QAM64", 7))]
    own = (phy.trellis_steps(phy.RATE_BY_NAME["RATE_1_2_BPSK"], 100)
           + phy.trellis_steps(phy.RATE_BY_NAME["RATE_3_4_QAM64"], 100)
           + phy.trellis_steps(phy.RATE_BY_NAME["RATE_3_4_QAM64"], 7))
    mean = sum(phy.trellis_steps(phy.RATE_BY_NAME[n], int(config["length"]))
               for n in names) / len(names)
    assert steps(drv, delivered, 0) == own
    assert steps(drv, delivered, 2) == pytest.approx(own + 2 * mean)
    assert steps(drv, [], 0) == 0
