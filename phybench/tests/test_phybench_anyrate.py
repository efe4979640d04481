"""The universal capture cell (capture-anyrate, entries/capture_anyrate.py)
on the CPU at the small size: a delivered frame with another header or
payload, not correct; a traced run reading the program's spans and
counters; its readers giving None where their inputs are missing.

The small copy of the benchmark (conftest.SMALL) gains the cut of this
cell's files at import, so that every test of the directory that takes
`small_root` runs it at the size of capture-sim's cut: 100-byte frames, 6
a recording, 2 recordings. test_phybench_harness.py's
test_cell_is_correct_on_the_cpu[capture-anyrate] is the cell's correct
run at that size.
Its max_length is cut too, from 4,095 to 200: on the CPU the plain
Viterbi's traceback walks the whole longest trellis of every slot in
Python (32,902 steps a call at 4,095, 1,662 at 200), and the profiled
slice of a traced run records every one of its operations.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from phybench import run as bench
from phybench import tracing
from phybench.entries import capture_anyrate
from phybench.reference import phy

CELL = "capture-anyrate"
CUT = {
    "configs/sim1-anyrate-4095.json": dict(length=100, frames_per_channel=6,
                                           pad_frames=2, max_length=200),
    "traffic/closed-captures-anyrate.json": dict(captures=2, trace_steps=2),
}
# this directory's conftest, as pytest imports it when the directory is
# collected on its own (collected with tests/, whose conftest.py shares
# its name, it is not importable: run phybench/tests by itself)
_conftest = sys.modules.get("conftest")
if Path(getattr(_conftest, "__file__", "")).parent == Path(__file__).parent:
    _conftest.SMALL.update(CUT)

REPO = Path(__file__).resolve().parents[2]
READERS = ("capture.device_ms_per_call.anyrate",
           "viterbi.acs_roofline.anyrate", "device.idle_share.anyrate",
           "rx.decode_host_ms_per_call.anyrate",
           "rx.anyrate_extract_factor.anyrate")


def run(root, trace=False, seconds=0.5, seed=2**31 + 21):
    result, _ = bench.run(CELL, seed, seconds, trace, root=root,
                          device="cpu")
    return result


def test_the_cell_is_cut_in_the_small_copy(small_root):
    conf = json.loads((small_root / "phybench/configs/"
                       "sim1-anyrate-4095.json").read_text())
    assert (conf["length"], conf["max_length"]) == (100, 200)
    assert len(conf["decode_rates"]) == 11


def test_a_traced_run_reads_the_programs_spans_and_counters(small_root):
    res = run(small_root, trace=True)
    assert res["correct"], res["checks"]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    # no device: the device-trace metrics find nothing to read
    assert set(m) == {"rx.decode_host_ms_per_call.anyrate",
                      "rx.anyrate_extract_factor.anyrate"}
    assert m["rx.decode_host_ms_per_call.anyrate"] > 0
    # every slot extracted at 200 bytes of RATE_1_2_BPSK, each planted
    # frame needing 100 bytes of RATE_3_4_QAM16
    assert m["rx.anyrate_extract_factor.anyrate"] == pytest.approx(
        phy.num_symbols(0, 200) / phy.num_symbols(8, 100))


def _length(out):
    out["hdr_length"][0, 0] -= 1


def _rate(out):
    out["rate_field"][0, 0] = 9          # RATE_1_2_QAM16: a rate decoded


def _payload(out):
    out["payload"][0, 0, 7] ^= 1


FAULTS = {"hdr_length": _length, "rate_field": _rate, "payload": _payload}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_delivered_frame_altered_is_not_correct(small_root, fault,
                                                  monkeypatch):
    """Slot 0 holds a noiseless frame, delivered: another length, another
    rate or another payload byte turns `correct` false."""
    from fun_ofdm_tpu_torch.models import frontend

    real = frontend.receive_capture_anyrate_p

    def altered(*a, **k):
        out = real(*a, **k)
        FAULTS[fault](out)
        return out
    monkeypatch.setattr(frontend, "receive_capture_anyrate_p", altered)
    res = run(small_root, seconds=1.0)
    assert res["checks"]["frames_wrong"]["value"] > 0, res["checks"]
    assert not res["correct"], res["checks"]


def test_as_planted_keeps_only_the_planted_header():
    host = {"rate_field": np.array([[11, 11, 9]]),
            "hdr_length": np.array([[100, 99, 100]]),
            "header_ok": np.array([[True, True, True]]),
            "crc_ok": np.array([[True, True, True]]),
            "payload": np.arange(3 * 200).reshape(1, 3, 200)}
    capture_anyrate.as_planted(host, 11, 100)
    assert host["crc_ok"].tolist() == [[True, False, False]]
    assert host["header_ok"].tolist() == [[True, False, False]]
    assert host["payload"].shape == (1, 3, 100)


def test_header_symbols_counts_the_slots_whose_header_holds():
    host = {"rate_field": np.array([[0xB, 0xD, 0x3]]),
            "hdr_length": np.array([[1500, 4095, 7]]),
            "header_ok": np.array([[True, True, False]])}
    assert capture_anyrate.header_symbols(host) == 84 + 1368


def _load(name):
    return bench.load(REPO / "phybench" / "metrics" / f"{name}.py",
                      "test_metric_" + name.replace(".", "_"))


@pytest.mark.parametrize("counters", [
    {},                                          # nothing traced
    {"calls": 0, "frames_decoded": 0, "launches": {}},
    # a program whose tracer has no such spans or counters
    {"calls": 3, "frames_decoded": 300, "launches": {},
     "program_spans": {}, "program_counters": {"dropped": 0},
     "symbols_needed": 8400}])
@pytest.mark.parametrize("name", READERS)
def test_readers_give_none_without_their_inputs(name, counters):
    run_ = SimpleNamespace(trace=tracing.Trace(), counters=counters,
                           peaks=json.loads((REPO / "phybench/metrics/"
                                             "_peaks.json").read_text()),
                           inputs=SimpleNamespace(rate=8, length=1500))
    assert _load(name).read(run_) is None


def test_program_readers_arithmetic():
    run_ = SimpleNamespace(counters={
        "program_spans": {"frontend.receive_capture": (4, 40.0, 1.0),
                          "rx.decode": (4, 30.0, 2.0)},
        "program_counters": {"dropped": 0, "anyrate.symbols": 4 * 136800},
        "symbols_needed": 4 * 8400})
    assert _load("rx.decode_host_ms_per_call.anyrate").read(run_) == 7.5
    assert _load("rx.anyrate_extract_factor.anyrate").read(run_) == \
        pytest.approx(1368 / 84)
