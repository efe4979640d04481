"""The capture decode replayed from a CUDA graph (models/rx.capture_call),
on the card, against the same decode run eagerly.

For receive_capture_p, receive_capture_dynamic_p and
receive_capture_anyrate_p, over three distinct recordings at the
benchmark's real shapes (phybench's sim1-r36-1500 and sim1-anyrate-4095:
one channel of 7,832,000 samples, 100 slots), every replayed output is
torch.equal to the eager decode's; a call's outputs survive the next
call; a replayed call, and an eager decode once the tables are on the
card, make no synchronisation; the counters give one eager call and one
capture, then replays, and the Viterbi and soft-stream launch counters
move only on the eager call (a replay launches through no wrapper); a
profiled replay shows the hand kernels as device rows. A capture made
under another current stream, or with another card current, records
the decode's work (PyTorch warns of no empty graph) and replays it. These
need an NVIDIA GPU with the CUDA toolkit and skip elsewhere (the
other-card case needs two); they import no jax:

    python -m pytest --noconftest tests/test_torch_capture_graph_hopper.py -q
"""

import json
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from fun_ofdm_tpu_torch.models import frontend, rx, tx
from fun_ofdm_tpu_torch.ops import softbits_cuda, viterbi_cuda
from fun_ofdm_tpu_torch.rates import Rate
from fun_ofdm_tpu_torch.utils import trace

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parent.parent
SEED = 3181000007


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernels have "
                    "no CPU mode)")
    return torch.device("cuda")


def _config(name: str) -> dict:
    return json.loads((ROOT / "phybench" / "configs" / f"{name}.json")
                      .read_text())


@pytest.fixture(scope="module")
def recordings(cuda_device):
    """Three distinct test_sim recordings (half the frames at 12.5 dB),
    planar float32 (1, 7,832,000) on the card, as the benchmark makes
    them."""
    from phybench import generator

    traffic = {"layout": "capture", "captures": 3, "noisy_every": 2}
    t = generator.make(_config("sim1-r36-1500"), traffic, SEED, cuda_device)
    return t.captures


def _calls():
    """(name, call(stream), the Viterbi launches, softbits launches) of
    each capture entry point at the benchmark's configurations."""
    anyrate = _config("sim1-anyrate-4095")
    rates = tuple(Rate[n] for n in anyrate["decode_rates"])
    return {
        "receive_capture_p": (lambda s: frontend.receive_capture_p(
            s, Rate.RATE_3_4_QAM16, 1500, 100), 4, 0),
        "receive_capture_dynamic_p": (
            lambda s: frontend.receive_capture_dynamic_p(
                s, Rate.RATE_3_4_QAM16, 1500, 100), 4, 0),
        "receive_capture_anyrate_p": (
            lambda s: frontend.receive_capture_anyrate_p(
                s, rates, anyrate["max_length"], 100), 4, 1),
    }


CALLS = _calls()


def _eager(call, stream) -> dict:
    """The call as its key's first: the decode runs eagerly (and is then
    captured)."""
    rx._graphs.clear()
    return call(stream)


def _no_empty_graph(caught) -> None:
    """No warning that a captured CUDA graph is empty."""
    said = [str(w.message) for w in caught]
    assert not [m for m in said if "empty" in m.lower()], said


def _launches() -> tuple[int, int]:
    return (viterbi_cuda.launches["viterbi_acs"]
            + viterbi_cuda.launches["viterbi_chainback"],
            softbits_cuda.launches["softbits"])


@pytest.mark.parametrize("name", list(CALLS))
def test_replayed_outputs_equal_the_eager_decode(cuda_device, recordings,
                                                 name):
    call, vit, soft = CALLS[name]
    want = [_eager(call, s) for s in recordings]
    assert all(int((w["valid"] & w["crc_ok"]).sum()) >= 50 for w in want)
    rx._graphs.clear()
    trace.take()
    trace.enable()
    try:
        got, kept = [], None
        for i in range(6):
            before = _launches()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                out = call(recordings[i % 3])
            torch.cuda.synchronize()
            _no_empty_graph(caught)
            # the eager call launches through the wrappers; the capture and
            # the replays launch nothing there
            launched = (vit, soft) if i == 0 else (0, 0)
            assert _launches() == (before[0] + launched[0],
                                   before[1] + launched[1])
            got.append(out)
            if i == 2:
                kept = {k: v.clone() for k, v in out.items()}
        _, counters = trace.take()
    finally:
        trace.disable()
    for i, out in enumerate(got):
        assert out.keys() == want[i % 3].keys()
        for k in out:
            assert torch.equal(out[k], want[i % 3][k]), (i, k)
    # the third call's outputs, a replay's, survived three more replays
    for k in kept:
        assert torch.equal(got[2][k], kept[k]), k
    assert counters["rx.decode_eager"] == 1
    assert counters["rx.graph_captures"] == 1
    assert counters["rx.graph_replays"] == 5
    if name == "receive_capture_anyrate_p":
        # the universal decode's host-known counters, on every call
        assert counters["anyrate.slots"] == 6 * 100
        assert counters["anyrate.kernel_slots"] == 6 * 100
        assert counters["anyrate.symbols"] == 6 * 100 * 1368


@pytest.mark.parametrize("name", list(CALLS))
def test_no_synchronisation_in_a_replay_or_a_warm_eager_decode(
        cuda_device, recordings, name, monkeypatch):
    """A replay makes no synchronisation, nor does an eager decode once
    its tables are on the card (the capture itself, once a key, does:
    torch.cuda.graph synchronises the device first, so here it is
    switched off for the eager call)."""
    call = CALLS[name][0]
    _eager(call, recordings[0])        # every table on the card, captured
    torch.cuda.synchronize()
    try:
        torch.cuda.set_sync_debug_mode("error")
        replayed = call(recordings[1])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    rx._graphs.clear()
    monkeypatch.setattr(rx._Replayed, "_capture", lambda self: None)
    torch.cuda.synchronize()
    try:
        torch.cuda.set_sync_debug_mode("error")
        eager = call(recordings[1])     # a key's first call: eager
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for k in eager:
        assert torch.equal(eager[k], replayed[k]), k


def test_a_profiled_replay_shows_the_hand_kernels(cuda_device, recordings):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for name, kernels in (("receive_capture_p", ("acs_kernel",
                                                 "chainback_walk_kernel",
                                                 "chainback_maps_kernel")),
                          ("receive_capture_anyrate_p",
                           ("acs_kernel", "chainback_walk_kernel",
                            "softbits_kernel"))):
        call = CALLS[name][0]
        rx._graphs.clear()
        call(recordings[0])
        torch.cuda.synchronize()
        trace.take()
        trace.enable()
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                call(recordings[2])
                torch.cuda.synchronize()
            _, counters = trace.take()
        finally:
            trace.disable()
        assert counters["rx.graph_replays"] == 1
        rows = [e.name for e in prof.events()
                if e.device_type == DeviceType.CUDA]
        for kernel in kernels:
            assert any(kernel in r for r in rows), (name, kernel, rows[:20])


def test_two_channel_stream_with_a_tail(cuda_device):
    """Two channels through the dynamic decode: the stream buffer with
    its zero tail is not contiguous over the channels, so detection reads
    a contiguous copy; replays equal the eager decode."""
    rng = np.random.default_rng(5)
    rate, length = Rate.RATE_1_2_QPSK, 200
    pay = torch.from_numpy(rng.integers(0, 256, (2, 2, length))).to(
        cuda_device)
    fre, fim = tx.build_frame_p(pay.reshape(4, length), rate)
    frame_len = fre.shape[-1]
    n = 2 * frame_len + 3000
    re = torch.zeros((2, n), device=cuda_device)
    im = torch.zeros((2, n), device=cuda_device)
    for c in range(2):
        for f in range(2):
            at = 500 + f * (frame_len + 1000)
            re[c, at:at + frame_len] = fre[2 * c + f]
            im[c, at:at + frame_len] = fim[2 * c + f]

    def call(s):
        return frontend.receive_capture_dynamic_p(s, rate, length, 4)
    want = _eager(call, (re, im))
    assert int((want["valid"] & want["crc_ok"]).sum()) == 4
    rx._graphs.clear()
    outs = [call((re, im)) for _ in range(4)]
    for out in outs:
        for k in want:
            assert torch.equal(out[k], want[k]), k


def _on(device, recording):
    return tuple(x.to(device) for x in recording)


def _replays_equal_eager(call, recordings, device, want) -> None:
    """Four calls on `device` (eager and capture, then three replays over
    the recordings) equal `want`, the eager decode's outputs of each, and
    the capture is not empty."""
    rx._graphs.clear()
    trace.take()
    trace.enable()
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            got = [call(_on(device, recordings[i % 3])) for i in range(4)]
            torch.cuda.synchronize(device)
        _, counters = trace.take()
    finally:
        trace.disable()
    _no_empty_graph(caught)
    assert counters["rx.graph_captures"] == 1
    assert counters["rx.graph_replays"] == 3
    device = torch.empty(0, device=device).device      # with its index
    for i, out in enumerate(got):
        for k in out:
            assert out[k].device == device, k
            assert torch.equal(out[k].cpu(), want[i % 3][k].cpu()), (i, k)


@pytest.mark.parametrize("name", ["receive_capture_p",
                                  "receive_capture_anyrate_p"])
def test_capture_under_a_side_stream(cuda_device, recordings, name):
    """Calls made under a stream of the caller's own (the key tells it
    apart) capture on a stream of the decode's own, replay on the
    caller's and equal the eager decode."""
    call = CALLS[name][0]
    want = [_eager(call, s) for s in recordings]
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(side):
        _replays_equal_eager(call, recordings, cuda_device, want)
        ((key, entry),) = rx._graphs.items()
        assert key[4] == side.cuda_stream
        assert entry.graph is not None
    torch.cuda.current_stream(cuda_device).wait_stream(side)


def test_capture_on_a_card_other_than_the_current(cuda_device, recordings):
    """With cuda:0 current and a graph already captured there, capture
    calls on cuda:1 capture cuda:1's work and replay it: each replay
    equals the eager decode of its own recording."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    call = CALLS["receive_capture_p"][0]
    zero, one = torch.device("cuda", 0), torch.device("cuda", 1)
    with torch.cuda.device(zero):
        want = [_eager(call, _on(zero, s)) for s in recordings]
        call(_on(zero, recordings[1]))          # a replay on cuda:0
        assert torch.cuda.current_device() == 0
        _replays_equal_eager(call, recordings, one, want)
        assert torch.cuda.current_device() == 0


@pytest.mark.parametrize("kind", ["frames", "dynamic", "anyrate"])
@pytest.mark.parametrize("slots", [1, 3, 14])
def test_capture_at_a_few_slots(cuda_device, kind, slots):
    """A one-channel stream the size of the multi-device dry run's block
    and halo (parallel/dryrun.py: 16-byte RATE_1_2_BPSK frames, 4,096
    samples and one frame more) decoded in few slots, where torch.isin in
    the header decode once broke the capture: every replay equals the
    eager decode."""
    rate, length = Rate.RATE_1_2_BPSK, 16
    rng = np.random.default_rng(slots)
    pay = torch.from_numpy(rng.integers(0, 256, (3, length))).to(cuda_device)
    fre, fim = tx.build_frame_p(pay, rate)
    frame_len = fre.shape[-1]
    n = 4096 + frame_len + 128 + 64
    re = torch.zeros((1, n), device=cuda_device)
    im = torch.zeros((1, n), device=cuda_device)
    for f, at in enumerate((100, 2000, n - frame_len - 130)):
        re[0, at:at + frame_len] = fre[f]
        im[0, at:at + frame_len] = fim[f]
    call = {
        "frames": lambda s: frontend.receive_capture_p(s, rate, length,
                                                       slots),
        "dynamic": lambda s: frontend.receive_capture_dynamic_p(
            s, rate, length, slots),
        "anyrate": lambda s: frontend.receive_capture_anyrate_p(
            s, (rate, Rate.RATE_3_4_QAM16, Rate.RATE_2_3_QAM64), length,
            slots)}[kind]
    want = _eager(call, (re, im))
    assert int((want["valid"] & want["crc_ok"]).sum()) == min(slots, 3)
    _replays_equal_eager(call, [(re, im)] * 3, cuda_device, [want] * 3)
