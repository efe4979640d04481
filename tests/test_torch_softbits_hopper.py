"""The universal decode's soft streams on the card: the kernel of
csrc/softbits.cu (ops/softbits_cuda.py, taken by
models/ppdu.decode_data_anyrate_p for CUDA tensors) against its plain
version, _anyrate_coded_gather, on the same card and the same input.

The kernel's whole output must equal gather's, bit for bit, the erasure
included past each slot's own rate's end (2 * num_data_bits(max_length)
of the rate), where the Viterbi stops each frame. These need an NVIDIA
GPU with the CUDA toolkit and skip elsewhere; they import no jax:

    python -m pytest --noconftest tests/test_torch_softbits_hopper.py -q
"""

import numpy as np
import pytest
import torch

from fun_ofdm_tpu_torch.models import frontend, ppdu, tx
from fun_ofdm_tpu_torch.ops import softbits_cuda
from fun_ofdm_tpu_torch.rates import ALL_RATES, Rate, params_for
from test_torch_softbits import _points

pytestmark = pytest.mark.cuda

RATES = tuple(ALL_RATES)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernels have "
                    "no CPU mode)")
    return torch.device("cuda")


def _on_card(device, re_np, im_np, views):
    """The points on the card: contiguous float32 tensors, or the real and
    imaginary views of data[..., 1:, :] of a complex64 (slots, 1 + nsym,
    48) tensor, as models/rx.decode_frames_anyrate passes them."""
    if not views:
        return (torch.from_numpy(re_np).to(device),
                torch.from_numpy(im_np).to(device))
    slots, points = re_np.shape
    data = torch.zeros((slots, 1 + points // 48, 48), dtype=torch.complex64,
                       device=device)
    data[:, 1:, :] = torch.complex(
        torch.from_numpy(re_np), torch.from_numpy(im_np)).reshape(
            slots, -1, 48).to(device)
    rest = data[..., 1:, :].reshape(slots, -1)
    return rest.real, rest.imag


def _compare(device, re_np, im_np, ridx_np, max_length, views=False):
    """Kernel vs its plain version on one input; ridx_np may hold indices
    out of range, which both clamp as decode_data_anyrate_p does. Returns
    the kernel's output."""
    samples = _on_card(device, re_np, im_np, views)
    ridx = torch.from_numpy(ridx_np).to(device)
    clamped = ridx.clamp(0, len(RATES) - 1)
    before = softbits_cuda.launches["softbits"]
    got = softbits_cuda.softbits(samples, RATES, ridx, max_length)
    assert softbits_cuda.launches["softbits"] == before + 1
    assert torch.equal(got, softbits_cuda.softbits(samples, RATES, clamped,
                                                   max_length))
    gather = ppdu._anyrate_coded_gather(samples, RATES, clamped, max_length)
    assert got.dtype == gather.dtype == torch.int32
    assert got.shape == gather.shape
    assert torch.equal(got, gather)
    n_coded = torch.tensor([2 * params_for(r).num_data_bits(max_length)
                            for r in RATES], device=device)[clamped]
    inside = torch.arange(got.shape[-1], device=device) < n_coded[:, None]
    assert bool((got[~inside] == 127).all())
    return got


@pytest.mark.parametrize("max_length", [1, 100, 1500, 4095])
@pytest.mark.parametrize("views", [False, True])
def test_every_rate_with_special_values(cuda_device, max_length, views):
    """Every rate mixed across slots and indices -1 and 11, on points with
    NaN, +-inf, +-1e30, exact zeros and the PAM decision boundaries
    planted; contiguous planes and the complex tensor's strided views."""
    rng = np.random.default_rng(max_length + views)
    nsym_max = max(params_for(r).num_symbols(max_length) for r in RATES)
    re_np, im_np = _points(rng, 26, nsym_max * 48, RATES)
    ridx = (np.arange(26) % (len(RATES) + 2) - 1).astype(np.int64)
    _compare(cuda_device, re_np, im_np, ridx, max_length, views)


def test_the_capture_cells_shape(cuda_device):
    """100 slots x 65,664 points, 65,792 coded positions (max_length
    4095), random rates, the views of the complex tensor."""
    rng = np.random.default_rng(4095)
    nsym_max = max(params_for(r).num_symbols(4095) for r in RATES)
    re_np, im_np = _points(rng, 100, nsym_max * 48, RATES)
    ridx = rng.integers(0, len(RATES), 100).astype(np.int64)
    got = _compare(cuda_device, re_np, im_np, ridx, 4095, views=True)
    assert got.shape == (100, 2 * 32896)     # 2 x nbits_max at 4095


def test_decode_with_unknown_rates_equals_the_cpu(cuda_device):
    """decode_data_anyrate_p on the card equals the CPU's, unknown rate
    indices (crc_ok False) and out-of-range lengths included; one kernel
    launch a decode."""
    rng = np.random.default_rng(7)
    nsym_max = max(params_for(r).num_symbols(60) for r in RATES)
    re_np, im_np = _points(rng, 6, nsym_max * 48, RATES)
    rate_idx, lengths = [0, 4, -1, 11, 10, 7], [60, 1, 30, 30, 61, 59]
    cpu = (torch.from_numpy(re_np), torch.from_numpy(im_np))
    card = tuple(t.to(cuda_device) for t in cpu)
    want = ppdu.decode_data_anyrate_p(cpu, RATES, rate_idx, lengths, 60)
    before = softbits_cuda.launches["softbits"]
    got = ppdu.decode_data_anyrate_p(card, RATES, rate_idx, lengths, 60)
    assert softbits_cuda.launches["softbits"] == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert not bool(got[1][2:4].any())


def test_capture_with_a_longest_bpsk_frame_equals_the_cpu(cuda_device):
    """receive_capture_anyrate_p on a mixed-rate capture, one frame of each
    rate and a 4,095-byte RATE_1_2_BPSK frame: the card's starts, valid and detect_dropped equal the CPU's, and in every
    valid slot so do its header fields, crc_ok, rate_match and its
    payload's first hdr_length bytes; one launch a call. The rest is no
    part of an answer and may differ: an empty slot decodes the stream's
    start, and the bytes after a frame's CRC hold the last, weakly decided
    bits of a trellis that ends unterminated, where the card's and the
    CPU's float equalisation may round apart."""
    rng = np.random.default_rng(16)
    plan = [(r, int(n)) for r, n in zip(RATES, rng.integers(1, 400, 11))]
    plan.append((Rate.RATE_1_2_BPSK, 4095))
    parts = [np.zeros(400, np.complex64)]
    for r, n in plan:
        pay = torch.from_numpy(rng.integers(0, 256, n, dtype=np.uint8))
        fre, fim = tx.build_frame_p(pay, r)
        parts += [fre.numpy() + 1j * fim.numpy(),
                  np.zeros(400, np.complex64)]
    x = np.concatenate(parts).astype(np.complex64)
    cpu = (torch.from_numpy(x.real.copy())[None],
           torch.from_numpy(x.imag.copy())[None])
    card = tuple(t.to(cuda_device) for t in cpu)
    want = frontend.receive_capture_anyrate_p(cpu, RATES, 4095, 14)
    before = softbits_cuda.launches["softbits"]
    got = frontend.receive_capture_anyrate_p(card, RATES, 4095, 14)
    assert softbits_cuda.launches["softbits"] == before + 1
    got = {k: v.cpu() for k, v in got.items()}
    assert set(got) == set(want)
    for k in ("starts", "valid", "detect_dropped"):
        assert torch.equal(got[k], want[k]), k
    valid = want["valid"][0]
    assert int(valid.sum()) == len(plan)
    for k in ("header_ok", "crc_ok", "rate_field", "hdr_length",
              "rate_match"):
        assert torch.equal(got[k][0, valid], want[k][0, valid]), k
    assert bool(got["crc_ok"][0, valid].all())
    for i in valid.nonzero().flatten().tolist():
        n = int(want["hdr_length"][0, i])
        assert torch.equal(got["payload"][0, i, :n],
                           want["payload"][0, i, :n]), i


def test_soft_streams_make_no_blocking_copy(cuda_device):
    """Inside the ppdu.anyrate_coded span the host neither copies to or
    from the card nor waits for it: one kernel launch, no
    cudaMemcpy or synchronisation (the tracer's spans are the profiler's
    annotations); anyrate.kernel_slots counts every slot."""
    from torch.profiler import ProfilerActivity, profile

    from fun_ofdm_tpu_torch.utils import trace

    rng = np.random.default_rng(3)
    nsym_max = max(params_for(r).num_symbols(1500) for r in RATES)
    re_np, im_np = _points(rng, 8, nsym_max * 48, RATES)
    card = _on_card(cuda_device, re_np, im_np, views=True)

    def call():
        return ppdu.decode_data_anyrate_p(card, RATES, list(range(8)),
                                          [1500] * 8, 1500)
    call()
    torch.cuda.synchronize()
    trace.take()
    trace.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
    finally:
        trace.disable()
    _, counters = trace.take()
    assert counters["anyrate.kernel_slots"] == 8
    events = prof.events()
    spans = [e.time_range for e in events if e.name == "ppdu.anyrate_coded"
             and e.device_type == torch.autograd.DeviceType.CPU]
    assert len(spans) == 1
    inside = [e.name for e in events
              if spans[0].start <= e.time_range.start <= spans[0].end]
    assert not [n for n in inside
                if "Memcpy" in n or "Synchronize" in n], inside
    assert sum("cudaLaunchKernel" in n for n in inside) >= 1


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    n = 48 * params_for(RATES[0]).num_symbols(10)
    z = torch.zeros(2, n, device=cuda_device)
    idx = torch.zeros(2, dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError, match="CUDA"):
        softbits_cuda.softbits((z.cpu(), z.cpu()), RATES, idx.cpu(), 10)
    with pytest.raises(TypeError, match="float32"):
        softbits_cuda.softbits((z.double(), z.double()), RATES, idx, 10)
    with pytest.raises(TypeError, match="int64"):
        softbits_cuda.softbits((z, z), RATES, idx.int(), 10)
    with pytest.raises(ValueError, match="samples must be"):
        softbits_cuda.softbits((z[:, 1:], z[:, 1:]), RATES, idx, 10)
    with pytest.raises(ValueError, match="samples must be"):
        softbits_cuda.softbits((z, z), RATES, idx[:1], 10)
