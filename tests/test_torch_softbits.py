"""The universal decode's soft-stream kernel on the CPU: what csrc/softbits.cu
computes, written out here in numpy from the parameter block its wrapper
builds (ops/softbits_cuda.rate_params), equals the plain versions the port
runs on the CPU (models/ppdu._anyrate_tables and _anyrate_coded_gather),
and a CPU tensor takes the plain version without building or launching
anything (the kernel itself runs in tests/test_torch_softbits_hopper.py, on
a card)."""

import ctypes
import re

import numpy as np
import pytest
import torch

from fun_ofdm_tpu_torch.models import ppdu
from fun_ofdm_tpu_torch.ops import interleave, puncture, qam, softbits_cuda
from fun_ofdm_tpu_torch.rates import ALL_RATES, params_for

SOURCE = softbits_cuda.SOURCE.read_text()
RATES = tuple(ALL_RATES)


def _cu_const(name):
    m = re.search(rf"constexpr (?:int|float) {name} = ([0-9.]+)f?;", SOURCE)
    return float(m.group(1))


K_TILE = int(_cu_const("kTile"))


def _perm48(k):
    # the kernel's perm48
    return 3 * (k % 16) + k // 16


def _address(p, m):
    """The kernel's index formula for coded positions m (array) of a slot
    at the rate of RateParams p: (point, bit), or point -1 for an
    erasure."""
    group, nkeep = p.group, p.nkeep
    rank = np.array(list(p.rank))[m % group]
    ok = (m < p.n_coded) & (rank >= 0)
    k = m // group * nkeep + rank
    j = 48 * (k // 48) + _perm48(k % 48)
    return np.where(ok, j // p.bpsc, -1), j % p.bpsc


@pytest.mark.parametrize("max_length", [1, 100, 1500, 4095])
def test_parameter_block_expands_to_the_gather_tables(max_length):
    """Every rate's parameters, expanded by the kernel's index formula into
    the 13-wide all-modulation layout (qam.ALL_SOFT_OFFSET), equal
    ppdu._anyrate_tables'; and the demodulation constants are
    qam._axis_params' for the rate's modulation."""
    tabs = ppdu._anyrate_tables(RATES, max_length)[0]
    block = softbits_cuda.rate_params(RATES, max_length)
    assert len(block) == len(RATES)
    m = np.arange(tabs.shape[1])
    for i, (p, r) in enumerate(zip(block, RATES)):
        point, bit = _address(p, m)
        want = np.where(point >= 0, qam.ALL_SOFT_WIDTH * point
                        + qam.ALL_SOFT_OFFSET[p.bpsc] + bit, -1)
        np.testing.assert_array_equal(want, tabs[i], err_msg=r.name)
        axis_bits, power = qam._MOD_CFG[params_for(r).bpsc]
        _, scale_d, amp0 = qam._axis_params(axis_bits, power)
        assert (p.axis_bits, p.amp0) == (axis_bits, amp0)
        assert p.scale_d == np.float32(scale_d)
        assert p.bpsc == params_for(r).bpsc


def test_struct_and_constants_mirror_the_source():
    """RateParams has the source's fields in its order and widths; the
    tile, the erasure, the clamp and the rate limit are the port's."""
    body = re.search(r"struct RateParams \{(.*?)\};", SOURCE, re.S).group(1)
    fields = re.findall(r"^\s*(\w+) (\w+)(?:\[(\d+)\])?;", body, re.M)
    c_types = {"float": ctypes.c_float, "int32_t": ctypes.c_int32,
               "uint8_t": ctypes.c_uint8, "int8_t": ctypes.c_int8}
    mirror = []
    for ctype, name, count in fields:
        t = c_types[ctype]
        mirror.append((name, t * int(count) if count else t))
    assert [n for n, _ in mirror] == [n for n, _ in
                                      softbits_cuda.RateParams._fields_]
    for (_, want), (_, got) in zip(mirror,
                                   softbits_cuda.RateParams._fields_):
        assert ctypes.sizeof(want) == ctypes.sizeof(got)
        assert getattr(want, "_type_", want) == getattr(got, "_type_", got)
    # whole 48-bit chunks and puncture groups at rates 1/2, 2/3 and 3/4
    assert K_TILE % 576 == 0
    assert int(_cu_const("kMaxRates")) == softbits_cuda.MAX_RATES
    assert int(_cu_const("kErasure")) == puncture.ERASURE
    assert _cu_const("kPtLimit") == qam._PT_LIMIT
    np.testing.assert_array_equal(_perm48(np.arange(48)), interleave.PERM)


def _axis_soft(v, p):
    """The kernel's axis_soft over an array: (n,) float32 -> (n, bits)."""
    x = v * np.float32(p.scale_d)
    x = np.where(np.isnan(x), np.float32(0), x)
    pt = np.trunc(np.clip(x, -qam._PT_LIMIT, qam._PT_LIMIT)).astype(np.int32)
    flip, amp, outs = np.ones_like(pt), p.amp0, []
    for _ in range(p.axis_bits):
        outs.append(np.clip(flip * pt + 128, 0, 255))
        s = np.where(pt >= 0, 1, -1).astype(np.int32)
        pt, flip, amp = pt - s * amp, -s, amp // 2
    return np.stack(outs, axis=-1)


def _kernel_emulated(re_np, im_np, ridx, rates, max_length):
    """csrc/softbits.cu block by block: a block per (slot, tile of K_TILE
    coded positions), its punctured span's points demodulated into a
    staging buffer, then each position read from it or erased."""
    block = softbits_cuda.rate_params(rates, max_length)
    slots, points = re_np.shape
    row = 2 * max(params_for(r).num_data_bits(max_length) for r in rates)
    out = np.empty((slots, row), np.int32)
    with np.errstate(invalid="ignore", over="ignore"):
        for slot in range(slots):
            p = block[int(np.clip(ridx[slot], 0, len(rates) - 1))]
            for m0 in range(0, row, K_TILE):
                soft = np.full(K_TILE, 255, np.int32)   # never read unstaged
                live = m0 < p.n_coded
                if live:
                    k0 = m0 // p.group * p.nkeep
                    kend = p.n_coded // p.group * p.nkeep
                    kt = min(K_TILE // p.group * p.nkeep, kend - k0)
                    pts = k0 // p.bpsc + np.arange(kt // p.bpsc)
                    inside = pts < points
                    x = np.where(inside, re_np[slot, pts.clip(0, points - 1)],
                                 np.float32(0))
                    bits = [_axis_soft(x, p)]
                    if p.bpsc > 1:
                        y = np.where(inside,
                                     im_np[slot, pts.clip(0, points - 1)],
                                     np.float32(0))
                        bits.append(_axis_soft(y, p))
                    soft[:kt] = np.concatenate(bits, axis=-1).reshape(-1)
                local = np.arange(min(K_TILE, row - m0))
                rank = np.array(list(p.rank))[local % p.group]
                use = live & (m0 + local < p.n_coded) & (rank >= 0)
                kl = local // p.group * p.nkeep + rank
                j = np.where(use, 48 * (kl // 48) + _perm48(kl % 48), 0)
                out[slot, m0:m0 + local.size] = np.where(
                    use, soft[j], puncture.ERASURE)
    return out


def _points(rng, slots, points, rates):
    """Random equalised points with NaN, +-inf, +-1e30, exact zeros and
    values on (and one ulp either side of) every rate's PAM decision
    boundaries planted."""
    re_np = rng.normal(0, 0.6, (slots, points)).astype(np.float32)
    im_np = rng.normal(0, 0.6, (slots, points)).astype(np.float32)
    special = [np.nan, np.inf, -np.inf, 1e30, -1e30, 0.0, -0.0]
    for p in softbits_cuda.rate_params(rates, 1):
        s = np.float32(p.scale_d)
        for k in range(-256, 257, 32):
            x = np.float32(k) / s
            special += [x, np.nextafter(x, np.float32(np.inf)),
                        np.nextafter(x, np.float32(-np.inf))]
    special = np.array(special, np.float32)
    for arr in (re_np, im_np):
        flat = arr.reshape(-1)
        at = rng.choice(flat.size, min(flat.size // 3, 40 * special.size),
                        replace=False)
        flat[at] = rng.choice(special, at.size)
    return re_np, im_np


@pytest.mark.parametrize("max_length,slots", [(1, 30), (100, 26), (1500, 13)])
def test_kernel_algebra_equals_gather(max_length, slots):
    """The kernel's tiles, staging and addresses, emulated in numpy, give
    _anyrate_coded_gather's whole output on points with every special value
    planted, every rate mixed across slots and out-of-range indices
    (clamped as decode_data_anyrate_p clamps them)."""
    rng = np.random.default_rng(max_length)
    nsym_max = max(params_for(r).num_symbols(max_length) for r in RATES)
    re_np, im_np = _points(rng, slots, nsym_max * 48, RATES)
    ridx = np.arange(slots) % (len(RATES) + 2) - 1
    got = _kernel_emulated(re_np, im_np, ridx, RATES, max_length)
    want = ppdu._anyrate_coded_gather(
        (torch.from_numpy(re_np), torch.from_numpy(im_np)), RATES,
        torch.from_numpy(ridx).clamp(0, len(RATES) - 1), max_length)
    np.testing.assert_array_equal(got, want.numpy())


def test_cpu_tensor_takes_the_plain_version(monkeypatch):
    """decode_data_anyrate_p on CPU tensors runs the plain version,
    _anyrate_coded_gather, once over every slot, and neither builds the
    library nor counts a launch."""
    softbits_cuda.reset_launches()
    rng = np.random.default_rng(5)
    nsym_max = max(params_for(r).num_symbols(40) for r in RATES)
    re_np, im_np = _points(rng, 4, nsym_max * 48, RATES)
    samples = (torch.from_numpy(re_np), torch.from_numpy(im_np))
    calls = []
    plain = ppdu._anyrate_coded_gather

    def spy(*args):
        calls.append(args[2].tolist())
        return plain(*args)
    monkeypatch.setattr(ppdu, "_anyrate_coded_gather", spy)
    ppdu.decode_data_anyrate_p(samples, RATES, [0, 3, 8, 10],
                               [40, 7, 1, 39], 40)
    assert calls == [[0, 3, 8, 10]]
    assert softbits_cuda.launches == {"softbits": 0}
    assert softbits_cuda.build.cache_info().currsize == 0


def test_wrapper_refuses_a_cpu_tensor():
    z = torch.zeros(2, 48 * params_for(RATES[0]).num_symbols(10))
    with pytest.raises(ValueError, match="CUDA"):
        softbits_cuda.softbits((z, z), RATES,
                               torch.zeros(2, dtype=torch.int64), 10)
