"""The algebra of the port's CUDA Viterbi pair, held on the CPU.

The kernels (fun_ofdm_tpu_torch/csrc/viterbi.cu) cannot run here, so their
arithmetic is held in plain form: `viterbi.chainback_segmented_plain` (the
segment maps, their composition from state 0, the walk of each segment)
and `viterbi._acs_step_early` / `viterbi.acs_early_plain` (the
renormalisation's minimum and trigger from the old metrics, the
subtraction deferred into a uniform offset). Each must equal the plain
versions (`chainback_plain`, `_acs_step`, `acs_plain`) and, through the
decode, the JAX `viterbi_decode_scan`, at tolerance 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from fun_ofdm_tpu.ops import convcode as j_convcode
from fun_ofdm_tpu.ops import viterbi as j_viterbi
from fun_ofdm_tpu_torch.ops import viterbi, viterbi_cuda
from fun_ofdm_tpu_torch.tools import viterbi_variants_ab

torch.set_num_threads(1)


def _noisy_soft(rng, batch, nbits, noise=120):
    bits = rng.integers(0, 2, size=(batch, nbits + 6))
    coded = np.asarray(j_convcode.conv_encode(jnp.asarray(bits)))
    return np.clip(coded * 255 + rng.integers(-noise, noise, coded.shape),
                   0, 255).astype(np.int32)


def _soft(kind, rng, batch, nbits):
    soft = _noisy_soft(rng, batch, nbits)
    if kind == "hard":
        return np.where(soft >= 128, 255, 0).astype(np.int32)
    if kind == "erasure":
        return np.full_like(soft, 127)
    return soft


def _segmented_decode(soft, nbits, seg, nbits_dynamic=None):
    """viterbi_decode_scan's composition through the kernels' algebra."""
    soft = torch.from_numpy(soft)
    steps = viterbi.step_counts(nbits, nbits_dynamic, (soft.shape[0],), "cpu")
    dec = viterbi.acs_early_plain(soft, steps, torch.ones_like(steps))
    return viterbi.chainback_segmented_plain(dec, nbits, seg).numpy()


def _segments(total):
    """Segment lengths 1, 7, 64, T - 1, T and > T for T trellis steps."""
    return [1, 7, 64, total - 1, total, total + 9]


@pytest.mark.parametrize("nbits", [18, 90])
@pytest.mark.parametrize("k", range(6))
def test_segmented_chainback_matches_plain(nbits, k):
    """Random decisions, with dead steps (zero decisions past each frame's
    count): every segment length gives chainback_plain's bits."""
    total = nbits + 6
    seg = _segments(total)[k]
    rng = np.random.default_rng(100 * nbits + k)
    dec = rng.integers(0, 2, size=(total, 5, 64)).astype(np.uint8)
    live = np.array([total, total - 1, total // 2, 6, 0])
    dec[np.arange(total)[:, None] >= live[None, :]] = 0
    dec = torch.from_numpy(dec)
    assert torch.equal(viterbi.chainback_segmented_plain(dec, nbits, seg),
                       viterbi.chainback_plain(dec, nbits))


@pytest.mark.parametrize("kind", ["noisy", "hard", "erasure"])
@pytest.mark.parametrize("nbits,seg", [(18, 1), (18, 24), (100, 7),
                                       (100, 64), (337, 105), (337, 343),
                                       (337, 500)])
def test_segmented_decode_matches_jax_scan(kind, nbits, seg):
    """The decode through both redesigned formulations equals the JAX
    scan: noisy, hard 0/255 (saturation) and all-127 (renormalisation at
    every chance) inputs, the 18-bit header, segments shorter than, equal
    to and longer than the trellis."""
    rng = np.random.default_rng(nbits + seg)
    soft = _soft(kind, rng, 3, nbits)
    want = np.asarray(j_viterbi.viterbi_decode_scan(jnp.asarray(soft), nbits))
    np.testing.assert_array_equal(_segmented_decode(soft, nbits, seg), want)


@pytest.mark.parametrize("seg", [1, 64, 306])
def test_segmented_decode_dynamic_lengths_match_jax_scan(seg):
    """Per-frame lengths (dead steps past each count) through the
    kernels' algebra equal the JAX scan with nbits_dynamic."""
    rng = np.random.default_rng(seg)
    nbits = 300
    soft = _noisy_soft(rng, 5, nbits)
    nbd = np.array([300, 299, 151, 6, 0], np.int32)
    want = np.asarray(j_viterbi.viterbi_decode_scan(
        jnp.asarray(soft), nbits, nbits_dynamic=jnp.asarray(nbd)))
    got = _segmented_decode(soft, nbits, seg, torch.from_numpy(nbd))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["noisy", "hard", "erasure"])
@pytest.mark.parametrize("init", [1, 0])
def test_early_acs_matches_acs_plain(kind, init):
    """acs_early_plain's decisions equal acs_plain's, with mixed per-frame
    lengths, exact and uniform init."""
    rng = np.random.default_rng(7 + init)
    nbits = 400
    soft = torch.from_numpy(_soft(kind, rng, 6, nbits))
    steps = viterbi.step_counts(
        nbits, torch.from_numpy(rng.integers(0, nbits + 1, 6)), (6,), "cpu")
    init_t = torch.full((6,), init, dtype=torch.int32)
    assert torch.equal(viterbi.acs_early_plain(soft, steps, init_t),
                       viterbi.acs_plain(soft, steps, init_t))


@settings(max_examples=300, deadline=None)
@given(metrics=st.lists(st.integers(0, 255), min_size=64, max_size=64),
       s0=st.integers(0, 255), s1=st.integers(0, 255),
       off=st.integers(0, 3_000_000))
def test_early_step_matches_step(metrics, s0, s1, off):
    """One step in offset form, on any metrics in 0..255 and any offset:
    the same decisions as _acs_step, and new metrics minus the new offset
    equal to _acs_step's (renormalised or not)."""
    m = torch.tensor([metrics], dtype=torch.int32)
    t = viterbi._branch_metrics(torch.tensor([s0]), torch.tensor([s1]))
    want, want_dec = viterbi._acs_step(m, t)
    off_t = torch.tensor([[off]], dtype=torch.int32)
    got, got_off, got_dec = viterbi._acs_step_early(m + off_t, off_t, t)
    assert torch.equal(got_dec, want_dec)
    assert torch.equal(got - got_off, want)
    # a renormalisation leaves the smallest metric at 0
    assert int(got_off) == off or int((got - got_off).min()) == 0


def test_early_step_renormalises_when_state_zero_passes_210():
    """A state 0 just above 210 after the step triggers the deferred
    renormalisation: the offset rises by the new minimum."""
    m = torch.full((1, 64), 220, dtype=torch.int32)
    m[0, 5] = 190
    t = viterbi._branch_metrics(torch.tensor([0]), torch.tensor([0]))
    want, _ = viterbi._acs_step(m, t)
    got, off, _ = viterbi._acs_step_early(m, torch.zeros((1, 1),
                                                         dtype=torch.int32), t)
    assert int(off) > 0
    assert torch.equal(got - off, want)
    assert int((got - off).min()) == 0


@pytest.mark.parametrize("name", sorted(viterbi_variants_ab.VARIANTS))
def test_variant_edits_apply_to_the_source(name):
    """Every design variant of the A/B tool still finds the text it edits
    in csrc/viterbi.cu (the tool itself runs only on a GPU)."""
    src = viterbi_cuda.SOURCE.read_text()
    edited = viterbi_variants_ab.VARIANTS[name](src)
    assert edited != src and "acs_kernel" in edited
