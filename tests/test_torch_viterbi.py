"""The port's Viterbi: plain twin vs fun_ofdm_tpu, and the CUDA kernel.

On the CPU the twin (fun_ofdm_tpu_torch.ops.viterbi) must be bit-exact
with the JAX `viterbi_decode_scan` and with the Pallas kernel run in
interpret mode, exactly as tests/test_viterbi_pallas.py runs it. The
CUDA kernel cannot run here; its wrapper must refuse CPU tensors
(tests/test_torch_cuda.py holds it against the twin on a GPU).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fun_ofdm_tpu.ops import convcode as j_convcode
from fun_ofdm_tpu.ops import viterbi as j_viterbi
from fun_ofdm_tpu.ops import viterbi_pallas
from fun_ofdm_tpu_torch.ops import viterbi, viterbi_cuda

torch.set_num_threads(1)


def _noisy_soft(rng, batch, nbits):
    bits = rng.integers(0, 2, size=batch + (nbits + 6,))
    coded = np.asarray(j_convcode.conv_encode(jnp.asarray(bits)))
    return np.clip(coded * 255 + rng.integers(-120, 120, coded.shape),
                   0, 255).astype(np.int32)


def _twin(soft, nbits, nbits_dynamic=None):
    nbd = None if nbits_dynamic is None else torch.from_numpy(nbits_dynamic)
    return viterbi.viterbi_decode(torch.from_numpy(soft), nbits,
                                  nbits_dynamic=nbd).numpy()


@pytest.mark.parametrize("nbits", [18, 100, 337, 811])
def test_twin_matches_scan_and_pallas(nbits):
    rng = np.random.default_rng(nbits)
    soft = _noisy_soft(rng, (3,), nbits)
    got = _twin(soft, nbits)
    np.testing.assert_array_equal(
        got, np.asarray(j_viterbi.viterbi_decode_scan(jnp.asarray(soft),
                                                      nbits)))
    np.testing.assert_array_equal(
        got, np.asarray(viterbi_pallas.viterbi_decode_pallas(
            jnp.asarray(soft), nbits, interpret=True)))


def test_twin_erasure_and_extremes():
    rng = np.random.default_rng(7)
    nbits = 90
    soft_h = _noisy_soft(rng, (2,), nbits)
    hard = np.where(soft_h >= 128, 255, 0).astype(np.int32)
    for soft in (soft_h, np.full_like(soft_h, 127), hard):
        got = _twin(soft, nbits)
        np.testing.assert_array_equal(
            got, np.asarray(j_viterbi.viterbi_decode_scan(jnp.asarray(soft),
                                                          nbits)))
        np.testing.assert_array_equal(
            got, np.asarray(viterbi_pallas.viterbi_decode_pallas(
                jnp.asarray(soft), nbits, interpret=True)))


def test_twin_2d_batch():
    rng = np.random.default_rng(3)
    nbits = 130
    soft = _noisy_soft(rng, (2, 3), nbits)
    got = _twin(soft, nbits)
    assert got.shape == (2, 3, nbits)
    np.testing.assert_array_equal(
        got, np.asarray(j_viterbi.viterbi_decode_scan(jnp.asarray(soft),
                                                      nbits)))


def test_twin_nbits_dynamic():
    rng = np.random.default_rng(11)
    nbits = 300
    soft = _noisy_soft(rng, (5,), nbits)
    nbd = np.array([300, 299, 151, 6, 0], np.int32)
    got = _twin(soft, nbits, nbd)
    np.testing.assert_array_equal(
        got, np.asarray(j_viterbi.viterbi_decode_scan(
            jnp.asarray(soft), nbits, nbits_dynamic=jnp.asarray(nbd))))
    # bits past each frame's own count are unspecified: compare within it
    pallas = np.asarray(viterbi_pallas.viterbi_decode_pallas(
        jnp.asarray(soft), nbits, interpret=True,
        nbits_dynamic=jnp.asarray(nbd)))
    for row, n in enumerate(nbd):
        np.testing.assert_array_equal(got[row, :n], pallas[row, :n])


def test_twin_decisions_match_scan_steps():
    """The twin's decision tensor, step by step, equals the JAX ACS
    step's decisions on the same path metrics."""
    rng = np.random.default_rng(12)
    nbits = 40
    soft = _noisy_soft(rng, (2,), nbits)
    steps = torch.full((2,), nbits + 6, dtype=torch.int32)
    dec = viterbi.acs_plain(torch.from_numpy(soft), steps,
                            torch.ones(2, dtype=torch.int32)).numpy()
    metrics = jnp.asarray(np.where(np.arange(64) == 0, 0, 63)[None]
                          .repeat(2, 0).astype(np.int32))
    for t in range(nbits + 6):
        metrics, d = j_viterbi._acs_step(metrics, jnp.asarray(soft[:, 2 * t]),
                                         jnp.asarray(soft[:, 2 * t + 1]))
        np.testing.assert_array_equal(dec[t], np.asarray(d), err_msg=str(t))


def test_cuda_wrapper_refuses_cpu_tensors():
    before = dict(viterbi_cuda.launches)
    soft = torch.zeros((2, 48), dtype=torch.int32)
    steps = torch.full((2,), 24, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        viterbi_cuda.acs(soft, steps, torch.ones_like(steps))
    with pytest.raises(ValueError, match="CUDA"):
        viterbi_cuda.chainback(torch.zeros((24, 2), dtype=torch.int64), 18)
    assert viterbi_cuda.launches == before


def test_dispatcher_refuses_other_devices():
    with pytest.raises(ValueError, match="no Viterbi"):
        viterbi.viterbi_decode(torch.zeros((1, 48), dtype=torch.int32,
                                           device="meta"), 18)
