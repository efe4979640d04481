"""The ACS ablation variants' plain version and the A/B harness, on the CPU.

`acs_ablate_plain` (ops/viterbi_ab.py) is what the CUDA ablation kernel
is held to on the card. Here its "full" variant's decisions must equal
those of fun_ofdm_tpu's `_acs_kernel`, run through `pl.pallas_call` in
interpret mode with tools/viterbi_acs_ab.py's own specs (its `acs_only`,
:148-170) at 128 frames x 256 steps; its "norenorm" and "minimal"
variants must equal, final metrics and decisions, a transcription of the
tool's step bodies (:190-226) driven by lax.scan. All integer, all exact.
The harness (fun_ofdm_tpu_torch/tools/viterbi_acs_ab.py) is run at a tiny
size with its plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from fun_ofdm_tpu.ops import convcode as j_convcode
from fun_ofdm_tpu.ops import viterbi_pallas as vp
from fun_ofdm_tpu_torch.ops import viterbi, viterbi_ab, viterbi_cuda
from fun_ofdm_tpu_torch.tools import viterbi_acs_ab

torch.set_num_threads(1)


def _soft(rng, batch, steps, noise=100):
    bits = rng.integers(0, 2, size=(batch, steps))
    coded = np.asarray(j_convcode.conv_encode(jnp.asarray(bits)))
    return np.clip(coded * 255 + rng.integers(-noise, noise + 1, coded.shape),
                   0, 255).astype(np.int32)


def _unpack(words: torch.Tensor) -> np.ndarray:
    """(T, B) int64 words -> (T, B, 64) bits."""
    return ((words[..., None] >> torch.arange(64)) & 1).numpy()


def _acs_only_interpret(soft: np.ndarray, steps: int) -> np.ndarray:
    """tools/viterbi_acs_ab.py's acs_only pallas_call of vp._acs_kernel,
    in interpret mode: (bsz, 2 * t_pad) soft -> (t_pad, 64, bsz) int8
    decisions in the kernel's butterfly row order."""
    bsz, t_pad = soft.shape[0], soft.shape[1] // 2
    pairs = jnp.asarray(soft, jnp.int32)
    s0, s1 = pairs[:, 0::2].T, pairs[:, 1::2].T
    sv = jnp.full((1, bsz), steps, jnp.int32)
    iv = jnp.ones((1, bsz), jnp.int32)
    dec = pl.pallas_call(
        vp._acs_kernel,
        grid=(bsz // vp.BATCH_TILE, t_pad // vp.TIME_CHUNK),
        in_specs=[
            pl.BlockSpec((1, vp.BATCH_TILE), lambda b, t: (0, b),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((1, vp.BATCH_TILE), lambda b, t: (0, b),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((64, 1), lambda b, t: (0, 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((vp.TIME_CHUNK, vp.BATCH_TILE), lambda b, t: (t, b),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((vp.TIME_CHUNK, vp.BATCH_TILE), lambda b, t: (t, b),
                         memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((vp.TIME_CHUNK, 64, vp.BATCH_TILE),
                               lambda b, t: (t, 0, b),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((t_pad, 64, bsz), jnp.int8),
        scratch_shapes=[pltpu.VMEM((64, vp.BATCH_TILE), jnp.int32)],
        interpret=True,
    )(sv, iv, jnp.asarray(vp._branch_cols("int32")), s0, s1)
    return np.asarray(dec)


def test_full_decisions_equal_jax_acs_kernel():
    bsz, t_pad = 128, 256
    soft = _soft(np.random.default_rng(0), bsz, t_pad)
    dec = _acs_only_interpret(soft, t_pad)
    # butterfly row order: natural state s lives at row (s>>1)|((s&1)<<5)
    s = np.arange(64)
    natural = dec[:, (s >> 1) | ((s & 1) << 5), :].transpose(0, 2, 1)
    steps = torch.full((bsz,), t_pad, dtype=torch.int32)
    _, words = viterbi_ab.acs_ablate_plain(torch.from_numpy(soft), steps,
                                           torch.ones_like(steps), "full")
    np.testing.assert_array_equal(_unpack(words), natural)


def _tool_step(mode, e0, e1):
    """tools/viterbi_acs_ab.py's make_kernel step (:190-226) for "full",
    "norenorm" and "minimal": (m (64, B), s0, s1 (1, B)) -> (new m,
    (64, B) decisions, states in natural order)."""
    def step(m, s):
        s0, s1 = s[0][None, :], s[1][None, :]
        if mode == "minimal":
            m = jnp.minimum(m + s0, 255)
            return m, (m <= 128).astype(jnp.int8)
        a = jnp.where(e0 == 1, 255 - s0, s0)
        b = jnp.where(e1 == 1, 255 - s1, s1)
        t = (a + b + 1) >> 3
        tc = 63 - t
        lo, hi = m[:32, :], m[32:, :]
        mel = jnp.minimum(lo + t, 255)
        meh = jnp.minimum(hi + tc, 255)
        mol = jnp.minimum(lo + tc, 255)
        moh = jnp.minimum(hi + t, 255)
        ne = jnp.minimum(mel, meh)
        de = (meh <= mel).astype(jnp.int8)
        no = jnp.minimum(mol, moh)
        do = (moh <= mol).astype(jnp.int8)
        new = jnp.stack([ne, no], axis=1).reshape(64, m.shape[1])
        dec = jnp.stack([de, do], axis=1).reshape(64, m.shape[1])
        if mode != "norenorm":
            minv = new
            while minv.shape[0] > 1:
                h = minv.shape[0] // 2
                minv = jnp.minimum(minv[:h], minv[h:])
            need = new[0:1, :] > 210
            new = jnp.where(need, new - minv, new)
        return new, dec
    return step


@pytest.mark.parametrize("mode", ["full", "norenorm", "minimal"])
def test_plain_modes_equal_tool_step_bodies(mode):
    bsz, steps = 16, 300
    rng = np.random.default_rng(1)
    soft = _soft(rng, bsz, steps)
    init = np.array([1, 0] * (bsz // 2), np.int32)
    cols = vp._branch_cols("int32").astype(np.int32)
    e0, e1 = jnp.asarray(cols[:32]), jnp.asarray(cols[32:])
    m0 = np.full((64, bsz), 63, np.int32)
    m0[0] = np.where(init == 1, 0, 63)
    pairs = jnp.asarray(soft.reshape(bsz, steps, 2).transpose(1, 2, 0),
                        jnp.int32)                       # (T, 2, B)
    m_end, dec = jax.lax.scan(_tool_step(mode, e0, e1),
                              jnp.asarray(m0), pairs)
    t_steps = torch.full((bsz,), steps, dtype=torch.int32)
    final, words = viterbi_ab.acs_ablate_plain(
        torch.from_numpy(soft), t_steps, torch.from_numpy(init), mode)
    np.testing.assert_array_equal(final.numpy(), np.asarray(m_end).T)
    np.testing.assert_array_equal(_unpack(words),
                                  np.asarray(dec).transpose(0, 2, 1))


def test_plain_variants_agree_with_exact_acs():
    """Mixed lengths and both inits: full and unrolled give acs_plain's
    decisions, nostore full's metrics and no decisions; noshuffle and
    minimal stay in u8 range; unknown modes raise."""
    bsz, nbits = 12, 200
    rng = np.random.default_rng(2)
    soft = torch.from_numpy(_soft(rng, bsz, nbits + 6))
    steps = viterbi.step_counts(nbits, torch.from_numpy(
        rng.integers(0, nbits + 1, bsz)), (bsz,), "cpu")
    init = torch.from_numpy(np.array([1, 0] * (bsz // 2), np.int32))
    want = viterbi.acs_plain(soft, steps, init).numpy()
    out = {m: viterbi_ab.acs_ablate_plain(soft, steps, init, m)
           for m in viterbi_ab.MODES}
    for m in ("full", "unrolled"):
        np.testing.assert_array_equal(_unpack(out[m][1]), want)
    assert out["nostore"][1] is None
    assert torch.equal(out["nostore"][0], out["full"][0])
    assert torch.equal(out["unrolled"][0], out["full"][0])
    for m in ("noshuffle", "minimal", "norenorm"):
        assert 0 <= int(out[m][0].min()) and int(out[m][0].max()) <= 255
    # past a frame's count the decisions are zero
    w = out["noshuffle"][1]
    assert all(int(w[int(s):, b].abs().sum()) == 0
               for b, s in enumerate(steps))
    assert viterbi_ab.MODES == viterbi_cuda.ABLATE_MODES
    with pytest.raises(ValueError, match="mode"):
        viterbi_ab.acs_ablate_plain(soft, steps, init, "fast")


def test_cuda_wrapper_refuses_cpu_tensors():
    soft = torch.zeros((2, 20), dtype=torch.int32)
    steps = torch.full((2,), 10, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        viterbi_cuda.acs_ablate(soft, steps, steps, "full")
    with pytest.raises(ValueError, match="mode"):
        viterbi_cuda.acs_ablate(soft, steps, steps, "static")


def test_harness_parses_and_runs_on_cpu(capsys):
    args = viterbi_acs_ab.parse_args([])
    assert (args.batch, args.nbits, args.reps, args.blocked,
            args.device) == (128, 12054, 10, 16, "cuda")
    args = viterbi_acs_ab.parse_args(["--batch", "4", "--nbits", "120",
                                      "--reps", "1", "--blocked", "4",
                                      "--device", "cpu"])
    out = viterbi_acs_ab.run(args.batch, args.nbits, args.reps, args.blocked,
                             args.device)
    assert out["bit_exact"] and out["merge_ok"] == 4
    assert out["blocked_bit_exact"] is True
    assert out["device"] == "cpu"
    names = {"exact", "acs", "chainback", "blocked-4"} | {
        f"ablate[{m}]" for m in viterbi_ab.MODES}
    assert set(out["ms"]) == names and out["vs_full"]["ablate[full]"] == 1.0
    printed = capsys.readouterr().out
    assert "ablate[minimal]" in printed and "bit-exact=True" in printed
    soft = viterbi_acs_ab.make_soft(4, 120)
    assert soft.shape == (4, 252) and soft.dtype == np.int32
    assert viterbi_acs_ab.main(["--batch", "2", "--nbits", "40", "--reps",
                                "1", "--blocked", "0", "--device",
                                "cpu"]) == 0


def test_chip_smoke_names_kernel_registers():
    import chip_smoke

    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN43_GLOBAL__N__67ed98ef"
        "_10_viterbi_cu_92e8e68e17acs_ablate_kernelILi5EEEvPKiS2_S2_PyPiiii'"
        " for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 68 registers, used 0 barriers",
        "ptxas info    : Compiling entry function '_ZN43_GLOBAL__N__67ed98ef"
        "_10_viterbi_cu_92e8e68e10acs_kernelEPKiS1_S1_Pyiii' for 'sm_90a'",
        "ptxas info    : Used 42 registers, used 0 barriers",
    ])
    assert chip_smoke.register_report(log) == {
        "acs_ablate_kernel<5>": 68, "acs_kernel": 42}
