"""A/B harness for the CUDA Viterbi: where does the decode's time go?

    python -m fun_ofdm_tpu_torch.tools.viterbi_acs_ab [--batch 128]
        [--nbits 12054] [--reps 10] [--blocked 16] [--device cuda]

Counterpart of tools/viterbi_acs_ab.py. On seeded noisy soft pairs (the
same recipe: np.random.default_rng(0), conv-coded random bits plus
uniform noise in [-100, 100], clipped to 0..255; default 128 frames of
12,054 bits, the capture's Viterbi workload) it checks the exact decode
against the plain twin on the first 8 frames, then times:

  * the exact decode (ACS + chainback kernels);
  * the ACS alone (viterbi_cuda.acs, forced by a strided sum of its
    decision words, as the JAX tool forces its pallas_call) and the
    chainback alone;
  * the block-overlap decode with --blocked blocks (0 skips it), whose
    bits on the checked frames that its merge guard passes must equal
    the exact decode's;
  * every ACS ablation variant (viterbi_cuda.acs_ablate: full, norenorm,
    noshuffle, nostore, minimal, unrolled), each forced the same way;

and prints each time and its ratio to the "full" variant. On a GPU the
times are CUDA-event times; --device cpu runs the plain versions with
host timing (a check of the harness, not a measurement).

Not ported: the JAX tool's TPU layout knobs (--radixes, --dtypes,
--batch-tile, --time-chunk). Radix, metric carrier dtype, batch tile and
time chunk are choices of the Pallas kernel's (8, 128) tiling; the CUDA
kernel has one warp per trellis and int32 metrics, and has none of them.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..ops import convcode, viterbi, viterbi_ab, viterbi_blocked, viterbi_cuda

#: frames checked against the plain twin (the plain decode is slow)
N_CHECK = 8
#: the stride of the decision rows summed to force the ACS, as the JAX tool
FORCE_STRIDE = 97


def make_soft(batch: int, nbits: int, seed: int = 0) -> np.ndarray:
    """(batch, 2 * (nbits + 6)) int32 soft pairs, the JAX tool's recipe."""
    rng = np.random.default_rng(seed)
    bits = torch.from_numpy(rng.integers(0, 2, size=(batch, nbits + 6)))
    coded = convcode.conv_encode(bits).numpy()
    return np.clip(coded * 255 + rng.integers(-100, 101, coded.shape),
                   0, 255).astype(np.int32)


def _timer(device: torch.device):
    """ms per call of fn, mean over reps after one warm-up: CUDA events on
    a GPU, the host clock on the CPU."""
    def timed(fn, reps: int) -> float:
        fn()
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(device)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / reps
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    return timed


def run(batch: int = 128, nbits: int = 12054, reps: int = 10,
        blocked: int = 16, device: str = "cuda", verbose: bool = True
        ) -> dict:
    """Check and time everything; returns {"device", "bit_exact",
    "blocked_bit_exact", "merge_ok", "ms": {name: ms},
    "vs_full": {name: full_ms / ms}}. blocked_bit_exact is None when
    blocked is 0."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA device")
    on_gpu = dev.type == "cuda"
    soft = torch.from_numpy(make_soft(batch, nbits)).to(dev)
    steps = viterbi.step_counts(nbits, None, (batch,), dev)
    init = torch.ones_like(steps)
    timed = _timer(dev)
    say = print if verbose else (lambda *a, **k: None)

    ref = viterbi.viterbi_decode_scan(soft[:N_CHECK].cpu(), nbits)
    got = viterbi.viterbi_decode(soft, nbits)[:N_CHECK].cpu()
    exact = bool(torch.equal(got, ref))
    ms = {"exact": timed(lambda: viterbi.viterbi_decode(soft, nbits), reps)}
    say(f"exact: {ms['exact']:8.3f} ms  bit-exact={exact}", flush=True)

    if on_gpu:
        def acs():
            return viterbi_cuda.acs(soft, steps, init)

        def chainback(words):
            return viterbi_cuda.chainback(words, nbits)

        def ablate(mode):
            return viterbi_cuda.acs_ablate(soft, steps, init, mode)
    else:
        def acs():
            return viterbi.acs_plain(soft, steps, init)

        def chainback(words):
            return viterbi.chainback_plain(words, nbits)

        def ablate(mode):
            return viterbi_ab.acs_ablate_plain(soft, steps, init, mode)

    ms["acs"] = timed(lambda: acs()[::FORCE_STRIDE].sum(), reps)
    words = acs()
    ms["chainback"] = timed(lambda: chainback(words), reps)
    say(f"acs-only: {ms['acs']:8.3f} ms", flush=True)
    say(f"chainback-only: {ms['chainback']:8.3f} ms", flush=True)

    merge_ok = b_exact = None
    if blocked:
        def blocked_decode():
            return viterbi_blocked.viterbi_decode_blocked(
                soft, nbits, n_blocks=blocked, warmup=128,
                return_merge_ok=True)

        name = f"blocked-{blocked}"
        ms[name] = timed(blocked_decode, reps)
        bits, ok = blocked_decode()
        merge_ok = int(ok.sum())
        # a frame the guard flags is re-decoded exactly by its callers
        passed = ok[:N_CHECK].cpu()
        b_exact = bool(torch.equal(bits[:N_CHECK].cpu()[passed], ref[passed]))
        say(f"{name}: {ms[name]:8.3f} ms  bit-exact={b_exact}  "
            f"merge_ok={merge_ok}/{batch}", flush=True)

    def forced(mode):
        final, dec = ablate(mode)
        s = final.sum()
        return s if dec is None else s + dec[::FORCE_STRIDE].sum()

    for mode in viterbi_ab.MODES:
        key = f"ablate[{mode}]"
        ms[key] = timed(lambda: forced(mode), reps)
        say(f"{key}: {ms[key]:8.3f} ms", flush=True)

    base = ms["ablate[full]"]
    vs_full = {k: base / v for k, v in ms.items()}
    for k, r in vs_full.items():
        say(f"{k}: {r:5.2f}x vs ablate[full]")
    name = torch.cuda.get_device_name(dev) if on_gpu else "cpu"
    return {"device": name, "batch": batch, "nbits": nbits,
            "bit_exact": exact, "blocked_bit_exact": b_exact,
            "merge_ok": merge_ok, "ms": ms,
            "vs_full": vs_full}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m fun_ofdm_tpu_torch.tools.viterbi_acs_ab",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--nbits", type=int, default=12054)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--blocked", type=int, default=16,
                    help="also time the block-overlap decode with this "
                         "many blocks (0: skip)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (CUDA events) or cpu (plain versions, host "
                         "clock)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    out = run(args.batch, args.nbits, args.reps, args.blocked, args.device)
    exact = out["bit_exact"] and out["blocked_bit_exact"] is not False
    return 0 if exact else 1


if __name__ == "__main__":
    raise SystemExit(main())
