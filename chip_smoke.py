#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (fun_ofdm_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printed as it ends; any failure raises and exits nonzero:
  1. the card's name and power limit (nvidia-smi);
  2. building the CUDA Viterbi from csrc/viterbi.cu (nvcc, sm_90a), with
     the compiler's register report;
  3. each kernel against its plain PyTorch version on the card, on the
     same inputs, bit-exact (tolerance 0): the dense capture's shape
     (512 frames x 12,090 bits) and its first 256 and 128 frames (timed
     too), an 18-bit header batch (less than one chainback segment), 37
     frames of mixed lengths up to 513 bits (a batch that is not a
     multiple of the chainback's frame group, a 1-step last segment),
     all-erasure and hard 0/255 inputs, mixed per-frame lengths and
     uniform init; the decisions also against the kernel's own algebra in
     plain form (viterbi.acs_early_plain) and the bits against the
     segmented chainback's (viterbi.chainback_segmented_plain); with both
     times (CUDA events);
  4. the main path at bench_capture's geometry: build_frame_p for 16
     channels, each 32 back-to-back 1500-byte RATE_3_4_QAM16 frames and
     a 2048-sample zero tail (3,678,208 samples), then receive_capture_p
     on the card; asserts 512/512 crc_ok with the seeded payloads, that
     each kernel was launched, and times the receive (host wall clock
     to torch.cuda.synchronize(), mean of 10 calls after 3 warm-ups),
     then a torch.profiler pass over 3 calls (the card's busy share, the
     busiest items, the Viterbi kernels' device time);
  5. the block-overlap kernels (windowed ACS, chainback, splice + merge
     guard) against their plain versions on the card, bit-exact (bits and
     merge flags, tolerance 0): 64 and 4 frames x 12,090 bits of noisy
     soft pairs (16 blocks, warm-up 128), the warm-up-2 guard case, mixed
     per-frame lengths and all-erasure; with both times (CUDA events);
  6. the streaming ReceiverChain on a dense stream at bench.py's
     reference-parity configuration (RATE_3_4_QAM16, 1500 bytes,
     ChainParams(): 1,048,576-sample supersteps, int10 wire): phase 4's
     channel-0 unit tiled 36 times (8,275,968 samples, 1,152 frames) fed
     in 4096-sample float32 pieces; every frame delivered once with its
     payload and start; samples/s after one warm-up pass, and a
     torch.profiler pass over one superstep (the card's busy share);
  7. the chain at the reference cadence (4096-sample supersteps): 64 lone
     frames, each followed by 20,000 zeros; 64/64 delivered through the
     block-overlap kernels; the median wall ms from a frame's last sample
     to its packet;
  8. the chain with all 11 rates (universal decode, 2,097,152-sample
     supersteps, header_slots 384, int10): a mixed stream of 1500-byte
     frames of every rate, ~4 M samples; every frame delivered with its
     rate; samples/s;
  9. a 4-channel chain (int10, 1,048,576-sample supersteps) on ~1 M
     samples per channel; every frame delivered with its channel;
 10. the ACS ablation kernel (every variant of
     fun_ofdm_tpu_torch.tools.viterbi_acs_ab) against its plain version on
     the card, bit-exact (final metrics and decisions, tolerance 0): 32
     frames x 2,048 bits of noisy input, of mixed lengths and inits, and
     of all-erasure input, and the harness's own input (128 x 12,054
     bits); then the harness at its defaults (its main path), printing
     every variant's time;
 11. a CFO-impaired dense stream through ReceiverChain(lts_segments=4,
     cfo_correct=True, int10): 300 distinct 1500-byte RATE_3_4_QAM16
     frames back to back (2,140,096 samples), rotated by 4e-3 and, in a
     second pass, 8e-3 cycles/sample, at 24 dB SNR; every frame delivered
     once with its payload and start, crc_fail 0; samples/s, beside
     phase 6's;
 12. the BER/PER harness (fun_ofdm_tpu_torch.sim.ber) at
     tools/ber_baseline.py's configuration: 11 rates, sync AWGN, 13 SNR
     points x 512 frames of 200 bytes; detect mode for 3 rates at 6
     points x 256 frames; cfo (2e-4, corrected), multipath and
     cfo+multipath at RATE_3_4_QAM16; every PER within
     4 sqrt(2 p (1 - p) / n) + 2 / n of docs/ber_data.json.
Each main-path phase (4, 6-12) sets the kernels' launch counts to 0 just
before it runs and reads them just after. The last two lines are a JSON
object with one entry per kernel (its time, its plain version's, and its
bound: the larger of its bytes over the card's memory rate and its
integer operations over the card's int32 rate) and the JSON result line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

RATE_NAME = "RATE_3_4_QAM16"
LENGTH = 1500
CHANNELS = 16
FRAMES_PER_CHANNEL = 32
TAIL = 2048
SEED = 0
#: where the streaming phases (6-9, 11) and the harnesses (10, 12) run
DEVICE = "cuda"

#: the H100 SXM's published peaks (NVIDIA data sheet; the Hopper
#: architecture white paper gives 64 INT32 lanes per SM, 132 SMs, and the
#: data sheet a 1.98 GHz boost clock): memory bytes/s and int32 ops/s
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
#: integer operations of one ACS trellis step, as few as the recurrence
#: needs: a step has 4 distinct branch metrics, one per code-bit parity
#: pair: their 4 soft sums take 5 ops (s0 + s1, 255 - s1, s0 + (255 - s1),
#: and the other two as 510 minus those), each + 1 and >> 3 (8 ops), and
#: the 4 complements 63 - t (4 ops); then 64 new states of 6 (two adds, two
#: saturations, a compare, a select) and the renormalisation check. The
#: renormalisation itself, which depends on the data, is left out, so the
#: bound stays a lower bound
ACS_OPS_PER_STEP = 5 + 4 * 2 + 4 + 64 * 6 + 1
#: one chainback step: a shift and a mask to read the bit, a store, and
#: the state update's shift, shift and or
CHAINBACK_OPS_PER_STEP = 6


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of fn() over reps launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def register_report(ptxas_log: str) -> dict:
    """{kernel: registers} from nvcc's -Xptxas -v report; a template
    instance is named by its mode, e.g. acs_ablate_kernel<0>."""
    out, name = {}, None
    for ln in ptxas_log.splitlines():
        entry = re.search(r"entry function '(\w+)'", ln)
        if entry:
            m = re.search(r"\d+([a-z][a-z_]*_kernel)(?:ILi(\d+)E)?",
                          entry.group(1))
            name = entry.group(1) if m is None else (
                m.group(1) + (f"<{m.group(2)}>" if m.group(2) else ""))
        regs = re.search(r"Used (\d+) registers", ln)
        if regs and name is not None:
            out[name] = int(regs.group(1))
            name = None
    return out


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """The least time (ms) the card could take for work that must move
    nbytes and do ops integer operations, and which of the two bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def unpack_words(words: torch.Tensor) -> torch.Tensor:
    """(T, B) int64 decision words -> (T, B, 64) uint8 bits."""
    shifts = torch.arange(64, device=words.device)
    return ((words[..., None] >> shifts) & 1).to(torch.uint8)


def noisy_soft(rng, batch: int, nbits: int, noise: int) -> np.ndarray:
    """Soft pairs of random conv-coded bits plus uniform noise, 0..255."""
    from fun_ofdm_tpu_torch.ops import convcode

    bits = torch.from_numpy(rng.integers(0, 2, size=(batch, nbits + 6)))
    coded = convcode.conv_encode(bits).numpy()
    soft = coded * 255 + rng.integers(-noise, noise + 1, coded.shape)
    return np.clip(soft, 0, 255).astype(np.int32)


def kernel_case(name, soft_np, nbits, nbits_dynamic=None, init=1,
                timed=False):
    """Kernel vs plain version on one input; returns its record."""
    from fun_ofdm_tpu_torch.ops import viterbi, viterbi_cuda

    dev = torch.device("cuda")
    soft = torch.from_numpy(soft_np).to(dev)
    bsz = soft.shape[0]
    steps = viterbi.step_counts(nbits, nbits_dynamic, (bsz,), dev)
    init_t = torch.full((bsz,), init, dtype=torch.int32, device=dev)

    words = viterbi_cuda.acs(soft, steps, init_t)
    bits = viterbi_cuda.chainback(words, nbits)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dec_plain = viterbi.acs_plain(soft, steps, init_t)
    torch.cuda.synchronize()
    acs_plain_ms = (time.perf_counter() - t0) * 1e3
    dec_kernel = unpack_words(words)
    acs_err = int((dec_kernel.int() - dec_plain.int()).abs().max())
    # the chainbacks run on the same decisions
    t0 = time.perf_counter()
    bits_plain = viterbi.chainback_plain(dec_kernel, nbits)
    torch.cuda.synchronize()
    cb_plain_ms = (time.perf_counter() - t0) * 1e3
    cb_err = int((bits - bits_plain).abs().max()) if nbits else 0
    # the kernels' own algebra, in plain form: the early-minimum ACS with
    # the deferred renormalisation, and the segmented chainback
    early_err = int((dec_kernel.int()
                     - viterbi.acs_early_plain(soft, steps, init_t).int())
                    .abs().max())
    seg = viterbi_cuda.build().viterbi_chainback_segment()
    seg_err = int((bits - viterbi.chainback_segmented_plain(dec_kernel, nbits,
                                                            seg))
                  .abs().max()) if nbits else 0
    acs_err, cb_err = max(acs_err, early_err), max(cb_err, seg_err)
    rec = {"case": name, "batch": bsz, "nbits": nbits,
           "acs_max_abs_err": acs_err, "chainback_max_abs_err": cb_err,
           "acs_plain_ms": acs_plain_ms, "chainback_plain_ms": cb_plain_ms,
           "chainback_segments": -(-nbits // seg)}
    if timed:
        rec["acs_ms"] = cuda_ms(lambda: viterbi_cuda.acs(soft, steps, init_t),
                                reps=5)
        rec["chainback_ms"] = cuda_ms(
            lambda: viterbi_cuda.chainback(words, nbits), reps=5)
        rec["acs_bound"] = bound(nbytes(soft, steps, init_t, words),
                                 int(steps.sum()) * ACS_OPS_PER_STEP)
        rec["chainback_bound"] = bound(nbytes(words, bits),
                                       bsz * nbits * CHAINBACK_OPS_PER_STEP)
    print("kernel vs plain:", json.dumps(rec), flush=True)
    if acs_err or cb_err:
        raise AssertionError(f"kernel disagrees with its plain version: {rec}")
    return rec


def kernel_phase() -> list:
    from fun_ofdm_tpu_torch.rates import Rate, params_for

    rp = params_for(Rate[RATE_NAME])
    nbits = rp.num_data_bits(LENGTH) - 6        # 12,090 at the slice
    frames = CHANNELS * FRAMES_PER_CHANNEL      # 512
    rng = np.random.default_rng(SEED)
    hard = noisy_soft(rng, 64, 1000, 0)
    capture = noisy_soft(rng, frames, nbits, 100)
    return [
        kernel_case("capture", capture, nbits, timed=True),
        # the dense chain's 256-frame bucket, and 128 frames (the words of
        # 512 frames fill the 50 MB L2; of 128, a quarter of it)
        kernel_case("frames256", capture[:256], nbits, timed=True),
        kernel_case("frames128", capture[:128], nbits, timed=True),
        kernel_case("header", noisy_soft(rng, frames, 18, 100), 18),
        # a batch that is not a multiple of the chainback's frame group,
        # and a last segment of one step
        kernel_case("ragged", noisy_soft(rng, 37, 513, 100), 513,
                    nbits_dynamic=torch.from_numpy(
                        rng.integers(0, 514, size=37))),
        kernel_case("erasure", np.full((64, 2 * (1000 + 6)), 127, np.int32),
                    1000),
        kernel_case("hard", hard, 1000),
        kernel_case("dynamic", noisy_soft(rng, 128, 4000, 100), 4000,
                    nbits_dynamic=torch.from_numpy(
                        rng.integers(0, 4001, size=128))),
        kernel_case("uniform_init", noisy_soft(rng, 64, 2000, 100), 2000,
                    init=0),
    ]


def slice_phase() -> tuple[dict, dict]:
    """bench_capture's geometry through the port on the card."""
    from fun_ofdm_tpu_torch.models import frontend, tx
    from fun_ofdm_tpu_torch.ops import viterbi_cuda
    from fun_ofdm_tpu_torch.rates import Rate, params_for

    dev = torch.device("cuda")
    rate = Rate[RATE_NAME]
    frame_len = params_for(rate).frame_samples(LENGTH)      # 7120
    payloads = np.random.default_rng(SEED).integers(
        0, 256, size=(CHANNELS, LENGTH), dtype=np.uint8)

    def capture_streams():
        frames = tx.build_frame_p(torch.from_numpy(payloads).to(dev), rate)
        return tuple(torch.cat(
            [f[:, None, :].expand(-1, FRAMES_PER_CHANNEL, -1).reshape(
                CHANNELS, -1),
             torch.zeros((CHANNELS, TAIL), dtype=f.dtype, device=dev)], dim=1)
            for f in frames)

    def receive(streams):
        return frontend.receive_capture_p(streams, rate, LENGTH,
                                          FRAMES_PER_CHANNEL)

    viterbi_cuda.reset_launches()
    streams = capture_streams()
    out = receive(streams)
    torch.cuda.synchronize()
    launches = dict(viterbi_cuda.launches)

    n_samples = streams[0].numel()
    expected = CHANNELS * FRAMES_PER_CHANNEL
    crc_ok = out["crc_ok"].cpu().numpy()
    payload = out["payload"].cpu().numpy()
    starts = out["starts"].cpu().numpy()
    if streams[0].shape != (CHANNELS, FRAMES_PER_CHANNEL * frame_len + TAIL):
        raise AssertionError(f"stream shape {tuple(streams[0].shape)}")
    if int(crc_ok.sum()) != expected:
        raise AssertionError(f"decoded {int(crc_ok.sum())}/{expected}")
    if not (out["header_ok"].cpu().numpy().all()
            and (payload == payloads[:, None, :]).all()):
        raise AssertionError("headers or payloads differ from the input")
    if not (starts == frame_len * np.arange(FRAMES_PER_CHANNEL)).all():
        raise AssertionError(f"frame starts {starts}")
    for name in ("viterbi_acs", "viterbi_chainback"):
        if launches[name] == 0:
            raise AssertionError(f"{name} was not launched on the main path")

    tx_ms = cuda_ms(capture_streams, reps=5)
    reps = 10
    for _ in range(3):      # warm the caching allocator and the kernels
        receive(streams)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        receive(streams)
    torch.cuda.synchronize()
    wall_s = (time.perf_counter() - t0) / reps

    def three_calls():
        for _ in range(3):
            receive(streams)
    prof = profile_device(three_calls)
    rec = {"samples": n_samples, "frames": expected,
           "crc_ok": int(crc_ok.sum()), "launches": launches,
           "receive_wall_ms": wall_s * 1e3,
           "receive_samples_per_s": n_samples / wall_s,
           "tx_build_ms": tx_ms,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
           "profile_three_calls": prof}
    print("slice:", json.dumps(rec), flush=True)
    return rec, launches


def kernel_record(kernel: str, replaces: str, cases: list, launches: dict):
    """The result entry of kernel "acs", "chainback", "acs_windowed",
    "splice_guard" or "acs_ablate"; `replaces` is where its TPU
    counterpart starts (for the exact pair, the radix-4 kernel the TPU
    path runs). The first case of `cases` is the timed one. No single
    PyTorch call computes a Viterbi step, so library_ms is null."""
    name = f"viterbi_{kernel}"
    bound_ms, bound_by = cases[0][f"{kernel}_bound"]
    return {"name": name, "route": "cuda",
            "source": "fun_ofdm_tpu_torch/csrc/viterbi.cu",
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max(c[f"{kernel}_max_abs_err"] for c in cases),
            "ms": cases[0][f"{kernel}_ms"],
            "plain_ms": cases[0][f"{kernel}_plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}


def blocked_case(name, soft_np, nbits, n_blocks=16, warmup=128,
                 nbits_dynamic=None, timed=False):
    """The block-overlap kernels vs their plain versions on one input.

    Each kernel's output is held against its plain version on the same
    input: the windowed ACS's decisions, the chainback of those decisions
    (the exact pair's kernel), and the splice + guard on the kernel's
    window bits (bits and merge flags). Frames whose blocked bits differ
    from the exact decode must carry a False flag."""
    from fun_ofdm_tpu_torch.ops import viterbi, viterbi_blocked, viterbi_cuda

    dev = torch.device("cuda")
    soft = torch.from_numpy(soft_np).to(dev)
    frames = soft.shape[0]
    steps = viterbi.step_counts(nbits, nbits_dynamic, (frames,), dev)
    geo = viterbi_blocked.geometry(nbits, n_blocks, warmup)

    def kernels():
        words = viterbi_cuda.acs_windowed(soft, steps, geo.n_blocks, geo.tb,
                                          geo.wf, geo.win)
        win_bits = viterbi_cuda.chainback(words, geo.win)
        return (words, win_bits) + viterbi_cuda.splice_guard(
            win_bits.T, steps, nbits, geo.n_blocks, geo.tb, geo.wf, geo.ov,
            geo.trim)

    words, win_bits, bits, ok = kernels()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dec_plain = viterbi_blocked.acs_windowed_plain(soft, steps, geo)
    torch.cuda.synchronize()
    acs_plain_ms = (time.perf_counter() - t0) * 1e3
    dec_kernel = unpack_words(words)
    acs_err = int((dec_kernel.int() - dec_plain.int()).abs().max())
    del dec_plain
    cb_err = int((win_bits - viterbi.chainback_plain(dec_kernel, geo.win))
                 .abs().max())
    del dec_kernel
    t0 = time.perf_counter()
    bits_plain, ok_plain = viterbi_blocked.splice_guard_plain(win_bits, steps,
                                                              geo)
    torch.cuda.synchronize()
    sg_plain_ms = (time.perf_counter() - t0) * 1e3
    sg_err = max(int((bits - bits_plain).abs().max()),
                 int((ok != ok_plain).sum()))
    exact = viterbi.viterbi_decode(soft, nbits, nbits_dynamic=nbits_dynamic)
    nbd = (torch.full((frames,), nbits) if nbits_dynamic is None
           else torch.as_tensor(nbits_dynamic)).to(dev)
    live = torch.arange(nbits, device=dev)[None, :] < nbd[:, None]
    differs = ((bits != exact) & live).any(-1)
    rec = {"case": name, "frames": frames, "nbits": nbits,
           "n_blocks": geo.n_blocks, "warmup": warmup, "win": geo.win,
           "acs_windowed_max_abs_err": acs_err,
           "chainback_max_abs_err": cb_err,
           "splice_guard_max_abs_err": sg_err,
           "flagged": int((~ok).sum()),
           "differs_from_exact": int(differs.sum()),
           "acs_windowed_plain_ms": acs_plain_ms,
           "splice_guard_plain_ms": sg_plain_ms}
    if timed:
        rec["acs_windowed_ms"] = cuda_ms(
            lambda: viterbi_cuda.acs_windowed(soft, steps, geo.n_blocks,
                                              geo.tb, geo.wf, geo.win),
            reps=5)
        rec["splice_guard_ms"] = cuda_ms(
            lambda: viterbi_cuda.splice_guard(
                win_bits.T, steps, nbits, geo.n_blocks, geo.tb, geo.wf,
                geo.ov, geo.trim), reps=5)
        run = viterbi_blocked.window_steps(steps, geo)  # steps per lane
        rec["acs_windowed_bound"] = bound(
            nbytes(soft, steps, words), int(run.sum()) * ACS_OPS_PER_STEP)
        # the splice copies each bit once, the guard compares each cut's
        # trimmed overlap once
        rec["splice_guard_bound"] = bound(
            nbytes(win_bits, steps, bits, ok.int()),
            frames * (nbits + (geo.n_blocks - 1)
                      * (geo.ov - 2 * geo.trim) * 3))
        rec["blocked_decode_ms"] = cuda_ms(kernels, reps=5)
        rec["exact_decode_ms"] = cuda_ms(
            lambda: viterbi.viterbi_decode(soft, nbits,
                                           nbits_dynamic=nbits_dynamic),
            reps=5)
    print("blocked vs plain:", json.dumps(rec), flush=True)
    if acs_err or cb_err or sg_err:
        raise AssertionError(f"blocked kernels disagree with their plain "
                             f"versions: {rec}")
    if bool((differs & ok).any()):
        raise AssertionError(f"a frame differs from the exact decode with "
                             f"its merge flag set: {rec}")
    return rec


def blocked_phase() -> list:
    from fun_ofdm_tpu_torch.rates import Rate, params_for

    nbits = params_for(Rate[RATE_NAME]).num_data_bits(LENGTH) - 6  # 12,090
    rng = np.random.default_rng(SEED + 5)
    guard = blocked_case("guard_warmup2", noisy_soft(rng, 8, 1200, 127), 1200,
                         n_blocks=8, warmup=2)
    if guard["differs_from_exact"] == 0:
        raise AssertionError("the warm-up-2 case forced no splice failure")
    return [
        blocked_case("bucket64", noisy_soft(rng, 64, nbits, 100), nbits,
                     timed=True),
        blocked_case("bucket4", noisy_soft(rng, 4, nbits, 100), nbits,
                     timed=True),
        guard,
        blocked_case("mixed_lengths", noisy_soft(rng, 64, nbits, 100), nbits,
                     nbits_dynamic=torch.from_numpy(
                         rng.integers(0, nbits + 1, size=64))),
        blocked_case("erasure", np.full((16, 2 * (nbits + 6)), 127, np.int32),
                     nbits),
    ]


def unit_stream(payload: np.ndarray, rate, frames: int, tail: int):
    """(re, im) float32 numpy: `frames` copies of payload's frame (built
    on the card), then `tail` zeros."""
    from fun_ofdm_tpu_torch.models import tx

    fre, fim = tx.build_frame_p(
        torch.from_numpy(payload).to(DEVICE)[None], rate)
    return tuple(np.concatenate([np.tile(f[0].cpu().numpy(), frames),
                                 np.zeros(tail, np.float32)])
                 for f in (fre, fim))


def run_chain(chain, pieces) -> list:
    pkts = []
    for p in pieces:
        pkts += chain.process_samples(p)
    return pkts + chain.flush()


def check_packets(pkts, planted, what: str) -> None:
    """planted: {(channel, start): (payload bytes, rate)}; every planted
    frame must come back exactly once, and nothing else."""
    got = sorted((p.channel, p.start) for p in pkts)
    if got != sorted(planted):
        missing = sorted(set(planted) - set(got))[:5]
        extra = sorted(set(got) - set(planted))[:5]
        raise AssertionError(f"{what}: delivered {len(got)} frames of "
                             f"{len(planted)} planted; missing {missing}, "
                             f"unplanted or repeated {extra or 'none'}")
    for p in pkts:
        payload, rate = planted[(p.channel, p.start)]
        if p.payload != payload or p.rate != rate:
            raise AssertionError(f"{what}: frame at {p.start} on channel "
                                 f"{p.channel} decoded wrong")


def launches_of(fn):
    """Run fn with every kernel's launch count set to 0; return its result
    and the counts just after."""
    from fun_ofdm_tpu_torch.ops import viterbi_cuda

    viterbi_cuda.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(viterbi_cuda.launches)


def profile_device(fn) -> dict:
    """torch.profiler over fn(): host wall ms; device busy ms, the sum of
    the device time of every kernel, copy and memset (they run one at a
    time on the one stream; the operators' rows, which repeat their
    kernels' time, are left out of the sum); the busiest device items and
    the busiest operators (device ms, calls); and the Viterbi kernels'
    device ms and launches by kernel. The profiler's own overhead
    lengthens the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device, ops = [], []
    for e in prof.key_averages():
        if e.self_device_time_total > 0:
            row = (e.key, e.self_device_time_total / 1e3, e.count)
            (ops if e.device_type == DeviceType.CPU else device).append(row)
    busy_ms = sum(r[1] for r in device)
    device.sort(key=lambda r: -r[1])
    ops.sort(key=lambda r: -r[1])
    viterbi = {re.match(r"\(anonymous namespace\)::(\w+)", k).group(1):
               [ms, n] for k, ms, n in device
               if k.startswith("(anonymous namespace)::")}
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "busy_share": busy_ms / wall_ms,
            "top_device": [[k[:60], ms, n] for k, ms, n in device[:12]],
            "top_ops": [[k[:60], ms, n] for k, ms, n in ops[:12]],
            "viterbi_kernels_ms": viterbi}


def profile_feed(chain, pieces) -> dict:
    """profile_device over feeding `pieces` into a chain already in
    steady state."""
    def feed():
        for p in pieces:
            chain.process_samples(p)
    return profile_device(feed)


def dense_stream_phase() -> dict:
    """bench.py's reference-parity streaming configuration."""
    from fun_ofdm_tpu_torch.config import ChainParams
    from fun_ofdm_tpu_torch.rates import Rate, params_for
    from fun_ofdm_tpu_torch.runtime.chain import ReceiverChain, pack10

    rate = Rate[RATE_NAME]
    frame_len = params_for(rate).frame_samples(LENGTH)
    payloads = np.random.default_rng(SEED).integers(
        0, 256, size=(CHANNELS, LENGTH), dtype=np.uint8)
    unit = unit_stream(payloads[0], rate, FRAMES_PER_CHANNEL, TAIL)
    tiles = 36
    s_re, s_im = (np.tile(u, tiles) for u in unit)
    n = s_re.size
    pieces = [(s_re[i:i + 4096], s_im[i:i + 4096]) for i in range(0, n, 4096)]
    planted = {(0, t * unit[0].size + k * frame_len): (payloads[0].tobytes(),
                                                       rate)
               for t in range(tiles) for k in range(FRAMES_PER_CHANNEL)}

    def chain():
        return ReceiverChain(rates=(rate,), max_length=LENGTH,
                             params=ChainParams(), ingest_dtype="int10",
                             device=DEVICE)

    warm = chain()                  # warm-up pass, with the profile
    step_pieces = warm.step // 4096
    for p in pieces[:3 * step_pieces]:
        warm.process_samples(p)
    prof = profile_feed(warm, pieces[3 * step_pieces:4 * step_pieces])
    run_chain(warm, pieces[4 * step_pieces:])
    c = chain()
    t0 = time.perf_counter()
    pkts, launches = launches_of(lambda: run_chain(c, pieces))
    wall_s = time.perf_counter() - t0
    check_packets(pkts, planted, "dense stream")
    # the host's share: int10 packing of one superstep's two components
    t0 = time.perf_counter()
    for x in (s_re, s_im):
        pack10(x[:c.step])
    pack_ms = (time.perf_counter() - t0) * 1e3
    rec = {"samples": n, "frames": len(planted), "delivered": len(pkts),
           "step": c.step, "wall_s": wall_s, "samples_per_s": n / wall_s,
           "wall_ms_per_superstep": wall_s * 1e3 / c.stats.windows,
           "host_pack10_ms_per_superstep": pack_ms,
           "stats": c.stats.as_dict(), "launches": launches,
           "profile_one_superstep": prof}
    print("stream dense:", json.dumps(rec), flush=True)
    return rec


def sparse_stream_phase() -> dict:
    """The reference cadence: 4096-sample supersteps, lone frames."""
    from fun_ofdm_tpu_torch.config import ChainParams
    from fun_ofdm_tpu_torch.models import tx
    from fun_ofdm_tpu_torch.rates import Rate, params_for
    from fun_ofdm_tpu_torch.runtime.chain import ReceiverChain

    rate = Rate[RATE_NAME]
    frame_len = params_for(rate).frame_samples(LENGTH)
    frames, gap = 64, 20000
    payloads = np.random.default_rng(SEED + 7).integers(
        0, 256, size=(frames, LENGTH), dtype=np.uint8)
    fre, fim = (f.cpu().numpy() for f in tx.build_frame_p(
        torch.from_numpy(payloads).to(DEVICE), rate))
    period = frame_len + gap
    s_re = np.zeros(frames * period, np.float32)
    s_im = np.zeros(frames * period, np.float32)
    for k in range(frames):
        s_re[k * period:k * period + frame_len] = fre[k]
        s_im[k * period:k * period + frame_len] = fim[k]
    planted = {(0, k * period): (payloads[k].tobytes(), rate)
               for k in range(frames)}

    def chain():
        return ReceiverChain(rates=(rate,), max_length=LENGTH,
                             params=ChainParams(strides_per_step=1),
                             viterbi_impl="auto", device=DEVICE)

    # warm-up, with a profile of the second frame's period
    warm = chain()
    pieces = [(s_re[i:i + 4096], s_im[i:i + 4096])
              for i in range(0, 2 * period, 4096)]
    half = len(pieces) // 2
    run_chain(warm, pieces[:half])
    prof = profile_feed(warm, pieces[half:])
    warm.flush()
    c = chain()
    # pieces at the radio's 4096-sample cadence (0.8 ms at 5 MS/s); a
    # frame's latency runs from the call that hands over its last sample
    # to the call that returns its packet
    last_piece = {k * period + frame_len - 1: k for k in range(frames)}
    t_last, lat_ms = {}, []

    def feed():
        pkts = []
        for i in range(0, s_re.size, 4096):
            for end, k in last_piece.items():
                if i <= end < i + 4096:
                    t_last[k] = time.perf_counter()
            got = c.process_samples((s_re[i:i + 4096], s_im[i:i + 4096]))
            now = time.perf_counter()
            for p in got:
                lat_ms.append((now - t_last[p.start // period]) * 1e3)
            pkts += got
            time.sleep(0.0008)
        return pkts + c.flush()

    t0 = time.perf_counter()
    pkts, launches = launches_of(feed)
    wall_s = time.perf_counter() - t0
    check_packets(pkts, planted, "sparse stream")
    for name in ("viterbi_acs_windowed", "viterbi_splice_guard"):
        if launches[name] == 0:
            raise AssertionError(f"{name} was not launched on the sparse "
                                 f"stream")
    rec = {"frames": frames, "delivered": len(pkts), "step": c.step,
           "latency_ms_median": float(np.median(lat_ms)),
           "latency_ms_p90": float(np.percentile(lat_ms, 90)),
           "latencies_measured": len(lat_ms),
           "wall_s": wall_s,
           "ms_per_piece_incl_0.8_ms_sleep": wall_s * 1e3 / -(-s_re.size
                                                              // 4096),
           "viterbi_fallbacks": c.stats.viterbi_fallbacks,
           "stats": c.stats.as_dict(), "launches": launches,
           "profile_one_frame_period": prof}
    print("stream sparse:", json.dumps(rec), flush=True)
    return rec


def all_rates_phase() -> dict:
    """The Receiver default: all 11 rates, universal decode."""
    from fun_ofdm_tpu_torch.config import ChainParams
    from fun_ofdm_tpu_torch.models import tx
    from fun_ofdm_tpu_torch.rates import ALL_RATES
    from fun_ofdm_tpu_torch.runtime.chain import ReceiverChain, pack10

    rng = np.random.default_rng(2)
    pieces_re, pieces_im, unit_frames, pos = [], [], [], 0
    for r in ALL_RATES:       # bench.py's build_mixed_rate_stream
        payload = rng.integers(0, 256, size=(1, LENGTH), dtype=np.uint8)
        fre, fim = (f[0].cpu().numpy() for f in tx.build_frame_p(
            torch.from_numpy(payload).to(DEVICE), r))
        unit_frames.append((pos, fre.size, payload[0].tobytes(), r))
        pieces_re += [fre, np.zeros(64, np.float32)]
        pieces_im += [fim, np.zeros(64, np.float32)]
        pos += fre.size + 64
    unit = pos
    tiles = -(-(4 << 20) // unit)
    s_re = np.tile(np.concatenate(pieces_re), tiles)
    s_im = np.tile(np.concatenate(pieces_im), tiles)
    params = ChainParams(strides_per_step=512, min_frame_samples=4000,
                         header_slots=384)

    def chain():
        return ReceiverChain(rates=ALL_RATES, max_length=LENGTH,
                             params=params, ingest_dtype="int10",
                             device=DEVICE)

    step = chain().step
    n_whole = s_re.size // step * step
    pb = step * 5 // 4
    p_re, p_im = pack10(s_re[:n_whole]), pack10(s_im[:n_whole])
    pieces = [(p_re[i:i + pb], p_im[i:i + pb]) for i in range(0, p_re.size, pb)]
    planted = {(0, t * unit + p): (pl, r) for t in range(tiles)
               for p, size, pl, r in unit_frames
               if t * unit + p + size <= n_whole}
    warm = chain()              # warm-up, with a profile of one superstep
    warm.process_samples(pieces[0])
    prof = profile_feed(warm, pieces[1:2])
    warm.flush()
    c = chain()
    t0 = time.perf_counter()
    pkts, launches = launches_of(lambda: run_chain(c, pieces))
    wall_s = time.perf_counter() - t0
    check_packets(pkts, planted, "all-rates stream")
    rec = {"samples": n_whole, "frames": len(planted),
           "delivered": len(pkts), "step": step, "wall_s": wall_s,
           "samples_per_s": n_whole / wall_s, "classes": [
               [r.name for r in cls] for cls in c._classes],
           "stats": c.stats.as_dict(), "launches": launches,
           "profile_one_superstep": prof}
    print("stream all rates:", json.dumps(rec), flush=True)
    return rec


def multichannel_phase() -> dict:
    """bench.py's bench_multichannel at C=4, ~1 M samples per channel."""
    from fun_ofdm_tpu_torch.config import ChainParams
    from fun_ofdm_tpu_torch.rates import Rate, params_for
    from fun_ofdm_tpu_torch.runtime.chain import ReceiverChain, pack10

    rate, channels, per_unit = Rate[RATE_NAME], 4, 8
    frame_len = params_for(rate).frame_samples(LENGTH)
    payloads = np.random.default_rng(7).integers(
        0, 256, size=(channels, LENGTH), dtype=np.uint8)
    units = [unit_stream(payloads[c], rate, per_unit, 2048)
             for c in range(channels)]
    unit = units[0][0].size
    tiles = -(-(1 << 20) // unit)
    s_re = np.stack([np.tile(u[0], tiles) for u in units])
    s_im = np.stack([np.tile(u[1], tiles) for u in units])
    c = ReceiverChain(rates=(rate,), max_length=LENGTH,
                      params=ChainParams(strides_per_step=256,
                                         min_frame_samples=4000),
                      channels=channels, ingest_dtype="int10", device=DEVICE)
    n_whole = s_re.shape[-1] // c.step * c.step
    # whole supersteps as packed wire words, the rest as float32
    pieces = [(pack10(s_re[:, :n_whole]), pack10(s_im[:, :n_whole])),
              (s_re[:, n_whole:], s_im[:, n_whole:])]
    planted = {(ch, t * unit + k * frame_len): (payloads[ch].tobytes(), rate)
               for ch in range(channels) for t in range(tiles)
               for k in range(per_unit)}
    t0 = time.perf_counter()
    pkts, launches = launches_of(lambda: run_chain(c, pieces))
    wall_s = time.perf_counter() - t0
    check_packets(pkts, planted, "4-channel stream")
    rec = {"channels": channels, "samples_per_channel": s_re.shape[-1],
           "frames": len(planted), "delivered": len(pkts),
           "wall_s_first_pass": wall_s, "stats": c.stats.as_dict(),
           "launches": launches}
    print("stream 4 channels:", json.dumps(rec), flush=True)
    return rec


def ablate_case(name, soft_np, steps_np, init_np, timed=False):
    """Every ACS ablation variant's kernel vs its plain version on the
    card, on one input: final metrics and decision words, tolerance 0."""
    from fun_ofdm_tpu_torch.ops import viterbi_ab, viterbi_cuda

    dev = torch.device("cuda")
    soft = torch.from_numpy(soft_np).to(dev)
    steps = torch.from_numpy(steps_np.astype(np.int32)).to(dev)
    init = torch.from_numpy(init_np.astype(np.int32)).to(dev)
    rec = {"case": name, "batch": soft.shape[0],
           "steps": soft.shape[1] // 2, "modes": {}}
    err = 0
    for mode in viterbi_ab.MODES:
        final, dec = viterbi_cuda.acs_ablate(soft, steps, init, mode)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p_final, p_dec = viterbi_ab.acs_ablate_plain(soft, steps, init, mode)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        e = int((final - p_final).abs().max()) if final.numel() else 0
        if (dec is None) != (p_dec is None):
            raise AssertionError(f"{mode}: decisions stored by one side only")
        if dec is not None and dec.numel():
            e = max(e, int((unpack_words(dec).int()
                            - unpack_words(p_dec).int()).abs().max()))
        rec["modes"][mode] = {"max_abs_err": e, "plain_ms": plain_ms}
        err = max(err, e)
        if mode == "full":
            rec["acs_ablate_plain_ms"] = plain_ms
            if timed:
                rec["acs_ablate_ms"] = cuda_ms(
                    lambda: viterbi_cuda.acs_ablate(soft, steps, init,
                                                    "full"), reps=5)
                rec["acs_ablate_bound"] = bound(
                    nbytes(soft, steps, init, dec, final),
                    int(steps.sum()) * ACS_OPS_PER_STEP)
    rec["acs_ablate_max_abs_err"] = err
    print("ablate vs plain:", json.dumps(rec), flush=True)
    if err:
        raise AssertionError(f"an ablation kernel disagrees with its plain "
                             f"version: {rec}")
    return rec


def ablation_phase() -> tuple[list, dict]:
    """Phase 10: the ablation kernel against its plain version, then the
    A/B harness at its defaults as the main path."""
    from fun_ofdm_tpu_torch.ops import viterbi
    from fun_ofdm_tpu_torch.tools import viterbi_acs_ab

    rng = np.random.default_rng(SEED + 10)
    batch, nbits = 128, 12054
    main_soft = viterbi_acs_ab.make_soft(batch, nbits)
    main_steps = viterbi.step_counts(nbits, None, (batch,), "cpu").numpy()
    cases = [
        ablate_case("harness_input", main_soft, main_steps,
                    np.ones(batch), timed=True),
        ablate_case("noisy", noisy_soft(rng, 32, 2048, 100),
                    np.full(32, 2054), np.ones(32)),
        ablate_case("mixed_lengths", noisy_soft(rng, 32, 2048, 100),
                    rng.integers(0, 2055, 32) // 2 * 2,
                    rng.integers(0, 2, 32)),
        ablate_case("erasure", np.full((32, 2 * 2054), 127, np.int32),
                    np.full(32, 2054), np.ones(32)),
    ]
    out, launches = launches_of(lambda: viterbi_acs_ab.run(
        batch, nbits, reps=10, blocked=16, device=DEVICE, verbose=False))
    rec = {"harness_ms": out["ms"], "vs_full": out["vs_full"],
           "bit_exact": out["bit_exact"],
           "blocked_bit_exact": out["blocked_bit_exact"],
           "merge_ok": out["merge_ok"], "launches": launches}
    print("acs ablation harness:", json.dumps(rec), flush=True)
    if not (out["bit_exact"] and out["blocked_bit_exact"]) \
            or launches["viterbi_acs_ablate"] == 0:
        raise AssertionError(f"the harness failed: {rec}")
    return cases, launches


def cfo_stream_phase(dense_samples_per_s: float, frames: int = 300) -> dict:
    """Phase 11: a CFO-impaired dense stream through the CFO chain;
    dense_samples_per_s is phase 6's rate, printed beside this one's."""
    from fun_ofdm_tpu_torch.config import ChainParams
    from fun_ofdm_tpu_torch.models import tx
    from fun_ofdm_tpu_torch.rates import Rate
    from fun_ofdm_tpu_torch.runtime.chain import ReceiverChain

    rate, tail = Rate[RATE_NAME], 4096
    rng = np.random.default_rng(SEED + 11)
    payloads = rng.integers(0, 256, size=(frames, LENGTH), dtype=np.uint8)
    fre, fim = (f.cpu().numpy() for f in tx.build_frame_p(
        torch.from_numpy(payloads).to(DEVICE), rate))
    frame_len = fre.shape[1]
    base = np.concatenate([(fre + 1j * fim).reshape(-1),
                           np.zeros(tail, np.complex64)])
    n = base.size
    prms = np.sqrt(np.mean(np.abs(fre + 1j * fim) ** 2))
    sigma = prms / np.sqrt(2 * 10 ** (24 / 10))            # 24 dB SNR
    planted = {(0, k * frame_len): (payloads[k].tobytes(), rate)
               for k in range(frames)}

    def chain():
        return ReceiverChain(rates=(rate,), max_length=LENGTH,
                             params=ChainParams(lts_segments=4),
                             cfo_correct=True, ingest_dtype="int10",
                             device=DEVICE)

    rec = {"samples": n, "frames": frames, "snr_db": 24, "passes": [],
           "phase6_dense_samples_per_s": dense_samples_per_s}
    launches_all = None
    for cfo in (4e-3, 8e-3):
        # the rotation's angle in float64 on the host, as the JAX test
        rot = base * np.exp(2j * np.pi * cfo * np.arange(n))
        rot = rot + sigma * (rng.normal(size=n) + 1j * rng.normal(size=n))
        s_re = rot.real.astype(np.float32)
        s_im = rot.imag.astype(np.float32)
        pieces = [(s_re[i:i + 4096], s_im[i:i + 4096])
                  for i in range(0, n, 4096)]
        if launches_all is None:
            # warm-up on the first superstep, a profile of the second
            warm = chain()
            k = warm.step // 4096
            for p in pieces[:k]:
                warm.process_samples(p)
            rec["profile_one_superstep"] = profile_feed(warm,
                                                        pieces[k:2 * k])
            warm.flush()
        c = chain()
        t0 = time.perf_counter()
        pkts, launches = launches_of(lambda: run_chain(c, pieces))
        wall_s = time.perf_counter() - t0
        check_packets(pkts, planted, f"CFO {cfo} stream")
        if c.stats.crc_fail:
            raise AssertionError(f"CFO {cfo}: crc_fail {c.stats.crc_fail}")
        rec["passes"].append({
            "cfo_cycles_per_sample": cfo, "delivered": len(pkts),
            "wall_s": wall_s, "samples_per_s": n / wall_s,
            "stats": c.stats.as_dict(), "launches": launches})
        launches_all = launches if launches_all is None else {
            k: launches_all[k] + v for k, v in launches.items()}
    rec["launches"] = launches_all
    print("stream cfo:", json.dumps(rec), flush=True)
    return rec


def ber_phase(root) -> dict:
    """Phase 12: tools/ber_baseline.py's configuration through the port's
    harness, held to the JAX harness's artifact (docs/ber_data.json)."""
    from fun_ofdm_tpu_torch.rates import ALL_RATES, Rate
    from fun_ofdm_tpu_torch.sim import ber

    data = json.loads((root / "docs" / "ber_data.json").read_text())
    length, frames = data["length"], data["frames_per_point"]
    snr_all = data["snr_db"]
    ref = {(c["mode"], c["channel"], c["rate"]): c for c in data["curves"]}
    det_rates = (Rate.RATE_1_2_BPSK, Rate.RATE_3_4_QAM16,
                 Rate.RATE_3_4_QAM64)
    imp = Rate.RATE_3_4_QAM16
    taps = (1.0, 0.25 + 0.15j)
    runs = [("sync", "awgn", r, {}) for r in ALL_RATES]
    runs += [("detect", "awgn", r, {"detect": True}) for r in det_rates]
    runs += [("sync", "cfo", imp, {"cfo_norm": 2e-4, "cfo_correct": True}),
             ("sync", "multipath", imp, {"taps": taps}),
             ("sync", "cfo+multipath", imp,
              {"cfo_norm": 2e-4, "cfo_correct": True, "taps": taps})]

    def all_curves():
        out = []
        for mode, chan, rate, kw in runs:
            c = ref[(mode, chan, rate.name)]
            snrs, n = c.get("snr_db", snr_all), c["n_frames"]
            t0 = time.perf_counter()
            r = ber.error_rates(rate, length, snrs, n_frames=n, batch=n,
                                seed=SEED, device=DEVICE, **kw)
            torch.cuda.synchronize()
            lim = ber.binomial_bound(r.per, c["per"], n)
            diff = np.abs(r.per - np.asarray(c["per"]))
            out.append({"mode": mode, "channel": chan, "rate": rate.name,
                        "frames": n, "points": len(snrs),
                        "wall_s": time.perf_counter() - t0,
                        "per": r.per.tolist(),
                        "max_per_diff": float(diff.max()),
                        "worst_diff_over_bound": float((diff / lim).max()),
                        "within": bool((diff <= lim).all())})
            if mode == "sync":
                out[-1]["max_ber_diff"] = float(
                    np.abs(r.ber - np.asarray(c["ber"])).max())
        return out

    t0 = time.perf_counter()
    curves, launches = launches_of(all_curves)
    wall_s = time.perf_counter() - t0
    rec = {"wall_s": wall_s, "curves": curves, "launches": launches,
           "frames_decoded": sum(c["frames"] * c["points"] for c in curves)}
    print("ber harness:", json.dumps(rec), flush=True)
    bad = [c for c in curves if not c["within"]]
    if bad:
        raise AssertionError(f"PER outside the binomial bound of "
                             f"docs/ber_data.json: {bad}")
    return rec


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # full float32 in every matmul and convolution
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from fun_ofdm_tpu_torch.ops import viterbi_cuda

    print(card_line(), flush=True)
    t0 = time.perf_counter()
    viterbi_cuda.build()
    build_s = time.perf_counter() - t0
    log = viterbi_cuda.library_path().with_suffix(".log")
    report = register_report(log.read_text()) if log.exists() else {}
    print(f"build: {build_s:.2f} s; registers: {json.dumps(report)}",
          flush=True)

    cases = kernel_phase()
    _, launches = slice_phase()
    blocked = blocked_phase()
    dense = dense_stream_phase()
    for rec in (dense, sparse_stream_phase(), all_rates_phase(),
                multichannel_phase()):
        for name, count in rec["launches"].items():
            launches[name] += count
    ablate, ab_launches = ablation_phase()
    for rec in ({"launches": ab_launches},
                cfo_stream_phase(dense["samples_per_s"]),
                ber_phase(Path(__file__).resolve().parent)):
        for name, count in rec["launches"].items():
            launches[name] += count
    vp = "fun_ofdm_tpu/ops/viterbi_pallas.py"
    print(json.dumps({"kernels": [
        kernel_record("acs", f"{vp}:261", cases, launches),
        kernel_record("chainback", f"{vp}:394", cases + blocked, launches),
        kernel_record("acs_windowed", f"{vp}:571", blocked, launches),
        kernel_record("splice_guard", f"{vp}:644", blocked, launches),
        kernel_record("acs_ablate", "tools/viterbi_acs_ab.py:148", ablate,
                      launches),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
