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
     uniform init, and phase 13's shapes (256 frames of every length up
     to 16,194 and 16,074 bits, the any-rate trellises of the two length
     classes of an all-rates Receiver at max_length 2000, 64 and 63
     chainback segments); the decisions also against the kernel's own algebra in
     plain form (viterbi.acs_early_plain) and the bits against the
     segmented chainback's (viterbi.chainback_segmented_plain); with both
     times (CUDA events);
  4. the main path at bench_capture's geometry: build_frame_p for 16
     channels, each 32 back-to-back 1500-byte RATE_3_4_QAM16 frames and
     a 2048-sample zero tail (3,678,208 samples), then receive_capture_p
     on the card; asserts 512/512 crc_ok with the seeded payloads, that
     each kernel was launched (the shape's first call, eager), and times
     the receive (host wall clock to torch.cuda.synchronize(), mean of
     10 calls after 3 warm-ups: replays of the decode's CUDA graph),
     then a torch.profiler pass over 3 calls (the card's busy share, the
     busiest items, the Viterbi kernels' device time);
  5. the block-overlap decode (one call of blocked_decode: the window
     kernel and the guard kernel) against its plain versions on the card,
     bit-exact (bits, merge flags and the packed overlap words, tolerance
     0): 64 and 4 frames x 12,090 bits of noisy soft pairs (16 blocks,
     warm-up 128), the warm-up-2 guard case, mixed per-frame lengths,
     all-erasure, uniform soft pairs (no information), and phase 13's
     shapes (64 frames of every length up to
     16,194 and 16,074 bits, windows of 1,270 and 1,262 steps); at 64 and
     4 frames the decode's time through the entry point (CUDA events),
     each kernel's device time (torch.profiler), the bound and the
     step-chain floor (the longest window's steps x the ACS step's time);
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
     4 sqrt(2 p (1 - p) / n) + 2 / n of docs/ber_data.json;
 13. the user API (fun_ofdm_tpu_torch.api) at full width, all seeded:
     Transmitter.send_burst at bench.py's bench_tx geometry (512 payloads
     of 1500 bytes, RATE_3_4_QAM16) into a capturing sink, frames equal
     to build_frame_p's, wall ms and Msample/s (mean of 10 after 3
     warm-ups); a burst of 256 payloads of 1..2000 bytes at one rate and
     one of 64 frames at per-frame rates over all 11, every frame equal
     to build_frame_p's for its length and rate (tolerance 0); the
     per-rate burst and 65 mixed frames through send_burst with its shape
     buckets and without (wall ms, buckets, none, none, buckets); those
     bursts through a LoopbackRadio into a Receiver (all rates,
     max_length 2000), every payload delivered once, in order, with its
     rate and length, crc_fail 0; the 512-frame burst written by a
     FileSink as sc16 and read back through FileSource -> Receiver; 64
     frames over UdpSink -> UdpSource on 127.0.0.1 in every wire format,
     sent at 0.5 MS/s and decoded once the source holds them (a missing
     frame fails the phase unless the source counted lost samples); and
     the examples sim and transceiver at their defaults as subprocesses
     ("Received 100 packets", "Received 10/10 packets"); then, live,
     examples.rx listening on UDP and examples.tx --pace sending it 64
     frames of 1500 bytes from a second process at the 5 MS/s radio clock:
     the frames delivered and the samples counted lost are printed as
     they are (frames may be lost; only a failed process or a missing
     or impossible count fails the case);
 14. the adaptive superstep ladder (ChainParams(latency_target_ms=40),
     bench.py's lat_auto_ms, at the default 1,048,576-sample superstep):
     phase 7's 64 lone frames at phase 7's cadence, each delivered once
     (the block-overlap kernels launched), the median and p90 latency
     beside phase 7's, and the dispatches per rung (counted by wrapping
     the chain's _ingest); phase 6's dense stream (int10), the same
     packets and counters as phase 6 but the dispatch count, Msample/s;
     phase 9's four channels ending in flush(), phase 9's packets;
 15. multi-device receive on the one card (fun_ofdm_tpu_torch.parallel).
     NCCL refuses two ranks on one card, so the multi-rank runs take gloo
     with every rank on cuda:0, the halo and the all-gather through host
     memory: (a) `python -m fun_ofdm_tpu_torch.parallel.dryrun --ranks 4`,
     both passes; (b) phase 4's capture on a 2 (channel) x 2 (time) mesh
     of 4 ranks (this script with --shard-worker, one process a rank),
     the time cut through frame 16 of every channel, every rank's
     delivered (channel, global start, payload) set equal to the
     single-process receive_capture_p on the card, each rank's wall ms
     per call (after a warm-up, CUDA-synchronised; the 4 ranks share the
     card) beside phase 4's; (c) the same capture on a one-rank NCCL
     group (mesh 1 x 1), the all-gather on the card;
 16. frame detection's two kernels (csrc/detect.cu, through
     frontend.detect_frames) against the plain version
     (frontend.detect_frames_plain) on the card: starts, valid and dropped
     equal, the LTS correlation to float32 rounding, at the capture's
     shape (fun_ofdm's test_sim recording, 1 x 7,832,000 samples, k =
     100, every frame found) and the K=1 chain's header window (11,216
     samples, drops counted below 4,096); both timed (CUDA events), each
     kernel's device time (torch.profiler) and the bound (the filter's
     FP64 FMAs at the card's FP64 rate, or its bytes);
 17. the universal decode's soft-stream kernel (csrc/softbits.cu, through
     ops/softbits_cuda.softbits) against its plain version on the card
     at the universal capture's shape (100 slots x 1,368 symbols, all 11
     rates, max_length 4095; the points as the real and imaginary views of
     a complex64 tensor): equal to _anyrate_coded_gather over the whole
     output, the erasure past each slot's rate's end, with the slots all
     RATE_3_4_QAM16 (the capture cell's frames), all RATE_1_2_BPSK (the
     most points read) and of random rates; the kernel and its plain
     version timed (CUDA events), the kernel's device time
     (torch.profiler) and its bound (the output written and the points
     read, 8 bytes a point, at the card's memory rate).
The phases run in the order 1-3, 16, 17, 4-9, 14, 15, 10, 13, 11, 12. Each
main-path phase (4, 6-15) sets the kernels' launch counts to 0 just before it runs
and reads them just after; phase 15 adds the counts its ranks report.
The last two lines are a JSON object with one entry per kernel (its
time, its plain version's, and its bound: the larger of its bytes over
the card's memory rate and its integer operations over the card's int32
rate) and the JSON result line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
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
#: where the streaming phases (6-9, 11), the harnesses (10, 12) and the
#: API phase (13) run
DEVICE = "cuda"
#: phase 13: bench_tx's burst, the mixed-length burst (the largest batch
#: bucket) and the per-frame-rate burst, in frames; the largest payload of
#: the mixed bursts (the reference's MAX_FRAME_SIZE); frames sent over UDP
API_TX_FRAMES = 512
API_MIXED_FRAMES = 256
API_PER_RATE_FRAMES = 64
API_MAX_LENGTH = 2000
API_UDP_FRAMES = 64

#: the H100 SXM's published peaks (NVIDIA data sheet; the Hopper
#: architecture white paper gives 64 INT32 lanes per SM, 132 SMs, and the
#: data sheet a 1.98 GHz boost clock): memory bytes/s and int32 ops/s
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
#: FP64 FMAs/s: 64 FP64 lanes per SM (the white paper; 33.5 TFLOP/s in the
#: data sheet)
FP64_FMAS_PER_S = 132 * 64 * 1.98e9
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


def ptxas_report(ptxas_log: str) -> dict:
    """{kernel: {"registers": n, "smem_static": bytes}} from nvcc's -Xptxas
    -v report; a template instance is named by its mode, e.g.
    acs_ablate_kernel<0>; with each kernel's spill stores and loads in
    bytes. Dynamic shared memory is not in the report."""
    out, name, spills = {}, None, None
    for ln in ptxas_log.splitlines():
        entry = re.search(r"entry function '(\w+)'", ln)
        if entry:
            m = re.search(r"\d+([a-z][a-z_]*_kernel)(?:ILi(\d+)E)?",
                          entry.group(1))
            name = entry.group(1) if m is None else (
                m.group(1) + (f"<{m.group(2)}>" if m.group(2) else ""))
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", ln)
        if spill:
            spills = [int(spill.group(1)), int(spill.group(2))]
        regs = re.search(r"Used (\d+) registers", ln)
        if regs and name is not None:
            smem = re.search(r"(\d+) bytes smem", ln)
            out[name] = {"registers": int(regs.group(1)),
                         "smem_static": int(smem.group(1)) if smem else 0,
                         "spill_stores_loads": spills}
            name = None
    return out


def register_report(ptxas_log: str) -> dict:
    """{kernel: registers} from nvcc's -Xptxas -v report, named as
    ptxas_report names them."""
    return {k: v["registers"] for k, v in ptxas_report(ptxas_log).items()}


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


def api_trellis_bits() -> list[int]:
    """Decoded bits of the any-rate trellis of each length class that a
    Receiver with all rates and max_length API_MAX_LENGTH decodes in
    (phase 13): the longest frame of the class, less the 6 tail bits."""
    from fun_ofdm_tpu_torch.rates import ALL_RATES, params_for
    from fun_ofdm_tpu_torch.runtime.chain import length_classes

    return [max(params_for(r).num_data_bits(API_MAX_LENGTH) for r in cls) - 6
            for cls in length_classes(ALL_RATES, API_MAX_LENGTH)]


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
    ] + [
        # phase 13's shapes: the 256-frame bucket of each length class of
        # the all-rates Receiver at max_length 2000, frames of every length
        kernel_case(f"api{API_MAX_LENGTH}_class{k}",
                    noisy_soft(rng, 256, nb, 100), nb,
                    nbits_dynamic=torch.from_numpy(
                        rng.integers(0, nb + 1, size=256)))
        for k, nb in enumerate(api_trellis_bits())
    ]


def slice_phase() -> tuple[dict, dict]:
    """bench_capture's geometry through the port on the card."""
    from fun_ofdm_tpu_torch.models import frontend, rx
    from fun_ofdm_tpu_torch.rates import Rate, params_for

    dev = torch.device("cuda")
    rate = Rate[RATE_NAME]
    frame_len = params_for(rate).frame_samples(LENGTH)      # 7120

    def capture_streams():
        return bench_capture_streams(dev)[0]

    payloads = bench_capture_streams(dev)[1]

    def receive(streams):
        return frontend.receive_capture_p(streams, rate, LENGTH,
                                          FRAMES_PER_CHANNEL)

    # a key's first call decodes eagerly, so the counts are its own
    # launches; the timed and profiled calls after it replay the decode's
    # CUDA graph (models/rx.capture_call)
    rx._graphs.clear()
    reset_launches()
    streams = capture_streams()
    out = receive(streams)
    torch.cuda.synchronize()
    launches = read_launches()

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
    for name in ("viterbi_acs", "viterbi_chainback", "detect_frames"):
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


def test_sim_capture(device):
    """fun_ofdm's test_sim recording (phybench's sim1-r36-1500): 100
    distinct 1500-byte RATE_3_4_QAM16 frames back to back, every second
    one with AWGN at 12.5 dB over its SIGNAL and data symbols, then a zero
    pad of 1000 frame lengths; a (1, 7,832,000) complex64 tensor."""
    from fun_ofdm_tpu_torch.models import tx
    from fun_ofdm_tpu_torch.rates import Rate

    rng = np.random.default_rng(SEED + 16)
    payloads = rng.integers(0, 256, size=(100, LENGTH), dtype=np.uint8)
    fre, fim = tx.build_frame_p(torch.from_numpy(payloads), Rate[RATE_NAME])
    frames = fre.numpy() + 1j * fim.numpy()
    sigma = np.sqrt(52 / 4096 / 10 ** 1.25 / 2)
    noisy = frames[1::2, 320:]
    noisy += sigma * (rng.standard_normal(noisy.shape)
                      + 1j * rng.standard_normal(noisy.shape))
    x = np.zeros((1, 1100 * frames.shape[1]), np.complex64)
    x[0, :frames.size] = frames.reshape(-1)
    return torch.from_numpy(x).to(device)


def detect_case(name, x, k, drop_count_limit=None):
    """The detection kernels vs their plain version on one input, timed:
    both through CUDA events, each kernel's device time through the
    profiler, and the bound."""
    from fun_ofdm_tpu_torch.config import ChainParams
    from fun_ofdm_tpu_torch.models import frontend
    from fun_ofdm_tpu_torch.ops import correlate, detect_cuda
    from torch.profiler import ProfilerActivity, profile

    params = ChainParams()
    got = frontend.detect_frames(x, k, params, True, drop_count_limit)
    want = frontend.detect_frames_plain(x, k, params, True, drop_count_limit)
    equal = all(torch.equal(g, w) for g, w in zip(got, want))
    n = x.shape[-1]
    lts = detect_cuda.detect(x, k, params, frontend._block_cap(n, k),
                             drop_count_limit, True)[3]
    lts_err = float((lts - correlate.lts_correlation(x)).abs().max())
    reps = 20
    ms = cuda_ms(lambda: frontend.detect_frames(x, k, params, True,
                                                drop_count_limit), reps=reps)
    plain_ms = cuda_ms(lambda: frontend.detect_frames_plain(
        x, k, params, True, drop_count_limit), reps=3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            frontend.detect_frames(x, k, params, True, drop_count_limit)
        torch.cuda.synchronize()
    kernels = {}
    for e in prof.key_averages():
        m = re.search(r"(detect_\w+_kernel)", e.key)
        if m and e.self_device_time_total > 0:
            kernels[m.group(1)] = e.self_device_time_total / 1e3 / reps
    # the matched filter's FP64 FMAs (4 a tap, 64 taps a sample) or the
    # bytes: the samples read, the correlation, event bits and slots written
    fmas = x.numel() * 64 * 4
    t_ops = fmas / FP64_FMAS_PER_S * 1e3
    t_bytes = (x.numel() * 12 + x.numel() / 8 + k * 9) / HBM_BYTES_PER_S * 1e3
    rec = {"case": name, "shape": list(x.shape), "k": k,
           "drop_count_limit": drop_count_limit, "equal": equal,
           "valid": int(got[1].sum()), "dropped": int(got[2].sum()),
           "lts_max_abs_err": lts_err, "ms": ms, "plain_ms": plain_ms,
           "kernel_device_ms": kernels,
           "bound_ms": max(t_ops, t_bytes),
           "bound_by": "fp64 fmas" if t_ops >= t_bytes else "bytes"}
    print("detect vs plain:", json.dumps(rec), flush=True)
    if not equal or lts_err > 1e-5:
        raise AssertionError(f"the detection kernels disagree with their "
                             f"plain version: {rec}")
    return rec


def detect_phase() -> list:
    """Phase 16: frame detection's kernels (csrc/detect.cu) against the
    plain version on the card, at the capture's shape and the K=1 chain's
    header window."""
    from fun_ofdm_tpu_torch.ops import detect_cuda
    from fun_ofdm_tpu_torch.rates import Rate, params_for
    from fun_ofdm_tpu_torch.runtime import chain

    t0 = time.perf_counter()
    detect_cuda.build()
    log = detect_cuda.library_path().with_suffix(".log")
    print(f"detect build: {time.perf_counter() - t0:.2f} s; registers: "
          f"{json.dumps(register_report(log.read_text()))}", flush=True)
    dev = torch.device("cuda")
    capture = test_sim_capture(dev)
    cases = [detect_case("capture", capture, 100)]
    if cases[0]["valid"] != 100:
        raise AssertionError(f"capture: {cases[0]['valid']}/100 frames")
    # the K=1 chain's header pass: a 4,096-sample read and one longest
    # frame (11,216 samples), drops counted in the read, the read's
    # capacity in shortest frames
    step = 4096
    rate = Rate[RATE_NAME]
    window = step + params_for(rate).frame_samples(LENGTH)
    k = -(-(step + chain.DETECT_LEAD) // params_for(rate).frame_samples(1)) + 1
    cases.append(detect_case("k1_window", capture[:, :window].contiguous()
                             .reshape(-1), k, drop_count_limit=step))
    return cases


def softbits_case(name, samples, rates, ridx, max_length, reps=50):
    """The soft-stream kernel vs its plain version on one input, timed:
    both through CUDA events, the kernel's device time through the
    profiler, and its bound (bytes)."""
    from fun_ofdm_tpu_torch.models import ppdu
    from fun_ofdm_tpu_torch.ops import softbits_cuda
    from fun_ofdm_tpu_torch.rates import params_for
    from torch.profiler import ProfilerActivity, profile

    def kernel():
        return softbits_cuda.softbits(samples, rates, ridx, max_length)

    got = kernel()
    row = got.shape[-1]
    gather = ppdu._anyrate_coded_gather(samples, rates, ridx, max_length)
    n_coded = torch.tensor([2 * params_for(r).num_data_bits(max_length)
                            for r in rates], device=ridx.device)[ridx]
    inside = torch.arange(row, device=ridx.device) < n_coded[:, None]
    rec = {"case": name, "shape": list(got.shape),
           "equal_gather": bool(torch.equal(got, gather)),
           "erasure_outside": bool((got[~inside] == 127).all())}
    del gather
    rec["ms"] = cuda_ms(kernel, reps=reps)
    rec["gather_ms"] = cuda_ms(lambda: ppdu._anyrate_coded_gather(
        samples, rates, ridx, max_length), reps=3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            kernel()
        torch.cuda.synchronize()
    rec["kernel_device_ms"] = sum(
        e.self_device_time_total for e in prof.key_averages()
        if "softbits_kernel" in e.key) / 1e3 / reps
    # the output written once and the points each slot's rate covers read
    # once, 8 bytes a point (a complex64 point's real and imaginary parts)
    points = sum(params_for(rates[int(i)]).num_symbols(max_length) * 48
                 for i in ridx.tolist())
    rec["bytes"] = got.numel() * 4 + points * 8 + ridx.numel() * 8
    rec["bound_ms"] = rec["bytes"] / HBM_BYTES_PER_S * 1e3
    rec["bound_by"] = "bytes"
    print("softbits vs plain:", json.dumps(rec), flush=True)
    if not (rec["equal_gather"] and rec["erasure_outside"]):
        raise AssertionError(f"the soft-stream kernel disagrees with its "
                             f"plain version: {rec}")
    return rec


def softbits_phase() -> list:
    """Phase 17: the universal decode's soft-stream kernel
    (csrc/softbits.cu) against its plain version on the card, at the
    universal capture's shape."""
    from fun_ofdm_tpu_torch.ops import softbits_cuda
    from fun_ofdm_tpu_torch.rates import ALL_RATES, Rate, params_for

    t0 = time.perf_counter()
    softbits_cuda.build()
    log = softbits_cuda.library_path().with_suffix(".log")
    print(f"softbits build: {time.perf_counter() - t0:.2f} s; ptxas: "
          f"{json.dumps(ptxas_report(log.read_text()))}", flush=True)
    dev = torch.device("cuda")
    rates, max_length, slots = tuple(ALL_RATES), 4095, 100
    nsym = max(params_for(r).num_symbols(max_length) for r in rates)
    rng = np.random.default_rng(SEED + 17)
    # a SIGNAL symbol then the data symbols, as models/rx equalises them
    pts = rng.normal(0, 0.6, (2, slots, 1 + nsym, 48)).astype(np.float32)
    data = torch.complex(torch.from_numpy(pts[0]),
                         torch.from_numpy(pts[1])).to(dev)
    rest = data[..., 1:, :].reshape(slots, -1)
    samples = (rest.real, rest.imag)

    def all_at(rate):
        return torch.full((slots,), rates.index(rate), dtype=torch.int64,
                          device=dev)
    mixed = torch.from_numpy(rng.integers(0, len(rates), slots)).to(dev)
    return [softbits_case("capture_qam16_3_4", samples, rates,
                          all_at(Rate.RATE_3_4_QAM16), max_length),
            softbits_case("all_bpsk_1_2", samples, rates,
                          all_at(Rate.RATE_1_2_BPSK), max_length),
            softbits_case("mixed", samples, rates, mixed, max_length)]


def kernel_record(kernel: str, replaces: str, cases: list, launches: dict):
    """The result entry of kernel "acs", "chainback", "blocked_decode" or
    "acs_ablate"; `replaces` is where its TPU counterpart starts (for the
    exact pair, the radix-4 kernel the TPU path runs). The first case of
    `cases` is the timed one. No single PyTorch call computes a Viterbi
    step, so library_ms is null."""
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
    """The block-overlap decode's kernels vs their plain versions on one
    input.

    One call of viterbi_cuda.blocked_decode (the window kernel and the
    guard kernel) against the plain version of the decode (decode_plain:
    bits and merge flags) and the plain form of the kernels' own algebra
    (decode_words_plain's pieces: the packed overlap words, and the bits
    and flags again). Frames whose blocked bits differ from the exact
    decode must carry a False flag. Timed: the decode through the entry
    point (CUDA events), each kernel's device time (torch.profiler), the
    bound, and the step-chain floor: the longest window's steps times the
    ACS step's time, read from acs_ablate "full" on the same frames."""
    from fun_ofdm_tpu_torch.ops import viterbi, viterbi_blocked, viterbi_cuda

    dev = torch.device("cuda")
    soft = torch.from_numpy(soft_np).to(dev)
    frames = soft.shape[0]
    steps = viterbi.step_counts(nbits, nbits_dynamic, (frames,), dev)
    geo = viterbi_blocked.geometry(nbits, n_blocks, warmup)

    def decode():
        return viterbi_cuda.blocked_decode(soft, steps, geo)

    bits, ok, overlaps = decode()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bits_plain, ok_plain = viterbi_blocked.decode_plain(soft, steps, geo)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    words = viterbi_blocked.window_words_plain(
        viterbi_blocked.acs_windowed_plain(soft, steps, geo), geo.win)
    overlaps_plain = viterbi_blocked.pack_overlaps_plain(words, geo)
    err = max(int((bits - bits_plain).abs().max()) if bits.numel() else 0,
              int((ok != ok_plain).sum()),
              int((overlaps != overlaps_plain).sum()),
              int((bits != viterbi_blocked.span_write_plain(words, geo))
                  .sum()),
              int((ok != viterbi_blocked.guard_words_plain(
                  overlaps_plain, steps, geo)).sum()))
    exact = viterbi.viterbi_decode(soft, nbits, nbits_dynamic=nbits_dynamic)
    nbd = (torch.full((frames,), nbits) if nbits_dynamic is None
           else torch.as_tensor(nbits_dynamic)).to(dev)
    live = torch.arange(nbits, device=dev)[None, :] < nbd[:, None]
    differs = ((bits != exact) & live).any(-1)
    rec = {"case": name, "frames": frames, "nbits": nbits,
           "n_blocks": geo.n_blocks, "warmup": warmup, "win": geo.win,
           "blocked_decode_max_abs_err": err,
           "flagged": int((~ok).sum()),
           "differs_from_exact": int(differs.sum()),
           "blocked_decode_plain_ms": plain_ms}
    if timed:
        rec["blocked_decode_ms"] = cuda_ms(decode, reps=20)
        prof = profile_device(lambda: [decode() for _ in range(20)])
        rec["device_ms"] = {k: ms / n for k, (ms, n)
                            in prof["viterbi_kernels_ms"].items()}
        run = viterbi_blocked.window_steps(steps, geo)  # steps per window
        # the ACS steps, one walk of every window, the span write (a copy
        # a bit), and the guard's XOR, mask and OR on each cut's words
        ops = (int(run.sum()) * ACS_OPS_PER_STEP
               + frames * geo.n_blocks * geo.win * CHAINBACK_OPS_PER_STEP
               + frames * nbits
               + frames * (geo.n_blocks - 1)
               * viterbi_blocked.overlap_words(geo) * 3)
        rec["blocked_decode_bound"] = bound(nbytes(soft, steps, bits, ok),
                                            ops)
        init = torch.ones_like(steps)
        ablate_ms = cuda_ms(
            lambda: viterbi_cuda.acs_ablate(soft, steps, init, "full"),
            reps=5)
        step_ms = ablate_ms / int(steps.max())
        rec["acs_step_ns"] = step_ms * 1e6
        rec["step_chain_floor_ms"] = int(run.max()) * step_ms
        rec["exact_decode_ms"] = cuda_ms(
            lambda: viterbi.viterbi_decode(soft, nbits,
                                           nbits_dynamic=nbits_dynamic),
            reps=5)
    print("blocked vs plain:", json.dumps(rec), flush=True)
    if err:
        raise AssertionError(f"the blocked decode's kernels disagree with "
                             f"their plain versions: {rec}")
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
        # uniform soft pairs carry no information: survivor paths meet
        # late, and the traceback's corrections take several rounds
        blocked_case("noinfo", rng.integers(0, 256, (16, 2 * (nbits + 6)),
                                            dtype=np.int32), nbits),
    ] + [
        # phase 13's shapes: the 64-frame bucket of each length class of the
        # all-rates Receiver at max_length 2000, frames of every length
        blocked_case(f"api{API_MAX_LENGTH}_class{k}",
                     noisy_soft(rng, 64, nb, 100), nb,
                     nbits_dynamic=torch.from_numpy(
                         rng.integers(0, nb + 1, size=64)))
        for k, nb in enumerate(api_trellis_bits())
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


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    from fun_ofdm_tpu_torch.ops import detect_cuda, softbits_cuda, viterbi_cuda

    viterbi_cuda.reset_launches()
    detect_cuda.reset_launches()
    softbits_cuda.reset_launches()


def read_launches() -> dict:
    """Every kernel's launch count, by name."""
    from fun_ofdm_tpu_torch.ops import detect_cuda, softbits_cuda, viterbi_cuda

    return {**viterbi_cuda.launches, **detect_cuda.launches,
            **softbits_cuda.launches}


def launches_of(fn):
    """Run fn with every kernel's launch count set to 0; return its result
    and the counts just after."""
    reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, read_launches()


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


def dense_stream():
    """Phase 6's stream: phase 4's channel-0 unit tiled 36 times, as
    4096-sample float32 pieces; returns (s_re, s_im, pieces, planted)."""
    from fun_ofdm_tpu_torch.rates import Rate, params_for

    rate = Rate[RATE_NAME]
    frame_len = params_for(rate).frame_samples(LENGTH)
    payloads = np.random.default_rng(SEED).integers(
        0, 256, size=(CHANNELS, LENGTH), dtype=np.uint8)
    unit = unit_stream(payloads[0], rate, FRAMES_PER_CHANNEL, TAIL)
    tiles = 36
    s_re, s_im = (np.tile(u, tiles) for u in unit)
    pieces = [(s_re[i:i + 4096], s_im[i:i + 4096])
              for i in range(0, s_re.size, 4096)]
    planted = {(0, t * unit[0].size + k * frame_len): (payloads[0].tobytes(),
                                                       rate)
               for t in range(tiles) for k in range(FRAMES_PER_CHANNEL)}
    return s_re, s_im, pieces, planted


def dense_stream_phase() -> dict:
    """bench.py's reference-parity streaming configuration."""
    from fun_ofdm_tpu_torch.config import ChainParams
    from fun_ofdm_tpu_torch.rates import Rate
    from fun_ofdm_tpu_torch.runtime.chain import ReceiverChain, pack10

    rate = Rate[RATE_NAME]
    s_re, s_im, pieces, planted = dense_stream()
    n = s_re.size

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


SPARSE_FRAMES, SPARSE_GAP = 64, 20000


def sparse_stream():
    """Phase 7's stream: 64 lone frames, each followed by 20,000 zeros;
    returns (s_re, s_im, planted, period)."""
    from fun_ofdm_tpu_torch.models import tx
    from fun_ofdm_tpu_torch.rates import Rate, params_for

    rate = Rate[RATE_NAME]
    frame_len = params_for(rate).frame_samples(LENGTH)
    payloads = np.random.default_rng(SEED + 7).integers(
        0, 256, size=(SPARSE_FRAMES, LENGTH), dtype=np.uint8)
    fre, fim = (f.cpu().numpy() for f in tx.build_frame_p(
        torch.from_numpy(payloads).to(DEVICE), rate))
    period = frame_len + SPARSE_GAP
    s_re = np.zeros(SPARSE_FRAMES * period, np.float32)
    s_im = np.zeros(SPARSE_FRAMES * period, np.float32)
    for k in range(SPARSE_FRAMES):
        s_re[k * period:k * period + frame_len] = fre[k]
        s_im[k * period:k * period + frame_len] = fim[k]
    planted = {(0, k * period): (payloads[k].tobytes(), rate)
               for k in range(SPARSE_FRAMES)}
    return s_re, s_im, planted, period


def feed_at_cadence(c, s_re, s_im, period):
    """Feed phase 7's stream to chain c in 4096-sample pieces at the
    radio's cadence (a 0.8 ms sleep after each, 5 MS/s), then flush.
    A frame's latency runs from the call that hands over its last sample
    to the call that returns its packet. Returns (packets, latencies)."""
    frame_len = period - SPARSE_GAP
    last_piece = {k * period + frame_len - 1: k for k in range(SPARSE_FRAMES)}
    t_last, lat_ms, pkts = {}, [], []
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
    return pkts + c.flush(), lat_ms


def sparse_stream_phase() -> dict:
    """The reference cadence: 4096-sample supersteps, lone frames."""
    from fun_ofdm_tpu_torch.config import ChainParams
    from fun_ofdm_tpu_torch.rates import Rate
    from fun_ofdm_tpu_torch.runtime.chain import ReceiverChain

    rate = Rate[RATE_NAME]
    s_re, s_im, planted, period = sparse_stream()

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
    t0 = time.perf_counter()
    (pkts, lat_ms), launches = launches_of(
        lambda: feed_at_cadence(c, s_re, s_im, period))
    wall_s = time.perf_counter() - t0
    check_packets(pkts, planted, "sparse stream")
    if launches["viterbi_blocked_decode"] == 0:
        raise AssertionError("viterbi_blocked_decode was not launched on the "
                             "sparse stream")
    rec = {"frames": SPARSE_FRAMES, "delivered": len(pkts), "step": c.step,
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


def multichannel_stream(latency_target_ms=None):
    """Phase 9's 4-channel chain and stream: (chain, s_re, pieces,
    planted); the chain adaptive when latency_target_ms is set."""
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
                                         min_frame_samples=4000,
                                         latency_target_ms=latency_target_ms),
                      channels=channels, ingest_dtype="int10", device=DEVICE)
    n_whole = s_re.shape[-1] // c.step * c.step
    # whole supersteps as packed wire words, the rest as float32
    pieces = [(pack10(s_re[:, :n_whole]), pack10(s_im[:, :n_whole])),
              (s_re[:, n_whole:], s_im[:, n_whole:])]
    planted = {(ch, t * unit + k * frame_len): (payloads[ch].tobytes(), rate)
               for ch in range(channels) for t in range(tiles)
               for k in range(per_unit)}
    return c, s_re, pieces, planted


def multichannel_phase() -> dict:
    """bench.py's bench_multichannel at C=4, ~1 M samples per channel."""
    c, s_re, pieces, planted = multichannel_stream()
    channels = s_re.shape[0]
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


#: bench.py's lat_auto_ms row: the adaptive ladder's latency target
LATENCY_TARGET_MS = 40.0


def _counting_rungs(c) -> dict:
    """Wrap adaptive chain c's _ingest to count its dispatches by size in
    strides (the ladder's rungs; every dispatch comes from the pending
    float32 buffer); returns the live {rung: count} dict."""
    rungs = {}
    ingest = c._ingest

    def counted(c_re, c_im):
        rung = c_re.shape[-1] // c.stride
        rungs[rung] = rungs.get(rung, 0) + 1
        ingest(c_re, c_im)

    c._ingest = counted
    return rungs


def _counters(stats: dict) -> dict:
    """A chain's counters but its dispatch count and its wait times (the
    ladder's dispatches follow the host clock)."""
    return {k: v for k, v in stats.items()
            if k != "windows" and not k.startswith("time_")}


def adaptive_phase(dense: dict, sparse: dict, multichannel: dict) -> dict:
    """Phase 14: the adaptive ladder (ChainParams.latency_target_ms=40,
    bench.py's lat_auto_ms) at the GPU's default 1,048,576-sample
    superstep, on phase 7's sparse stream at the radio's cadence, phase
    6's dense stream and phase 9's four channels; the records of phases
    6, 7 and 9 from this run are printed beside it."""
    from fun_ofdm_tpu_torch.config import ChainParams
    from fun_ofdm_tpu_torch.rates import Rate
    from fun_ofdm_tpu_torch.runtime.chain import ReceiverChain

    rate = Rate[RATE_NAME]
    params = ChainParams(latency_target_ms=LATENCY_TARGET_MS)

    def chain(**kw):
        return ReceiverChain(rates=(rate,), max_length=LENGTH, params=params,
                             device=DEVICE, **kw)

    rec = {"latency_target_ms": LATENCY_TARGET_MS}
    # the sparse stream, after a warm-up over its first two periods
    s_re, s_im, planted, period = sparse_stream()
    feed_at_cadence(chain(), s_re[:2 * period], s_im[:2 * period], period)
    c = chain()
    rungs = _counting_rungs(c)
    t0 = time.perf_counter()
    (pkts, lat_ms), launches = launches_of(
        lambda: feed_at_cadence(c, s_re, s_im, period))
    wall_s = time.perf_counter() - t0
    check_packets(pkts, planted, "adaptive sparse stream")
    if launches["viterbi_blocked_decode"] == 0:
        raise AssertionError("viterbi_blocked_decode was not launched on the "
                             "adaptive sparse stream")
    rec["sparse"] = {
        "frames": SPARSE_FRAMES, "delivered": len(pkts), "step": c.step,
        "ladder": c._ladder, "dispatches_per_rung": rungs,
        "latency_ms_median": float(np.median(lat_ms)),
        "latency_ms_p90": float(np.percentile(lat_ms, 90)),
        "latencies_measured": len(lat_ms),
        "phase7_k1_latency_ms_median": sparse["latency_ms_median"],
        "phase7_k1_latency_ms_p90": sparse["latency_ms_p90"],
        "wall_s": wall_s, "stats": c.stats.as_dict(), "launches": launches}
    print("adaptive sparse:", json.dumps(rec["sparse"]), flush=True)
    total = dict(launches)

    # the dense stream: full supersteps while backlogged
    s_re, s_im, pieces, planted = dense_stream()
    c = chain(ingest_dtype="int10")
    rungs = _counting_rungs(c)
    t0 = time.perf_counter()
    pkts, launches = launches_of(lambda: run_chain(c, pieces))
    wall_s = time.perf_counter() - t0
    check_packets(pkts, planted, "adaptive dense stream")
    same = _counters(c.stats.as_dict()) == _counters(dense["stats"])
    rec["dense"] = {
        "samples": s_re.size, "frames": len(planted), "delivered": len(pkts),
        "dispatches_per_rung": rungs, "wall_s": wall_s,
        "samples_per_s": s_re.size / wall_s,
        "phase6_samples_per_s": dense["samples_per_s"],
        "same_counters_as_phase6": same,
        "windows": [c.stats.windows, dense["stats"]["windows"]],
        "stats": c.stats.as_dict(), "launches": launches}
    print("adaptive dense:", json.dumps(rec["dense"]), flush=True)
    if not same:
        raise AssertionError(f"adaptive dense counters {c.stats} differ from "
                             f"phase 6's {dense['stats']}")
    total = {k: v + launches[k] for k, v in total.items()}

    # four channels, ending in flush(): phase 9's packets
    c, s_re, pieces, planted = multichannel_stream(LATENCY_TARGET_MS)
    rungs = _counting_rungs(c)
    pkts, launches = launches_of(lambda: run_chain(c, pieces))
    check_packets(pkts, planted, "adaptive 4-channel stream")
    same = _counters(c.stats.as_dict()) == _counters(multichannel["stats"])
    rec["channels4"] = {
        "frames": len(planted), "delivered": len(pkts),
        "dispatches_per_rung": rungs, "same_counters_as_phase9": same,
        "stats": c.stats.as_dict(), "launches": launches}
    print("adaptive 4 channels:", json.dumps(rec["channels4"]), flush=True)
    if not same:
        raise AssertionError(f"adaptive 4-channel counters {c.stats} differ "
                             f"from phase 9's {multichannel['stats']}")
    rec["launches"] = {k: v + launches[k] for k, v in total.items()}
    return rec


#: phase 15's mesh for bench_capture's capture, (channel, time), and
#: every rank's device (the one card)
SHARD_MESH = (2, 2)
RANK_DEVICE = "cuda:0"


def bench_capture_streams(device):
    """Phase 4's capture, (CHANNELS, FRAMES_PER_CHANNEL * frame + TAIL)
    planar tensors on `device`, and its payloads."""
    from fun_ofdm_tpu_torch.models import tx
    from fun_ofdm_tpu_torch.rates import Rate

    payloads = np.random.default_rng(SEED).integers(
        0, 256, size=(CHANNELS, LENGTH), dtype=np.uint8)
    frames = tx.build_frame_p(torch.from_numpy(payloads).to(device),
                              Rate[RATE_NAME])
    return tuple(torch.cat(
        [f[:, None, :].expand(-1, FRAMES_PER_CHANNEL, -1).reshape(
            CHANNELS, -1),
         torch.zeros((CHANNELS, TAIL), dtype=f.dtype, device=device)], dim=1)
        for f in frames), payloads


def delivered_set(out: dict) -> set:
    """{(channel, start, payload bytes)} of the CRC-valid slots."""
    crc = out["crc_ok"].cpu().numpy()
    starts = out["starts"].cpu().numpy()
    payload = out["payload"].cpu().numpy()
    return {(int(c), int(starts[c, k]), payload[c, k].tobytes())
            for c, k in zip(*np.nonzero(crc))}


def shard_worker(argv) -> int:
    """One rank of phase 15 (b, c): bench_capture's capture on a mesh of
    --world-size ranks (SHARD_MESH, or 1 x 1 for one rank), every rank on
    cuda:0; writes its global result to --out/rank<r>.npz and prints one
    JSON line: its wall ms per call (after a warm-up, CUDA-synchronised)
    and the kernels' launches in its first call."""
    import argparse

    from fun_ofdm_tpu_torch.parallel import distributed, stream_shard
    from fun_ofdm_tpu_torch.rates import Rate

    ap = argparse.ArgumentParser()
    for flag in ("--out", "--address", "--backend"):
        ap.add_argument(flag)
    ap.add_argument("--rank", type=int)
    ap.add_argument("--world-size", type=int)
    args = ap.parse_args(argv)
    distributed.initialize(args.address, args.world_size, args.rank,
                           backend=args.backend)
    try:
        shape = SHARD_MESH if args.world_size > 1 else (1, 1)
        mesh = distributed.global_mesh(*shape, device=RANK_DEVICE)
        streams, _ = bench_capture_streams(mesh.device)
        c, t = mesh.coords
        c_loc, n_loc = distributed.local_capture_shape(
            mesh, *streams[0].shape)
        block = tuple(x[c * c_loc:(c + 1) * c_loc, t * n_loc:(t + 1) * n_loc]
                      .cpu().numpy() for x in streams)
        block = distributed.shard_host_capture(
            mesh, *block, global_shape=tuple(streams[0].shape))

        def receive():
            return stream_shard.sharded_receive(
                block, Rate[RATE_NAME], LENGTH, mesh, FRAMES_PER_CHANNEL)

        out, launches = launches_of(receive)
        np.savez(Path(args.out) / f"rank{args.rank}.npz",
                 **{k: v.cpu().numpy() for k, v in out.items()})
        for _ in range(2):
            receive()
        torch.cuda.synchronize(mesh.device)
        reps = 5
        t0 = time.perf_counter()
        for _ in range(reps):
            receive()
        torch.cuda.synchronize()
        print(json.dumps({
            "rank": mesh.rank, "coords": list(mesh.coords),
            "block": [c_loc, n_loc], "backend": args.backend,
            "wall_ms_per_call": (time.perf_counter() - t0) * 1e3 / reps,
            "launches": launches}), flush=True)
    finally:
        torch.distributed.destroy_process_group()
    return 0


def _rank_lines(results, what: str) -> list:
    """The JSON line of each rank of dryrun.launch's results; raises if a
    rank failed or printed none."""
    recs = []
    for r, (rc, out, err) in enumerate(results):
        lines = [ln for ln in out.splitlines() if ln.startswith("{")]
        if rc != 0 or not lines:
            raise AssertionError(f"{what}: rank {r} returned {rc}\n"
                                 f"{err[-3000:]}")
        recs.append(json.loads(lines[-1]))
    return recs


def multi_device_phase(root: Path, slice_rec: dict) -> dict:
    """Phase 15: multi-device receive on one card. NCCL refuses two ranks
    on one card, so the multi-rank runs take gloo with every rank on
    cuda:0 (the halo and the gather go through host memory): (a) the dry
    run on 4 ranks; (b) bench_capture's capture on a 2 x 2 mesh of 4
    ranks, with a frame of every channel across the time cut, equal to
    the single-process receive_capture_p; (c) the same capture on a one-
    rank NCCL group (mesh 1 x 1). slice_rec is phase 4's record."""
    from fun_ofdm_tpu_torch.models import frontend
    from fun_ofdm_tpu_torch.parallel import dryrun
    from fun_ofdm_tpu_torch.rates import Rate, params_for

    env = dict(os.environ, PYTHONPATH=str(root))
    rec = {}
    launches = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "fun_ofdm_tpu_torch.parallel.dryrun",
         "--ranks", "4", "--device", RANK_DEVICE, "--backend", "gloo"],
        cwd=root, env=env, capture_output=True, text=True, timeout=300)
    lines = [json.loads(ln) for ln in proc.stdout.splitlines()
             if ln.startswith("{")]
    rec["dryrun"] = {"returncode": proc.returncode, "ranks": lines,
                     "wall_s": time.perf_counter() - t0}
    print("multi-device dryrun:", json.dumps(rec["dryrun"]), flush=True)
    if proc.returncode != 0 or len(lines) != 4:
        raise AssertionError(f"dryrun failed: {proc.stderr[-3000:]}")
    for r in lines:
        add(r["launches"])

    # the single-process reference on the card
    streams, _ = bench_capture_streams(DEVICE)
    want = delivered_set(frontend.receive_capture_p(
        streams, Rate[RATE_NAME], LENGTH, FRAMES_PER_CHANNEL))
    frame_len = params_for(Rate[RATE_NAME]).frame_samples(LENGTH)
    cut = streams[0].shape[-1] // SHARD_MESH[1]
    straddling = [k for k in range(FRAMES_PER_CHANNEL)
                  if k * frame_len < cut < (k + 1) * frame_len]
    if len(want) != CHANNELS * FRAMES_PER_CHANNEL or not straddling:
        raise AssertionError(f"reference: {len(want)} frames, straddling "
                             f"{straddling}")
    me = str(Path(__file__).resolve())
    for name, n, backend in (("gloo_2x2", 4, "gloo"), ("nccl_1x1", 1, "nccl")):
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            ranks = _rank_lines(dryrun.launch(
                [sys.executable, me, "--shard-worker", "--out", tmp,
                 "--backend", backend], n, 300, env=env), name)
            for r in range(n):
                got = delivered_set({k: torch.from_numpy(v) for k, v in
                                     np.load(Path(tmp) / f"rank{r}.npz")
                                     .items()})
                if got != want:
                    raise AssertionError(
                        f"{name} rank {r}: {len(got)} frames delivered, "
                        f"{len(got ^ want)} differ from the single-process "
                        f"receive")
        rec[name] = {"ranks": ranks, "frames": len(want),
                     "straddling_frame_per_channel": straddling,
                     "wall_s": time.perf_counter() - t0,
                     "phase4_single_process_wall_ms":
                         slice_rec["receive_wall_ms"]}
        print(f"multi-device {name}:", json.dumps(rec[name]), flush=True)
        for r in ranks:
            add(r["launches"])
    rec["launches"] = launches
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


class _DropSink:
    """A sink that drops what it is sent (for timing the build alone)."""

    def send_burst(self, samples) -> None:
        pass


class _PacedUdp:
    """Forwards a burst to a UdpSink one frame's samples at a time, at
    `rate` samples/s, flushing after each so that no frame's tail waits in
    the sink for the next datagram to fill."""

    def __init__(self, sink, rate: float, piece: int):
        self.sink, self.rate, self.piece = sink, rate, piece

    def send_burst(self, samples) -> None:
        re, im = samples
        t0 = time.perf_counter()
        for i in range(0, re.size, self.piece):
            self.sink.send_burst((re[i:i + self.piece],
                                  im[i:i + self.piece]))
            self.sink.flush()
            ahead = (i + self.piece) / self.rate - (time.perf_counter() - t0)
            if ahead > 0:
                time.sleep(ahead)


def _check_frames(what: str, re_all, im_all, payloads, rates) -> None:
    """The burst's samples, frame by frame, against build_frame_p of each
    payload at its rate on the card: tolerance 0."""
    from fun_ofdm_tpu_torch.models import tx

    off = 0
    for k, (p, r) in enumerate(zip(payloads, rates)):
        w_re, w_im = (f.cpu().numpy() for f in tx.build_frame_p(
            torch.frombuffer(bytearray(p), dtype=torch.uint8).to(DEVICE), r))
        n = w_re.size
        if not (np.array_equal(re_all[off:off + n], w_re)
                and np.array_equal(im_all[off:off + n], w_im)):
            err = float(max(np.abs(re_all[off:off + n] - w_re).max(),
                            np.abs(im_all[off:off + n] - w_im).max()))
            raise AssertionError(
                f"{what}: frame {k} ({len(p)} bytes, {r.name}) differs from "
                f"build_frame_p's by up to {err}")
        off += n
    if off != re_all.size:
        raise AssertionError(f"{what}: {re_all.size} samples sent, the "
                             f"frames hold {off}")


def _receive_all(source, bursts, send, rates, max_length, what,
                 done=None, wait_s: float = 120.0, start_when=None,
                 **kw) -> dict:
    """Start a Receiver on `source` (with start_when: only once it holds,
    or 5 s after the send), run send() (which puts `bursts`, a list of
    (payloads, rates), on the air), wait for every frame or for done() (at
    most wait_s seconds), stop, and hold what was delivered against what
    was sent: every payload once, in order, with its rate and length.
    Returns the counts, the wall s from the first send to the last
    callback, and the chain's stats. A frame may be missing only if
    `source` counted lost samples."""
    from fun_ofdm_tpu_torch.api import Receiver

    expected = [(p, r, len(p)) for ps, rs in bursts for p, r in zip(ps, rs)]
    received, t_last = [], [0.0]

    def callback(packets):
        received.extend(packets)
        t_last[0] = time.perf_counter()

    rx = Receiver(callback, source=source, rates=rates,
                  max_length=max_length, device=DEVICE,
                  start=start_when is None, **kw)
    try:
        t0 = time.perf_counter()
        send()
        if start_when is not None:
            t_sent = time.perf_counter()
            while not start_when() and time.perf_counter() < t_sent + 5:
                time.sleep(0.01)
            rx.start()
        deadline = t0 + wait_s
        while len(received) < len(expected) \
                and time.perf_counter() < deadline \
                and not (done is not None and done()):
            time.sleep(0.01)
    finally:
        rx.stop()
    got = [(p.payload, p.rate, p.length) for p in received]
    stats = getattr(source, "stats", None)
    lost = stats.lost_samples if stats is not None else 0
    rec = {"frames": len(expected), "delivered": len(got),
           "wall_s_first_send_to_last_callback": t_last[0] - t0,
           "step": rx.chain.step, "stats": rx.chain.stats.as_dict()}
    if stats is not None:
        rec["radio_stats"] = stats.as_dict()
    if got != expected:
        missing = len(expected) - len(got)
        in_order = iter(expected)
        if not (lost and missing > 0 and all(g in in_order for g in got)):
            raise AssertionError(
                f"{what}: delivered {len(got)} of {len(expected)} frames "
                f"or a wrong one, with {lost} samples counted lost: {rec}")
    if rx.chain.stats.crc_fail and not lost:
        raise AssertionError(f"{what}: crc_fail: {rec}")
    return rec


def example_line(name: str, want: str, root: Path) -> dict:
    """Run one example program at its defaults as a subprocess."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", f"fun_ofdm_tpu_torch.examples.{name}"],
        cwd=root, env=dict(os.environ, PYTHONPATH=str(root)),
        capture_output=True, text=True, timeout=300)
    lines = proc.stdout.strip().splitlines()
    rec = {"example": name, "returncode": proc.returncode,
           "wall_s": time.perf_counter() - t0, "last_lines": lines[-2:]}
    if proc.returncode != 0 or want not in lines:
        raise AssertionError(f"example {name}: {rec}\n{proc.stderr[-2000:]}")
    return rec


def live_udp_examples(root: Path, frames: int = API_UDP_FRAMES) -> dict:
    """examples.rx listening on UDP and examples.tx --pace streaming to it
    from a second process, the reference's two-machine demo without the
    radios: `frames` 1500-byte RATE_3_4_QAM16 frames in bursts of 8, a
    3000-sample gap after each burst, sc16 on the wire, the receiver a live
    Receiver at the 5 MS/s radio clock. UDP has no backpressure, and a read
    that runs dry pads zeros into the stream, so frames may be lost on a
    busy host: the count delivered and the samples the source counted lost
    are reported as they are. The case fails only if a process fails or
    prints no count, or more than was sent arrives."""
    env = dict(os.environ, PYTHONPATH=str(root))
    rx = subprocess.Popen(
        [sys.executable, "-m", "fun_ofdm_tpu_torch.examples.rx",
         "udp://127.0.0.1:0", "--rate", RATE_NAME, "--max-length",
         str(LENGTH), "--quiet"],
        cwd=root, env=env, text=True, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE)
    try:
        listening = rx.stdout.readline().strip()    # printed once bound
        port = int(listening.rsplit(":", 1)[1])
        time.sleep(10)      # the receiver's CUDA start-up and pause/resume
        t0 = time.perf_counter()
        tx = subprocess.run(
            [sys.executable, "-m", "fun_ofdm_tpu_torch.examples.tx",
             f"udp://127.0.0.1:{port}", "--count", str(frames), "--length",
             str(LENGTH), "--rate", RATE_NAME, "--gap", "3000", "--batch",
             "8", "--pace"],
            cwd=root, env=env, capture_output=True, text=True, timeout=300)
        out, err = rx.communicate(timeout=120)
    finally:
        if rx.poll() is None:
            rx.kill()
            rx.communicate()
    lines = out.strip().splitlines()
    got = re.fullmatch(r"Received (\d+) packets", lines[-1] if lines else "")
    lost = re.search(r"lost (\d+) samples", out)
    rec = {"frames": frames, "delivered": int(got.group(1)) if got else None,
           "lost_samples": int(lost.group(1)) if lost else 0,
           "tx_returncode": tx.returncode, "rx_returncode": rx.returncode,
           "wall_s_tx_start_to_rx_exit": time.perf_counter() - t0}
    if tx.returncode or rx.returncode or not got \
            or rec["delivered"] > frames:
        raise AssertionError(f"live UDP examples: {rec}\n{tx.stderr[-1000:]}"
                             f"\n{err[-2000:]}")
    return rec


def api_phase() -> dict:
    """Phase 13: the user API at full width (see the module docstring).
    The record's "launches" are the kernels' counts over the whole phase,
    set to 0 at its start."""
    from fun_ofdm_tpu_torch.api import CaptureSink, Transmitter
    from fun_ofdm_tpu_torch.rates import ALL_RATES, Rate, params_for
    from fun_ofdm_tpu_torch.runtime.io import (FileSink, FileSource,
                                               LoopbackRadio, UdpSink,
                                               UdpSource)

    rate = Rate[RATE_NAME]
    rng = np.random.default_rng(SEED + 13)
    frame_len = params_for(rate).frame_samples(LENGTH)
    rec = {}
    reset_launches()

    def payloads_of(lengths):
        return [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
                for n in lengths]

    def wall_ms(fn, reps=10, warmup=3):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps

    # TX at bench_tx's geometry
    dense = payloads_of([LENGTH] * API_TX_FRAMES)
    sink = CaptureSink()
    sent = Transmitter(sink, device=DEVICE).send_burst(dense, rate)
    if sent != API_TX_FRAMES * frame_len:
        raise AssertionError(f"TX: {sent} samples for {API_TX_FRAMES} frames")
    _check_frames("TX", sink.re, sink.im, dense, [rate] * API_TX_FRAMES)
    drop = Transmitter(_DropSink(), device=DEVICE)
    ms = wall_ms(lambda: drop.send_burst(dense, rate))
    rec["tx"] = {"frames": API_TX_FRAMES, "samples": sent, "wall_ms": ms,
                 "samples_per_s": sent / ms * 1e3}
    print("api tx:", json.dumps(rec["tx"]), flush=True)

    # a mixed-length burst, and per-frame rates over all 11
    mixed = payloads_of(rng.integers(1, API_MAX_LENGTH + 1,
                                     API_MIXED_FRAMES))
    per_rate = payloads_of(rng.integers(1, API_MAX_LENGTH + 1,
                                        API_PER_RATE_FRAMES))
    per_rate_rates = [ALL_RATES[k % len(ALL_RATES)]
                      for k in range(API_PER_RATE_FRAMES)]
    for name, pl, rates in (("mixed", mixed, [rate] * API_MIXED_FRAMES),
                            ("per_frame_rates", per_rate, per_rate_rates)):
        sink = CaptureSink()
        arg = rate if name == "mixed" else rates
        sent = Transmitter(sink, device=DEVICE).send_burst(pl, arg)
        _check_frames(name, sink.re, sink.im, pl, rates)
        rec[name] = {"frames": len(pl), "samples": sent,
                     "max_abs_err_vs_static": 0.0,
                     "wall_ms": wall_ms(lambda: drop.send_burst(pl, arg),
                                        reps=3, warmup=1)}
        print(f"api {name}:", json.dumps(rec[name]), flush=True)

    # the send_burst shape buckets against a Transmitter that pads nothing
    # (each build at its own frame count and longest payload): the per-rate
    # burst (11 groups of ~6 frames, each padded to 16 x 2000) and 65 mixed
    # frames (padded to 256 x 2000); wall ms in the order buckets, none,
    # none, buckets
    class _NoBuckets(Transmitter):
        BURST_BATCH_BUCKETS = ()
        BURST_LEN_BUCKETS = ()

    plain = _NoBuckets(_DropSink(), device=DEVICE)
    rec["buckets_vs_none"] = {
        name: [wall_ms(lambda t=t: t.send_burst(pl, arg), reps=5, warmup=2)
               for t in (drop, plain, plain, drop)]
        for name, pl, arg in (("per_frame_rates_ms", per_rate, per_rate_rates),
                              ("mixed65_ms", mixed[:65], rate))}
    print("api buckets vs none:", json.dumps(rec["buckets_vs_none"]),
          flush=True)

    # loopback end to end: bursts the ring holds (4,194,304 samples)
    quarter = API_TX_FRAMES // 4
    bursts = [(dense[i:i + quarter], [rate] * quarter)
              for i in range(0, API_TX_FRAMES, quarter)]
    bursts += [(mixed, [rate] * API_MIXED_FRAMES), (per_rate, per_rate_rates)]
    radio = LoopbackRadio()
    try:
        txr = Transmitter(radio, device=DEVICE)
        rec["loopback"] = _receive_all(
            radio, bursts,
            lambda: [txr.send_burst(pl, rs) for pl, rs in bursts],
            ALL_RATES, API_MAX_LENGTH, "loopback")
    finally:
        radio.close()
    print("api loopback:", json.dumps(rec["loopback"]), flush=True)

    # the dense burst through an sc16 capture file
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "capture.sc16")
        fsink = FileSink(path, fmt="int16")
        try:
            ftx = Transmitter(fsink, device=DEVICE)
            for pl, rs in bursts[:4]:
                ftx.send_burst(pl, rs)
            fsink.send_burst(np.zeros(4096, np.complex64))
        finally:
            fsink.close()
        src = FileSource(path, fmt="int16")
        try:
            rec["file_int16"] = _receive_all(
                src, bursts[:4], lambda: None, (rate,), LENGTH, "file",
                done=lambda: src.exhausted)
            rec["file_int16"]["bytes"] = os.path.getsize(path)
        finally:
            src.close()
    print("api file:", json.dumps(rec["file_int16"]), flush=True)

    # frames over UDP on the loopback interface, in every wire format. UDP
    # has no backpressure, and a source whose reads run dry pads zeros, so
    # the sender keeps to 0.5 MS/s (the socket's buffer then covers a
    # datagram thread that is not scheduled for ~90 ms) and the Receiver
    # starts once the source holds the whole stream: the datagram thread
    # then competes with the sender alone, not with the chain's dispatch.
    # Once the source has run dry, stop()'s flush delivers the rest
    rec["udp"] = {}
    for wire in ("int16", "int12", "int10", "int8"):
        usrc = UdpSource(("127.0.0.1", 0))
        usink = None
        try:
            usink = UdpSink(("127.0.0.1", usrc.addr[1]), wire=wire)
            utx = Transmitter(_PacedUdp(usink, 5e5, frame_len),
                              device=DEVICE)
            rec["udp"][wire] = _receive_all(
                usrc, [(dense[:API_UDP_FRAMES], [rate] * API_UDP_FRAMES)],
                lambda: utx.send_burst(dense[:API_UDP_FRAMES], rate),
                (rate,), LENGTH, f"udp {wire}", wait_s=30,
                start_when=lambda: usrc.pending >= API_UDP_FRAMES * frame_len,
                done=lambda: usrc.pending == 0)
        finally:
            if usink is not None:
                usink.close()
            usrc.close()
        print(f"api udp {wire}:", json.dumps(rec["udp"][wire]), flush=True)
    torch.cuda.synchronize()
    rec["launches"] = read_launches()
    return rec


def main() -> int:
    if sys.argv[1:2] == ["--shard-worker"]:
        return shard_worker(sys.argv[2:])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # full float32 in every matmul and convolution
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from fun_ofdm_tpu_torch.ops import detect_cuda, softbits_cuda, viterbi_cuda

    print(card_line(), flush=True)
    t0 = time.perf_counter()
    viterbi_cuda.build()
    build_s = time.perf_counter() - t0
    log = viterbi_cuda.library_path().with_suffix(".log")
    ptxas_log = log.read_text() if log.exists() else ""
    report = ptxas_report(ptxas_log)
    print(f"build: {build_s:.2f} s; registers: "
          f"{json.dumps(register_report(ptxas_log))}", flush=True)

    cases = kernel_phase()
    detect = detect_phase()
    softbits = softbits_phase()
    slice_rec, launches = slice_phase()
    blocked = blocked_phase()
    dense = dense_stream_phase()
    sparse = sparse_stream_phase()
    all_rates = all_rates_phase()
    multichannel = multichannel_phase()
    root = Path(__file__).resolve().parent
    for rec in (dense, sparse, all_rates, multichannel,
                adaptive_phase(dense, sparse, multichannel),
                multi_device_phase(root, slice_rec)):
        for name, count in rec["launches"].items():
            launches[name] += count
    ablate, ab_launches = ablation_phase()
    api = api_phase()
    for name in ("viterbi_acs", "viterbi_chainback",
                 "viterbi_blocked_decode"):
        if api["launches"][name] == 0:
            raise AssertionError(f"{name} was not launched by the API phase")
    # the examples run in their own processes: their launches are not
    # counted here
    print("examples:", json.dumps([
        example_line("sim", "Received 100 packets", root),
        example_line("transceiver", "Received 10/10 packets", root)]),
        flush=True)
    print("api udp live examples:", json.dumps(live_udp_examples(root)),
          flush=True)
    for rec in ({"launches": ab_launches},
                cfo_stream_phase(dense["samples_per_s"]),
                ber_phase(root), api):
        for name, count in rec["launches"].items():
            launches[name] += count
    vp = "fun_ofdm_tpu/ops/viterbi_pallas.py"
    print(json.dumps({"kernels": [
        kernel_record("acs", f"{vp}:261", cases, launches),
        kernel_record("chainback", f"{vp}:394", cases, launches),
        dict(kernel_record("blocked_decode", f"{vp}:571", blocked, launches),
             cases=[c["case"] for c in blocked],
             ptxas={k: report[k] for k in ("blocked_window_kernel",
                                           "blocked_guard_kernel")},
             smem_dynamic_bytes={
                 c["win"]: viterbi_cuda.build().viterbi_blocked_smem(c["win"])
                 for c in blocked}),
        kernel_record("acs_ablate", "tools/viterbi_acs_ab.py:148", ablate,
                      launches),
        {"name": "detect_frames", "route": "cuda",
         "source": "fun_ofdm_tpu_torch/csrc/detect.cu", "replaces": None,
         "launches": launches["detect_frames"], "cases": detect,
         "ptxas": ptxas_report(
             detect_cuda.library_path().with_suffix(".log").read_text()),
         "library_ms": None},
        {"name": "softbits", "route": "cuda",
         "source": "fun_ofdm_tpu_torch/csrc/softbits.cu", "replaces": None,
         "launches": launches["softbits"], "cases": softbits,
         "max_abs_err": 0, "ms": softbits[0]["ms"],
         "plain_ms": {"gather": softbits[0]["gather_ms"]},
         "bound_ms": softbits[0]["bound_ms"], "bound_by": "bytes",
         "ptxas": ptxas_report(
             softbits_cuda.library_path().with_suffix(".log").read_text()),
         "library_ms": None},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
