#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (fun_ofdm_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printed as it ends; any failure raises and exits nonzero:
  1. the card's name and power limit (nvidia-smi);
  2. building the CUDA Viterbi from csrc/viterbi.cu (nvcc, sm_90a), with
     the compiler's register report;
  3. each kernel against its plain PyTorch version on the card, on the
     same inputs, bit-exact (tolerance 0): the dense capture's shape
     (512 frames x 12,090 bits), an 18-bit header batch, all-erasure and
     hard 0/255 inputs, mixed per-frame lengths and uniform init; with
     both times (CUDA events);
  4. the main path at bench_capture's geometry: build_frame_p for 16
     channels, each 32 back-to-back 1500-byte RATE_3_4_QAM16 frames and
     a 2048-sample zero tail (3,678,208 samples), then receive_capture_p
     on the card; asserts 512/512 crc_ok with the seeded payloads, that
     each kernel was launched, and times the receive (host wall clock
     to torch.cuda.synchronize(), mean of 10 calls after 3 warm-ups).
The last two lines are a JSON object with one entry per kernel and the
JSON result line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

RATE_NAME = "RATE_3_4_QAM16"
LENGTH = 1500
CHANNELS = 16
FRAMES_PER_CHANNEL = 32
TAIL = 2048
SEED = 0


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
    rec = {"case": name, "batch": bsz, "nbits": nbits,
           "acs_max_abs_err": acs_err, "chainback_max_abs_err": cb_err,
           "acs_plain_ms": acs_plain_ms, "chainback_plain_ms": cb_plain_ms}
    if timed:
        rec["acs_ms"] = cuda_ms(lambda: viterbi_cuda.acs(soft, steps, init_t),
                                reps=5)
        rec["chainback_ms"] = cuda_ms(
            lambda: viterbi_cuda.chainback(words, nbits), reps=5)
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
    return [
        kernel_case("capture", noisy_soft(rng, frames, nbits, 100), nbits,
                    timed=True),
        kernel_case("header", noisy_soft(rng, frames, 18, 100), 18),
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
    for name, count in launches.items():
        if count == 0:
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
    rec = {"samples": n_samples, "frames": expected,
           "crc_ok": int(crc_ok.sum()), "launches": launches,
           "receive_wall_ms": wall_s * 1e3,
           "receive_samples_per_s": n_samples / wall_s,
           "tx_build_ms": tx_ms,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    print("slice:", json.dumps(rec), flush=True)
    return rec, launches


def kernel_record(kernel: str, line: int, cases: list, launches: dict):
    """The result entry of kernel "acs" or "chainback"; `line` is where
    its TPU counterpart (the radix-4 kernel the TPU path runs) starts."""
    name = f"viterbi_{kernel}"
    return {"name": name, "route": "cuda",
            "source": "fun_ofdm_tpu_torch/csrc/viterbi.cu",
            "replaces": f"fun_ofdm_tpu/ops/viterbi_pallas.py:{line}",
            "launches": launches[name],
            "max_abs_err": max(c[f"{kernel}_max_abs_err"] for c in cases),
            "ms": cases[0][f"{kernel}_ms"],
            "plain_ms": cases[0][f"{kernel}_plain_ms"]}


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
    report = [ln.strip() for ln in log.read_text().splitlines()
              if "registers" in ln] if log.exists() else []
    print(f"build: {build_s:.2f} s; " + " | ".join(report), flush=True)

    cases = kernel_phase()
    _, launches = slice_phase()
    print(json.dumps({"kernels": [
        kernel_record("acs", 261, cases, launches),
        kernel_record("chainback", 394, cases, launches),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
