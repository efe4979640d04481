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
     to torch.cuda.synchronize(), mean of 10 calls after 3 warm-ups);
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
     samples per channel; every frame delivered with its channel.
Each main-path phase (4, 6-9) sets the kernels' launch counts to 0 just
before it runs and reads them just after. The last two lines are a JSON
object with one entry per kernel and the JSON result line
{"ok": true, "device": {...}}.
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
#: where the streaming phases (6-9) run
DEVICE = "cuda"


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
    rec = {"samples": n_samples, "frames": expected,
           "crc_ok": int(crc_ok.sum()), "launches": launches,
           "receive_wall_ms": wall_s * 1e3,
           "receive_samples_per_s": n_samples / wall_s,
           "tx_build_ms": tx_ms,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    print("slice:", json.dumps(rec), flush=True)
    return rec, launches


def kernel_record(kernel: str, line: int, cases: list, launches: dict):
    """The result entry of kernel "acs", "chainback", "acs_windowed" or
    "splice_guard"; `line` is where its TPU counterpart starts (for the
    exact pair, the radix-4 kernel the TPU path runs). The first case of
    `cases` is the timed one."""
    name = f"viterbi_{kernel}"
    return {"name": name, "route": "cuda",
            "source": "fun_ofdm_tpu_torch/csrc/viterbi.cu",
            "replaces": f"fun_ofdm_tpu/ops/viterbi_pallas.py:{line}",
            "launches": launches[name],
            "max_abs_err": max(c[f"{kernel}_max_abs_err"] for c in cases),
            "ms": cases[0][f"{kernel}_ms"],
            "plain_ms": cases[0][f"{kernel}_plain_ms"]}


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


def profile_feed(chain, pieces) -> dict:
    """torch.profiler over feeding `pieces` into a chain already in
    steady state: host wall ms, device busy ms (the sum of the device time
    of every kernel and copy, which run one at a time on the one stream)
    and the busiest kernels. The profiler's own overhead lengthens the
    wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        for p in pieces:
            chain.process_samples(p)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.self_device_time_total > 0]
    busy_ms = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "busy_share": busy_ms / wall_ms,
            "top": [[k[:60], ms, n] for k, ms, n in rows[:8]]}


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
    blocked = blocked_phase()
    for rec in (dense_stream_phase(), sparse_stream_phase(),
                all_rates_phase(), multichannel_phase()):
        for name, count in rec["launches"].items():
            launches[name] += count
    print(json.dumps({"kernels": [
        kernel_record("acs", 261, cases, launches),
        kernel_record("chainback", 394, cases + blocked, launches),
        kernel_record("acs_windowed", 571, blocked, launches),
        kernel_record("splice_guard", 644, blocked, launches),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
