"""A/B of the block-overlap decode's kernels, built side by side on one card.

    python -m fun_ofdm_tpu_torch.tools.blocked_variants_ab
        [--cases 4x12090,16x12090,64x12090,64x16194] [--reps 50]
        [--noise 100] [--baseline OLD_VITERBI_CU]

Times the block-overlap decode through its C entry point alone (no
wrapper, outputs allocated once; CUDA events, mean of --reps calls after
a warm-up) at the streaming chain's buckets of 4, 16 and 64 frames of a
1500-byte RATE_3_4_QAM16 frame (12,090 bits) and at 64 frames of the
all-rates chain's longest any-rate trellis (16,194 bits), 16 blocks,
warm-up 128, on seeded soft pairs of random coded bits with uniform
noise of +-noise (100 by default, the A/B harness's recipe; near 255 the
pairs carry little information and survivor paths merge late); and each
kernel's device time
(torch.profiler over --reps calls). The libraries, all compiled at once
(one nvcc each, in parallel) into a scratch directory:
  * production: csrc/viterbi.cu (`viterbi_blocked_decode`: the window
    kernel, whose traceback walks each lane's 32-step segment from state
    0 and corrects it from its true entry until the paths meet, and the
    guard kernel);
  * serial_walk: the production source with the traceback done by one
    lane walking the whole window from state 0 (a chain of win + 5
    dependent steps);
  * segment_maps: the production source with the chainback's scheme in
    the warp: each lane walks its segment from all 64 states (its map),
    one lane composes the maps from state 0, each lane walks its segment
    from its start state;
  * baseline (with --baseline): an older viterbi.cu that has the
    three-call block-overlap pipeline (`viterbi_acs_windowed`,
    `viterbi_chainback` on the window decisions, `viterbi_splice_guard`),
    e.g. `git show bea8261:fun_ofdm_tpu_torch/csrc/viterbi.cu`, timed as
    its three C calls.
Every library's bits and merge flags must equal production's. Prints one
JSON object: {"device", "card" (nvidia-smi name and power limit),
"registers": {library: {kernel: registers}}, "entry_ms": {case:
{library: ms}}, "device_ms": {case: {library: {kernel: ms}}}}. Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from ..ops import convcode, nvcc, viterbi, viterbi_blocked, viterbi_cuda

_TRACE_START = "  // the traceback."
_TRACE_END = "  // the window's span of the output\n"
_SERIAL_WALK = """  // one lane walks the whole window from state 0
  if (lane == 0) {
    unsigned z = 0u;
    for (int w = nw - 1; w >= 0; --w) {
      const unsigned long long* seg = sm.words + w * 33;
      unsigned acc = 0u;
      for (int i = 31; i >= 0; --i) {
        z = trace_step(z, seg[i]);
        acc = (acc << 1) | (z >> 31);
      }
      sm.out[w] = acc;
    }
    sm.out[nw] = 0u;
  }
  __syncwarp();

"""
_SEGMENT_MAPS = """  // each segment's map of the 64 states at its top, the maps
  // composed from state 0 by one lane, each segment walked from its
  // start state
  unsigned char* maps = sm.scratch;                       // nw x 68
  int* starts = reinterpret_cast<int*>(maps + (size_t)nw * 68);
  for (int w = lane; w < nw; w += 32) {
    const unsigned long long* seg = sm.words + w * 33;
    unsigned z[64];
#pragma unroll
    for (int x = 0; x < 64; ++x) z[x] = static_cast<unsigned>(x) << 26;
#pragma unroll 2
    for (int i = 31; i >= 0; --i) {
      const unsigned long long word = seg[i];
#pragma unroll
      for (int x = 0; x < 64; ++x) z[x] = trace_step(z[x], word);
    }
    unsigned* map = reinterpret_cast<unsigned*>(maps + w * 68);
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      map[q] = (z[4 * q] >> 26) | (z[4 * q + 1] >> 26) << 8
             | (z[4 * q + 2] >> 26) << 16 | (z[4 * q + 3] >> 26) << 24;
    }
  }
  __syncwarp();
  if (lane == 0) {
    int s = 0;
    for (int w = nw - 1; w >= 0; --w) {
      starts[w] = s;
      s = maps[w * 68 + s];
    }
    sm.out[nw] = 0u;
  }
  __syncwarp();
  for (int w = lane; w < nw; w += 32) {
    const unsigned long long* seg = sm.words + w * 33;
    unsigned z = static_cast<unsigned>(starts[w]) << 26;
    unsigned acc = 0u;
#pragma unroll 8
    for (int i = 31; i >= 0; --i) {
      z = trace_step(z, seg[i]);
      acc = (acc << 1) | (z >> 31);
    }
    sm.out[w] = acc;
  }
  __syncwarp();

"""


def _traceback(body: str, trace_bytes: int | None = None):
    """The edit that puts `body` in place of the window kernel's
    traceback, and sizes its scratch at trace_bytes a word if given."""
    def edit(src: str) -> str:
        i0 = src.index(_TRACE_START)
        i1 = src.index(_TRACE_END, i0)
        src = src[:i0] + body + src[i1:]
        if trace_bytes is not None:
            old = "constexpr int kTraceBytes = 48;"
            if old not in src:
                raise ValueError(f"the source no longer holds {old!r}")
            src = src.replace(old, f"constexpr int kTraceBytes = "
                                   f"{trace_bytes};")
        return src
    return edit


#: name -> the edit of the production source that makes the variant
VARIANTS = {"serial_walk": _traceback(_SERIAL_WALK),
            "segment_maps": _traceback(_SEGMENT_MAPS, 72)}


def _registers(log: str) -> dict:
    out, name = {}, None
    for ln in log.splitlines():
        entry = re.search(r"entry function '\w*?\d+([a-z_]+_kernel)", ln)
        if entry:
            name = entry.group(1)
        regs = re.search(r"Used (\d+) registers", ln)
        if regs and name:
            out[name] = int(regs.group(1))
            name = None
    return out


def _build(sources: dict, workdir: Path) -> dict:
    """{name: source} -> {name: (ctypes library, {kernel: registers})}."""
    procs = {}
    for name, text in sources.items():
        cu = workdir / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc.compiler(), *nvcc.FLAGS, "-o",
             str(workdir / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out = {}
    ptr, cint = ctypes.c_void_p, ctypes.c_int
    for name, proc in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{stderr}")
        lib = ctypes.CDLL(str(workdir / f"{name}.so"))
        if hasattr(lib, "viterbi_blocked_decode"):
            lib.viterbi_blocked_decode.argtypes = [ptr] * 5 + [cint] * 9 + [
                ptr]
        else:
            lib.viterbi_acs_windowed.argtypes = [ptr, ptr, ptr] + [cint] * 6 + [
                ptr]
            lib.viterbi_chainback.argtypes = [ptr] * 4 + [cint] * 2 + [ptr]
            lib.viterbi_chainback_segment.restype = cint
            lib.viterbi_splice_guard.argtypes = [ptr] * 4 + [cint] * 7 + [
                ptr]
        out[name] = (lib, _registers(stdout + stderr))
    return out


def _decoder(lib, soft: torch.Tensor, steps: torch.Tensor, geo):
    """A no-argument call of lib's block-overlap decode on (soft, steps)
    into outputs allocated here, and a function returning (bits, flags)."""
    frames, width = soft.shape
    dev = soft.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    bits = torch.empty((frames, geo.nbits), dtype=torch.int32, device=dev)
    if hasattr(lib, "viterbi_blocked_decode"):
        ok = torch.empty((frames,), dtype=torch.bool, device=dev)
        overlaps = torch.empty(
            (frames * geo.n_blocks, 2, viterbi_blocked.overlap_words(geo)),
            dtype=torch.int32, device=dev)

        def call():
            lib.viterbi_blocked_decode(
                soft.data_ptr(), steps.data_ptr(), bits.data_ptr(),
                ok.data_ptr(), overlaps.data_ptr(), frames, width,
                geo.n_blocks, geo.nbits, geo.tb, geo.wf, geo.win, geo.ov,
                geo.trim, stream)
        return call, lambda: (bits, ok)
    lanes = frames * geo.n_blocks
    total = geo.win + viterbi.K - 1
    n_seg = -(-geo.win // lib.viterbi_chainback_segment())
    dec = torch.empty((total, lanes), dtype=torch.int64, device=dev)
    win_bits = torch.empty((geo.win, lanes), dtype=torch.int32, device=dev)
    maps = torch.empty((n_seg, lanes, 64), dtype=torch.uint8, device=dev)
    starts = torch.empty((n_seg, lanes), dtype=torch.int32, device=dev)
    ok = torch.empty((frames,), dtype=torch.int32, device=dev)

    def call():
        lib.viterbi_acs_windowed(soft.data_ptr(), steps.data_ptr(),
                                 dec.data_ptr(), lanes, width, geo.n_blocks,
                                 geo.tb, geo.wf, geo.win, stream)
        lib.viterbi_chainback(dec.data_ptr(), win_bits.data_ptr(),
                              maps.data_ptr(), starts.data_ptr(), lanes,
                              total, stream)
        lib.viterbi_splice_guard(win_bits.data_ptr(), steps.data_ptr(),
                                 bits.data_ptr(), ok.data_ptr(), frames,
                                 geo.n_blocks, geo.nbits, geo.tb, geo.wf,
                                 geo.ov, geo.trim, stream)
    return call, lambda: (bits, ok.bool())


def _event_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _kernel_ms(fn, reps: int) -> dict:
    """{kernel: device ms per launch} over reps calls (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        m = re.search(r"(\w+_kernel)", e.key)
        if m and e.self_device_time_total > 0:
            out[m.group(1)] = e.self_device_time_total / 1e3 / e.count
    return out


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=False, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout else "unknown"


def _soft(frames: int, nbits: int, noise: int) -> torch.Tensor:
    """(frames, 2 (nbits + 6)) int32 soft pairs on the card, seeded by the
    shape."""
    rng = np.random.default_rng(frames * 100003 + nbits)
    bits = torch.from_numpy(rng.integers(0, 2, size=(frames, nbits + 6)))
    coded = convcode.conv_encode(bits).numpy()
    soft = coded * 255 + rng.integers(-noise, noise + 1, coded.shape)
    return torch.from_numpy(np.clip(soft, 0, 255).astype(np.int32)).cuda()


def run(cases=((4, 12090), (16, 12090), (64, 12090), (64, 16194)),
        reps: int = 50, baseline: str | None = None,
        noise: int = 100) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    src = viterbi_cuda.SOURCE.read_text()
    sources = {"production": src}
    sources.update({name: edit(src) for name, edit in VARIANTS.items()})
    if baseline:
        sources["baseline"] = Path(baseline).read_text()
    entry, device = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        libs = _build(sources, Path(tmp))
        for frames, nbits in cases:
            key = f"{frames}x{nbits}"
            soft = _soft(frames, nbits, noise)
            steps = viterbi.step_counts(nbits, None, (frames,), "cuda")
            geo = viterbi_blocked.geometry(nbits)
            entry[key], device[key] = {}, {}
            want = None
            for name, (lib, _) in libs.items():
                call, result = _decoder(lib, soft, steps, geo)
                call()
                torch.cuda.synchronize()
                bits, ok = result()
                if want is None:
                    want = (bits.clone(), ok.clone())
                elif not (torch.equal(bits, want[0])
                          and torch.equal(ok, want[1])):
                    raise AssertionError(f"{name} differs from production "
                                         f"at {key}")
                entry[key][name] = _event_ms(call, reps)
                device[key][name] = _kernel_ms(call, reps)
    return {"device": torch.cuda.get_device_name(0), "card": _card(),
            "noise": noise,
            "registers": {n: r for n, (_, r) in libs.items()},
            "entry_ms": entry, "device_ms": device}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m fun_ofdm_tpu_torch.tools.blocked_variants_ab",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--cases", default="4x12090,16x12090,64x12090,64x16194",
                    help="frames x nbits, comma-separated")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--noise", type=int, default=100)
    ap.add_argument("--baseline", default=None,
                    help="an older viterbi.cu with the three-call pipeline")
    args = ap.parse_args(argv)
    cases = tuple(tuple(int(v) for v in c.split("x"))
                  for c in args.cases.split(","))
    print(json.dumps(run(cases, args.reps, args.baseline, args.noise)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
