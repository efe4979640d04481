"""A/B of design choices in csrc/viterbi.cu, built side by side on one card.

    python -m fun_ofdm_tpu_torch.tools.viterbi_variants_ab [--nbits 12090]
        [--batches 128,256,512] [--reps 10]

Each variant is the production source with one choice undone by a text
edit (VARIANTS: the ACS loop unrolled by 4 or 16 instead of 32, the
renormalisation's minimum and trigger taken after the compare-select,
128-step chainback segments, segment maps without the merged-paths
shortcut); all are compiled at once (one nvcc each, in parallel)
into a scratch directory, and each one's ACS and chainback are timed
(CUDA events, the C entry points called directly, so no wrapper overhead)
beside the production build's, on the A/B harness's seeded input, after
checking that its decisions and bits equal the production kernels'. Prints
one JSON object: {"device", "registers": {variant: acs_kernel's},
"ms": {batch: {variant: [acs ms, chainback ms]}}}. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import tempfile
from pathlib import Path

import torch

from ..ops import viterbi, viterbi_cuda
from .viterbi_acs_ab import make_soft

_RENORM_EARLY = """        if constexpr (kRenorm) {
          // the minimum of the new metrics, from the old ones"""
_RENORM_END = """        m_hi = min(c_lo_b, c_hi_b);
      }
"""
_RENORM_AFTER = """        m_lo = min(c_lo_a, c_hi_a);
        m_hi = min(c_lo_b, c_hi_b);
        if constexpr (kRenorm) {
          const int low = __reduce_min_sync(kFull, min(m_lo, m_hi));
          const int z = __shfl_sync(kFull, m_lo, 0);
          off = z - off > 210 ? low : off;
        }
      }
"""
_UNROLLED = """    if (n_in == 32) {
#pragma unroll
      for (int i = 0; i < 32; ++i) step(i);
    } else {"""


def _unroll(n: int):
    def edit(src: str) -> str:
        return _replace(src, _UNROLLED, _UNROLLED.replace(
            "#pragma unroll\n", f"#pragma unroll {n}\n"))
    return edit


def _renorm_after_acs(src: str) -> str:
    """The renormalisation's minimum and trigger from the new metrics,
    after the compare-select (the offset form kept)."""
    i0 = src.index(_RENORM_EARLY)
    i1 = src.index(_RENORM_END, i0) + len(_RENORM_END)
    return src[:i0] + _RENORM_AFTER + src[i1:]


def _replace(src: str, old: str, new: str) -> str:
    if old not in src:
        raise ValueError(f"the source no longer holds {old[:60]!r}")
    return src.replace(old, new)


#: name -> the edit of the production source that makes the variant
VARIANTS = {
    "unroll4": _unroll(4),
    "unroll16": _unroll(16),
    "renorm_after_acs": _renorm_after_acs,
    "segment128": lambda src: _replace(src, "constexpr int kSeg = 256;",
                                       "constexpr int kSeg = 128;"),
    # the segment maps without the merged-paths shortcut: every warp walks
    # all 64 start states through its whole segment
    "maps_full_walk": lambda src: _replace(
        src, "agree = __all_sync(kFull, sa == sb && sa == s0);",
        "agree = false;"),
}


def _build(sources: dict, workdir: Path) -> dict:
    """{name: source} -> {name: (ctypes library, acs_kernel registers)}."""
    procs = {}
    for name, text in sources.items():
        cu = workdir / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [viterbi_cuda._nvcc(), *viterbi_cuda.NVCC_FLAGS, "-o",
             str(workdir / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out = {}
    for name, proc in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{stderr}")
        regs = re.search(r"10acs_kernel\w*\n[^\n]*\nptxas info\s*: Used "
                         r"(\d+) registers", stdout + stderr)
        lib = ctypes.CDLL(str(workdir / f"{name}.so"))
        ptr, cint = ctypes.c_void_p, ctypes.c_int
        lib.viterbi_acs.argtypes = [ptr, ptr, ptr, ptr, cint, cint, cint, ptr]
        lib.viterbi_chainback.argtypes = [ptr, ptr, ptr, ptr, cint, cint, ptr]
        lib.viterbi_chainback_segment.restype = cint
        out[name] = (lib, int(regs.group(1)) if regs else None)
    return out


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


def run(nbits: int = 12090, batches=(128, 256, 512), reps: int = 10) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    src = viterbi_cuda.SOURCE.read_text()
    sources = {"production": src}
    sources.update({name: edit(src) for name, edit in VARIANTS.items()})
    with tempfile.TemporaryDirectory() as tmp:
        libs = _build(sources, Path(tmp))
        stream = torch.cuda.current_stream().cuda_stream
        ms = {}
        for bsz in batches:
            soft = torch.from_numpy(make_soft(bsz, nbits)).cuda()
            steps = viterbi.step_counts(nbits, None, (bsz,), "cuda")
            init = torch.ones_like(steps)
            ref_dec = ref_bits = None
            ms[bsz] = {}
            for name, (lib, _) in libs.items():
                dec = torch.empty((nbits + 6, bsz), dtype=torch.int64,
                                  device="cuda")
                n_seg = -(-nbits // lib.viterbi_chainback_segment())
                maps = torch.empty((n_seg, bsz, 64), dtype=torch.uint8,
                                   device="cuda")
                starts = torch.empty((n_seg, bsz), dtype=torch.int32,
                                     device="cuda")
                bits = torch.empty((nbits, bsz), dtype=torch.int32,
                                   device="cuda")

                def acs(lib=lib, dec=dec):
                    lib.viterbi_acs(soft.data_ptr(), steps.data_ptr(),
                                    init.data_ptr(), dec.data_ptr(), bsz,
                                    soft.shape[1], nbits + 6, stream)

                def chainback(lib=lib, dec=dec, maps=maps, starts=starts,
                              bits=bits):
                    lib.viterbi_chainback(dec.data_ptr(), bits.data_ptr(),
                                          maps.data_ptr(), starts.data_ptr(),
                                          bsz, nbits + 6, stream)

                acs()
                chainback()
                torch.cuda.synchronize()
                if ref_dec is None:
                    ref_dec, ref_bits = dec.clone(), bits.clone()
                elif not (torch.equal(dec, ref_dec)
                          and torch.equal(bits, ref_bits)):
                    raise AssertionError(f"{name} differs from production")
                ms[bsz][name] = [_event_ms(acs, reps),
                                 _event_ms(chainback, reps)]
    return {"device": torch.cuda.get_device_name(0),
            "registers": {n: r for n, (_, r) in libs.items()}, "ms": ms}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m fun_ofdm_tpu_torch.tools.viterbi_variants_ab",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--nbits", type=int, default=12090)
    ap.add_argument("--batches", default="128,256,512")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    print(json.dumps(run(args.nbits, tuple(
        int(b) for b in args.batches.split(",")), args.reps)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
