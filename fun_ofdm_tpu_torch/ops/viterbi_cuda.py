"""The hand-written CUDA Viterbi (csrc/viterbi.cu), bound with ctypes.

The kernels replace the Pallas kernels of fun_ofdm_tpu/ops/viterbi_pallas.py:
forward ACS and survivor chainback (radix 4 and radix 2), and the
block-overlap decode `_blocked_decode_impl` (a windowed ACS, the same
chainback, and a splice + merge-guard kernel), and the ACS ablation
variants of tools/viterbi_acs_ab.py (`acs_ablate`). The source is
compiled with nvcc for sm_90a into a shared library with a plain C
interface, at first use, into csrc/build/ (keyed by a hash of the source
and flags); importing this module builds nothing. Each wrapper checks its
tensors, launches on the current CUDA stream, raises when the launch
fails, and counts its calls in `launches` (one per call, also where a
call is several kernel launches, as chainback's three).

What bounds them on the H100, and what the design does (the note at the
top of csrc/viterbi.cu has the detail):
  * acs: the serial steps of one warp per frame (~12k a 1500-byte frame),
    each its dependency chain and its instructions dispatched in order; the
    renormalisation's minimum and trigger are taken from the old metrics
    and its subtraction deferred into a uniform offset, the step's branch
    metrics come packed in one shuffle, the decisions are stored once per
    32 steps, and the 32-step loop is unrolled, leaving a shuffle, an
    add-min and a min on the chain;
  * chainback: a per-frame traceback is a chain of device-memory round
    trips; it runs as segment maps (all 64 start states of a 256-step
    segment, words staged in shared memory), their composition from
    state 0, and a walk of every segment from its start state, in
    parallel over (segment, 16-frame group); exact, with no assumption
    that the survivor paths merge.

The plain versions are ops/viterbi.acs_plain and ops/viterbi.chainback_plain
(the kernels' own algebra: ops/viterbi.acs_early_plain and
ops/viterbi.chainback_segmented_plain, used by the tests), for the
block-overlap pair ops/viterbi_blocked.acs_windowed_plain and
ops/viterbi_blocked.splice_guard_plain, and for the ablation variants
ops/viterbi_ab.acs_ablate_plain.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

K = 7
SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "viterbi.cu"
BUILD_DIR = SOURCE.parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: kernel launches since the last reset_launches(), by kernel name
launches = {"viterbi_acs": 0, "viterbi_chainback": 0,
            "viterbi_acs_windowed": 0, "viterbi_splice_guard": 0,
            "viterbi_acs_ablate": 0}

#: the ACS ablation variants, in csrc/viterbi.cu's AcsMode order
ABLATE_MODES = ("full", "norenorm", "noshuffle", "nostore", "minimal",
                "unrolled")


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path() -> Path:
    """Where the built library for the current source and flags lives."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libviterbi_{digest[:16]}.so"


@functools.lru_cache(maxsize=None)
def build() -> ctypes.CDLL:
    """Compile the kernels (once per source version) and load them.

    The compiler's report (registers, spills, shared memory per kernel)
    is kept beside the library, with the suffix .log.
    """
    lib_path = library_path()
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
            capture_output=True, text=True, check=False)
        lib_path.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed with code {proc.returncode}:\n{proc.stderr}")
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    ptr, cint = ctypes.c_void_p, ctypes.c_int
    lib.viterbi_acs.argtypes = [ptr, ptr, ptr, ptr, cint, cint, cint, ptr]
    lib.viterbi_acs.restype = cint
    lib.viterbi_chainback.argtypes = [ptr, ptr, ptr, ptr, cint, cint, ptr]
    lib.viterbi_chainback.restype = cint
    lib.viterbi_chainback_segment.argtypes = []
    lib.viterbi_chainback_segment.restype = cint
    lib.viterbi_acs_windowed.argtypes = [ptr, ptr, ptr, cint, cint, cint,
                                         cint, cint, cint, ptr]
    lib.viterbi_acs_windowed.restype = cint
    lib.viterbi_splice_guard.argtypes = [ptr, ptr, ptr, ptr, cint, cint, cint,
                                         cint, cint, cint, cint, ptr]
    lib.viterbi_splice_guard.restype = cint
    lib.viterbi_acs_ablate.argtypes = [ptr, ptr, ptr, ptr, ptr, cint, cint,
                                       cint, cint, ptr]
    lib.viterbi_acs_ablate.restype = cint
    return lib


def _check(x: torch.Tensor, name: str, dtype: torch.dtype,
           shape: tuple) -> None:
    if not x.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _acs_inputs(soft: torch.Tensor, steps: torch.Tensor,
                init: torch.Tensor):
    """Check acs's inputs; returns (B, 2T, T, steps clamped to T)."""
    if soft.dim() != 2 or soft.shape[1] % 2:
        raise ValueError(f"soft must be (B, 2T), got {tuple(soft.shape)}")
    bsz, width = soft.shape
    _check(soft, "soft", torch.int32, (bsz, width))
    _check(steps, "steps", torch.int32, (bsz,))
    _check(init, "init", torch.int32, (bsz,))
    if not (steps.device == init.device == soft.device):
        raise ValueError("soft, steps and init must be on one device")
    if soft.data_ptr() % 8:
        raise ValueError("soft must be 8-byte aligned")
    # a count past the trellis would read past the row
    return bsz, width, width // 2, torch.clamp(steps, 0, width // 2)


def acs(soft: torch.Tensor, steps: torch.Tensor,
        init: torch.Tensor) -> torch.Tensor:
    """Forward ACS on the card.

    soft: (B, 2T) int32 soft pairs, 8-byte aligned; steps: (B,) int32
    per-frame step counts (even, <= T); init: (B,) int32, 1 = exact,
    0 = uniform. Returns (T, B) int64 decision words: bit s of word
    [t, b] is state s's decision at step t, zero for t >= steps[b].
    """
    bsz, width, total, steps = _acs_inputs(soft, steps, init)
    dec = torch.empty((total, bsz), dtype=torch.int64, device=soft.device)
    if bsz == 0:
        return dec
    lib = build()
    with torch.cuda.device(soft.device):
        err = lib.viterbi_acs(soft.data_ptr(), steps.data_ptr(),
                              init.data_ptr(), dec.data_ptr(), bsz, width,
                              total, _stream(soft.device))
    launches["viterbi_acs"] += 1
    if err:
        raise RuntimeError(f"viterbi_acs launch failed: CUDA error {err}")
    return dec


def chainback(dec: torch.Tensor, nbits: int) -> torch.Tensor:
    """Survivor chainback on the card.

    dec: (nbits + 6, B) int64 decision words from acs. Returns the
    (B, nbits) int32 decoded bits (a transposed view of the kernels'
    (nbits, B) output). One call is one launch for a trellis of at most
    one segment (csrc/viterbi.cu, kSeg steps) and three otherwise (the
    segment maps, their composition, the walk), with scratch of
    n_seg x B x 68 bytes; it counts as one launch of viterbi_chainback.
    """
    if dec.dim() != 2 or dec.shape[0] != nbits + K - 1:
        raise ValueError(f"dec must be ({nbits + K - 1}, B), got "
                         f"{tuple(dec.shape)}")
    bsz = dec.shape[1]
    _check(dec, "dec", torch.int64, (nbits + K - 1, bsz))
    out = torch.empty((nbits, bsz), dtype=torch.int32, device=dec.device)
    if bsz == 0 or nbits == 0:
        return out.T
    lib = build()
    n_seg = -(-nbits // lib.viterbi_chainback_segment())
    maps = starts = None
    if n_seg > 1:
        maps = torch.empty((n_seg, bsz, 64), dtype=torch.uint8,
                           device=dec.device)
        starts = torch.empty((n_seg, bsz), dtype=torch.int32,
                             device=dec.device)
    with torch.cuda.device(dec.device):
        err = lib.viterbi_chainback(
            dec.data_ptr(), out.data_ptr(),
            None if maps is None else maps.data_ptr(),
            None if starts is None else starts.data_ptr(), bsz,
            nbits + K - 1, _stream(dec.device))
    launches["viterbi_chainback"] += 1
    if err:
        raise RuntimeError(f"viterbi_chainback launch failed: CUDA error {err}")
    return out.T


def decode(soft: torch.Tensor, steps: torch.Tensor, init: torch.Tensor,
           nbits: int) -> torch.Tensor:
    """(B, 2*(nbits+6)) soft -> (B, nbits) int32 bits on the card."""
    if soft.dim() != 2 or soft.shape[1] != 2 * (nbits + K - 1):
        raise ValueError(f"soft must be (B, {2 * (nbits + K - 1)}), got "
                         f"{tuple(soft.shape)}")
    return chainback(acs(soft, steps, init), nbits)


def acs_windowed(soft: torch.Tensor, steps: torch.Tensor, n_blocks: int,
                 tb: int, wf: int, win: int) -> torch.Tensor:
    """Forward ACS of every (frame, block) window on the card.

    soft: (F, 2T) int32 soft pairs, 8-byte aligned; steps: (F,) int32
    per-frame even step counts <= T. Lane b = f * n_blocks + blk runs
    window blk of frame f: from trellis step max(0, blk * tb - wf), for
    min(max(steps[f] - that, 0), win) steps, exact init for blk 0 and
    uniform for the others. Returns (win + 6, F * n_blocks) int64
    decision words, zero past each lane's count.
    """
    if soft.dim() != 2 or soft.shape[1] % 2:
        raise ValueError(f"soft must be (F, 2T), got {tuple(soft.shape)}")
    frames, width = soft.shape
    _check(soft, "soft", torch.int32, (frames, width))
    _check(steps, "steps", torch.int32, (frames,))
    if steps.device != soft.device:
        raise ValueError("soft and steps must be on one device")
    if soft.data_ptr() % 8:
        raise ValueError("soft must be 8-byte aligned")
    if n_blocks < 1 or min(tb, wf, win) < 0:
        raise ValueError("n_blocks must be >= 1 and tb, wf, win >= 0")
    # a count past the trellis would read past the row
    steps = torch.clamp(steps, 0, width // 2)
    lanes = frames * n_blocks
    dec = torch.empty((win + K - 1, lanes), dtype=torch.int64,
                      device=soft.device)
    if lanes == 0:
        return dec
    lib = build()
    with torch.cuda.device(soft.device):
        err = lib.viterbi_acs_windowed(soft.data_ptr(), steps.data_ptr(),
                                       dec.data_ptr(), lanes, width, n_blocks,
                                       tb, wf, win, _stream(soft.device))
    launches["viterbi_acs_windowed"] += 1
    if err:
        raise RuntimeError(
            f"viterbi_acs_windowed launch failed: CUDA error {err}")
    return dec


def splice_guard(win_bits: torch.Tensor, steps: torch.Tensor, nbits: int,
                 n_blocks: int, tb: int, wf: int, ov: int, trim: int):
    """Splice the windows' bits into frames and run the merge guard.

    win_bits: (win, F * n_blocks) int32, the chainback's output layout;
    steps: (F,) int32 per-frame step counts. Returns ((F, nbits) int32
    bits, (F,) bool merge flags).
    """
    lanes = win_bits.shape[1] if win_bits.dim() == 2 else -1
    frames = steps.shape[0] if steps.dim() == 1 else -1
    if lanes != frames * n_blocks:
        raise ValueError(f"win_bits must be (win, {frames} * {n_blocks}), "
                         f"got {tuple(win_bits.shape)}")
    _check(win_bits, "win_bits", torch.int32, tuple(win_bits.shape))
    _check(steps, "steps", torch.int32, (frames,))
    if steps.device != win_bits.device:
        raise ValueError("win_bits and steps must be on one device")
    if tb * n_blocks < nbits or win_bits.shape[0] < tb + ov or tb < wf:
        raise ValueError("the block geometry does not cover the splice")
    bits = torch.empty((frames, nbits), dtype=torch.int32,
                       device=win_bits.device)
    ok = torch.empty((frames,), dtype=torch.int32, device=win_bits.device)
    if frames == 0:
        return bits, ok.bool()
    lib = build()
    with torch.cuda.device(win_bits.device):
        err = lib.viterbi_splice_guard(
            win_bits.data_ptr(), steps.data_ptr(), bits.data_ptr(),
            ok.data_ptr(), frames, n_blocks, nbits, tb, wf, ov, trim,
            _stream(win_bits.device))
    launches["viterbi_splice_guard"] += 1
    if err:
        raise RuntimeError(
            f"viterbi_splice_guard launch failed: CUDA error {err}")
    return bits, ok.bool()


def acs_ablate(soft: torch.Tensor, steps: torch.Tensor, init: torch.Tensor,
               mode: str):
    """One ACS ablation variant on the card (csrc/viterbi.cu, AcsMode).

    Same inputs as acs. mode: one of ABLATE_MODES. Returns (final
    metrics (B, 64) int32, lane l's two metrics at l and 32 + l; decision
    words (T, B) int64 as acs returns them, or None for "nostore").
    """
    if mode not in ABLATE_MODES:
        raise ValueError(f"mode must be one of {ABLATE_MODES}, got {mode!r}")
    bsz, width, total, steps = _acs_inputs(soft, steps, init)
    final = torch.empty((bsz, 64), dtype=torch.int32, device=soft.device)
    dec = None if mode == "nostore" else torch.empty(
        (total, bsz), dtype=torch.int64, device=soft.device)
    if bsz == 0:
        return final, dec
    lib = build()
    with torch.cuda.device(soft.device):
        err = lib.viterbi_acs_ablate(
            soft.data_ptr(), steps.data_ptr(), init.data_ptr(),
            None if dec is None else dec.data_ptr(), final.data_ptr(), bsz,
            width, total, ABLATE_MODES.index(mode), _stream(soft.device))
    launches["viterbi_acs_ablate"] += 1
    if err:
        raise RuntimeError(
            f"viterbi_acs_ablate launch failed: CUDA error {err}")
    return final, dec
