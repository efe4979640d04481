"""The hand-written CUDA frame detection (csrc/detect.cu), bound with ctypes.

Two kernels behind one C entry point compute models/frontend.detect_frames
on the card: the stream pass (a block per tile of a stream: the STS ratio
and plateau events, the 64-tap LTS matched filter in float64, the peak
pairs within reach, and each 512-block's event bits and count) and the
slot pass (a block per stream: the first k events, at most `block_cap`
from each 512-block, the events dropped over the cap, and a warp per slot
for the top-5 peak pairing). The note at the top of csrc/detect.cu has the
design and what bounds it. The source is compiled at first use
(ops/nvcc.py); importing this module builds nothing.

The plain version is models/frontend.detect_frames_plain, which
detect_frames runs for CPU tensors; for a CUDA tensor it calls `detect`
here, and nothing of the eager chain.
`detect` checks its tensors, launches on the current CUDA stream without
a host synchronisation, raises when the launch fails, and counts its calls
in `launches` (one per call; a call is two kernel launches).
"""

from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import torch

from ..config import ChainParams
from . import nvcc

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "detect.cu"
#: the 512-sample blocks of the event bits (models/frontend._BLOCK)
BLOCK = 512

#: calls since the last reset_launches()
launches = {"detect_frames": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def library_path() -> Path:
    """Where the built library for the current source and flags lives."""
    return nvcc.library_path(SOURCE, "detect")


@functools.lru_cache(maxsize=None)
def build() -> ctypes.CDLL:
    """Compile the kernels (once per source version) and load them
    (ops/nvcc.py; the compiler's report is kept beside the library)."""
    lib = nvcc.load(SOURCE, "detect")
    ptr, cint, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ofdm_detect.argtypes = [ptr] * 7 + [cll, cll, cll, cint, cint, cll,
                                            cint, cint, cint, cint,
                                            ctypes.c_float, ctypes.c_float,
                                            ptr]
    lib.ofdm_detect.restype = cint
    return lib


def detect(stream: torch.Tensor, max_frames: int, params: ChainParams,
           block_cap: int, drop_count_limit: int | None = None,
           return_lts: bool = False):
    """detect_frames on the card.

    stream: (..., n) complex64, contiguous, on a CUDA device. block_cap:
    the events kept from each 512-sample block, 16 for the blocked
    extractor and 512 (all) for the exact first k. Returns (starts (...,
    max_frames) int64, valid (..., max_frames) bool, dropped (...,) int64),
    as detect_frames(..., return_dropped=True) does, and with return_lts
    the LTS correlation (..., n) float32 as well.
    """
    if not stream.is_cuda:
        raise ValueError(f"stream must be a CUDA tensor, got {stream.device}")
    if stream.dtype != torch.complex64:
        raise TypeError(f"stream must be complex64, got {stream.dtype}")
    if not stream.is_contiguous():
        raise ValueError("stream must be contiguous")
    if 64 % params.lts_segments:
        raise ValueError("segments must divide 64")
    if params.lts_search < 64 or params.sts_length < 1 \
            or params.sts_plateau_length < 1:
        raise ValueError(
            f"lts_search must be >= 64 and the STS lengths >= 1: {params}")
    lead, n = stream.shape[:-1], stream.shape[-1]
    streams = math.prod(lead)
    nb = -(-n // BLOCK)
    stride = -(-n // 4) * 4
    dev = stream.device
    starts = torch.empty(lead + (max_frames,), dtype=torch.int64, device=dev)
    valid = torch.empty(lead + (max_frames,), dtype=torch.bool, device=dev)
    dropped = torch.empty(lead, dtype=torch.int64, device=dev)
    lts = torch.empty((streams, stride), dtype=torch.float32, device=dev)
    scratch = torch.empty((streams, nb * (BLOCK // 32 + 1)),
                          dtype=torch.int32, device=dev)
    if streams:
        drop_limit = n if drop_count_limit is None else min(drop_count_limit,
                                                            n)
        with torch.cuda.device(dev):
            err = build().ofdm_detect(
                stream.data_ptr(), lts.data_ptr(), scratch.data_ptr(),
                scratch.data_ptr() + streams * nb * BLOCK // 8,
                starts.data_ptr(), valid.data_ptr(), dropped.data_ptr(),
                streams, n, stride, max_frames, block_cap, drop_limit,
                params.sts_length, params.sts_plateau_length,
                params.lts_search, params.lts_segments,
                params.plateau_threshold, params.lts_corr_threshold,
                torch.cuda.current_stream(dev).cuda_stream)
        launches["detect_frames"] += 1
        if err == -1:
            raise ValueError(f"the detection halo of {params} does not fit "
                             "the card's shared memory")
        if err:
            raise RuntimeError(f"ofdm_detect launch failed: CUDA error {err}")
    if return_lts:
        return starts, valid, dropped, lts[:, :n].reshape(lead + (n,))
    return starts, valid, dropped
