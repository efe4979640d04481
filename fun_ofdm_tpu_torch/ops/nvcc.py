"""Building the port's CUDA sources (csrc/*.cu) into shared libraries with
a plain C interface, loaded with ctypes.

nvcc compiles a source for sm_90a at its first use, into csrc/build/,
under a name keyed by a hash of the source and the flags, and keeps the
compiler's report (registers, spills, shared memory per kernel) beside
the library with the suffix .log. Importing this module builds nothing.
The wrappers count their launches through count_launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

BUILD_DIR = Path(__file__).resolve().parent.parent / "csrc" / "build"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def count_launch(launches: dict, name: str) -> None:
    """launches[name] += 1, unless the current stream is capturing a CUDA
    graph: a launch recorded into a graph runs only when the graph
    replays, and a count is a kernel that ran (a replay is counted by
    its caller, as models/rx's rx.graph_replays)."""
    if not torch.cuda.is_current_stream_capturing():
        launches[name] += 1


def compiler() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path(source: Path, stem: str) -> Path:
    """Where the library built from `source` with FLAGS lives."""
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{stem}_{digest[:16]}.so"


def load(source: Path, stem: str) -> ctypes.CDLL:
    """Compile `source` unless its library exists, and load it."""
    lib_path = library_path(source, stem)
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        proc = subprocess.run(
            [compiler(), *FLAGS, "-o", str(tmp), str(source)],
            capture_output=True, text=True, check=False)
        lib_path.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed with code {proc.returncode}:\n{proc.stderr}")
        os.replace(tmp, lib_path)
    return ctypes.CDLL(str(lib_path))
