"""ctypes bindings for the port's native streaming runtime
(csrc/stream_runtime.cpp, a copy of fun_ofdm_tpu's).

The native layer is the host-side transport: a blocking planar-sample ring
buffer (the loopback radio bus / RX ingest queue — the reference's usrp
send/recv role, src/usrp.cpp:91-130) and an overlap-save window chunker
(the reference's per-stage carryover buffers, src/receiver_chain.cpp:106-126,
generalized to one halo window). Device compute stays in PyTorch.

The source ships as package data (fun_ofdm_tpu_torch/csrc/stream_runtime.cpp)
and is compiled with $CXX (default g++) at first use into the port's own
build directory, csrc/build/, keyed by a hash of the source and flags; the
JAX package builds its copy elsewhere, so the two never share a library.
A failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "stream_runtime.cpp"
BUILD_DIR = SOURCE.parent / "build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-shared")

_lib = None
_lib_lock = threading.Lock()

_F32P = ctypes.POINTER(ctypes.c_float)


def library_path() -> Path:
    """Where the built library for the current source and flags lives."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libstream_runtime_{digest[:16]}.so"


def _build(lib_path: Path) -> None:
    cxx = os.environ.get("CXX", "g++")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE), "-lpthread"],
        capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} failed with code {proc.returncode} "
                           f"building {SOURCE.name}:\n{proc.stderr}")
    os.replace(tmp, lib_path)  # atomic vs concurrent builders


def load():
    """Load (building if needed) the native runtime library."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib_path = library_path()
        if not lib_path.exists():
            _build(lib_path)
        lib = ctypes.CDLL(str(lib_path))
        lib.ring_create.restype = ctypes.c_void_p
        lib.ring_create.argtypes = [ctypes.c_size_t]
        lib.ring_destroy.argtypes = [ctypes.c_void_p]
        lib.ring_close.argtypes = [ctypes.c_void_p]
        lib.ring_size.restype = ctypes.c_size_t
        lib.ring_size.argtypes = [ctypes.c_void_p]
        lib.ring_push.restype = ctypes.c_size_t
        lib.ring_push.argtypes = [ctypes.c_void_p, _F32P, _F32P,
                                  ctypes.c_size_t, ctypes.c_int]
        lib.ring_pop.restype = ctypes.c_size_t
        lib.ring_pop.argtypes = [ctypes.c_void_p, _F32P, _F32P,
                                 ctypes.c_size_t, ctypes.c_int]
        lib.ring_pop_timeout.restype = ctypes.c_size_t
        lib.ring_pop_timeout.argtypes = [ctypes.c_void_p, _F32P, _F32P,
                                         ctypes.c_size_t, ctypes.c_double]
        lib.chunker_create.restype = ctypes.c_void_p
        lib.chunker_create.argtypes = [ctypes.c_size_t, ctypes.c_size_t]
        lib.chunker_destroy.argtypes = [ctypes.c_void_p]
        lib.chunker_push.argtypes = [ctypes.c_void_p, _F32P, _F32P,
                                     ctypes.c_size_t]
        lib.chunker_available.restype = ctypes.c_size_t
        lib.chunker_available.argtypes = [ctypes.c_void_p]
        lib.chunker_ready.restype = ctypes.c_int
        lib.chunker_ready.argtypes = [ctypes.c_void_p]
        lib.chunker_pop.restype = ctypes.c_int64
        lib.chunker_pop.argtypes = [ctypes.c_void_p, _F32P, _F32P,
                                    ctypes.c_int]
        _lib = lib
        return lib


def _planar_f32(samples) -> tuple[np.ndarray, np.ndarray]:
    """Any 1-D complex/planar input -> contiguous (re, im) float32 arrays."""
    if isinstance(samples, tuple):
        re, im = samples
        return (np.ascontiguousarray(re, dtype=np.float32),
                np.ascontiguousarray(im, dtype=np.float32))
    arr = np.asarray(samples)
    if np.iscomplexobj(arr):
        return (np.ascontiguousarray(arr.real, dtype=np.float32),
                np.ascontiguousarray(arr.imag, dtype=np.float32))
    return (np.ascontiguousarray(arr, dtype=np.float32),
            np.zeros(arr.shape, dtype=np.float32))


class SampleRing:
    """Blocking bounded FIFO of planar float32 samples (native-backed).

    The loopback radio bus and RX ingest queue: `push` is the TX side
    (usrp::send_burst, reference src/usrp.cpp:91), `pop` the RX side
    (usrp::get_samples, src/usrp.cpp:125). `close()` unblocks all waiters;
    a closed ring drains then returns short counts.
    """

    def __init__(self, capacity: int = 1 << 22):
        self._lib = load()
        self._h = self._lib.ring_create(capacity)
        self.capacity = capacity

    def push(self, samples, blocking: bool = True) -> int:
        re, im = _planar_f32(samples)
        return self._lib.ring_push(
            self._h, re.ctypes.data_as(_F32P), im.ctypes.data_as(_F32P),
            re.size, int(blocking))

    def pop(self, n: int, blocking: bool = True,
            timeout: float | None = None):
        """Pop up to n samples -> planar (re, im) float32 of the count read.

        timeout (seconds): wait at most this long for n samples, then
        return what arrived — the radio sample-clock pop (reference
        usrp::get_samples blocking recv, src/usrp.cpp:125-130).
        """
        re = np.empty(n, np.float32)
        im = np.empty(n, np.float32)
        if timeout is not None:
            got = self._lib.ring_pop_timeout(
                self._h, re.ctypes.data_as(_F32P), im.ctypes.data_as(_F32P),
                n, float(timeout) * 1e3)
        else:
            got = self._lib.ring_pop(
                self._h, re.ctypes.data_as(_F32P), im.ctypes.data_as(_F32P),
                n, int(blocking))
        return re[:got], im[:got]

    def __len__(self) -> int:
        return self._lib.ring_size(self._h)

    def close(self) -> None:
        self._lib.ring_close(self._h)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.ring_destroy(self._h)
            self._h = None


class Chunker:
    """Overlap-save window assembler (native-backed).

    Feeds arbitrary-length sample runs; pops fixed `window`-sample views
    that advance by `stride` owned samples, re-presenting the trailing
    window-stride halo — so a frame that starts inside one owned chunk is
    always whole inside that chunk's window.
    """

    def __init__(self, stride: int, window: int):
        if window < stride:
            raise ValueError("window must be >= stride")
        self._lib = load()
        self._h = self._lib.chunker_create(stride, window)
        self.stride = stride
        self.window = window

    def push(self, samples) -> None:
        re, im = _planar_f32(samples)
        self._lib.chunker_push(
            self._h, re.ctypes.data_as(_F32P), im.ctypes.data_as(_F32P),
            re.size)

    @property
    def available(self) -> int:
        return self._lib.chunker_available(self._h)

    def ready(self) -> bool:
        return bool(self._lib.chunker_ready(self._h))

    def pop(self, pad: bool = False):
        """One (window_re, window_im, global_pos) or None if not ready.

        pad=True zero-fills a short tail (flush at stream end).
        """
        re = np.empty(self.window, np.float32)
        im = np.empty(self.window, np.float32)
        pos = self._lib.chunker_pop(
            self._h, re.ctypes.data_as(_F32P), im.ctypes.data_as(_F32P),
            int(pad))
        if pos < 0:
            return None
        return re, im, int(pos)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.chunker_destroy(self._h)
            self._h = None
