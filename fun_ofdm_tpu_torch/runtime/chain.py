"""Streaming receiver chain: superstep-pipelined chunked RX, in PyTorch.

Counterpart of fun_ofdm_tpu/runtime/chain.py (the reference's
receiver_chain, src/receiver_chain.cpp:29-126) in its fixed-superstep
mode: `process_samples(chunk)` takes sample runs of any length and
returns every CRC-valid payload whose frame has completed. Device work is
batched into supersteps of `strides_per_step` chunks:

  * the device keeps a rolling sample window; each superstep ships its
    samples once (optionally as int16/int12/int10/int8 wire words,
    unpacked on the device) and rolls them in;
  * stage 1 detects frames in the owned region and decodes their SIGNAL
    headers (models/frontend.decode_headers, all channels at once);
  * stage 2 decodes the payloads of the owned frames, per rate or, with
    several rates, per length class through the any-rate decoder
    (models/rx.decode_frames_dynamic / decode_frames_anyrate), in batches
    padded to fixed bucket sizes. Buckets of <= 64 frames take the
    block-overlap Viterbi; a frame its merge guard flags is re-decoded
    exactly (ChainStats.viterbi_fallbacks).

Both stages run dispatch-ahead: each result is copied to pinned host
memory without blocking and a CUDA event marks its arrival; the host
waits only when a stage holds more than pipeline_depth supersteps, or
takes a result early when its event has already fired. On a CPU device
everything is synchronous.

A frame belongs to the superstep whose owned [0, step) region holds its
preamble start; equal duplicate starts are dropped before decode, so
every frame is delivered once.

The host side is the port's own: the native chunker (runtime/native.py,
csrc/stream_runtime.cpp) and the wire formats (runtime/wire.py), copies of
fun_ofdm_tpu's. cfo_correct=True runs the coarse + fine CFO cascade in the
header pass and in every decode. Not ported yet: the adaptive superstep
ladder (ChainParams.latency_target_ms).
"""

from __future__ import annotations

import collections
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..config import DEFAULT_PARAMS, ChainParams
from ..models import frontend, rx
from ..ops import viterbi_cuda
from ..rates import ALL_RATES, Rate, params_for
from . import native
from .wire import (  # noqa: F401  (pack10: re-exported for callers)
    INGEST_FORMATS,
    PACKED_FORMATS,
    _dequantize_wire,
    _pack_np,
    _unpack_np,
    pack10,
)

#: detection + SIGNAL header need this much beyond a frame start
#: (320 preamble + 80 SIGNAL + LTS search margin)
DETECT_LEAD = 512

#: reference MAX_FRAME_SIZE (src/ppdu.h:17)
MAX_FRAME_SIZE = 2000

#: samples per superstep that strides_per_step=None aims at on a GPU
AUTO_STEP_SAMPLES = 1 << 20

#: payload-decode batch sizes: a job is padded up to one of these
DECODE_BUCKETS = (4, 16, 64, 256, 1024)

#: rows of the per-channel header block: starts, valid, rate_field,
#: hdr_length, header_ok, and a trailer [dropped, n_detected, 0, ...]
_HDR_ROWS = 6


def _unpack_device(b: torch.Tensor, fmt: str, scale: float) -> torch.Tensor:
    """Packed int12 (3 bytes / 2 samples) or int10 (5 bytes / 4 samples)
    wire bytes -> float32 samples, on the tensor's device (the inverse of
    pack12/pack10, last axis)."""
    t = b.to(torch.int32)
    if fmt == "int12":
        t = t.reshape(*b.shape[:-1], -1, 3)
        v = torch.stack([t[..., 0] | ((t[..., 1] & 0xF) << 8),
                         (t[..., 1] >> 4) | (t[..., 2] << 4)], dim=-1)
        sign = 0x800
    else:
        t = t.reshape(*b.shape[:-1], -1, 5)
        v = torch.stack([t[..., 0] | ((t[..., 1] & 0x3) << 8),
                         (t[..., 1] >> 2) | ((t[..., 2] & 0xF) << 6),
                         (t[..., 2] >> 4) | ((t[..., 3] & 0x3F) << 4),
                         (t[..., 3] >> 6) | (t[..., 4] << 2)], dim=-1)
        sign = 0x200
    v = v.reshape(*b.shape[:-1], -1)
    v = v - ((v & sign) << 1)           # sign-extend
    return v.to(torch.float32) * np.float32(1.0 / scale)


def _to_float(c: torch.Tensor, fmt: str, scale: float) -> torch.Tensor:
    """Wire samples of `fmt` on the device -> float32 samples."""
    if fmt in PACKED_FORMATS:
        return _unpack_device(c, fmt, scale)
    if fmt != "float32":
        return c.to(torch.float32) * np.float32(1.0 / scale)
    return c


def _headers_block(wr, wi, step: int, max_frames: int, n_hdr: int,
                   params: ChainParams, cfo_correct: bool) -> torch.Tensor:
    """Detection + SIGNAL headers over the window's first step +
    DETECT_LEAD samples (the owned region and the lead a header needs),
    packed as a (C, 6, n_hdr) int32 block (rows: starts, valid,
    rate_field, hdr_length, header_ok, and a trailer [dropped,
    n_detected]). Drops are counted in the owned region only: the lead
    is scanned again by the next superstep."""
    n = step + DETECT_LEAD
    h = frontend.decode_headers_p(
        (wr[..., :n], wi[..., :n]), max_frames, params=params,
        drop_count_limit=step, cfo_correct=cfo_correct,
        hdr_slots=None if n_hdr == max_frames else n_hdr)
    rows = torch.stack([h[k].to(torch.int32) for k in
                        ("starts", "valid", "rate_field", "hdr_length",
                         "header_ok")], dim=-2)          # (C, 5, n_hdr)
    trailer = torch.zeros(rows.shape[:-2] + (1, n_hdr), dtype=torch.int32,
                          device=rows.device)
    trailer[..., 0, 0] = h["detect_dropped"].to(torch.int32)
    trailer[..., 0, 1] = h["n_detected"].to(torch.int32)
    return torch.cat([rows, trailer], dim=-2)


def _impl_for_bucket(impl: str, bucket: int) -> str | None:
    """Resolve the chain's viterbi_impl knob to a per-bucket backend:
    "auto" takes the block-overlap decode for buckets of <= 64 frames
    (a small batch leaves the card's SMs idle and each frame's ~12k-step
    chain serial; the blocks cut the chain ~12x) and the exact decode
    above; "exact" always the exact decode; any other name goes to
    ops/viterbi.viterbi_decode as it is."""
    if impl == "auto":
        return "pallas-blocked" if bucket <= 64 else None
    if impl == "exact":
        return None
    return impl


def _pack_decode_rows(out: dict) -> torch.Tensor:
    """A decode-output dict -> (bucket, max_length + 5) uint8 rows:
    payload bytes, then [crc_ok, len_lo, len_hi, viterbi_exact,
    rate_field]."""
    ln = out["hdr_length"].to(torch.int32)
    cols = [out["crc_ok"], ln & 0xFF, (ln >> 8) & 0xFF, out["viterbi_exact"],
            out["rate_field"] & 0xFF]
    return torch.cat([out["payload"].to(torch.uint8)]
                     + [c[:, None].to(torch.uint8) for c in cols], dim=1)


def _build_decode_fn(rate, bucket: int, max_length: int, impl: str,
                     cfo_correct: bool = False):
    """Payload pass for one bucket: fn(wr, wi, starts) -> (bucket,
    max_length + 5) uint8 rows (see _pack_decode_rows). rate: a Rate
    (single-rate decode) or a tuple of Rates (any-rate decode). Multi-
    channel chains pass their (C, W) window with starts offset by
    channel * W; the flattened window serves every channel in one
    decode. cfo_correct: derotate every frame by its CFO estimate."""
    vimpl = _impl_for_bucket(impl, bucket)

    def fn(wr, wi, starts):
        stream = torch.complex(wr.reshape(-1), wi.reshape(-1))
        if isinstance(rate, tuple):
            out = rx.decode_frames_anyrate(stream, rate, max_length, starts,
                                           viterbi_impl=vimpl,
                                           cfo_correct=cfo_correct)
        else:
            out = rx.decode_frames_dynamic(stream, rate, max_length, starts,
                                           viterbi_impl=vimpl,
                                           cfo_correct=cfo_correct)
        return _pack_decode_rows(out)

    return fn


class _Fetch:
    """A device result on its way to the host: a non-blocking copy into
    pinned memory and a CUDA event recorded after it. A CPU tensor is
    simply held."""

    def __init__(self, x: torch.Tensor):
        if x.is_cuda:
            self._host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            self._host.copy_(x, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host, self._event = x, None

    def ready(self) -> bool:
        return self._event is None or self._event.query()

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


@dataclass(frozen=True)
class DecodedPacket:
    """One CRC-valid decoded frame (the chain's output unit)."""

    payload: bytes
    rate: Rate
    length: int
    #: preamble start position in the global (per-channel) sample stream
    start: int
    #: channel index (multi-channel chains; 0 for single-channel)
    channel: int = 0

    def __bytes__(self) -> bytes:
        return self.payload


@dataclass
class ChainStats:
    """Running counters of the chain (fun_ofdm_tpu's ChainStats)."""

    samples_in: int = 0
    #: device supersteps processed (strides_per_step chunks each)
    windows: int = 0
    headers_ok: int = 0
    crc_ok: int = 0
    crc_fail: int = 0
    unknown_rate: int = 0
    #: CRC-valid headers dropped because hdr_length > max_length
    length_overflow: int = 0
    #: supersteps where every detection slot filled (possible missed frames)
    detect_saturated: int = 0
    #: detection events dropped by the blocked extractor's per-block cap
    detect_dropped: int = 0
    #: duplicate equal frame starts removed before decode
    dup_starts: int = 0
    #: supersteps whose detections exceeded header_slots and re-ran the
    #: full-capacity header pass (nothing lost)
    header_overflows: int = 0
    #: frames re-decoded exactly because the block-overlap Viterbi's merge
    #: guard flagged them
    viterbi_fallbacks: int = 0
    #: host wall time spent waiting on results per stage (not device time)
    time_headers_s: float = 0.0
    time_decode_s: float = 0.0

    def as_dict(self) -> dict:
        return dict(self.__dict__)


class ReceiverChain:
    """Stateful streaming receiver (fun_ofdm_tpu's ReceiverChain).

    Args:
      device: where the window lives and every device pass runs
        ("cuda" by default, "cuda:1", "cpu", a torch.device). The chain
        never moves to another device by itself: a "cuda" chain without a
        GPU fails.
      rates: rates to decode (default: all 11). The halo is sized by the
        longest frame any of them can produce at max_length.
      max_length: largest payload length to decode (reference
        MAX_FRAME_SIZE, src/ppdu.h:17, is 2000).
      params: chain thresholds, chunk size and superstep batching.
        strides_per_step=None means 1 on a CPU device and
        AUTO_STEP_SAMPLES // chunk_size (256 at 4096) on a GPU.
        latency_target_ms (the adaptive ladder) is not ported yet.
      cfo_correct: estimate each frame's carrier offset (coarse STS +
        fine LTS cascade) and derotate it, in the header pass and in the
        payload decode. Pair with ChainParams(lts_segments=4) for offsets
        past ~3e-3 cycles/sample, where the coherent LTS correlation of
        the default detection collapses.
      verbose: print "Invalid CRC (length N)" to stderr on CRC failures
        (src/ppdu.cpp:276).
      pipeline_depth: supersteps each stage keeps in flight before the
        host waits on the oldest (>= 1).
      ingest_dtype: host->device sample format: "float32", "int16" (UHD
        sc16), "int12" (sc12, packed 3 bytes / 2 samples), "int10" (4
        samples / 5 bytes) or "int8" (sc8; refused with 64-QAM rates).
        See INGEST_FORMATS.
      viterbi_impl: payload Viterbi: None or "auto" (the guarded
        block-overlap decode for buckets of <= 64 frames, with exact
        re-decode of flagged frames; the exact decode above), "exact",
        "pallas"/"scan" (exact), "pallas-blocked" (always blocked,
        still guarded). The FUN_OFDM_VITERBI variable is not read.
      decode_mode: "auto" (universal any-rate decode with several rates,
        single-rate otherwise), "universal" or "per-rate".
      channels: synchronized streams; process_samples then takes (C, n)
        buffers, all channels share each device pass, and packets carry
        their channel index.
      prewarm_exact: on a GPU, build the CUDA kernel library at
        construction instead of at the first decode. None = True on a
        GPU.
    """

    def __init__(self, rates: tuple[Rate, ...] = ALL_RATES,
                 max_length: int = 1500,
                 params: ChainParams = DEFAULT_PARAMS,
                 cfo_correct: bool = False,
                 verbose: bool = False,
                 pipeline_depth: int = 2,
                 ingest_dtype: str = "float32",
                 viterbi_impl: str | None = None,
                 decode_mode: str = "auto",
                 channels: int = 1,
                 prewarm_exact: bool | None = None,
                 device="cuda"):
        self.device = torch.device(device)
        if self.device.type not in ("cpu", "cuda"):
            raise ValueError(f"no chain for device {self.device}")
        if params.latency_target_ms is not None:
            raise NotImplementedError(
                "ChainParams.latency_target_ms: the adaptive superstep "
                "ladder is not ported yet (ROADMAP.md, Queue 1)")
        if max_length > MAX_FRAME_SIZE:
            raise ValueError(f"max_length > MAX_FRAME_SIZE ({MAX_FRAME_SIZE})")
        if ingest_dtype not in INGEST_FORMATS:
            raise ValueError(f"ingest_dtype must be one of "
                             f"{sorted(INGEST_FORMATS)}")
        self.rates = tuple(Rate(r) for r in rates)
        if ingest_dtype == "int8":
            qam64 = [r.name for r in self.rates if params_for(r).bpsc >= 6]
            if qam64:
                raise ValueError(
                    f"ingest_dtype='int8' (sc8) cannot carry 64-QAM "
                    f"frames ({', '.join(qam64)}): 8-bit quantization "
                    f"noise fails their CRC. Exclude those rates or use "
                    f"ingest_dtype='int12'.")
        self.max_length = int(max_length)
        self.params = params
        self.cfo_correct = bool(cfo_correct)
        self.ingest_dtype = ingest_dtype
        self.channels = int(channels)
        if self.channels < 1:
            raise ValueError("channels must be >= 1")
        self.viterbi_impl = viterbi_impl or "auto"
        if decode_mode not in ("auto", "universal", "per-rate"):
            raise ValueError("decode_mode must be auto|universal|per-rate")
        self.decode_mode = ("universal" if len(rates) > 1 else "per-rate") \
            if decode_mode == "auto" else decode_mode
        self.stride = params.chunk_size
        k = params.strides_per_step
        if k is None:
            k = (1 if self.device.type == "cpu"
                 else max(1, -(-AUTO_STEP_SAMPLES // self.stride)))
        self.strides_per_step = max(1, int(k))
        #: samples per device superstep (ownership region length)
        self.step = self.stride * self.strides_per_step
        halo = max(params_for(r).frame_samples(max_length)
                   for r in self.rates)
        self.halo = max(halo, DETECT_LEAD)
        self.window = self.step + self.halo
        self.verbose = bool(verbose)
        self.pipeline_depth = max(1, int(pipeline_depth))
        # detection capacity: back-to-back shortest frames anywhere in
        # [0, step + DETECT_LEAD) cannot exhaust the slots
        min_frame = min(params_for(r).frame_samples(0) for r in self.rates)
        if params.min_frame_samples is not None:
            min_frame = max(min_frame, int(params.min_frame_samples))
        if params.max_frames_per_chunk is not None:
            self.max_frames = (int(params.max_frames_per_chunk)
                               * self.strides_per_step)
        else:
            self.max_frames = -(-(self.step + DETECT_LEAD) // min_frame) + 1
        # >= 2: the header-block trailer carries [dropped, n_detected]
        self.max_frames = max(2, self.max_frames)
        self._n_hdr = self.max_frames if params.header_slots is None \
            else max(2, min(params.header_slots, self.max_frames))
        self._valid_fields = {params_for(r).rate_field: r for r in self.rates}
        self._classes = length_classes(self.rates, self.max_length)
        self._field_class = {
            params_for(r).rate_field: ci
            for ci, cls in enumerate(self._classes) for r in cls}
        self.stats = ChainStats()
        if prewarm_exact is None:
            prewarm_exact = self.device.type == "cuda"
        if prewarm_exact and self.device.type == "cuda":
            viterbi_cuda.build()

        # host side: slice pushes into exact supersteps (single channel:
        # the native chunker; multi-channel: a list of (C, k) pieces)
        self._rechunk = native.Chunker(self.step, self.step) \
            if self.channels == 1 else None
        self._mc_buf: list = []
        self._mc_avail = 0
        # device side: rolling window state
        self._dev_win = None
        self._s_total = 0             # samples ingested (incl. warm-up pad)
        self._t_real = 0              # real samples pushed
        # in-flight queues: headers awaiting sync, decodes awaiting sync
        self._hdr_q: collections.deque = collections.deque()
        self._dec_q: collections.deque = collections.deque()

    # --- device passes -----------------------------------------------------

    def _decode_fn(self, rate, bucket: int, exact: bool = False):
        """Decode pass for one bucket. rate: a Rate (single-rate), a tuple
        of Rates (any-rate over that length class) or None (any-rate over
        every configured rate)."""
        impl = "exact" if exact else self.viterbi_impl
        if rate is None:
            rate = self.rates
        return _build_decode_fn(rate, bucket, self.max_length, impl,
                                self.cfo_correct)

    # --- streaming API ----------------------------------------------------

    def process_samples(self, samples) -> list[DecodedPacket]:
        """Feed a chunk of samples; return packets completed by it.

        samples: 1-D complex array, or planar (re, im) arrays. Planar
        arrays already in ingest_dtype (a radio's native sc16/sc8
        buffers, or packed int12/int10 bytes) ship as they are when they
        come in whole supersteps; other integer wire buffers are rescaled
        to float32 once and rechunked. Packets may come back on a later
        call than the one that completed them; flush() drains everything.
        """
        if self.channels > 1:
            return self._process_multichannel(samples)
        if isinstance(samples, tuple):
            n = samples[0].size
            np_dtype, scale = INGEST_FORMATS[self.ingest_dtype]
            if self.ingest_dtype in PACKED_FORMATS \
                    and samples[0].dtype == np.uint8 \
                    and samples[1].dtype == np.uint8:
                gb, gs = PACKED_FORMATS[self.ingest_dtype]
                pb = self.step * gb // gs
                n = samples[0].size * gs // gb
                if (self._rechunk.available == 0
                        and samples[0].size % pb == 0):
                    self.stats.samples_in += n
                    self._t_real += n
                    for i in range(0, samples[0].size, pb):
                        self._ingest(samples[0][i:i + pb],
                                     samples[1][i:i + pb])
                    return self._drain(force=False)
                if samples[0].size % gb:
                    raise ValueError(
                        f"packed {self.ingest_dtype} buffers must be a "
                        f"multiple of {gb} bytes")
                samples = (_unpack_np(samples[0], self.ingest_dtype, scale),
                           _unpack_np(samples[1], self.ingest_dtype, scale))
            elif (samples[0].dtype == np_dtype
                    and samples[1].dtype == np_dtype
                    and np_dtype != np.float32
                    and self._rechunk.available == 0
                    and n % self.step == 0):
                # pre-quantized fast path: exact supersteps, no conversion
                self.stats.samples_in += n
                self._t_real += n
                for i in range(0, n, self.step):
                    self._ingest(samples[0][i:i + self.step],
                                 samples[1][i:i + self.step])
                return self._drain(force=False)
            else:
                # other integer wire buffers: rescale to float32 first, or
                # _ingest would quantize their raw magnitudes again
                samples = (_dequantize_wire(np.asarray(samples[0])),
                           _dequantize_wire(np.asarray(samples[1])))
        else:
            n = np.asarray(samples).size
        self._rechunk.push(samples)
        self.stats.samples_in += n
        self._t_real += n
        while self._rechunk.ready():
            chunk = self._rechunk.pop()
            self._ingest(chunk[0], chunk[1])
        return self._drain(force=False)

    def _mc_take(self, k: int):
        """Pop k samples per channel from the multi-channel accumulator."""
        taken_re, taken_im, got = [], [], 0
        while got < k:
            re, im = self._mc_buf[0]
            need = k - got
            if re.shape[-1] <= need:
                taken_re.append(re)
                taken_im.append(im)
                got += re.shape[-1]
                self._mc_buf.pop(0)
            else:
                taken_re.append(re[:, :need])
                taken_im.append(im[:, :need])
                self._mc_buf[0] = (re[:, need:], im[:, need:])
                got = k
        self._mc_avail -= k
        return (np.concatenate(taken_re, axis=-1),
                np.concatenate(taken_im, axis=-1))

    def _process_multichannel(self, samples) -> list[DecodedPacket]:
        """process_samples for channels > 1: (C, n) complex or planar
        buffers, the same wire formats and fast paths."""
        if not isinstance(samples, tuple):
            arr = np.asarray(samples)
            samples = (np.ascontiguousarray(arr.real, dtype=np.float32),
                       np.ascontiguousarray(arr.imag, dtype=np.float32))
        re, im = np.asarray(samples[0]), np.asarray(samples[1])
        if re.ndim != 2 or re.shape[0] != self.channels:
            raise ValueError(
                f"multi-channel chain expects (channels={self.channels}, n)"
                " buffers")
        np_dtype, scale = INGEST_FORMATS[self.ingest_dtype]
        if self.ingest_dtype in PACKED_FORMATS and re.dtype == np.uint8 \
                and im.dtype == np.uint8:
            gb, gs = PACKED_FORMATS[self.ingest_dtype]
            pb = self.step * gb // gs
            n = re.shape[-1] * gs // gb
            if self._mc_avail == 0 and re.shape[-1] % pb == 0:
                self.stats.samples_in += n * self.channels
                self._t_real += n
                for i in range(0, re.shape[-1], pb):
                    self._ingest(re[:, i:i + pb], im[:, i:i + pb])
                return self._drain(force=False)
            if re.shape[-1] % gb:
                raise ValueError(
                    f"packed {self.ingest_dtype} buffers must be a "
                    f"multiple of {gb} bytes")
            re = _unpack_np(re, self.ingest_dtype, scale)
            im = _unpack_np(im, self.ingest_dtype, scale)
        elif (re.dtype == np_dtype and im.dtype == np_dtype
                and np_dtype != np.float32
                and self._mc_avail == 0
                and re.shape[-1] % self.step == 0):
            self.stats.samples_in += re.size
            self._t_real += re.shape[-1]
            for i in range(0, re.shape[-1], self.step):
                self._ingest(re[:, i:i + self.step],
                             im[:, i:i + self.step])
            return self._drain(force=False)
        else:
            re = _dequantize_wire(re)
            im = _dequantize_wire(im)
        re = np.ascontiguousarray(re, dtype=np.float32)
        im = np.ascontiguousarray(im, dtype=np.float32)
        self.stats.samples_in += re.size
        self._t_real += re.shape[-1]
        self._mc_buf.append((re, im))
        self._mc_avail += re.shape[-1]
        while self._mc_avail >= self.step:
            self._ingest(*self._mc_take(self.step))
        return self._drain(force=False)

    def flush(self, terminal: bool = True) -> list[DecodedPacket]:
        """Drain buffered samples (zero-padding the tail) at stream end.

        Rolls zero supersteps through the window until every real sample
        has been owned. terminal=False also resets the window and the
        stream position, so the same chain serves a next stream whose
        packet starts count from 0 again; stats stay cumulative."""
        if self._t_real == 0:
            return []
        if self.channels == 1:
            tail = self._rechunk.pop(pad=True)
            if tail is not None:
                self._ingest(tail[0], tail[1])
            zeros = np.zeros(self.step, np.float32)
        else:
            if self._mc_avail:
                re, im = self._mc_take(self._mc_avail)
                z = np.zeros((self.channels, self.step - re.shape[-1]),
                             np.float32)
                self._ingest(np.concatenate([re, z], axis=-1),
                             np.concatenate([im, z], axis=-1))
            zeros = np.zeros((self.channels, self.step), np.float32)
        # ownership lags ingestion by `halo`
        while self._s_total - self.halo < self._t_real:
            self._ingest(zeros, zeros)
        packets = self._drain(force=True)
        if not terminal:
            self._dev_win = None
            self._s_total = 0
            self._t_real = 0
            if self._rechunk is not None:
                self._rechunk = native.Chunker(self.step, self.step)
            self._mc_buf = []
            self._mc_avail = 0
        return packets

    # --- pipeline stages ---------------------------------------------------

    def _ingest(self, c_re: np.ndarray, c_im: np.ndarray) -> None:
        """Ship one superstep of samples to the device, roll it into the
        window and queue the detection + header pass."""
        if self._dev_win is None:
            shape = (self.window,) if self.channels == 1 \
                else (self.channels, self.window)
            z = torch.zeros(shape, dtype=torch.float32, device=self.device)
            self._dev_win = (z, z)
        dtype, scale = INGEST_FORMATS[self.ingest_dtype]
        if self.ingest_dtype in PACKED_FORMATS:
            if c_re.dtype != np.uint8:
                c_re = _pack_np(c_re, self.ingest_dtype, scale)
                c_im = _pack_np(c_im, self.ingest_dtype, scale)
        elif self.ingest_dtype != "float32" and c_re.dtype != dtype:
            lim = float(np.iinfo(dtype).max)
            c_re = np.clip(np.rint(c_re * scale), -lim, lim).astype(dtype)
            c_im = np.clip(np.rint(c_im * scale), -lim, lim).astype(dtype)
        elif self.ingest_dtype == "float32":
            c_re = np.asarray(c_re, np.float32)
            c_im = np.asarray(c_im, np.float32)
        cr, ci = (_to_float(torch.from_numpy(np.ascontiguousarray(c)).to(
            self.device, non_blocking=True), self.ingest_dtype, scale)
            for c in (c_re, c_im))
        k = cr.shape[-1]
        wr, wi = (torch.cat([w[..., k:], c], dim=-1)
                  for w, c in zip(self._dev_win, (cr, ci)))
        self._dev_win = (wr, wi)
        # this superstep owns the k samples lagging ingestion by `halo`
        gpos = self._s_total - self.halo
        self._s_total += k
        if gpos + k <= 0:
            return  # warm-up: owned region entirely before the stream
        hdr = _headers_block(wr, wi, self.step, self.max_frames,
                             self._n_hdr, self.params, self.cfo_correct)
        self.stats.windows += 1
        self._hdr_q.append((gpos, k, self._dev_win, _Fetch(hdr)))

    def _dispatch_one(self, win, rate, chs, local_starts, jobs) -> None:
        """Queue decode jobs for (channel, start) pairs of all channels,
        padded to a bucket with copies of the first start (their rows are
        dropped on the host); more than the largest bucket splits. The
        channel folds into the start (ch * window + start) of the
        flattened window."""
        flat = chs.astype(np.int64) * self.window + local_starts
        for lo in range(0, flat.size, DECODE_BUCKETS[-1]):
            part = slice(lo, lo + DECODE_BUCKETS[-1])
            fpart = flat[part]
            bucket = next(b for b in DECODE_BUCKETS if b >= fpart.size)
            padded = np.full(bucket, fpart[0], np.int64)
            padded[:fpart.size] = fpart
            out = self._decode_fn(rate, bucket)(
                win[0], win[1], torch.from_numpy(padded).to(self.device))
            jobs.append((rate, chs[part], local_starts[part], fpart.copy(),
                         _Fetch(out)))

    def _dispatch_decodes(self, win, chs, starts, fields, jobs) -> None:
        """Queue the payload decodes of one superstep's owned frames (all
        channels together): one job per length class in universal mode,
        one per rate otherwise."""
        if self.decode_mode == "universal":
            for ci, cls in enumerate(self._classes):
                sel = np.array([self._field_class.get(int(f)) == ci
                                for f in fields])
                if sel.any():
                    self._dispatch_one(win, cls, chs[sel], starts[sel], jobs)
        else:
            for field_val in np.unique(fields):
                sel = fields == field_val
                self._dispatch_one(win, self._valid_fields[int(field_val)],
                                   chs[sel], starts[sel], jobs)

    def _redecode_exact(self, win, rate, flat_bad) -> np.ndarray:
        """Re-decode merge-guard-flagged frames with the exact Viterbi
        (synchronous); flat_bad: channel-folded starts. Returns the same
        (n, max_length + 5) uint8 rows as the primary decode."""
        row = self.max_length + 5
        outs = []
        for lo in range(0, flat_bad.size, DECODE_BUCKETS[-1]):
            part = flat_bad[lo:lo + DECODE_BUCKETS[-1]]
            bucket = next(b for b in DECODE_BUCKETS if b >= part.size)
            padded = np.full(bucket, part[0], np.int64)
            padded[:part.size] = part
            out = self._decode_fn(rate, bucket, exact=True)(
                win[0], win[1], torch.from_numpy(padded).to(self.device))
            outs.append(_Fetch(out).numpy()[:part.size].reshape(-1, row))
        return np.concatenate(outs)

    def _collect_decodes(self, gpos, win, jobs) -> list[DecodedPacket]:
        """Sync one superstep's decode jobs into DecodedPackets."""
        wpkts: list[DecodedPacket] = []
        t1 = time.perf_counter()
        for rate, chs, starts, flat, out in jobs:
            packed = out.numpy()[:chs.size]
            exact = packed[:, self.max_length + 3].astype(bool)
            bad = np.nonzero(~exact)[0]
            if bad.size:
                # the block-overlap merge guard tripped: restore exactness
                self.stats.viterbi_fallbacks += int(bad.size)
                packed = packed.copy()
                packed[bad] = self._redecode_exact(win, rate, flat[bad])
            payloads = packed[:, :self.max_length]
            crc_ok = packed[:, self.max_length].astype(bool)
            hdr_len = (packed[:, self.max_length + 1].astype(np.int32)
                       | (packed[:, self.max_length + 2]
                          .astype(np.int32) << 8))
            rfield = packed[:, self.max_length + 4]
            for k in range(chs.size):
                if not crc_ok[k]:
                    # reference: report + drop, keep streaming
                    self.stats.crc_fail += 1
                    if self.verbose:
                        print(f"Invalid CRC (length {int(hdr_len[k])})",
                              file=sys.stderr)
                    continue
                self.stats.crc_ok += 1
                n = int(hdr_len[k])
                wpkts.append(DecodedPacket(
                    payload=payloads[k, :n].tobytes(),
                    rate=(rate if isinstance(rate, Rate)
                          else self._valid_fields[int(rfield[k])]),
                    length=n,
                    start=gpos + int(starts[k]),
                    channel=int(chs[k])))
        self.stats.time_decode_s += time.perf_counter() - t1
        wpkts.sort(key=lambda p: (p.start, p.channel))
        return wpkts

    def _drain(self, force: bool) -> list[DecodedPacket]:
        """Sync finished stages past the pipeline depth; return packets.

        Each stage keeps up to pipeline_depth supersteps in flight; a
        result is synced when its queue is deeper than that or when its
        copy has already arrived."""
        keep = 0 if force else self.pipeline_depth
        cap, n_hdr = self.max_frames, self._n_hdr
        while self._hdr_q and (len(self._hdr_q) > keep
                               or self._hdr_q[0][3].ready()):
            gpos, step_k, win, hdr = self._hdr_q.popleft()
            t0 = time.perf_counter()
            hs = hdr.numpy().reshape(self.channels, _HDR_ROWS, n_hdr)
            if n_hdr < cap and int(hs[:, 5, 1].max()) > n_hdr:
                # more detections than the header budget: re-run the
                # full-capacity pass on the (unchanged) window
                self.stats.header_overflows += 1
                full = _headers_block(win[0], win[1], self.step, cap, cap,
                                      self.params, self.cfo_correct)
                hs = _Fetch(full).numpy().reshape(self.channels, _HDR_ROWS,
                                                  cap)
            self.stats.time_headers_s += time.perf_counter() - t0
            jobs: list = []
            sel_chs, sel_starts, sel_fields = [], [], []
            for ch in range(self.channels):
                starts, valid, fields, lengths, header_ok = hs[ch, :5]
                header_ok = header_ok.astype(bool)
                dropped = int(hs[ch, 5, 0])
                if dropped:
                    self.stats.detect_dropped += dropped
                    if self.verbose:
                        print(f"Detection events dropped ({dropped})",
                              file=sys.stderr)
                if int(hs[ch, 5, 1]) >= cap:
                    # every slot of the full capacity filled: frames past
                    # it were missed
                    self.stats.detect_saturated += 1
                    if self.verbose:
                        print(f"Detection saturated ({cap} slots)",
                              file=sys.stderr)
                owned = header_ok & (starts >= 0) & (starts < step_k) \
                    & (gpos + starts >= 0)
                if owned.any():
                    # equal starts (a noise-fragmented plateau resolving
                    # to one LTS pair twice) decode once
                    ow = np.nonzero(owned)[0]
                    _, first = np.unique(starts[ow], return_index=True)
                    if first.size != ow.size:
                        self.stats.dup_starts += ow.size - first.size
                        dup = np.ones(ow.size, bool)
                        dup[first] = False
                        owned[ow[dup]] = False
                if not owned.any():
                    continue
                self.stats.headers_ok += int(owned.sum())
                known = np.isin(fields, list(self._valid_fields)) & owned
                self.stats.unknown_rate += int((owned & ~known).sum())
                over = known & (lengths > self.max_length)
                self.stats.length_overflow += int(over.sum())
                sel = known & (lengths <= self.max_length)
                if sel.any():
                    idx = np.nonzero(sel)[0]
                    sel_chs.append(np.full(idx.size, ch, np.int32))
                    sel_starts.append(starts[idx].astype(np.int32))
                    sel_fields.append(fields[idx])
            if sel_chs:
                # the owned region starts the window: a start is a window
                # index
                self._dispatch_decodes(
                    win, np.concatenate(sel_chs), np.concatenate(sel_starts),
                    np.concatenate(sel_fields), jobs)
            if jobs:
                self._dec_q.append((gpos, win, jobs))

        packets: list[DecodedPacket] = []
        while self._dec_q and (len(self._dec_q) > keep
                               or all(o.ready()
                                      for *_, o in self._dec_q[0][2])):
            gpos, win, jobs = self._dec_q.popleft()
            packets.extend(self._collect_decodes(gpos, win, jobs))
        return packets


def length_classes(rates: tuple[Rate, ...],
                   max_length: int) -> list[tuple[Rate, ...]]:
    """Split the rates into <= 2 classes by symbol count at max_length,
    minimising sum(|class| * its largest symbol count): the any-rate
    decode of a class extracts and equalizes that many symbols per frame
    (fun_ofdm_tpu's ReceiverChain makes the same split)."""
    by_nsym = sorted(rates, key=lambda r: params_for(r).num_symbols(
        max_length))
    nsyms = [params_for(r).num_symbols(max_length) for r in by_nsym]
    best, best_cost = [tuple(by_nsym)], len(by_nsym) * nsyms[-1]
    for cut in range(1, len(by_nsym)):
        cost = cut * nsyms[cut - 1] + (len(by_nsym) - cut) * nsyms[-1]
        if cost < best_cost:
            best_cost = cost
            best = [tuple(by_nsym[:cut]), tuple(by_nsym[cut:])]
    return best
