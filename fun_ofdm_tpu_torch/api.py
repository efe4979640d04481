"""Top-level API: the Transmitter and Receiver facades.

Counterpart of fun_ofdm_tpu/api.py, mirroring the reference's two exported
classes (src/transmitter.h:49-73, src/receiver.h:58-83):
`Transmitter.send_frame(payload, rate)` and `Receiver(callback)` with
`pause()`/`resume()`, over the port's batched frame building (models/tx),
the streaming ReceiverChain (runtime/chain) and the pluggable sample I/O
backends (runtime/io) in place of the USRP. `send_burst(payloads, rate)`
builds a whole burst in one batched device pass per rate.

Both classes take `device` ("cuda" by default) and never move to another
device by themselves: without a GPU a "cuda" Transmitter or Receiver
raises.
"""

from __future__ import annotations

import contextlib
import operator
import threading
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .config import DEFAULT_PARAMS, ChainParams
from .models import tx
from .rates import ALL_RATES, Rate, params_for
from .runtime.chain import ReceiverChain
from .runtime.io import LoopbackRadio, RadioParams


def _device(device) -> torch.device:
    """`device` as a torch.device; a CUDA device without a GPU raises."""
    device = torch.device(device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no Transmitter or Receiver for device {device}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} asked for, and no CUDA device is available "
            f"(pass device='cpu' to run on the CPU)")
    return device


class Transmitter:
    """Builds 802.11a frames and sends them to a sample sink.

    Reference equivalent: transmitter (src/transmitter.cpp:15-37), the
    build_frame + send_burst_sync composition. The sink is any object
    with `send_burst(samples)` (LoopbackRadio, FileSink, UdpSink,
    CaptureSink or user code); samples are planar (re, im) float32 numpy
    arrays. Frames are built on `device`.
    """

    #: send_burst shape buckets: the batch sizes and payload-length caps a
    #: mixed-length burst is padded to, as in fun_ofdm_tpu. On the GPU no
    #: shape is compiled: the buckets only bound the set of tensor shapes
    #: models/tx sees (cuFFT keeps a plan, and the caching allocator its
    #: blocks, per shape). chip_smoke.py (phase 13) times a per-frame-rate
    #: burst and a 65-frame burst with them and with none.
    BURST_BATCH_BUCKETS = (4, 16, 64, 256)
    BURST_LEN_BUCKETS = (64, 256, 1024, 2000)

    def __init__(self, sink=None, params: RadioParams = RadioParams(),
                 device="cuda"):
        self.device = _device(device)
        self.sink = sink if sink is not None else LoopbackRadio(params)
        self.params = params

    def _send(self, re: np.ndarray, im: np.ndarray) -> None:
        # the reference's transmitter::send_frame uses the sync burst
        # (src/transmitter.cpp:33-37); sinks without one take the plain
        send = getattr(self.sink, "send_burst_sync", self.sink.send_burst)
        send((re, im))

    def send_frame(self, payload, rate: Rate = Rate.RATE_1_2_BPSK) -> int:
        """Build one frame and send it; returns the sample count sent
        (reference: src/transmitter.cpp:33-37)."""
        return self.send_burst([payload], rate)

    def _build_burst(self, mats: list[np.ndarray], rate: Rate):
        """Frames of `mats` at one rate, back to back: (re, im) float32
        numpy of all samples and the (len(mats),) sample count of each
        frame. Touches no sink."""
        sizes = {m.size for m in mats}
        if len(sizes) == 1:
            batch = torch.from_numpy(np.stack(mats)).to(self.device)
            re, im = tx.build_frame_p(batch, rate)
            counts = np.full(len(mats), re.shape[-1], np.int64)
        else:
            # mixed lengths: payloads zero-padded to a bucketed length, the
            # batch to a bucketed count (the extra rows repeat frame 0's
            # length and are dropped), each frame cut to its own extent
            lmax = max(sizes)
            lb = next((b for b in self.BURST_LEN_BUCKETS if b >= lmax), lmax)
            nb = next((b for b in self.BURST_BATCH_BUCKETS
                       if b >= len(mats)), len(mats))
            pay = np.zeros((nb, lb), np.uint8)
            lens = np.full(nb, mats[0].size, np.int64)
            for i, m in enumerate(mats):
                pay[i, :m.size] = m
                lens[i] = m.size
            re, im, ns = tx.build_frames_mixed_p(
                torch.from_numpy(pay).to(self.device),
                torch.from_numpy(lens).to(self.device), rate)
            ns = ns[:len(mats)]
            keep = torch.arange(re.shape[-1], device=self.device) < ns[:, None]
            re, im = re[:len(mats)][keep], im[:len(mats)][keep]
            counts = ns.cpu().numpy()
        return (re.reshape(-1).cpu().numpy(), im.reshape(-1).cpu().numpy(),
                counts)

    def send_burst(self, payloads: Sequence, rate) -> int:
        """Build a whole burst of frames, one batched device pass per
        rate, and send them back to back in order. Payload lengths may
        differ (the reference transmitter's per-frame flexibility,
        src/transmitter.cpp:33-37): equal-length bursts take
        models/tx.build_frame_p, mixed bursts build_frames_mixed_p, padded to
        the shape buckets. `rate` is one rate (a Rate or any integer,
        numpy's included) or a sequence of per-frame rates. Returns the
        samples sent. The sink is called once, after every frame is
        built."""
        mats = [np.frombuffer(bytes(p), dtype=np.uint8) for p in payloads]
        if not mats:
            return 0
        try:
            rates = [Rate(operator.index(rate))] * len(mats)
        except TypeError:       # not an integer: per-frame rates
            rates = [Rate(operator.index(r)) for r in rate]
            if len(rates) != len(mats):
                raise ValueError("per-frame rates must match payloads")
        if len(set(rates)) == 1:
            re, im, _ = self._build_burst(mats, rates[0])
        else:
            # one build per distinct rate, the frames then laid out in the
            # burst's order
            frames: list = [None] * len(mats)
            for r in sorted(set(rates)):
                idx = [i for i, ri in enumerate(rates) if ri == r]
                g_re, g_im, counts = self._build_burst(
                    [mats[i] for i in idx], r)
                ends = np.cumsum(counts)
                for i, lo, hi in zip(idx, ends - counts, ends):
                    frames[i] = (g_re[lo:hi], g_im[lo:hi])
            re = np.concatenate([f[0] for f in frames])
            im = np.concatenate([f[1] for f in frames])
        self._send(re, im)
        return int(re.size)


class CaptureSink:
    """A sink that keeps what it is sent (fun_ofdm_tpu's _CaptureSink):
    `re` and `im` are all samples so far, float32."""

    def __init__(self):
        self._re: list[np.ndarray] = []
        self._im: list[np.ndarray] = []

    def send_burst(self, samples) -> None:
        re, im = samples
        self._re.append(np.asarray(re, np.float32))
        self._im.append(np.asarray(im, np.float32))

    send_burst_sync = send_burst

    @property
    def re(self) -> np.ndarray:
        return np.concatenate(self._re) if self._re \
            else np.zeros(0, np.float32)

    @property
    def im(self) -> np.ndarray:
        return np.concatenate(self._im) if self._im \
            else np.zeros(0, np.float32)


def tx_len(txr, payload, rate: Rate) -> int:
    """Sample count of one frame (320 + 80*(1 + num_symbols))."""
    return params_for(Rate(rate)).frame_samples(len(bytes(payload)))


class Receiver:
    """Pulls sample chunks from a source, runs the streaming receiver
    chain on `device`, and delivers CRC-valid packets to a callback.

    Reference equivalent: receiver (src/receiver.cpp:16-77), which spawns
    its own RX thread running get_samples -> process_samples -> callback
    with semaphore pause/resume. The source is any object with
    `get_samples(n) -> (re, im)` (LoopbackRadio, FileSource, UdpSource or
    user code).

    callback: fn(list[DecodedPacket]), called from the RX thread with the
    packets a chunk completed (reference callback contract,
    src/receiver.h:58), and from stop()'s caller with the final flush's.
    An exception in the RX thread ends it and is raised by stop().

    On a GPU the chain's kernel library is built here, before the RX
    thread starts, and both threads run the chain under the chain's
    device.

    The chain's arguments are ReceiverChain's; viterbi_impl is None or
    "auto", "exact" or "blocked", and the constructor refuses any other.
    """

    def __init__(self, callback: Callable[[list], None],
                 source=None,
                 params: RadioParams = RadioParams(),
                 chain_params: ChainParams = DEFAULT_PARAMS,
                 rates: tuple[Rate, ...] = ALL_RATES,
                 max_length: int = 1500,
                 cfo_correct: bool = False,
                 start: bool = True,
                 ingest_dtype: str = "float32",
                 viterbi_impl: str | None = None,
                 decode_mode: str = "auto",
                 device="cuda"):
        self.device = _device(device)
        self.callback = callback
        self.source = source if source is not None else LoopbackRadio(params)
        self.chain = ReceiverChain(rates=rates, max_length=max_length,
                                   params=chain_params,
                                   cfo_correct=cfo_correct,
                                   ingest_dtype=ingest_dtype,
                                   viterbi_impl=viterbi_impl,
                                   decode_mode=decode_mode,
                                   prewarm_exact=True,
                                   device=self.device)
        self._chunk = chain_params.chunk_size
        self._running = threading.Event()   # set = not paused
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        self._running.set()
        if start:
            self.start()

    def _on_device(self):
        """The chain's CUDA device as the calling thread's current one (a
        new thread starts on device 0)."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._rx_loop, name="fun_ofdm_rx", daemon=True)
        self._thread.start()

    def _rx_loop(self) -> None:
        # reference receiver_chain_loop (src/receiver.cpp:42-58)
        try:
            with self._on_device():
                while not self._stop.is_set():
                    self._running.wait()    # the reference's sem_wait(m_pause)
                    if self._stop.is_set():
                        break
                    re, im = self.source.get_samples(self._chunk)
                    packets = self.chain.process_samples((re, im))
                    if packets:
                        self.callback(packets)
        except Exception as exc:    # ends the thread; stop() raises it
            self._error = exc

    def pause(self) -> None:
        """Pause the receiver chain (reference: src/receiver.cpp:64-70)."""
        self._running.clear()

    def resume(self) -> None:
        """Resume the receiver chain (reference: src/receiver.cpp:72-77)."""
        self._running.set()

    def stop(self, timeout: float = 10.0) -> None:
        """Stop the RX thread, then drain the buffered samples to the
        callback. Raises, without flushing, if the thread has not ended
        within `timeout` seconds (a flush beside a running
        process_samples would corrupt the chain), and re-raises an
        exception that ended the thread."""
        self._stop.set()
        self._running.set()
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise RuntimeError(
                    f"the RX thread did not end within {timeout} s; the "
                    f"chain was not flushed")
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error
        with self._on_device():
            packets = self.chain.flush()
        if packets:
            self.callback(packets)
