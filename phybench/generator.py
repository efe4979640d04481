"""The benchmark's one traffic generator.

A traffic mix is a JSON file of parameters under phybench/traffic/; this
module turns it, a configuration and a seed into the cell's inputs. The
frames come from the plain transmitter in phybench/reference, never from
the program, and every frame carries its own payload bytes, drawn from the
seed in one call. Every seed gives the same sizes and arrivals; only the
bytes and the noise differ.

Every `noisy_every`-th frame (the traffic's key; none without it) carries
complex white Gaussian noise over its SIGNAL and data symbols at the
configuration's checked_snr_db, relative to the nominal power of a symbol
sample; its preamble stays clean, so it is found where it was planted.
The noise comes from a torch.Generator on the device, seeded from --seed.
A configuration with a wire_scale puts every sample on its integer wire's
grid (wire_bits signed bits), as the radio would deliver it.

Layouts ("layout" in the traffic file):
  capture       `captures` distinct recordings: per channel, the
                configuration's frames_per_channel frames back to back,
                then pad_frames frame lengths of zeros; planar float32 on
                the device.
  back_to_back  a recording of `units` units, each frames_per_unit frames
                back to back and unit_tail zeros; host float32.
  lone          lone frames, each followed by `gap` zeros; host float32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from phybench.reference import phy


@dataclass
class Traffic:
    """What a cell's entry driver receives."""

    rate: int                   # reference rate index
    rate_name: str
    length: int                 # payload bytes of every frame
    frame_len: int              # samples of one frame
    payloads: np.ndarray        # (N, length) uint8, every frame's bytes
    noisy: np.ndarray           # (N,) bool, the frames at the checked SNR
    #: capture: [(re, im)] of (C, n) device tensors, one per capture
    captures: list = field(default_factory=list)
    #: capture: (captures, C, F) frame starts in each channel
    capture_starts: np.ndarray | None = None
    #: streams: the recording, (re, im) host float32, and its frame starts
    stream: tuple | None = None
    stream_starts: np.ndarray | None = None


def payloads(seed: int, n: int, length: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, size=(n, length),
                                                dtype=np.uint8)


def noisy_mask(n: int, every) -> np.ndarray:
    """Frames i with i % every == every - 1 (none when every is None)."""
    i = np.arange(n)
    return (i % int(every) == int(every) - 1) if every else i < 0


def _frames(pay: np.ndarray, rate: int, device, noisy: np.ndarray,
            snr_db, seed: int) -> torch.Tensor:
    """(N, frame_len) complex64 frames from the plain transmitter, the
    noisy ones with AWGN after their preamble."""
    f = phy.build_frames(pay, rate, device)
    idx = np.flatnonzero(noisy)
    if idx.size:
        g = torch.Generator(device=device)
        g.manual_seed(int(np.random.SeedSequence([seed, 3]).generate_state(
            1, np.uint64)[0]))
        sd = math.sqrt(phy.SYMBOL_POWER / 10 ** (float(snr_db) / 10) / 2)
        n = f.shape[1] - phy.PREAMBLE_LEN
        w = torch.randn((idx.size, n, 2), generator=g, device=device,
                        dtype=torch.float64) * sd
        at = torch.from_numpy(idx).to(device)
        f[at, phy.PREAMBLE_LEN:] += torch.view_as_complex(w)
    return f.to(torch.complex64)


def on_wire(x: torch.Tensor, config: dict) -> torch.Tensor:
    """Complex samples on the configuration's integer wire grid, if any."""
    if "wire_scale" not in config:
        return x
    scale, top = float(config["wire_scale"]), 1 << (int(config["wire_bits"])
                                                    - 1)

    def grid(v):
        return torch.clamp(torch.round(v * scale), -top, top - 1) / scale
    return torch.complex(grid(x.real), grid(x.imag))


def make(config: dict, traffic: dict, seed: int, device) -> Traffic:
    rate = phy.RATE_BY_NAME[config["rate"]]
    length = int(config["length"])
    frame_len = phy.frame_samples(rate, length)
    layout = traffic["layout"]
    every, snr = traffic.get("noisy_every"), config.get("checked_snr_db")
    base = dict(rate=rate, rate_name=config["rate"], length=length,
                frame_len=frame_len)
    if layout == "capture":
        caps, ch = int(traffic["captures"]), int(config["channels"])
        per = int(config["frames_per_channel"])
        tail = int(config["pad_frames"]) * frame_len
        pay = payloads(seed, caps * ch * per, length)
        noisy = np.tile(noisy_mask(per, every), caps * ch)
        f = _frames(pay, rate, device, noisy, snr, seed)
        f = on_wire(f.reshape(caps, ch, per * frame_len), config)
        f = torch.nn.functional.pad(f, (0, tail))
        captures = [(c.real.contiguous(), c.imag.contiguous()) for c in f]
        starts = np.broadcast_to(frame_len * np.arange(per),
                                 (caps, ch, per)).copy()
        return Traffic(payloads=pay, noisy=noisy, captures=captures,
                       capture_starts=starts, **base)
    if layout == "back_to_back":
        units, per = int(traffic["units"]), int(traffic["frames_per_unit"])
        tail = int(traffic["unit_tail"])
        pay = payloads(seed, units * per, length)
        noisy = noisy_mask(units * per, every)
        f = _frames(pay, rate, device, noisy, snr, seed)
        f = f.reshape(units, per * frame_len)
        x = torch.nn.functional.pad(f, (0, tail)).reshape(-1)
        unit = per * frame_len + tail
        starts = (unit * np.arange(units)[:, None]
                  + frame_len * np.arange(per)[None]).reshape(-1)
    elif layout == "lone":
        n, gap = int(traffic["frames"]), int(traffic["gap"])
        pay = payloads(seed, n, length)
        noisy = noisy_mask(n, every)
        f = _frames(pay, rate, device, noisy, snr, seed)
        x = torch.nn.functional.pad(f, (0, gap)).reshape(-1)
        starts = (frame_len + gap) * np.arange(n)
    else:
        raise ValueError(f"unknown traffic layout {layout!r}")
    x = on_wire(x, config).cpu()
    stream = (x.real.numpy().copy(), x.imag.numpy().copy())
    return Traffic(payloads=pay, noisy=noisy, stream=stream,
                   stream_starts=starts, **base)
