"""The comparison that decides `correct`.

Every number here has a limit (LIMITS); a run is correct when each number
it reports is at or under its limit. The traffic's noiseless frames are
compared exactly with what was planted; its noisy frames, at the
configuration's checked SNR, with the plain receiver's float64 decode of
the same samples (phybench/reference/phy.py).

  frames_wrong       every noiseless frame due in the window not delivered
                     exactly once with its payload, rate, length, channel
                     and start; every noisy frame not detected at its
                     start (the capture's slots); every delivery of
                     something not planted, or delivered again
  noisy_vs_ref       distinct noisy frames for which some answer of the
                     window differs from the float64 plain receiver's: a
                     payload delivered where its CRC fails there, none
                     where it holds, or another payload, rate or length
  ref_detect_wrong   sampled noiseless frames whose preamble the plain
                     receiver does not find exactly once, at their start
  ref_decode_wrong   sampled noiseless frames the plain receiver decodes
                     to another rate, length or payload than planted, or
                     with a bad CRC
  program_vs_ref     sampled noiseless frames whose delivered payload
                     differs from the plain receiver's decode of them
"""

from __future__ import annotations

import numpy as np
import torch

from phybench.reference import phy

#: set between the program's readings and the bfloat16 control's on the
#: chip (PERF.md, "Limits of correct")
NOISY_VS_REF = 3

LIMITS = {
    "frames_wrong": 0,
    "noisy_vs_ref": NOISY_VS_REF,
    "ref_detect_wrong": 0,
    "ref_decode_wrong": 0,
    "program_vs_ref": 0,
}

#: samples kept on each side of a frame for the plain receiver
GUARD = 256
#: frames the plain receiver decodes in one batch
BATCH = 256


def compare_frames(got: list, planted: dict, optional: dict | None = None
                   ) -> int:
    """got: (channel, start, payload bytes, rate name, length) of every
    delivery; planted: {(channel, start): (payload bytes, rate name,
    length)} of the frames that must come; optional: frames of the same
    form that may come (the one the end of the fed stream cuts: its
    payload may lie whole in what was fed). Returns frames_wrong."""
    allowed = {**(optional or {}), **planted}
    seen: dict = {}
    extra = 0
    for ch, start, payload, rate, length in got:
        key = (ch, start)
        if key in seen or allowed.get(key) != (payload, rate, length):
            extra += 1
        seen[key] = True
    missing = sum(1 for k in planted if k not in seen)
    return missing + extra


def _laid_out(regions: list, device):
    """The regions end to end with zeros between, as one complex128 stream,
    and each frame's start in it."""
    gap = np.zeros(512, np.complex128)
    parts, starts, pos = [], [], 0
    for (re, im), at in regions:
        parts += [re.astype(np.float64) + 1j * im.astype(np.float64), gap]
        starts.append(pos + at)
        pos += re.size + gap.size
    return torch.from_numpy(np.concatenate(parts)).to(device), starts


def answers(regions: list, device, precision: str = "float64") -> list:
    """The plain receiver's answer for the frame in each region, decoded
    at its start in the working `precision`: (payload bytes, rate name,
    length) when its header and CRC hold, else None."""
    out = []
    for i in range(0, len(regions), BATCH):
        x, starts = _laid_out(regions[i:i + BATCH], device)
        dec = phy.decode(x, starts, precision)
        out += [(dec.payload[k], phy.RATES[int(dec.rate[k])][0],
                 int(dec.length[k]))
                if dec.header_ok[k] and dec.crc_ok[k] else None
                for k in range(len(starts))]
    return out


def noisy_vs_ref(program: dict, reference: dict) -> int:
    """program: {frame: [answer of each time the window decoded it]};
    reference: {frame: the float64 answer}. Distinct frames with an
    answer that differs."""
    return sum(1 for k, got in program.items()
               if any(a != reference[k] for a in got))


def reference_sample(regions: list, expected: list, program: list,
                     device) -> dict:
    """The plain receiver over sampled noiseless frames.

    regions: (re, im) float32 numpy samples around each sampled frame, and
    the frame's start inside them; expected: (payload bytes, rate index,
    length) as planted; program: the program's delivered payload for the
    frame, or None. The regions are laid end to end with zeros between, so
    one detection pass and one batched decode serve them all."""
    x, starts = _laid_out(regions, device)
    found = phy.detect(x[None])[0]
    detect_wrong = sum(1 for s in starts if np.count_nonzero(found == s) != 1)
    detect_wrong += len(set(found.tolist()) - set(starts))
    dec = phy.decode(x, np.array(starts))
    decode_wrong = vs_program = 0
    for i, (payload, rate, length) in enumerate(expected):
        ok = (dec.header_ok[i] and dec.rate[i] == rate
              and dec.length[i] == length and dec.crc_ok[i]
              and dec.payload[i] == payload)
        decode_wrong += not ok
        vs_program += program[i] != dec.payload[i]
    return {"ref_detect_wrong": int(detect_wrong),
            "ref_decode_wrong": int(decode_wrong),
            "program_vs_ref": int(vs_program)}


def region(re: np.ndarray, im: np.ndarray, start: int, frame_len: int):
    """Samples [start - GUARD, start + frame_len + GUARD) of a stream,
    clipped to it, and the frame's start inside them."""
    a = max(0, start - GUARD)
    b = min(re.size, start + frame_len + GUARD)
    return (re[a:b], im[a:b]), start - a


def judge(numbers: dict) -> bool:
    return all(v <= LIMITS[k] for k, v in numbers.items())
