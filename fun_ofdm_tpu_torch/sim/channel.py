"""Baseband channel impairment models, planar (re, im) and batched.

Counterpart of fun_ofdm_tpu/sim/channel.py. The reference has no channel
simulator (its only hardware-free test is a noise-free loopback,
reference: examples/test_sim.cpp:43-104), so the statistical baseline
(BER/PER vs SNR, sim/ber.py) is generated here. Every impairment maps
planar (re, im) tensors over the last axis and broadcasts over leading
batch dims:

  * AWGN at a given SNR (dB) relative to a reference signal power; the
    noise comes from an explicit torch.Generator on the tensor's device,
    or is given (standard normals) so that a test can feed both packages
    the same draws;
  * carrier frequency offset (CFO), e^{j 2 pi f n}, f in cycles/sample;
  * static phase offset and amplitude scale;
  * multipath: complex FIR taps, 1-sample spacing;
  * integer sample delay.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

#: average per-sample power of a TX frame: 52 active unit-power subcarrier
#: bins spread by the 1/64-scaled IFFT give E|x[n]|^2 = 52/64^2 (the
#: preamble matches). The default SNR reference, so "SNR" means per-sample
#: signal power / noise power over the occupied samples.
DEFAULT_SIGNAL_POWER = 52.0 / 4096.0


def awgn(x, generator: torch.Generator | None, snr_db,
         signal_power: float = DEFAULT_SIGNAL_POWER, noise=None):
    """Add complex white Gaussian noise for a target SNR in dB.

    Noise variance per complex sample is signal_power / 10^(snr/10), split
    evenly between the planar components. snr_db: a scalar or anything
    broadcastable against x's batch dims. The standard normals come from
    `generator` (a torch.Generator on x's device), or from `noise`, a
    (n_re, n_im) pair of x's shape, when given.
    """
    re, im = x
    snr = torch.as_tensor(snr_db, dtype=re.dtype, device=re.device)
    sigma = torch.sqrt(signal_power / 10.0 ** (snr / 10.0) / 2.0)
    while sigma.ndim < re.ndim:
        sigma = sigma[..., None]
    if noise is None:
        noise = tuple(torch.randn(re.shape, generator=generator,
                                  dtype=re.dtype, device=re.device)
                      for _ in range(2))
    n_re, n_im = (torch.as_tensor(n, dtype=re.dtype, device=re.device)
                  for n in noise)
    return re + sigma * n_re, im + sigma * n_im


def cfo(x, freq_norm):
    """Carrier frequency offset: x[n] * e^{j 2 pi freq_norm n}.

    freq_norm is the offset in cycles per sample (f_offset_Hz / f_sample;
    at the reference's 5 MS/s, src/usrp.h:43, a 1 kHz error is 2e-4). The
    angle is formed in float32 over a float32 sample index, as in
    fun_ofdm_tpu.
    """
    re, im = x
    n = torch.arange(re.shape[-1], dtype=re.dtype, device=re.device)
    f = torch.as_tensor(freq_norm, dtype=re.dtype, device=re.device)
    ang = 2.0 * math.pi * f * n
    c, s = torch.cos(ang), torch.sin(ang)
    return re * c - im * s, re * s + im * c


def phase(x, phi):
    """Static phase rotation by phi radians."""
    re, im = x
    p = torch.as_tensor(phi, dtype=re.dtype, device=re.device)
    c, s = torch.cos(p), torch.sin(p)
    return re * c - im * s, re * s + im * c


def scale(x, amp):
    """Amplitude scale (the reference's tx_amp, src/usrp.cpp:94)."""
    re, im = x
    a = torch.as_tensor(amp, dtype=re.dtype, device=re.device)
    return re * a, im * a


def multipath(x, taps: Sequence[complex] | np.ndarray):
    """Convolve with a static complex FIR channel (same-length output).

    taps[0] is the line-of-sight tap; later taps are echoes at 1-sample
    spacing. The delay spread must stay under the 16-sample cyclic prefix
    for the zero-forcing equalizer to invert it exactly.
    """
    re, im = x
    out_re, out_im = torch.zeros_like(re), torch.zeros_like(im)
    for d, t in enumerate(np.asarray(taps, np.complex128)):
        if t == 0:
            continue
        sre = torch.nn.functional.pad(re, (d, 0))[..., :re.shape[-1]]
        sim = torch.nn.functional.pad(im, (d, 0))[..., :im.shape[-1]]
        tr, ti = float(t.real), float(t.imag)
        out_re = out_re + sre * tr - sim * ti
        out_im = out_im + sre * ti + sim * tr
    return out_re, out_im


def delay(x, n: int):
    """Prepend n zero samples (shifts frame starts right by n)."""
    re, im = x
    return (torch.nn.functional.pad(re, (n, 0)),
            torch.nn.functional.pad(im, (n, 0)))


def rayleigh_taps(generator: torch.Generator | None, n_taps: int,
                  decay_db_per_tap: float = 3.0) -> np.ndarray:
    """A random normalized Rayleigh-fading power-delay profile.

    Complex taps with exponentially decaying mean power and unit total
    power (numpy, host side: channels are static per trial). The normals
    come from `generator` (on the CPU).
    """
    p = 10.0 ** (-decay_db_per_tap * np.arange(n_taps) / 10.0)
    p = p / p.sum()
    re = torch.randn(n_taps, generator=generator,
                     dtype=torch.float64).numpy() * np.sqrt(p / 2)
    im = torch.randn(n_taps, generator=generator,
                     dtype=torch.float64).numpy() * np.sqrt(p / 2)
    taps = re + 1j * im
    return taps / np.abs(np.sqrt((np.abs(taps) ** 2).sum()))
