"""Batched 64-point FFT/IFFT in the centred subcarrier convention.

Counterpart of fun_ofdm_tpu/ops/fft64.py (reference: src/fft.cpp:20-96):
index 0 is subcarrier -32, and the inverse scales by 1/64.

  forward:  sym[k]  = sum_n time[n] e^{-2pi i (k-32) n / 64}
            = fftshift(fft(time))
  inverse:  time[n] = (1/64) sum_k sym[k] e^{+2pi i n (k-32) / 64}
            = ifft(ifftshift(sym))

The JAX package computes these as DFT matmuls because the TPU has no
complex dtype; here they go to torch.fft.
"""

from __future__ import annotations

import torch


def forward(samples: torch.Tensor) -> torch.Tensor:
    """(..., 64) complex time samples -> centred-order bins."""
    return torch.fft.fftshift(torch.fft.fft(samples, dim=-1), dim=-1)


def inverse(symbols: torch.Tensor) -> torch.Tensor:
    """(..., 64) centred-order complex bins -> time samples."""
    return torch.fft.ifft(torch.fft.ifftshift(symbols, dim=-1), dim=-1)


def forward_p(samples):
    """Planar form of forward."""
    out = forward(torch.complex(*samples))
    return out.real, out.imag


def inverse_p(symbols):
    """Planar form of inverse."""
    out = inverse(torch.complex(*symbols))
    return out.real, out.imag

