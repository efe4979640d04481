"""K=7 rate-1/2 convolutional encoder, polynomials {121, 91}.

Counterpart of fun_ofdm_tpu/ops/convcode.py. Output pair i is the parity
of the last 7 input bits against each polynomial's taps (the shift
register starts at 0; reference: src/viterbi.cpp:39-62), computed over
sliding windows at once. The caller's input already holds the 6 tail
bits it wants encoded.
"""

from __future__ import annotations

import numpy as np
import torch

K = 7
POLYS = (121, 91)

#: _TAPS[k][m] = bit m of poly k; register bit m holds input bit b_{i-m}
_TAPS = np.array(
    [[(p >> m) & 1 for m in range(K)] for p in POLYS], dtype=np.int32)


def conv_encode(bits: torch.Tensor) -> torch.Tensor:
    """(..., n) bits -> (..., 2n) coded bits, g0 and g1 interleaved."""
    bits = bits.to(torch.int32)
    n = bits.shape[-1]
    padded = torch.nn.functional.pad(bits, (K - 1, 0))
    # windows[..., i, w] = padded[i + w] = b_{i-m} with m = K-1-w
    windows = padded.unfold(-1, K, 1)                      # (..., n, 7)
    taps = torch.from_numpy(_TAPS[:, ::-1].copy()).to(bits.device)
    outs = (windows[..., None, :] * taps).sum(-1, dtype=torch.int32) & 1
    return outs.reshape(*bits.shape[:-1], 2 * n)
