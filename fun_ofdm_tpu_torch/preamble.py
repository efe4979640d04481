"""802.11a preamble: STS/LTS training sequences and the 320-sample preamble
(the port's own copy of fun_ofdm_tpu/preamble.py, numpy only).

Everything here is derived in closed form from the 802.11a-1999 standard
(section 17.3.3): the short training sequence is the IFFT of the +-(1+j)
pattern on every 4th subcarrier scaled by sqrt(13/6); the long training
sequence is the IFFT of the +-1 LTS subcarrier pattern. The reference ships
these as hardcoded tables (reference: src/preamble.h:24,363,432,501); ours are
computed; `tests/test_preamble.py` verifies fun_ofdm_tpu's against the
standard values, and `tests/test_torch_ops.py` holds this copy equal to it.

Windowing quirk replicated from the reference tables: sample 0 of the STS
section and sample 0 of the LTS section (index 160) are halved. (The
reference's table stores -0.078 at index 160 - a hand-truncated -0.078125;
we use the exact half, a ~1e-4 deviation in one TX sample with no effect on
decode.)

Subcarrier indexing convention (everywhere in this package): a 64-bin symbol
vector is in *centered* order - index 0 is subcarrier -32, index 32 is DC,
index 63 is subcarrier +31 (reference: src/fft.cpp:20-24 fft_map).
"""

from __future__ import annotations

import numpy as np

FFT_LEN = 64
STS_LENGTH = 16
LTS_LENGTH = 64
PREAMBLE_LENGTH = 320


def _sts_freq() -> np.ndarray:
    """STS frequency-domain sequence, centered order (802.11a 17.3.3.1)."""
    s = np.zeros(FFT_LEN, dtype=np.complex128)
    pp = 1 + 1j
    mm = -1 - 1j
    vals = {
        -24: pp, -20: mm, -16: pp, -12: mm, -8: mm, -4: pp,
        4: mm, 8: mm, 12: pp, 16: pp, 20: pp, 24: pp,
    }
    for k, v in vals.items():
        s[k + 32] = np.sqrt(13.0 / 6.0) * v
    return s


def _lts_freq() -> np.ndarray:
    """LTS frequency-domain sequence, centered order (802.11a 17.3.3.2)."""
    lo = [1, 1, -1, -1, 1, 1, -1, 1, -1, 1, 1, 1, 1, 1, 1, -1, -1, 1, 1, -1, 1, -1, 1, 1, 1, 1]
    hi = [1, -1, -1, 1, 1, -1, 1, -1, 1, -1, -1, -1, -1, -1, 1, 1, -1, -1, 1, -1, 1, -1, 1, 1, 1, 1]
    s = np.zeros(FFT_LEN, dtype=np.complex128)
    s[6:32] = lo   # subcarriers -26..-1
    s[33:59] = hi  # subcarriers +1..+26
    return s


def freq_to_time(sym: np.ndarray) -> np.ndarray:
    """64-pt IFFT of a centered-order symbol (matches reference fft::inverse)."""
    return np.fft.ifft(np.fft.ifftshift(sym, axes=-1), axis=-1)


STS_FREQ_DOMAIN: np.ndarray = _sts_freq()
LTS_FREQ_DOMAIN: np.ndarray = _lts_freq()

#: One 16-sample period of the short training sequence (time domain).
STS_TIME_DOMAIN: np.ndarray = freq_to_time(STS_FREQ_DOMAIN)[:STS_LENGTH].copy()

#: The 64-sample long training symbol (time domain).
LTS_TIME_DOMAIN: np.ndarray = freq_to_time(LTS_FREQ_DOMAIN)

#: Conjugate LTS, the RX timing-sync matched filter (reference: preamble.h:432).
LTS_TIME_DOMAIN_CONJ: np.ndarray = np.conj(LTS_TIME_DOMAIN)


def _preamble() -> np.ndarray:
    """320-sample preamble: 10x STS, then 32-sample CP + 2x LTS.

    Matches reference PREAMBLE_SAMPLES (src/preamble.h:24) to ~1e-12 except
    the hand-truncated constant at index 160 (see module docstring).
    """
    sts_part = np.tile(STS_TIME_DOMAIN, 10)
    sts_part[0] *= 0.5
    lts_part = np.concatenate([LTS_TIME_DOMAIN[32:], LTS_TIME_DOMAIN, LTS_TIME_DOMAIN])
    lts_part[0] *= 0.5
    return np.concatenate([sts_part, lts_part])


PREAMBLE_SAMPLES: np.ndarray = _preamble()

# --- RX geometry: fixed offsets from the preamble start P -----------------
# The reference timing_sync tags LTS1 at (LTS CP start)+24, i.e. 8 samples
# into the 16-sample symbol margin (reference: src/timing_sync.cpp:102-106),
# and fft_symbols then frames 64-sample bodies on an 80-sample stride 8
# samples early (reference: src/fft_symbols.cpp:41-71). Relative to a
# perfectly detected preamble start P:
#   LTS1 body  = x[P+184 : P+248]
#   LTS2 body  = x[P+248 : P+312]
#   symbol k   = x[P+328+80k : P+392+80k]   (k=0 is SIGNAL)
LTS1_OFFSET = 184
LTS2_OFFSET = 248
SYMBOL0_OFFSET = 328
SYMBOL_STRIDE = 80
