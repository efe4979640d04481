"""A plain 802.11a transmitter and receiver in PyTorch, for the benchmark.

This is the benchmark's yardstick, written from the fun_ofdm reference's
semantics (src/ppdu.cpp, src/viterbi.cpp, src/qam.h, src/interleaver.cpp,
src/puncturer.cpp, src/frame_builder.cpp, src/symbol_mapper.cpp) and the
802.11a-1999 preamble (section 17.3.3), and held to the upstream C++
golden vectors (tests/golden/golden.npz) by phybench/tests. It imports
nothing of the program under test: every table below is written out or
derived here.

Everything is batched over frames with plain tensor operations and runs on
any device. The transmitter makes the receive cells' inputs; the receiver
finds frames in a stream (LTS matched filter) and decodes them at their
starts (the reference's body cuts, FFT, zero-forcing channel estimate,
pilot phase tracking, the reference's soft demap, deinterleave,
depuncture, an 8-bit Viterbi, descramble, CRC-32), in float64 as the
yardstick, or in float32 or bfloat16 up to the soft bits.

Conventions follow the reference: a 64-bin symbol is in centered order
(index 0 is subcarrier -32), the scrambler XORs one LFSR bit into each
byte's LSB, the interleaver permutes blocks of 48 bits, and the Viterbi
keeps 8-bit saturating path metrics.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass

import numpy as np
import torch

#: rate index -> (name, SIGNAL rate field, coded bits per symbol, data bits
#: per symbol, bits per subcarrier, code rate); the reference's Rate enum
RATES = {
    0: ("RATE_1_2_BPSK", 0xD, 48, 24, 1, "1/2"),
    1: ("RATE_2_3_BPSK", 0xE, 48, 32, 1, "2/3"),
    2: ("RATE_3_4_BPSK", 0xF, 48, 36, 1, "3/4"),
    3: ("RATE_1_2_QPSK", 0x5, 96, 48, 2, "1/2"),
    4: ("RATE_2_3_QPSK", 0x6, 96, 64, 2, "2/3"),
    5: ("RATE_3_4_QPSK", 0x7, 96, 72, 2, "3/4"),
    6: ("RATE_1_2_QAM16", 0x9, 192, 96, 4, "1/2"),
    7: ("RATE_2_3_QAM16", 0xA, 192, 128, 4, "2/3"),
    8: ("RATE_3_4_QAM16", 0xB, 192, 144, 4, "3/4"),
    9: ("RATE_2_3_QAM64", 0x1, 288, 192, 6, "2/3"),
    10: ("RATE_3_4_QAM64", 0x3, 288, 216, 6, "3/4"),
}
RATE_BY_NAME = {v[0]: k for k, v in RATES.items()}
RATE_BY_FIELD = {v[1]: k for k, v in RATES.items()}

#: coded bits kept of each puncturing period (reference: src/puncturer.cpp)
KEEP = {"1/2": (1, 1), "2/3": (1, 0, 1, 1), "3/4": (1, 1, 0, 1, 0, 1)}

#: the K=7 code's generators (reference: src/viterbi.cpp:39-62)
POLYS = (121, 91)
K = 7
#: an erased (punctured) soft bit
ERASURE = 127

#: per subcarrier, centered order: 0 null, 1 data, 2 pilot
ACTIVE = np.array(
    [0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
     1, 2, 1, 1, 1, 1, 1, 1, 0, 1, 1, 1, 1, 1, 1, 2, 1, 1, 1, 1, 1, 1, 1, 1,
     1, 1, 1, 1, 1, 2, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0])
DATA_BINS = np.flatnonzero(ACTIVE == 1)
PILOT_BINS = np.flatnonzero(ACTIVE == 2)
PILOT_VALUES = np.array([1.0, 1.0, 1.0, -1.0])
#: the pilots' 127-long polarity sequence (802.11a 17.3.5.9)
POLARITY = np.array(
    [1, 1, 1, 1, -1, -1, -1, 1, -1, -1, -1, -1, 1, 1, -1, 1,
     -1, -1, 1, 1, -1, 1, 1, -1, 1, 1, 1, 1, 1, 1, -1, 1,
     1, 1, -1, 1, 1, -1, -1, 1, 1, 1, -1, 1, -1, -1, -1, 1,
     -1, 1, -1, -1, 1, -1, -1, 1, 1, 1, 1, 1, -1, -1, 1, 1,
     -1, -1, 1, -1, 1, -1, 1, 1, -1, -1, -1, 1, 1, -1, -1, -1,
     -1, 1, -1, -1, 1, -1, 1, 1, 1, 1, -1, 1, -1, 1, -1, 1,
     -1, -1, -1, -1, -1, 1, -1, 1, 1, -1, 1, -1, 1, 1, 1, -1,
     -1, 1, -1, -1, -1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1], dtype=float)

PREAMBLE_LEN = 320
#: the first long training symbol starts here, from the preamble's start
LTS_OFFSET = 192
SYMBOL_LEN = 80
CP_LEN = 16
#: the mean power of a symbol's samples: 52 active bins of unit mean power
#: through the inverse DFT's 1/64
SYMBOL_POWER = 52 / 64 ** 2


def _centered_ifft(sym: np.ndarray) -> np.ndarray:
    return np.fft.ifft(np.fft.ifftshift(sym, axes=-1), axis=-1)


def lts_freq() -> np.ndarray:
    """The long training symbol's 64 bins, centered order (17.3.3)."""
    s = np.zeros(64)
    s[6:32] = [1, 1, -1, -1, 1, 1, -1, 1, -1, 1, 1, 1, 1, 1, 1, -1, -1, 1, 1,
               -1, 1, -1, 1, 1, 1, 1]
    s[33:59] = [1, -1, -1, 1, 1, -1, 1, -1, 1, -1, -1, -1, -1, -1, 1, 1, -1,
                -1, 1, -1, 1, -1, 1, 1, 1, 1]
    return s


def preamble() -> np.ndarray:
    """The 320-sample preamble: ten short symbols, a 32-sample guard and two
    long symbols. As in the reference's tables, the first sample of the
    short and of the long section is halved (the windowing of 17.3.3)."""
    sts = np.zeros(64, complex)
    for k, v in {-24: 1, -20: -1, -16: 1, -12: -1, -8: -1, -4: 1,
                 4: -1, 8: -1, 12: 1, 16: 1, 20: 1, 24: 1}.items():
        sts[k + 32] = np.sqrt(13 / 6) * v * (1 + 1j)
    short = np.tile(_centered_ifft(sts), 3)[:160]
    lts = _centered_ifft(lts_freq().astype(complex))
    long = np.concatenate([lts[32:], lts, lts])
    out = np.concatenate([short, long])
    out[0] *= 0.5
    out[160] *= 0.5
    return out


def num_symbols(rate: int, length: int) -> int:
    """OFDM data symbols of a `length`-byte payload (service, CRC, tail)."""
    return -(-(16 + 8 * (length + 4) + 6) // RATES[rate][3])


def frame_samples(rate: int, length: int) -> int:
    return PREAMBLE_LEN + SYMBOL_LEN * (1 + num_symbols(rate, length))


def trellis_steps(rate: int, length: int) -> int:
    """Viterbi steps of one payload: every data bit of the symbols, tail
    included."""
    return num_symbols(rate, length) * RATES[rate][3]


def keystream(n: int) -> np.ndarray:
    """The scrambler's per-byte bits from seed 93 (x^7 + x^4 + 1)."""
    state, out = 93, np.zeros(n, np.int64)
    for i in range(n):
        fb = ((state >> 6) & 1) ^ ((state >> 3) & 1)
        out[i] = fb
        state = ((state << 1) & 0x7E) | fb
    return out


def interleave_map() -> np.ndarray:
    k = np.arange(48)
    return 3 * (k % 16) + k // 16


def _bits_msb(data: torch.Tensor) -> torch.Tensor:
    """(..., n) bytes -> (..., 8n) bits, most significant first."""
    shifts = torch.arange(7, -1, -1, device=data.device)
    return ((data[..., None] >> shifts) & 1).reshape(*data.shape[:-1], -1)


def conv_encode(bits: torch.Tensor) -> torch.Tensor:
    """(..., n) bits -> (..., 2n) coded bits, the shift register starting at
    0 and bit i - k at register bit k."""
    n = bits.shape[-1]
    padded = torch.nn.functional.pad(bits, (K - 1, 0))
    out = []
    for poly in POLYS:
        acc = torch.zeros_like(bits)
        for k in range(K):
            if (poly >> k) & 1:
                acc = acc ^ padded[..., K - 1 - k:K - 1 - k + n]
        out.append(acc)
    return torch.stack(out, -1).reshape(*bits.shape[:-1], 2 * n)


def puncture(coded: torch.Tensor, rate: int) -> torch.Tensor:
    keep = KEEP[RATES[rate][5]]
    g = coded.reshape(*coded.shape[:-1], -1, len(keep))
    return g[..., [i for i, k in enumerate(keep) if k]].reshape(
        *coded.shape[:-1], -1)


def depuncture(soft: torch.Tensor, rate: int) -> torch.Tensor:
    keep = KEEP[RATES[rate][5]]
    kept = [i for i, k in enumerate(keep) if k]
    g = soft.reshape(*soft.shape[:-1], -1, len(kept))
    out = torch.full(g.shape[:-1] + (len(keep),), ERASURE, dtype=soft.dtype,
                     device=soft.device)
    out[..., kept] = g
    return out.reshape(*soft.shape[:-1], -1)


def interleave(bits: torch.Tensor) -> torch.Tensor:
    g = bits.reshape(*bits.shape[:-1], -1, 48)
    out = torch.empty_like(g)
    out[..., torch.from_numpy(interleave_map()).to(bits.device)] = g
    return out.reshape(bits.shape)


def deinterleave(soft: torch.Tensor) -> torch.Tensor:
    g = soft.reshape(*soft.shape[:-1], -1, 48)
    return g[..., torch.from_numpy(interleave_map()).to(soft.device)].reshape(
        soft.shape)


def _axis_scale(nbits: int, power: float) -> float:
    nn = 1 << (nbits - 1)
    return float(np.sqrt(power * nn / ((4 * nn ** 3 - nn) // 3)))


def modulate(bits: torch.Tensor, rate: int) -> torch.Tensor:
    """(..., n) interleaved bits -> (..., n / bpsc) complex points, as the
    reference's qam encoder lays them out (I from the first half of each
    group, Q from the second)."""
    bpsc = RATES[rate][4]
    g = bits.reshape(*bits.shape[:-1], -1, bpsc).to(torch.float64) * 2 - 1
    if bpsc == 1:
        return torch.complex(g[..., 0], torch.zeros_like(g[..., 0]))
    half = bpsc // 2
    axes = []
    for part in (g[..., :half], g[..., half:]):
        pt = torch.zeros_like(part[..., 0])
        flip = torch.ones_like(pt)
        for i in range(half):
            b = part[..., i]
            pt = b * flip + pt * 2
            flip = flip * -b
        axes.append(pt * _axis_scale(half, 0.5))
    return torch.complex(*axes)


def demodulate(points: torch.Tensor, rate: int,
               precision: str = "float64") -> torch.Tensor:
    """(..., m) complex points -> (..., m * bpsc) soft bits 0..255, the
    reference's fixed-point axis decoder (src/qam.h): the point scaled to
    8 - bits of gain (the product in the working precision), truncated
    toward zero, then bit by bit."""
    bpsc = RATES[rate][4]
    nb, power = (1, 1.0) if bpsc == 1 else (bpsc // 2, 0.5)
    axes = [points.real] if bpsc == 1 else [points.real, points.imag]
    out = []
    for a in axes:
        gain = 8 - nb
        scaled = a * ((1 << gain) / _axis_scale(nb, power))
        if precision == "bfloat16":
            scaled = (a.to(torch.bfloat16)
                      * ((1 << gain) / _axis_scale(nb, power))).float()
        pt = torch.trunc(scaled).to(torch.int64)
        flip = torch.ones_like(pt)
        amp = (1 << (nb - 1)) << gain
        for _ in range(nb):
            out.append(torch.clamp(flip * pt + 128, 0, 255))
            s = torch.where(pt >= 0, 1, -1)
            pt = pt - s * amp
            flip = -s
            amp //= 2
    return torch.stack(out, -1).reshape(*points.shape[:-1], -1)


def crc32_rows(rows: np.ndarray) -> np.ndarray:
    """CRC-32 (zlib's polynomial) of each row of a (B, n) uint8 array."""
    return np.array([zlib.crc32(r.tobytes()) for r in rows], np.uint64)


def signal_bits(rate: int, length: int) -> np.ndarray:
    """The 24 SIGNAL bits: rate field, length, even parity, 6 tail zeros."""
    field = ((RATES[rate][1] & 0xF) << 13) | (length & 0xFFF)
    if bin(field).count("1") & 1:
        field |= 1 << 17
    field <<= 6
    return np.array([(field >> (23 - i)) & 1 for i in range(24)], np.int64)


def encode(payload: np.ndarray, rate: int, device="cpu") -> torch.Tensor:
    """(B, L) payload bytes -> (B, 48 * (1 + nsym)) complex points: the
    BPSK SIGNAL symbol, then the data symbols (reference: ppdu encode)."""
    b, length = payload.shape
    nsym = num_symbols(rate, length)
    n_bits = nsym * RATES[rate][3]
    n_bytes = n_bits // 8
    data = np.zeros((b, n_bytes + 1), np.int64)
    data[:, 2:2 + length] = payload
    crc = crc32_rows(data[:, :2 + length].astype(np.uint8))
    for i in range(4):
        data[:, 2 + length + i] = (crc >> np.uint64(8 * i)) & np.uint64(0xFF)
    data[:, :n_bytes] ^= keystream(n_bytes)
    bits = _bits_msb(torch.from_numpy(data).to(device))[:, :n_bits]
    coded = interleave(puncture(conv_encode(bits), rate))
    hdr = torch.from_numpy(signal_bits(rate, length)).to(device)
    hdr = interleave(conv_encode(hdr)).expand(b, 48)
    return torch.cat([modulate(hdr, 0), modulate(coded, rate)], -1)


def build_frames(payload: np.ndarray, rate: int,
                 device="cpu") -> torch.Tensor:
    """(B, L) payload bytes -> (B, frame_samples) complex128 baseband
    frames: points mapped onto 48 data and 4 pilot bins, a 64-point
    inverse DFT, a 16-sample cyclic prefix, the preamble in front."""
    points = encode(payload, rate, device)
    b = points.shape[0]
    syms = points.reshape(b, -1, 48)
    nsym = syms.shape[1]
    grid = torch.zeros(b, nsym, 64, dtype=torch.complex128, device=device)
    grid[..., torch.from_numpy(DATA_BINS).to(device)] = syms
    pol = POLARITY[np.arange(nsym) % 127]
    pilots = torch.from_numpy(pol[:, None] * PILOT_VALUES[None]).to(device)
    grid[..., torch.from_numpy(PILOT_BINS).to(device)] = pilots.to(
        torch.complex128)
    t = torch.fft.ifft(torch.fft.ifftshift(grid, dim=-1), dim=-1)
    body = torch.cat([t[..., 64 - CP_LEN:], t], -1).reshape(b, -1)
    pre = torch.from_numpy(preamble()).to(device)
    return torch.cat([pre.expand(b, PREAMBLE_LEN), body], -1)


# --------------------------------------------------------------------------
# receiver


def viterbi(soft: torch.Tensor, nbits: int) -> torch.Tensor:
    """(B, 2 (nbits + 6)) soft bits 0..255 -> (B, nbits) bits: the
    reference's 8-bit decoder (src/viterbi.cpp:166-459): branch metrics
    (a + b + 1) >> 3 of the XOR with the expected bits, metrics saturating
    at 255, renormalised when state 0 passes 210, a trailing odd step
    dropped, traceback from state 0."""
    dev = soft.device
    b = soft.shape[0]
    total = nbits + K - 1
    steps = (total // 2) * 2
    s = torch.arange(32, device=dev)

    def parity(x):
        x = x.clone()
        for sh in (4, 2, 1):
            x = x ^ (x >> sh)
        return x & 1

    bt0 = parity((2 * s) & POLYS[0]) * 255
    bt1 = parity((2 * s) & POLYS[1]) * 255
    metrics = torch.full((b, 64), 63, dtype=torch.int32, device=dev)
    metrics[:, 0] = 0
    dec = torch.zeros((total, b, 64), dtype=torch.bool, device=dev)
    soft = soft.to(torch.int32)
    lo, hi = metrics[:, :32], metrics[:, 32:]
    for t in range(steps):
        tm = ((soft[:, 2 * t, None] ^ bt0) + (soft[:, 2 * t + 1, None] ^ bt1)
              + 1) >> 3
        tc = 63 - tm
        lo, hi = metrics[:, :32], metrics[:, 32:]
        a0 = torch.clamp(lo + tm, max=255)
        a1 = torch.clamp(hi + tc, max=255)
        b0 = torch.clamp(lo + tc, max=255)
        b1 = torch.clamp(hi + tm, max=255)
        new = torch.stack([torch.minimum(a0, a1), torch.minimum(b0, b1)],
                          -1).reshape(b, 64)
        dec[t] = torch.stack([a1 <= a0, b1 <= b0], -1).reshape(b, 64)
        renorm = new[:, :1] > 210
        metrics = torch.where(renorm, new - new.min(1, keepdim=True).values,
                              new)
    bits = torch.zeros((b, nbits), dtype=torch.int64, device=dev)
    state = torch.zeros(b, dtype=torch.int64, device=dev)
    rows = torch.arange(b, device=dev)
    for t in range(total - 1, K - 2, -1):
        k = dec[t, rows, state].to(torch.int64)
        state = (state >> 1) | (k << 5)
        if t - (K - 1) < nbits:
            bits[:, t - (K - 1)] = k
    return bits


def lts_matches(x: torch.Tensor, threshold: float = 0.8) -> torch.Tensor:
    """Normalised matched filter of (..., n) complex samples against the long
    training symbol: (..., n - 63) in [0, 1], 1 where a window equals a
    multiple of it."""
    n = x.shape[-1]
    lts = torch.from_numpy(_centered_ifft(lts_freq().astype(complex))).to(
        x.device, torch.complex128)
    x = x.to(torch.complex128)
    nfft = 1 << int(np.ceil(np.log2(n + 64)))
    kernel = torch.zeros(nfft, dtype=torch.complex128, device=x.device)
    kernel[:64] = torch.flip(lts.conj(), [0])
    r = torch.fft.ifft(torch.fft.fft(x, nfft) * torch.fft.fft(kernel))
    r = r[..., 63:n]
    e = torch.nn.functional.pad(torch.cumsum(x.abs() ** 2, -1), (1, 0))
    energy = (e[..., 64:] - e[..., :-64]).clamp(min=0)
    return r.abs() / (lts.abs().square().sum().sqrt() * energy.sqrt() + 1e-12)


def detect(x: torch.Tensor, threshold: float = 0.8) -> list[np.ndarray]:
    """Frame starts in each row of (C, n) complex samples: a long training
    symbol matched at t and again at t + 64 marks a preamble at t - 192.
    Returns one sorted int64 array per row, starts >= 0 only."""
    c = lts_matches(x)
    hit = (c[..., :-64] > threshold) & (c[..., 64:] > threshold)
    out = []
    for row in hit.reshape(-1, hit.shape[-1]).cpu().numpy():
        t = np.flatnonzero(row) - LTS_OFFSET
        out.append(t[t >= 0])
    return out


def _fft_centered(t: torch.Tensor) -> torch.Tensor:
    return torch.fft.fftshift(torch.fft.fft(t, dim=-1), dim=-1)


#: the receiver's working precisions: "float64" (the yardstick), "float32",
#: and "bfloat16" (the step below float32: every stage's result rounded to
#: bfloat16, the 64-point DFT a bfloat16 matrix product)
PRECISIONS = ("float64", "float32", "bfloat16")


def _complex_dtype(precision: str):
    return torch.complex128 if precision == "float64" else torch.complex64


def _rounded(z: torch.Tensor, precision: str) -> torch.Tensor:
    """z in the working precision (bfloat16 parts held in complex64)."""
    z = z.to(_complex_dtype(precision))
    if precision != "bfloat16":
        return z
    bf = torch.bfloat16
    return torch.complex(z.real.to(bf).float(), z.imag.to(bf).float())


def _dft(t: torch.Tensor, precision: str) -> torch.Tensor:
    """The centered 64-point forward DFT of (..., 64) samples."""
    if precision != "bfloat16":
        return _fft_centered(t.to(_complex_dtype(precision)))
    n = np.arange(64)
    # time sample n -> bin k, subcarrier k - 32
    w = np.exp(-2j * np.pi * np.outer(n, n - 32) / 64)
    bf = torch.bfloat16
    wr = torch.from_numpy(w.real).to(t.device, bf)
    wi = torch.from_numpy(w.imag).to(t.device, bf)
    tr, ti = t.real.to(bf), t.imag.to(bf)
    return torch.complex((tr @ wr - ti @ wi).float(),
                         (tr @ wi + ti @ wr).float())


@dataclass
class Decoded:
    """The receiver's answer for a batch of frames, numpy rows."""

    rate: np.ndarray        # rate index from SIGNAL, -1 where it is invalid
    length: np.ndarray      # length from SIGNAL
    header_ok: np.ndarray   # parity holds and the rate field is known
    payload: list           # bytes of each frame (b"" where undecoded)
    crc_ok: np.ndarray


#: where a frame's bodies are cut, from its preamble's start: 8 samples
#: early, inside the cyclic prefix, as the reference's timing sync cuts
#: them (src/timing_sync.cpp:36-44); the channel estimate absorbs the
#: constant rotation
LTS_BODY, SYMBOL_BODY = LTS_OFFSET - 8, PREAMBLE_LEN + CP_LEN - 8


def _equalised(x: torch.Tensor, starts: torch.Tensor, nsym: int,
               precision: str = "float64"):
    """(B, 1 + nsym, 48) equalised data points of the frames at `starts` in
    the 1-D complex stream x: the zero-forcing inverse channel, the mean
    over both long symbols of LTS / received LTS, zero on inactive bins
    (src/channel_est.cpp:44-58), then each symbol's common phase taken out
    by its four pilots (src/phase_tracker.cpp:70-105)."""
    dev = x.device
    x = _rounded(x, precision)
    lts_at = (starts[:, None, None] + LTS_BODY
              + 64 * torch.arange(2, device=dev)[:, None]
              + torch.arange(64, device=dev))
    y = _dft(x[lts_at], precision)
    ref = torch.from_numpy(lts_freq()).to(dev, y.dtype)
    d = y.real * y.real + y.imag * y.imag
    inv = torch.where(d > 0, ref * y.conj() / torch.where(d > 0, d, 1), 0)
    h_inv = _rounded(inv.mean(1) * (ref != 0), precision)
    sym_at = (starts[:, None, None] + SYMBOL_BODY
              + SYMBOL_LEN * torch.arange(1 + nsym, device=dev)[None, :, None]
              + torch.arange(64, device=dev))
    z = _rounded(_dft(x[sym_at], precision) * h_inv[:, None, :], precision)
    pol = POLARITY[np.arange(1 + nsym) % 127]
    want = torch.from_numpy(pol[:, None] * PILOT_VALUES[None]).to(dev)
    pil = z[..., torch.from_numpy(PILOT_BINS).to(dev)]
    phase = torch.angle((pil * want).sum(-1))
    z = _rounded(z * torch.exp(-1j * phase)[..., None], precision)
    return z[..., torch.from_numpy(DATA_BINS).to(dev)]


def decode_headers(x: torch.Tensor, starts: np.ndarray,
                   precision: str = "float64"):
    """SIGNAL fields of the frames at `starts` in the 1-D stream x:
    (rate index or -1, length, header_ok) arrays."""
    st = torch.as_tensor(starts, dtype=torch.int64, device=x.device)
    pts = _equalised(x, st, 0, precision)[:, 0]
    soft = deinterleave(demodulate(pts, 0, precision))
    bits = viterbi(soft, 18).cpu().numpy()
    field = (bits << np.arange(23, 5, -1)).sum(1)
    parity_ok = np.array([bin(int(f)).count("1") % 2 == 0 for f in field])
    rate_field = (field >> 19) & 0xF
    rate = np.array([RATE_BY_FIELD.get(int(r), -1) for r in rate_field])
    length = (field >> 6) & 0xFFF
    ok = parity_ok & (rate >= 0)
    return np.where(ok, rate, -1), length, ok


def decode(x: torch.Tensor, starts, precision: str = "float64") -> Decoded:
    """Decode the frames whose preambles start at `starts` in the 1-D
    complex stream x: the SIGNAL header, then the payload at the rate and
    length it gives (frames of equal rate and length in one batch), in the
    working `precision` (PRECISIONS) up to the soft bits."""
    starts = np.asarray(starts, np.int64)
    n = x.shape[-1]
    rate, length, ok = decode_headers(x, starts, precision)
    payload = [b""] * len(starts)
    crc_ok = np.zeros(len(starts), bool)
    fits = ok & np.array([ok[i] and starts[i] + frame_samples(
        int(rate[i]), int(length[i])) <= n for i in range(len(starts))],
        bool)
    for r, ln in sorted({(int(rate[i]), int(length[i]))
                         for i in np.flatnonzero(fits)}):
        idx = np.flatnonzero(fits & (rate == r) & (length == ln))
        st = torch.as_tensor(starts[idx], device=x.device)
        nsym = num_symbols(r, ln)
        pts = _equalised(x, st, nsym, precision)[:, 1:].reshape(len(idx), -1)
        soft = depuncture(deinterleave(demodulate(pts, r, precision)), r)
        n_bits = nsym * RATES[r][3]
        n_bytes = n_bits // 8
        bits = viterbi(soft, n_bits - 6)
        byts = np.zeros((len(idx), n_bytes + 1), np.int64)
        nb = bits.shape[1] // 8 * 8
        packed = (bits[:, :nb].reshape(len(idx), -1, 8)
                  << torch.arange(7, -1, -1, device=x.device)).sum(-1)
        byts[:, :packed.shape[1]] = packed.cpu().numpy()
        if bits.shape[1] > nb:
            rest = bits[:, nb:].cpu().numpy()
            byts[:, nb // 8] = (rest << np.arange(7, 7 - rest.shape[1], -1)
                                ).sum(1)
        byts[:, :n_bytes] ^= keystream(n_bytes)
        byts = byts.astype(np.uint8)
        calc = crc32_rows(byts[:, :2 + ln])
        given = byts[:, 2 + ln:6 + ln].astype(np.uint64) @ (
            np.uint64(1) << (np.arange(4, dtype=np.uint64) * np.uint64(8)))
        for j, i in enumerate(idx):
            crc_ok[i] = given[j] == calc[j]
            payload[i] = byts[j, 2:2 + ln].tobytes()
    return Decoded(rate, length, ok, payload, crc_ok)
