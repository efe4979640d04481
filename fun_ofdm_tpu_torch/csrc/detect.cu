// Frame detection for Hopper, sm_90a: the stream pass and the slot pass.
//
// Replaces no Pallas kernel. The JAX package computes detection as XLA
// array code (fun_ofdm_tpu/ops/correlate.py, models/frontend.py
// detect_frames_p), and the port ran the same algebra as ~200 eager PyTorch
// ops a call (fun_ofdm_tpu_torch/models/frontend.detect_frames, which stays
// the plain version: the wrapper takes it for CPU tensors). These two
// kernels give its outputs (starts, valid, dropped) exactly, and its LTS
// correlation to float32 rounding.
//
// What bounds it on this card: the 64-tap complex LTS matched filter in
// float64 (the configuration states complex128 for it), 256 FP64 FMAs a
// sample: 2.0 G FMAs for a 7.83 M-sample capture, 0.12 ms at the H100's
// 16.7 T FP64 FMA/s. The bytes are 8 a sample read and ~4.1 written, 0.03
// ms at 3.35 TB/s. The design:
//
// detect_stream_kernel, a block per (stream, tile of `tile` samples, a
// multiple of the 512-sample block). The tile's samples and their halo
// (`behind` = the plateau rounded up to 32 + 2 sts_length - 1, rounded up
// to 8, behind; the search reach, 64 + 63 ahead) are read once from device
// memory (8 loads in flight a thread) into shared memory as float64, with
// |x|^2 rounded in float32 as the plain version rounds it. Then, all on
// chip:
//  1. the LTS filter, 8 consecutive outputs a thread: the 64-tap loop is
//     unrolled, the taps are constants of this file (kLtsRe/kLtsIm, the
//     conjugate LTS; each FMA takes its tap from the constant bank), and
//     the 8 outputs share a register window of 8 samples (one 16-byte
//     shared load a tap for 32 FMAs; the layout pads one sample in 8, so
//     the lanes' loads fall in distinct banks). `lts_segments`
//     sub-magnitudes are hypot()s summed in float64, cast to float32 and
//     divided by the 64-sample float32 power; zero past n - 64. The peaks
//     (> threshold) become bits;
//  2. the STS lag products in float64, rounded to float32, and per window
//     the correlation and power as float32 sums of sts_length terms.
//     Every window sum (these and the LTS power) is taken per window,
//     never as a difference of running float sums: 8 neighbouring windows
//     a thread share their common terms (window_sums). The ratio's
//     comparison gives the `above` bits;
//  3. with exclusive prefix popcounts of the bit words, each sample's
//     plateau test (sts_plateau_length above samples before a sample that
//     is not) and its reach (a pair, peaks at p and p + 64, in the next
//     lts_search - 64 samples) are exact integer differences; their
//     conjunction is the event mask.
// It writes the LTS correlation of the tile, the event bits and each
// 512-block's event count.
//
// detect_slot_kernel, a block per stream. The first k events in position
// order, taking at most `cap` from each 512-block (16, the blocked
// extractor of models/frontend._first_k_true_blocked; 512, i.e. all, on its
// exact path): each thread sums a run of the block counts, 16 read at a
// time, a scan of the sums gives each run its first slot, and each thread
// pulls its blocks' first events from their bits. The events over the cap
// in blocks that start below `drop_limit` are counted. Then a warp a slot
// (its lanes keep the first 128 values in registers through the rounds):
// the top 5 of the next lts_search LTS values above the threshold,
// descending, ties to the lower position (the plain version's stable
// sort), as 5 rounds of a warp maximum of 64-bit keys (value, position),
// and peak 0 paired with the first of peaks 1..4 exactly 64 away.
//
// No host synchronisation, no allocation: the wrapper
// (ops/detect_cuda.py) allocates outputs and scratch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// models/frontend._BLOCK: the blocked extractor's block, 16 words of
// event bits
constexpr int kBlock = 512;
constexpr int kBlockWords = kBlock / 32;
// LTS outputs a thread
constexpr int kGroup = 8;
// most threads of a stream-pass block: a 1,536-sample tile's 208 output
// groups, three blocks an SM (96 registers a thread)
constexpr int kStreamThreads = 224;
constexpr int kSlotThreads = 1024;
// tile lengths tried, longest first
constexpr int kTiles[] = {1536, 1024, 512};

// preamble.LTS_TIME_DOMAIN_CONJ, the LTS matched filter's taps
__constant__ double kLtsRe[64] = {
    0.15625, -0.005121250360419823, 0.0397496983535005, 0.09683188459112749,
    0.021111770349329442, 0.059823844859014236, -0.11513121478170157,
    -0.03831596747441848, 0.09754126073623884, 0.05333773437415131,
    0.0009889797089881053, -0.1368048768158598, 0.0244758515211019,
    0.05866876712873734, -0.022483206307774027, 0.1192390885103326, 0.0625,
    0.036917942001067135, -0.057206345871499156, -0.13126260897535943,
    0.08221832230305731, 0.06955684740689416, -0.0603101003162138,
    -0.056455128448539005, -0.03504126073623884, -0.12188700906074089,
    -0.1273243599077096, 0.07507369706822603, -0.0028059441734886725,
    -0.09188755526278003, 0.09171654912240958, 0.01228459045856715, -0.15625,
    0.012284590458567151, 0.09171654912240956, -0.09188755526278,
    -0.0028059441734886604, 0.07507369706822603, -0.1273243599077096,
    -0.12188700906074088, -0.03504126073623884, -0.05645512844853901,
    -0.0603101003162138, 0.06955684740689413, 0.08221832230305733,
    -0.13126260897535943, -0.05720634587149916, 0.03691794200106713, 0.0625,
    0.1192390885103326, -0.02248320630777402, 0.05866876712873734,
    0.0244758515211019, -0.13680487681585982, 0.0009889797089881018,
    0.05333773437415132, 0.09754126073623884, -0.03831596747441847,
    -0.11513121478170157, 0.059823844859014236, 0.021111770349329442,
    0.09683188459112749, 0.03974969835350049, -0.005121250360419835,
};
__constant__ double kLtsIm[64] = {
    -0.0, 0.12032513267372755, 0.1111579430511643, -0.08279790948776067,
    -0.027885918828227538, 0.08770675983572168, 0.05518049537437035,
    0.10617091261510256, 0.025888347648318447, -0.00407632648050834,
    0.11500464362403025, 0.04737981136568015, 0.05853179569459056,
    0.014938999450699444, -0.16065733295263412, 0.0040955944148015205, 0.0625,
    -0.0983441502870872, -0.039298588174111096, -0.06522722901814465,
    -0.09235655195372788, -0.014121958590578309, -0.08128612411572136,
    0.021803920607437136, 0.15088834764831843, 0.016566218139137195,
    0.020501379986300305, 0.07404041892509945, -0.053774266476545984,
    -0.11512870891096855, -0.10587165981863113, -0.09759955359207204, -0.0,
    0.09759955359207204, 0.10587165981863111, 0.11512870891096855,
    0.053774266476545984, -0.07404041892509947, -0.02050137998630029,
    -0.016566218139137195, -0.15088834764831843, -0.02180392060743714,
    0.08128612411572138, 0.014121958590578288, 0.09235655195372787,
    0.06522722901814465, 0.03929858817411108, 0.09834415028708719, -0.0625,
    -0.0040955944148015275, 0.16065733295263412, -0.014938999450699438,
    -0.058531795694590556, -0.04737981136568012, -0.11500464362403023,
    0.00407632648050835, -0.025888347648318447, -0.10617091261510256,
    -0.05518049537437035, -0.08770675983572167, 0.02788591882822755,
    0.08279790948776067, -0.11115794305116432, -0.12032513267372755,
};

// The stream pass's geometry, the same on the host and in the kernel.
struct Plan {
  int tile;     // samples a block owns, a multiple of kBlock
  int tiles;    // blocks a stream
  int pb;       // the plateau length rounded up to 32
  int behind;   // halo behind the tile, a multiple of 8
  int m;        // LTS outputs a block, a multiple of 32
  int xlen;     // samples a block holds, behind + m + 63
  int na;       // words of `above` bits, from the tile's start - pb
  int np;       // words of peak bits, from the tile's start
  int threads;  // threads a block
  long long smem;  // dynamic shared memory, bytes
};

__host__ __device__ inline int pad8(int i) { return i + (i >> 3); }

Plan make_plan(int tile, long long n, int sts_length, int plateau, int w) {
  Plan p;
  p.tile = tile;
  p.tiles = static_cast<int>((n + tile - 1) / tile);
  p.pb = (plateau + 31) / 32 * 32;
  p.behind = (p.pb + 2 * sts_length - 1 + 7) / 8 * 8;
  // peaks for [t0, t0 + tile + w + 63): pairs to t0 + tile + w - 1
  p.m = (tile + w + 63 + 31) / 32 * 32;
  p.xlen = p.behind + p.m + 63;
  p.na = (p.pb + tile) / 32;
  p.np = p.m / 32;
  const int groups = p.m / kGroup;
  const int rounds = (groups + kStreamThreads - 1) / kStreamThreads;
  const int per_round = (groups + rounds - 1) / rounds;
  p.threads = (per_round + 31) / 32 * 32;
  if (p.threads < 64) p.threads = 64;  // two warps scan the bit words
  const long long padded = pad8(p.xlen) + 1;
  p.smem = padded * 16            // xs, double2
           + p.xlen * 8LL         // ds, float2
           + padded * 4           // es, float
           + (tile / 32) * 4LL    // event words
           + (2LL * p.na + 1) * 4  // above bits and prefix counts
           + (3LL * p.np - 3) * 4;  // peak, pair bits, pair prefix counts
  return p;
}

struct StreamArgs {
  const float2* x;   // (streams, n) complex64
  float* lts;        // (streams, lts_stride)
  uint32_t* ev;      // (streams, nb * kBlockWords) event bits
  int* counts;       // (streams, nb) events a block
  long long n, lts_stride;
  int nb, sts_length, plateau, w;
  float sts_thr, lts_thr;
  Plan plan;
};

// Set bits of `bits` below bit x, from the exclusive prefix popcounts of
// its words (pre has one more entry than bits has words).
__device__ __forceinline__ int rank(const uint32_t* bits, const int* pre,
                                    int x) {
  const int w = x >> 5, b = x & 31;
  return b ? pre[w] + __popc(bits[w] & ((1u << b) - 1u)) : pre[w];
}

// One warp: pre[i] = set bits of words [0, i), for i <= count.
__device__ void warp_prefix_popc(const uint32_t* bits, int* pre, int count) {
  const int lane = threadIdx.x & 31;
  int carry = 0;
  for (int base = 0; base < count; base += 32) {
    const int i = base + lane;
    const int v = i < count ? __popc(bits[i]) : 0;
    int incl = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(~0u, incl, o);
      if (lane >= o) incl += t;
    }
    if (i < count) pre[i] = carry + incl - v;
    carry += __shfl_sync(~0u, incl, 31);
  }
  if (lane == 0) pre[count] = carry;
}

// Sums of G windows of `width` consecutive terms, the r-th starting at
// start + r: out[r] = (head_r + common) + tail_r, where common is the part
// all G windows share (width - G + 1 terms), head_r window r's terms before
// it and tail_r its terms after it; about (width + 3 G) / G adds and
// (width + G - 1) / G loads an output instead of width of each. Every sum
// is of the window's own terms: no difference of running sums, and a
// window of zeros sums to 0. Narrower windows are summed directly.
struct F3 {
  float x, y, z;
};

__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}

__device__ __forceinline__ F3 add(F3 a, F3 b) {
  return {__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z)};
}

template <int G, typename T, typename Term>
__device__ __forceinline__ void window_sums(Term term, int start, int width,
                                            T (&out)[G]) {
  if (width < G) {
#pragma unroll
    for (int r = 0; r < G; ++r) {
      out[r] = term(start + r);
      for (int m = 1; m < width; ++m) out[r] = add(out[r], term(start + r + m));
    }
    return;
  }
  T common = term(start + G - 1);
  for (int m = start + G; m < start + width; ++m) common = add(common, term(m));
  out[G - 1] = common;
  T head = common;
#pragma unroll
  for (int r = G - 2; r >= 0; --r) {
    head = r == G - 2 ? term(start + r) : add(term(start + r), head);
    out[r] = add(head, common);
  }
  T tail = common;
#pragma unroll
  for (int r = 1; r < G; ++r) {
    tail = r == 1 ? term(start + width)
                  : add(tail, term(start + width + r - 1));
    out[r] = add(out[r], tail);
  }
}

template <int SEG>
__global__ void __launch_bounds__(kStreamThreads, 3)
detect_stream_kernel(StreamArgs a) {
  extern __shared__ double2 smem[];
  const Plan& pl = a.plan;
  const int s = blockIdx.x / pl.tiles;
  const long long t0 =
      static_cast<long long>(blockIdx.x - s * pl.tiles) * pl.tile;
  const float2* x = a.x + s * a.n;
  const long long base = t0 - pl.behind;  // position of local sample 0

  double2* xs = smem;                                    // pad8(xlen) + 1
  float2* ds = reinterpret_cast<float2*>(xs + pad8(pl.xlen) + 1);  // xlen
  float* es = reinterpret_cast<float*>(ds + pl.xlen);    // pad8(xlen) + 1
  uint32_t* evw = reinterpret_cast<uint32_t*>(es + pad8(pl.xlen) + 1);
  uint32_t* above = evw + pl.tile / 32;                  // na
  int* above_pre = reinterpret_cast<int*>(above + pl.na);  // na + 1
  uint32_t* peak = reinterpret_cast<uint32_t*>(above_pre + pl.na + 1);
  uint32_t* pair = peak + pl.np;                         // np - 2
  int* pair_pre = reinterpret_cast<int*>(pair + pl.np - 2);  // np - 1

  // the samples as float64, and |x|^2 rounded as the plain version's
  // x.real * x.real + x.imag * x.imag; 8 loads in flight a thread
  for (int i0 = threadIdx.x; i0 < pl.xlen; i0 += 8 * blockDim.x) {
    float2 v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u * blockDim.x;
      const long long p = base + i;
      v[u] = (i < pl.xlen && p >= 0 && p < a.n) ? __ldg(x + p)
                                                : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < pl.xlen) {
        xs[pad8(i)] = make_double2(v[u].x, v[u].y);
        es[pad8(i)] = __fadd_rn(__fmul_rn(v[u].x, v[u].x),
                                __fmul_rn(v[u].y, v[u].y));
      }
    }
  }
  __syncthreads();

  // STS lag products x[i] conj(x[i - L]), exact products, one rounding
  for (int i = threadIdx.x + a.sts_length; i < pl.xlen; i += blockDim.x) {
    const double2 v = xs[pad8(i)], u = xs[pad8(i - a.sts_length)];
    ds[i] = make_float2(__double2float_rn(fma(v.x, u.x, v.y * u.y)),
                        __double2float_rn(fma(v.y, u.x, -(v.x * u.y))));
  }

  // the LTS matched filter, kGroup outputs a thread
  float* lts = a.lts + s * a.lts_stride;
  for (int g = threadIdx.x; g < pl.m / kGroup; g += blockDim.x) {
    const long long p0 = t0 + g * kGroup;
    // behind and g * kGroup are multiples of 8: the padded offsets of
    // the window are constants from here
    const int i0 = pl.behind + g * kGroup;
    double mag[kGroup];
    float pw[kGroup];
#pragma unroll
    for (int r = 0; r < kGroup; ++r) {
      mag[r] = 0.0;
      pw[r] = 0.f;
    }
    if (p0 <= a.n - 64) {
      const double2* xw = xs + pad8(i0);
      double re[kGroup], im[kGroup];
      double2 win[kGroup];
#pragma unroll
      for (int r = 0; r < kGroup; ++r) {
        re[r] = 0.0;
        im[r] = 0.0;
      }
#pragma unroll
      for (int r = 0; r < kGroup - 1; ++r) win[r] = xw[pad8(r)];
#pragma unroll
      for (int k = 0; k < 64; ++k) {
        win[(k + kGroup - 1) % kGroup] = xw[pad8(k + kGroup - 1)];
#pragma unroll
        for (int r = 0; r < kGroup; ++r) {
          const double2 v = win[(k + r) % kGroup];
          re[r] = fma(v.x, kLtsRe[k], re[r]);
          re[r] = fma(-v.y, kLtsIm[k], re[r]);
          im[r] = fma(v.x, kLtsIm[k], im[r]);
          im[r] = fma(v.y, kLtsRe[k], im[r]);
        }
        if ((k + 1) % (64 / SEG) == 0) {
#pragma unroll
          for (int r = 0; r < kGroup; ++r) {
            mag[r] += hypot(re[r], im[r]);
            re[r] = 0.0;
            im[r] = 0.0;
          }
        }
      }
      // the 64-sample power of each output
      window_sums([&](int i) { return es[pad8(i)]; }, i0, 64, pw);
    }
    unsigned bits = 0;
    float norm[kGroup];
#pragma unroll
    for (int r = 0; r < kGroup; ++r) {
      const long long p = p0 + r;
      norm[r] = (p <= a.n - 64 && pw[r] > 0.f)
                    ? __fdiv_rn(__double2float_rn(mag[r]), pw[r])
                    : 0.f;
      if (p < a.n && norm[r] > a.lts_thr) bits |= 1u << r;
    }
    reinterpret_cast<uint8_t*>(peak)[g] = static_cast<uint8_t>(bits);
    if (g * kGroup < pl.tile) {
      if (p0 + kGroup <= a.n) {
        // lts_stride and p0 are multiples of 4
        float4* out = reinterpret_cast<float4*>(lts + p0);
        out[0] = make_float4(norm[0], norm[1], norm[2], norm[3]);
        out[1] = make_float4(norm[4], norm[5], norm[6], norm[7]);
      } else {
#pragma unroll
        for (int r = 0; r < kGroup; ++r)
          if (p0 + r < a.n) lts[p0 + r] = norm[r];
      }
    }
  }
  __syncthreads();

  // STS ratio per window, kGroup positions a thread; `above` bits from
  // position t0 - pb
  for (int g = threadIdx.x; g < pl.na * 32 / kGroup; g += blockDim.x) {
    const int j0 = g * kGroup;
    F3 sum[kGroup];  // correlation (x, y) and power (z)
    window_sums(
        [&](int i) {
          const float2 d = ds[i];
          return F3{d.x, d.y, es[pad8(i)]};
        },
        pl.behind - pl.pb + j0 - a.sts_length + 1, a.sts_length, sum);
    unsigned bits = 0;
#pragma unroll
    for (int r = 0; r < kGroup; ++r) {
      const float mag = __fsqrt_rn(__fadd_rn(__fmul_rn(sum[r].x, sum[r].x),
                                             __fmul_rn(sum[r].y, sum[r].y)));
      const float ratio = sum[r].z > 0.f ? __fdiv_rn(mag, sum[r].z) : 0.f;
      if (t0 - pl.pb + j0 + r >= 0 && ratio > a.sts_thr) bits |= 1u << r;
    }
    reinterpret_cast<uint8_t*>(above)[g] = static_cast<uint8_t>(bits);
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  if (warp == 0) {
    warp_prefix_popc(above, above_pre, pl.na);
  } else if (warp == 1) {
    // pair[p] = peak[p] & peak[p + 64]: two words on
    for (int i = threadIdx.x & 31; i < pl.np - 2; i += 32)
      pair[i] = peak[i] & peak[i + 2];
    __syncwarp();
    warp_prefix_popc(pair, pair_pre, pl.np - 2);
  }
  __syncthreads();

  // events: not above, after `plateau` above samples, a pair within reach
  for (int j = threadIdx.x; j < pl.tile; j += blockDim.x) {
    const long long p = t0 + j;
    const int ja = pl.pb + j;
    bool event = p < a.n && !((above[ja >> 5] >> (ja & 31)) & 1u) &&
                 rank(above, above_pre, ja) -
                         rank(above, above_pre, ja - a.plateau) ==
                     a.plateau &&
                 rank(pair, pair_pre, j + a.w) > rank(pair, pair_pre, j);
    const unsigned word = __ballot_sync(~0u, event);
    if ((threadIdx.x & 31) == 0) evw[j >> 5] = word;
  }
  __syncthreads();

  const long long w0 = t0 / 32;  // first event word of the tile
  uint32_t* ev = a.ev + s * (static_cast<long long>(a.nb) * kBlockWords);
  for (int j = threadIdx.x; j < pl.tile / 32; j += blockDim.x)
    if (w0 + j < static_cast<long long>(a.nb) * kBlockWords)
      ev[w0 + j] = evw[j];
  for (int b = threadIdx.x; b < pl.tile / kBlock; b += blockDim.x) {
    const long long gb = w0 / kBlockWords + b;
    if (gb < a.nb) {
      int c = 0;
#pragma unroll
      for (int q = 0; q < kBlockWords; ++q)
        c += __popc(evw[b * kBlockWords + q]);
      a.counts[s * static_cast<long long>(a.nb) + gb] = c;
    }
  }
}

struct SlotArgs {
  const float* lts;
  const uint32_t* ev;
  const int* counts;
  long long* starts;  // (streams, k)
  bool* valid;        // (streams, k)
  long long* dropped;  // (streams,)
  long long n, lts_stride, drop_limit;
  int nb, k, cap, search;
  float lts_thr;
};

// float -> uint32 in the floats' order
__device__ __forceinline__ uint32_t order_key(float v) {
  const uint32_t u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ unsigned long long warp_max(unsigned long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long t = __shfl_xor_sync(~0u, v, o);
    v = t > v ? t : v;
  }
  return v;
}

// block counts a slot-pass thread reads at a time
constexpr int kRun = 16;
// LTS values a lane keeps in registers through the 5 rounds of a slot
constexpr int kSlotCache = 4;

__global__ void __launch_bounds__(kSlotThreads)
detect_slot_kernel(SlotArgs a) {
  __shared__ long long warp_kept[32], warp_drop[32];
  __shared__ long long total_kept;
  const int s = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int* counts = a.counts + s * static_cast<long long>(a.nb);
  const uint32_t* ev =
      a.ev + s * (static_cast<long long>(a.nb) * kBlockWords);
  long long* starts = a.starts + s * static_cast<long long>(a.k);

  // each thread a run of blocks: events kept (at most cap a block) and
  // dropped (over the cap, in blocks starting below drop_limit)
  const int per = (a.nb + static_cast<int>(blockDim.x) - 1) / blockDim.x;
  const int b0 = min(tid * per, a.nb), b1 = min(b0 + per, a.nb);
  long long kept = 0, drop = 0;
  for (int bb = b0; bb < b1; bb += kRun) {
    int c[kRun];
#pragma unroll
    for (int u = 0; u < kRun; ++u) c[u] = bb + u < b1 ? counts[bb + u] : 0;
#pragma unroll
    for (int u = 0; u < kRun; ++u) {
      kept += min(c[u], a.cap);
      if (c[u] > a.cap &&
          static_cast<long long>(bb + u) * kBlock < a.drop_limit)
        drop += c[u] - a.cap;
    }
  }
  long long incl = kept;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long t = __shfl_up_sync(~0u, incl, o);
    if (lane >= o) incl += t;
    drop += __shfl_xor_sync(~0u, drop, o);
  }
  if (lane == 31) warp_kept[warp] = incl;
  if (lane == 0) warp_drop[warp] = drop;
  __syncthreads();
  if (warp == 0) {
    const long long v = lane < nwarps ? warp_kept[lane] : 0;
    long long wi = v, dd = lane < nwarps ? warp_drop[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long t = __shfl_up_sync(~0u, wi, o);
      if (lane >= o) wi += t;
      dd += __shfl_xor_sync(~0u, dd, o);
    }
    if (lane < nwarps) warp_kept[lane] = wi - v;  // exclusive
    if (lane == 31) total_kept = wi;
    if (lane == 0) a.dropped[s] = dd;
  }
  __syncthreads();

  // the first k events in position order: slot o + j of a block with
  // offset o is its j-th event. The runs are walked in step, kRun counts
  // read at a time, and the lanes of a warp read their next block with
  // events together (a block's 16 words in 4 loads): the warp pays one
  // read a step, not one for each lane's block.
  long long o = warp_kept[warp] + incl - kept;
  for (int r0 = 0; r0 < per; r0 += kRun) {
    const int bb = b0 + r0;
    int c[kRun];
#pragma unroll
    for (int u = 0; u < kRun; ++u)
      c[u] = bb + u < b1 && o < a.k ? min(counts[bb + u], a.cap) : 0;
    for (int u = 0;; ++u) {
      while (u < kRun && c[u] == 0) ++u;
      const bool has = u < kRun && o < a.k;
      if (!__any_sync(~0u, has)) break;
      if (has) {
        const long long b = bb + u;
        const uint4* w4 = reinterpret_cast<const uint4*>(ev + b * kBlockWords);
        uint4 w[kBlockWords / 4];
#pragma unroll
        for (int q = 0; q < kBlockWords / 4; ++q) w[q] = w4[q];
        const long long end = min(o + c[u], static_cast<long long>(a.k));
        long long slot = o;
#pragma unroll
        for (int q = 0; q < kBlockWords; ++q) {
          const uint4 v = w[q / 4];
          uint32_t bits = q % 4 == 0   ? v.x
                          : q % 4 == 1 ? v.y
                          : q % 4 == 2 ? v.z
                                       : v.w;
          while (bits && slot < end) {
            starts[slot++] = b * kBlock + q * 32 + __ffs(bits) - 1;
            bits &= bits - 1;
          }
        }
        o += c[u];
      }
    }
  }
  const long long ncand = min(total_kept, static_cast<long long>(a.k));
  __syncthreads();

  // a warp a slot: the top 5 LTS peaks after the event, peak 0 paired
  // with the first of peaks 1..4 exactly 64 away
  const float* lts = a.lts + s * a.lts_stride;
  for (int i = warp; i < a.k; i += nwarps) {
    long long start = a.n;
    bool ok = false;
    if (i < ncand) {
      const long long e = starts[i];
      // key: the value, then the lower position; 0: no candidate
      auto key = [&](int r) -> unsigned long long {
        const long long p = e + r;
        const float v = p < a.n ? lts[p] : 0.f;
        return v > a.lts_thr
                   ? (static_cast<unsigned long long>(order_key(v)) << 32) |
                         (0xFFFFFFFFu - static_cast<uint32_t>(r))
                   : 0ull;
      };
      unsigned long long cached[kSlotCache];
#pragma unroll
      for (int u = 0; u < kSlotCache; ++u)
        cached[u] = lane + 32 * u < a.search ? key(lane + 32 * u) : 0ull;
      long long p0 = 0;
      unsigned long long prev = ~0ull;
      for (int round = 0; round < 5; ++round) {
        unsigned long long best = 0;
#pragma unroll
        for (int u = 0; u < kSlotCache; ++u)
          if (cached[u] < prev && cached[u] > best) best = cached[u];
        for (int r = lane + 32 * kSlotCache; r < a.search; r += 32) {
          const unsigned long long kr = key(r);
          if (kr < prev && kr > best) best = kr;
        }
        best = warp_max(best);
        if (best == 0) break;
        prev = best;
        const long long p =
            e + (0xFFFFFFFFu - static_cast<uint32_t>(best & 0xFFFFFFFFu));
        if (round == 0) {
          p0 = p;
        } else if (p - p0 == 64 || p0 - p == 64) {
          const long long offset = min(p0, p) - 32;
          ok = offset - 160 >= 0;
          if (ok) start = offset - 160;
          break;
        }
      }
    }
    if (lane == 0) {
      starts[i] = start;
      a.valid[s * static_cast<long long>(a.k) + i] = ok;
    }
  }
}

using StreamKernel = void (*)(StreamArgs);

StreamKernel stream_kernel(int segments) {
  switch (segments) {
    case 1: return detect_stream_kernel<1>;
    case 2: return detect_stream_kernel<2>;
    case 4: return detect_stream_kernel<4>;
    case 8: return detect_stream_kernel<8>;
    case 16: return detect_stream_kernel<16>;
    case 32: return detect_stream_kernel<32>;
    case 64: return detect_stream_kernel<64>;
    default: return nullptr;
  }
}

// The longest tile that still gives two blocks an SM, and whose halo fits
// the shared memory; tile 0 if none fits.
Plan choose_plan(long long streams, long long n, int sts_length, int plateau,
                 int w) {
  int dev = 0, sms = 132, smem_max = 232448;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  Plan fit{};
  for (int tile : kTiles) {
    const Plan p = make_plan(tile, n, sts_length, plateau, w);
    if (p.smem > smem_max) continue;
    fit = p;
    if (streams * p.tiles >= 2LL * sms) break;
  }
  return fit;
}

}  // namespace

extern "C" {

// x: (streams, n) complex64; lts: (streams, lts_stride) float32, lts_stride
// a multiple of 4 and >= n; ev: (streams, nb * 16) uint32; counts:
// (streams, nb) int32, nb = ceil(n / 512); starts: (streams, k) int64;
// valid: (streams, k) bool; dropped: (streams,) int64. Returns 0, a CUDA
// error code, or -1 when the plan does not fit shared memory (nothing
// launched), -2 for segments that do not divide 64.
int ofdm_detect(const void* x, void* lts, void* ev, void* counts,
                void* starts, void* valid, void* dropped, long long streams,
                long long n, long long lts_stride, int k, int cap,
                long long drop_limit, int sts_length, int plateau,
                int lts_search, int segments, float sts_thr, float lts_thr,
                void* stream) {
  const StreamKernel kern = stream_kernel(segments);
  if (kern == nullptr) return -2;
  const int nb = static_cast<int>((n + kBlock - 1) / kBlock);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (streams == 0) return 0;
  if (n > 0) {
    const Plan p =
        choose_plan(streams, n, sts_length, plateau, lts_search - 64);
    if (p.tile == 0) return -1;
    if (p.smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(p.smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    StreamArgs a{static_cast<const float2*>(x), static_cast<float*>(lts),
                 static_cast<uint32_t*>(ev), static_cast<int*>(counts), n,
                 lts_stride, nb, sts_length, plateau, lts_search - 64,
                 sts_thr, lts_thr, p};
    kern<<<static_cast<unsigned>(streams * p.tiles), p.threads, p.smem, st>>>(
        a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  SlotArgs b{static_cast<const float*>(lts), static_cast<const uint32_t*>(ev),
             static_cast<const int*>(counts), static_cast<long long*>(starts),
             static_cast<bool*>(valid), static_cast<long long*>(dropped), n,
             lts_stride, drop_limit, nb, k, cap, lts_search, lts_thr};
  detect_slot_kernel<<<static_cast<unsigned>(streams), kSlotThreads, 0, st>>>(
      b);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
