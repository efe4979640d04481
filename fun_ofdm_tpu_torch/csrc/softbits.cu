// The universal decode's soft streams for Hopper, sm_90a: one pass from
// equalised points to each slot's depunctured soft stream.
//
// Replaces no Pallas kernel. The JAX package computes this step as XLA
// array code (fun_ofdm_tpu/models/ppdu.py, decode_data_anyrate_p), and the
// port ran it as eager PyTorch: a demodulation under all four
// modulations and a table gather (models/ppdu._anyrate_coded_gather,
// which stays the plain version: the wrapper, ops/softbits_cuda.py, is
// taken for CUDA tensors only). This kernel gives _anyrate_coded_gather's
// output bit for bit, over the whole tensor.
//
// The function is a gather with erasures. Coded position m of a slot at
// rate r is the erasure 127 when m >= n_coded (2 * num_data_bits(
// max_length) of the rate) or when m % group is a puncture hole; otherwise
// it is punctured bit k = (m / group) * nkeep + rank[m % group], which the
// fixed 48-bit deinterleave reads from soft position
// j = 48 * (k / 48) + PERM[k % 48], PERM[k] = 3 * (k % 16) + k / 16: bit
// j % bpsc (I bits first) of point j / bpsc, by ops/qam._axis_soft_decode's
// recursion.
//
// What bounds it on this card: bytes. The output is (slots, 2 * nbits_max)
// int32 (26.3 MB at the universal capture's 100 x 65,664), and each slot
// reads the points its rate covers once (8 B a point: 8.8 MB at
// RATE_3_4_QAM16, 52.5 MB if every slot is RATE_1_2_BPSK): 10.5-23.5 us at
// 3.35 TB/s. The arithmetic is a few integer operations a bit. The design:
// a block owns one slot and a tile of kTile coded positions. kTile is a
// multiple of 576, the least common multiple of the coded positions that
// fill whole 48-bit deinterleave chunks at rates 1/2 (48), 2/3 (64) and
// 3/4 (72), so no chunk or puncture group straddles two blocks and the
// tile's punctured span [k0, k0 + kt) starts on a chunk. The block reads
// its slot's rate once, demodulates each point of the span once (threads
// on consecutive points: coalesced loads through the strides of the real
// and imaginary views, so a complex tensor's views need no copy) into
// shared memory as bytes, then each thread writes 4 consecutive coded
// positions as one 16-byte store. A tile wholly past n_coded reads
// nothing. One launch a call; no host synchronisation, no allocation (the
// wrapper allocates the output).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// coded positions a block: 4 x 576
constexpr int kTile = 2304;
// one 16-byte store of 4 positions a thread
constexpr int kThreads = kTile / 4;
// rates a call may configure
constexpr int kMaxRates = 16;
constexpr int kErasure = 127;
// ops/qam._PT_LIMIT
constexpr float kPtLimit = 1048576.0f;

}  // namespace

// One configured rate, built on the host by ops/softbits_cuda.rate_params
// (the ctypes mirror RateParams there has these fields in this order).
struct RateParams {
  float scale_d;     // the axis' demodulation scale, as float32
  int32_t amp0;      // the first bit's amplitude (qam._axis_params)
  int32_t n_coded;   // 2 * num_data_bits(max_length)
  uint8_t bpsc;      // coded bits a point
  uint8_t axis_bits; // bits an axis: bpsc for BPSK, bpsc / 2 otherwise
  uint8_t group;     // puncture group: 1 (rate 1/2), 4 (2/3), 6 (3/4)
  uint8_t nkeep;     // positions a group keeps
  int8_t rank[8];    // rank of group position j among the kept; -1: hole
};

namespace {

struct RateTable {
  RateParams r[kMaxRates];
};

struct Args {
  const float* re;
  const float* im;
  long long re_slot, re_step;  // strides of the views, in floats
  long long im_slot, im_step;
  const long long* ridx;       // (slots,) rate index, clamped here
  int32_t* out;                // (slots, row)
  long long points;            // points a slot holds
  long long row;               // coded positions a slot: 2 * nbits_max
  long long tiles;             // blocks a slot
  int n_rates;
};

__device__ __forceinline__ int perm48(int k) { return 3 * (k % 16) + k / 16; }

// ops/qam._axis_soft_decode for one value: the float32 product, NaN -> 0,
// the clamp, truncation toward zero, then per bit
// clamp(flip * pt + 128, 0, 255), pt -= s * amp, flip = -s, amp /= 2.
__device__ __forceinline__ void axis_soft(float v, float scale, int amp,
                                          int bits, uint8_t* dst) {
  float x = __fmul_rn(v, scale);
  if (isnan(x)) x = 0.0f;
  x = fminf(fmaxf(x, -kPtLimit), kPtLimit);
  int pt = __float2int_rz(x);
  int flip = 1;
  for (int b = 0; b < bits; ++b) {
    dst[b] = static_cast<uint8_t>(min(max(flip * pt + 128, 0), 255));
    const int s = pt >= 0 ? 1 : -1;
    pt -= s * amp;
    flip = -s;
    amp /= 2;
  }
}

__global__ void __launch_bounds__(kThreads)
    softbits_kernel(const __grid_constant__ Args a,
                    const __grid_constant__ RateTable tab) {
  __shared__ uint8_t soft[kTile];  // a tile's punctured span, at most kTile
  const long long slot = blockIdx.x / a.tiles;
  const long long m0 = (blockIdx.x % a.tiles) * static_cast<long long>(kTile);
  long long ri = a.ridx[slot];
  ri = ri < 0 ? 0 : (ri >= a.n_rates ? a.n_rates - 1 : ri);
  const RateParams& p = tab.r[ri];
  const int group = p.group, nkeep = p.nkeep, bpsc = p.bpsc;
  const bool live = m0 < p.n_coded;
  if (live) {
    // punctured span [k0, k0 + kt), kt a multiple of 48; only the part
    // below the rate's end is read
    const long long k0 = m0 / group * nkeep;
    const long long kend = p.n_coded / group * nkeep;
    const long long span = kTile / group * nkeep;
    const long long kt = kend - k0 < span ? kend - k0 : span;
    const long long pt0 = k0 / bpsc;
    const int npts = static_cast<int>(kt / bpsc);
    const float* re = a.re + slot * a.re_slot;
    const float* im = a.im + slot * a.im_slot;
    const int axis = p.axis_bits;
    for (int i = threadIdx.x; i < npts; i += kThreads) {
      const long long pt = pt0 + i;
      float x = 0.0f, y = 0.0f;
      if (pt < a.points) {
        x = re[pt * a.re_step];
        if (bpsc > 1) y = im[pt * a.im_step];
      }
      axis_soft(x, p.scale_d, p.amp0, axis, soft + i * bpsc);
      if (bpsc > 1) {
        axis_soft(y, p.scale_d, p.amp0, axis, soft + i * bpsc + axis);
      }
    }
  }
  __syncthreads();
  const int local = 4 * threadIdx.x;
  const long long m = m0 + local;
  if (m >= a.row) return;
  int v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int s = kErasure;
    const int l = local + i;
    if (live && m + i < p.n_coded) {
      const int r = p.rank[l % group];
      if (r >= 0) {
        const int kl = l / group * nkeep + r;
        s = soft[48 * (kl / 48) + perm48(kl % 48)];
      }
    }
    v[i] = s;
  }
  *reinterpret_cast<int4*>(a.out + slot * a.row + m) =
      make_int4(v[0], v[1], v[2], v[3]);
}

}  // namespace

extern "C" {

// re, im: float32 views, element (slot, point) at slot * *_slot + point *
// *_step floats; ridx: (slots,) int64; out: (slots, row) int32, 16-byte
// aligned, row a multiple of 4 (2 x nbits_max, and every rate's data bits
// a symbol are a multiple of 4); params: n_rates host RateParams. Returns
// 0, a CUDA error code, or -1 (nothing launched) for 0 or more than
// kMaxRates rates or a row that is not a multiple of 4.
int ofdm_softbits(const void* re, const void* im, long long re_slot,
                  long long re_step, long long im_slot, long long im_step,
                  const void* ridx, void* out, long long slots,
                  long long points, long long row, const void* params,
                  int n_rates, void* stream) {
  if (n_rates < 1 || n_rates > kMaxRates || row % 4 != 0) return -1;
  if (slots == 0 || row == 0) return 0;
  RateTable tab{};
  const RateParams* src = static_cast<const RateParams*>(params);
  for (int i = 0; i < n_rates; ++i) tab.r[i] = src[i];
  const long long tiles = (row + kTile - 1) / kTile;
  Args a{static_cast<const float*>(re), static_cast<const float*>(im),
         re_slot, re_step, im_slot, im_step,
         static_cast<const long long*>(ridx), static_cast<int32_t*>(out),
         points, row, tiles, n_rates};
  softbits_kernel<<<static_cast<unsigned>(slots * tiles), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(a, tab);
  return static_cast<int>(cudaGetLastError());
}

int ofdm_softbits_params_size() { return static_cast<int>(sizeof(RateParams)); }

}  // extern "C"
