// K=7 rate-1/2 soft-decision Viterbi (polys 121, 91) for Hopper, sm_90a.
//
// Replaces the TPU Pallas kernels of fun_ofdm_tpu/ops/viterbi_pallas.py:
// the forward add-compare-select kernels `_acs_kernel_r4` (radix 4) and
// `_acs_kernel` (radix 2), and the survivor chainback kernels
// `_chainback_kernel_r4` and `_chainback_kernel`, all driven by
// `_decode_tiles`. The output is bit-exact with them and with the plain
// twin in fun_ofdm_tpu_torch/ops/viterbi.py (u8 metric semantics carried
// in int32, saturation at 255, renormalisation when state 0 exceeds 210,
// ties to the high-half path, per-frame even step counts, exact or
// uniform init, bit n read at step n + 6).
//
// What bounds it on this card: each frame is a serial chain of ~12k
// dependent trellis steps (a 1500-byte frame), and the dense capture's
// 512 frames give only ~4 warps per SM on the H100's 132 SMs, so the ACS
// is bound by the latency of one step's dependency chain, not by
// arithmetic or bytes (it reads 8 bytes and writes 8 bytes per frame and
// step: ~100 MB in all). The design keeps that chain short: one warp per
// frame, two states per lane, the 64 metrics in registers, the previous
// step's metrics fetched with four independent warp shuffles, the 64
// decisions packed into one 64-bit word by two ballots, the
// renormalisation minimum by one warp reduction, and the soft pairs of
// 32 steps loaded in one coalesced read and handed out by shuffles. No
// shared memory and no block barrier on the step path. The chainback is
// one thread per frame walking the decision words newest-first; the
// words of a step for consecutive frames are adjacent ((T, B) layout), so
// a warp's loads coalesce, and eight steps' loads are issued ahead of
// their use. More frames per SM are later work.
//
// Block-overlap decode. `acs_windowed_kernel` and `splice_guard_kernel`
// replace `_blocked_decode_impl` (fun_ofdm_tpu/ops/viterbi_pallas.py,
// entry `viterbi_decode_pallas_blocked`), which runs `_decode_tiles` over
// a gathered (frames, n_blocks, window) stack and splices the windows'
// bits in XLA. Here the windowed ACS is the same warp-per-trellis ACS, one
// warp per (frame, block) lane, reading the frame's soft pairs in place
// at the window's offset (no gathered copy); its step count and init come
// from the frame's step count, the block index, the block span tb and the
// lead-in wf. The survivors go through the same chainback kernel, and the
// splice and merge guard are one more kernel: one block per frame whose
// threads copy each output bit from its window, and whose first warp
// compares every cut's doubly decoded overlap, trimmed at both ends and
// masked to the frame's live bits, and ORs the mismatches into the
// frame's merge flag. What bounds it on this card is again the serial
// step chain: a 1500-byte frame becomes 16 lanes of ~1,012 steps each
// instead of one lane of 12,096, so at the streaming chain's smallest
// bucket (4 frames, 64 warps on 132 SMs) the decode's latency is the
// chain of one window, about 12x shorter than a whole frame's. The
// design does nothing more about occupancy yet: 64 to 1,024 warps do not
// fill the card, and the overlap adds 2 x 128 steps per window.
//
// ACS ablation. `acs_ablate_kernel<Mode>` replaces tools/viterbi_acs_ab.py's
// `acs_only` (the pallas_call of `_acs_kernel` alone) and its
// `make_kernel` bodies, ACS steps with pieces removed to find where the
// step's time goes. Here each variant is the warp-per-trellis step above
// with one piece taken out, and a defined function with a plain version
// (ops/viterbi_ab.py): kModeFull is the production step (decision words
// bit-equal to acs_kernel's); kModeNoRenorm drops the > 210 check and the
// warp minimum; kModeNoShuffle reads each lane's own two metrics instead
// of the four shuffles (the TPU's state-interleave removal; the metrics
// then follow the lane layout, not the trellis); kModeNoStore writes no
// decisions (the ballots go with them); kModeMinimal is the tool's 2-op
// floor, m = min(m + s0, 255) with decisions m <= 128; kModeUnrolled is
// the production step with the 32-step loop unrolled (the TPU's
// full-static). Every variant writes its 64 final metrics per trellis, so
// none is dead code. What bounds them is what bounds acs_kernel: the
// serial step chain of each warp.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kPoly0 = 121;
constexpr int kPoly1 = 91;
constexpr int kTail = 6;  // K - 1

__device__ __forceinline__ bool parity_of(int x) { return __popc(x) & 1; }

// The ACS step variants of acs_ablate_kernel (see the note at the top).
enum AcsMode : int {
  kModeFull = 0,       // the production step
  kModeNoRenorm = 1,   // no renormalisation check or minimum
  kModeNoShuffle = 2,  // each lane's own metrics instead of the shuffles
  kModeNoStore = 3,    // no decision write
  kModeMinimal = 4,    // m = min(m + s0, 255), decision = (m <= 128)
  kModeUnrolled = 5,   // the production step, 32-step loop fully unrolled
};

// One warp runs one trellis. Lane l holds the metrics of states l ("lo")
// and l + 32 ("hi"). New state s comes from butterfly j = s >> 1, i.e.
// from old states j and j + 32; lane l's new states l and l + 32 use
// butterflies l >> 1 and 16 + (l >> 1). Decisions go to column `col` of
// the (total_steps, batch) word array, zero for steps >= n_steps. Mode
// selects an ablation variant (kModeFull is the production step); with
// kWriteFinal the 64 metrics after the last step are written to
// final_metrics[col * 64 + lane] (lo) and [col * 64 + 32 + lane] (hi).
template <int Mode = kModeFull, bool kWriteFinal = false>
__device__ __forceinline__ void acs_trellis(
    const int2* __restrict__ pairs, int n_steps, bool exact_init,
    unsigned long long* __restrict__ dec, int batch, int col,
    int total_steps, int* __restrict__ final_metrics = nullptr) {
  const int lane = threadIdx.x;
  const int j_lo = lane >> 1;
  const int j_hi = 16 + (lane >> 1);
  const bool odd = lane & 1;
  const bool e0_lo = parity_of((2 * j_lo) & kPoly0);
  const bool e1_lo = parity_of((2 * j_lo) & kPoly1);
  const bool e0_hi = parity_of((2 * j_hi) & kPoly0);
  const bool e1_hi = parity_of((2 * j_hi) & kPoly1);
  constexpr bool kStore = Mode != kModeNoStore;

  int m_lo = (lane == 0 && exact_init) ? 0 : 63;
  int m_hi = 63;

  for (int t0 = 0; t0 < n_steps; t0 += 32) {
    int2 mine = make_int2(0, 0);
    if (t0 + lane < n_steps) mine = pairs[t0 + lane];
    const int n_in = min(32, n_steps - t0);
    auto step = [&](int i) {
      const int s0 = __shfl_sync(kFull, mine.x, i);
      const int s1 = __shfl_sync(kFull, mine.y, i);
      if constexpr (Mode == kModeMinimal) {
        m_lo = min(m_lo + s0, 255);
        m_hi = min(m_hi + s0, 255);
        const unsigned w_lo = __ballot_sync(kFull, m_lo <= 128);
        const unsigned w_hi = __ballot_sync(kFull, m_hi <= 128);
        if (lane == i) {
          dec[(size_t)(t0 + i) * batch + col] =
              ((unsigned long long)w_hi << 32) | w_lo;
        }
        return;
      }
      int old_lo_a, old_hi_a, old_lo_b, old_hi_b;
      if constexpr (Mode == kModeNoShuffle) {
        old_lo_a = old_lo_b = m_lo;
        old_hi_a = old_hi_b = m_hi;
      } else {
        old_lo_a = __shfl_sync(kFull, m_lo, j_lo);
        old_hi_a = __shfl_sync(kFull, m_hi, j_lo);
        old_lo_b = __shfl_sync(kFull, m_lo, j_hi);
        old_hi_b = __shfl_sync(kFull, m_hi, j_hi);
      }

      const int t_a = ((e0_lo ? 255 - s0 : s0) + (e1_lo ? 255 - s1 : s1) + 1) >> 3;
      const int t_b = ((e0_hi ? 255 - s0 : s0) + (e1_hi ? 255 - s1 : s1) + 1) >> 3;
      // even new state: (lo + t, hi + 63 - t); odd: (lo + 63 - t, hi + t)
      const int c_lo_a = min(old_lo_a + (odd ? 63 - t_a : t_a), 255);
      const int c_hi_a = min(old_hi_a + (odd ? t_a : 63 - t_a), 255);
      const int c_lo_b = min(old_lo_b + (odd ? 63 - t_b : t_b), 255);
      const int c_hi_b = min(old_hi_b + (odd ? t_b : 63 - t_b), 255);
      const bool d_a = c_hi_a <= c_lo_a;
      const bool d_b = c_hi_b <= c_lo_b;
      int n_lo = d_a ? c_hi_a : c_lo_a;
      int n_hi = d_b ? c_hi_b : c_lo_b;

      if constexpr (kStore) {
        const unsigned w_lo = __ballot_sync(kFull, d_a);
        const unsigned w_hi = __ballot_sync(kFull, d_b);
        if (lane == i) {
          dec[(size_t)(t0 + i) * batch + col] =
              ((unsigned long long)w_hi << 32) | w_lo;
        }
      }
      if constexpr (Mode != kModeNoRenorm) {
        if (__shfl_sync(kFull, n_lo, 0) > 210) {
          const int m = __reduce_min_sync(kFull, min(n_lo, n_hi));
          n_lo -= m;
          n_hi -= m;
        }
      }
      m_lo = n_lo;
      m_hi = n_hi;
    };
    if constexpr (Mode == kModeUnrolled) {
      if (n_in == 32) {
#pragma unroll
        for (int i = 0; i < 32; ++i) step(i);
      } else {
        for (int i = 0; i < n_in; ++i) step(i);
      }
    } else {
      for (int i = 0; i < n_in; ++i) step(i);
    }
  }
  if constexpr (kStore) {
    // steps past the trellis's count record zero decisions
    for (int t = n_steps + lane; t < total_steps; t += 32) {
      dec[(size_t)t * batch + col] = 0ull;
    }
  }
  if constexpr (kWriteFinal) {
    final_metrics[(size_t)col * 64 + lane] = m_lo;
    final_metrics[(size_t)col * 64 + 32 + lane] = m_hi;
  }
}

// One warp per frame.
__global__ void __launch_bounds__(32)
acs_kernel(const int* __restrict__ soft, const int* __restrict__ steps,
           const int* __restrict__ init, unsigned long long* __restrict__ dec,
           int batch, int soft_stride, int total_steps) {
  const int frame = blockIdx.x;
  acs_trellis(reinterpret_cast<const int2*>(soft + (size_t)frame * soft_stride),
              steps[frame], init[frame] == 1, dec, batch, frame, total_steps);
}

// One warp per frame, an ablation variant of acs_kernel's step, writing
// the final metrics (and, except kModeNoStore, the decision words).
template <int Mode>
__global__ void __launch_bounds__(32)
acs_ablate_kernel(const int* __restrict__ soft, const int* __restrict__ steps,
                  const int* __restrict__ init,
                  unsigned long long* __restrict__ dec,
                  int* __restrict__ final_metrics, int batch, int soft_stride,
                  int total_steps) {
  const int frame = blockIdx.x;
  acs_trellis<Mode, true>(
      reinterpret_cast<const int2*>(soft + (size_t)frame * soft_stride),
      steps[frame], init[frame] == 1, dec, batch, frame, total_steps,
      final_metrics);
}

// One warp per (frame, block) lane b = frame * n_blocks + blk. The window
// starts at trellis step off = max(0, blk * tb - wf) of the frame's row;
// it runs min(max(steps[frame] - off, 0), win) steps of win + 6, with the
// exact init for block 0 and the uniform init for the others.
__global__ void __launch_bounds__(32)
acs_windowed_kernel(const int* __restrict__ soft,
                    const int* __restrict__ steps,
                    unsigned long long* __restrict__ dec, int lanes,
                    int soft_stride, int n_blocks, int tb, int wf, int win) {
  const int b = blockIdx.x;
  const int frame = b / n_blocks;
  const int blk = b - frame * n_blocks;
  const int off = max(0, blk * tb - wf);
  const int n_steps = min(max(steps[frame] - off, 0), win);
  acs_trellis(reinterpret_cast<const int2*>(soft + (size_t)frame * soft_stride
                                            + 2 * (size_t)off),
              n_steps, blk == 0, dec, lanes, b, win + kTail);
}

// One thread per frame, from state 0 at the last step down to step 6.
__global__ void __launch_bounds__(32)
chainback_kernel(const unsigned long long* __restrict__ dec,
                 int* __restrict__ out, int batch, int total_steps) {
  const int frame = blockIdx.x * blockDim.x + threadIdx.x;
  if (frame >= batch) return;
  constexpr int kAhead = 8;
  int state = 0;
  int t = total_steps - 1;
  for (; t - (kAhead - 1) >= kTail; t -= kAhead) {
    unsigned long long w[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) w[u] = dec[(size_t)(t - u) * batch + frame];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int bit = (int)((w[u] >> state) & 1ull);
      out[(size_t)(t - u - kTail) * batch + frame] = bit;
      state = (state >> 1) | (bit << 5);
    }
  }
  for (; t >= kTail; --t) {
    const int bit = (int)((dec[(size_t)t * batch + frame] >> state) & 1ull);
    out[(size_t)(t - kTail) * batch + frame] = bit;
    state = (state >> 1) | (bit << 5);
  }
}

// One block per frame. Output bit n of the frame lives in block
// b = n / tb at window index n - b * tb (+ wf for b > 0). The first warp
// also runs the merge guard: around each cut b, the region
// [b * tb - wf, b * tb + wc) was decoded by both block b - 1 (at window
// index prev_start + i) and block b (at i); mismatches at
// i in [trim, ov - trim) whose bit lies below the frame's live extent
// clear the frame's flag.
__global__ void __launch_bounds__(256)
splice_guard_kernel(const int* __restrict__ win_bits,
                    const int* __restrict__ steps, int* __restrict__ bits,
                    int* __restrict__ merge_ok, int lanes, int n_blocks,
                    int nbits, int tb, int wf, int ov, int trim) {
  const int frame = blockIdx.x;
  const int base = frame * n_blocks;
  for (int n = threadIdx.x; n < nbits; n += blockDim.x) {
    const int b = n / tb;
    const int m = n - b * tb + (b > 0 ? wf : 0);
    bits[(size_t)frame * nbits + n] = win_bits[(size_t)m * lanes + base + b];
  }
  if (threadIdx.x < 32) {
    const int live_hi = min(max(steps[frame] - kTail, 0), nbits);
    bool mism = false;
    for (int b = 1; b < n_blocks; ++b) {
      const int lo = b * tb - wf;
      const int prev_start = lo - max(0, (b - 1) * tb - wf);
      for (int i = trim + threadIdx.x; i < ov - trim; i += 32) {
        const int prev = win_bits[(size_t)(prev_start + i) * lanes + base + b - 1];
        const int cur = win_bits[(size_t)i * lanes + base + b];
        mism |= (lo + i < live_hi) && (prev != cur);
      }
    }
    mism = __any_sync(kFull, mism);
    if (threadIdx.x == 0) merge_ok[frame] = mism ? 0 : 1;
  }
}

}  // namespace

extern "C" {

// soft: (batch, soft_stride) int32, soft_stride >= 2 * max(steps), even;
// steps, init: (batch,) int32; dec: (total_steps, batch) uint64.
int viterbi_acs(const int* soft, const int* steps, const int* init,
                unsigned long long* dec, int batch, int soft_stride,
                int total_steps, void* stream) {
  if (batch > 0) {
    acs_kernel<<<batch, 32, 0, static_cast<cudaStream_t>(stream)>>>(
        soft, steps, init, dec, batch, soft_stride, total_steps);
  }
  return static_cast<int>(cudaGetLastError());
}

// The ablation variants: as viterbi_acs, plus final: (batch, 64) int32;
// dec may be null for mode kModeNoStore. An unknown mode returns
// cudaErrorInvalidValue.
int viterbi_acs_ablate(const int* soft, const int* steps, const int* init,
                       unsigned long long* dec, int* final_metrics, int batch,
                       int soft_stride, int total_steps, int mode,
                       void* stream) {
  if (batch <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FUN_OFDM_ABLATE(M)                                              \
  acs_ablate_kernel<M><<<batch, 32, 0, st>>>(soft, steps, init, dec,    \
                                             final_metrics, batch,      \
                                             soft_stride, total_steps)
  switch (mode) {
    case kModeFull: FUN_OFDM_ABLATE(kModeFull); break;
    case kModeNoRenorm: FUN_OFDM_ABLATE(kModeNoRenorm); break;
    case kModeNoShuffle: FUN_OFDM_ABLATE(kModeNoShuffle); break;
    case kModeNoStore: FUN_OFDM_ABLATE(kModeNoStore); break;
    case kModeMinimal: FUN_OFDM_ABLATE(kModeMinimal); break;
    case kModeUnrolled: FUN_OFDM_ABLATE(kModeUnrolled); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FUN_OFDM_ABLATE
  return static_cast<int>(cudaGetLastError());
}

// dec: (total_steps, batch) uint64; out: (total_steps - 6, batch) int32.
int viterbi_chainback(const unsigned long long* dec, int* out, int batch,
                      int total_steps, void* stream) {
  if (batch > 0) {
    const int threads = 32;
    const int blocks = (batch + threads - 1) / threads;
    chainback_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        dec, out, batch, total_steps);
  }
  return static_cast<int>(cudaGetLastError());
}

// soft: (frames, soft_stride) int32; steps: (frames,) int32;
// dec: (win + 6, frames * n_blocks) uint64.
int viterbi_acs_windowed(const int* soft, const int* steps,
                         unsigned long long* dec, int lanes, int soft_stride,
                         int n_blocks, int tb, int wf, int win, void* stream) {
  if (lanes > 0) {
    acs_windowed_kernel<<<lanes, 32, 0, static_cast<cudaStream_t>(stream)>>>(
        soft, steps, dec, lanes, soft_stride, n_blocks, tb, wf, win);
  }
  return static_cast<int>(cudaGetLastError());
}

// win_bits: (win, frames * n_blocks) int32; steps: (frames,) int32;
// bits: (frames, nbits) int32; merge_ok: (frames,) int32.
int viterbi_splice_guard(const int* win_bits, const int* steps, int* bits,
                         int* merge_ok, int frames, int n_blocks, int nbits,
                         int tb, int wf, int ov, int trim, void* stream) {
  if (frames > 0) {
    splice_guard_kernel<<<frames, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        win_bits, steps, bits, merge_ok, frames * n_blocks, n_blocks, nbits,
        tb, wf, ov, trim);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
