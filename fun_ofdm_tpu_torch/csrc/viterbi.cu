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
// The ACS. What bounds it on this card: each frame is a serial chain of
// ~12k dependent trellis steps (a 1500-byte frame), and the dense
// capture's 512 frames give about one warp per SM sub-partition, so
// nothing hides latency and each step costs its whole dependency chain;
// not arithmetic and not bytes (8 bytes read and 8 written per frame and
// step). The design keeps one warp per frame, two states per lane and the
// 64 metrics in registers, and takes everything it can off the chain:
//  - the renormalisation. The minimum of the 64 new metrics equals the
//    minimum over old states x of min(m_x + min(t, 63 - t), 255), t the
//    branch metric of x's butterfly (every new metric is the smaller of two
//    saturated candidates, and each old state feeds exactly two); lane l
//    holds both inputs of butterfly l, so the warp minimum starts from the
//    old metrics, in parallel with the butterfly shuffles. The trigger,
//    new state 0 > 210, is min(m_0 + t_0, m_32 + 63 - t_0) > 210, from two
//    broadcast shuffles of lane 0's old metrics. The subtraction is
//    deferred: the metrics are kept plus a warp-uniform offset `off`, a
//    renormalisation raises the offset to the new minimum instead of
//    lowering 64 metrics, and the saturation is at 255 + off (a decision
//    compares two metrics and does not see the offset), so the minimum is
//    needed only by the next step's saturation;
//  - the step's input. Each lane packs the 4 distinct branch metrics of
//    its own step of a 32-step block (one per code-bit parity pair) into
//    one 32-bit word; one shuffle a step hands them out, one step ahead,
//    and the next block's soft pairs are loaded one block ahead;
//  - the decisions. Two ballots a step; lane i keeps the word of step
//    t0 + i in a register (a select), and the 32 words are stored once a
//    block.
// The 32-step loop is unrolled: on the H100 the full unroll takes 0.90x
// the time of an unroll by 4 and 0.89x of one by 16 (PERF.md,
// tools/viterbi_variants_ab.py); one warp per block leaves registers to
// spare. What is left on the chain is a butterfly shuffle, an add-min and
// a min a step; with one warp per SM sub-partition dispatching in order, the
// ~40 instructions of a step (~77 cycles on the H100) look to be what
// bounds it now (no pipe counters were read), so an instruction off the
// chain still costs its dispatch slots.
//
// The chainback replaces `_chainback_kernel[_r4]`. The traceback from
// state 0 at the last step is a composition of per-step maps
// f_t(s) = (s >> 1) | (bit s of word t) << 5. Walked one frame per thread,
// as a plain loop, it is a chain of ~12k device-memory round trips; so it
// is cut into segments of kSeg steps and computed in three launches:
//  1. chainback_maps_kernel, a block per (segment, group of kGroup
//     frames), every segment but the oldest: the segment's (steps x
//     frames) words are staged in shared memory with cp.async; one warp
//     per frame walks all 64 start states (two per lane; the lanes read
//     one word, a broadcast) and writes the segment's map F(s), 64 bytes.
//     Survivor paths merge: once a warp's 64 states agree, the map is
//     constant and one lane per frame finishes the walk, so a frame costs
//     a warp only until its paths merge (this halves the chainback at
//     the capture's shape);
//  2. chainback_compose_kernel: per frame, the maps composed newest to
//     oldest from state 0, staged in shared memory, give every segment's
//     start state;
//  3. chainback_walk_kernel, a block per (segment, group): the words
//     staged again, one thread per frame walks its segment from its start
//     state and writes its bits; neighbouring threads write neighbouring
//     addresses of the (nbits, B) output.
// Exact by construction: a composition of functions, with no assumption
// that the paths merge. A trellis of one segment or less (the 18-bit
// header) is one launch of (3) from state 0. What bounds it: the words
// are read twice (74 MB at the capture's shape), and each segment's walk
// is a chain of shared-memory reads; there are ~1,500 blocks of each at
// the capture's shape for 132 SMs.
//
// Block-overlap decode. `acs_windowed_kernel` and `splice_guard_kernel`
// replace `_blocked_decode_impl` (fun_ofdm_tpu/ops/viterbi_pallas.py,
// entry `viterbi_decode_pallas_blocked`), which runs `_decode_tiles` over
// a gathered (frames, n_blocks, window) stack and splices the windows'
// bits in XLA. Here the windowed ACS is the same warp-per-trellis ACS, one
// warp per (frame, block) lane, reading the frame's soft pairs in place
// at the window's offset (no gathered copy); its step count and init come
// from the frame's step count, the block index, the block span tb and the
// lead-in wf. The survivors go through the same chainback, and the
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
// bit-equal to acs_kernel's); kModeNoRenorm drops the > 210 trigger and
// the warp minimum; kModeNoShuffle reads each lane's own two metrics
// instead of the four shuffles (the TPU's state-interleave removal; the
// metrics then follow the lane layout, not the trellis, and the minimum
// is taken over the lane's four candidates); kModeNoStore writes no
// decisions (the ballots go with them); kModeMinimal is the tool's 2-op
// floor, m = min(m + s0, 255) with decisions m <= 128; kModeUnrolled is
// the production step with the 32-step loop unrolled (the TPU's
// full-static); the production step is now unrolled too, so the two are
// one code path and the variant reads 1.0x. Every variant writes its 64
// final metrics per trellis, so none is dead code. What bounds them is what bounds acs_kernel: the
// serial step chain of each warp.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kPoly0 = 121;
constexpr int kPoly1 = 91;
constexpr int kTail = 6;  // K - 1

// The chainback's segment length (steps) and the frames of one tile.
constexpr int kSeg = 256;
constexpr int kGroup = 16;
constexpr unsigned kGroupLanes = kGroup == 32 ? kFull : (1u << kGroup) - 1;
// The compose kernel's frames per block and segments per staged chunk.
constexpr int kComposeFrames = 8;
constexpr int kComposeSegs = 32;

__device__ __forceinline__ int parity_of(int x) { return __popc(x) & 1; }

// The parity class e0 * 2 + e1 of butterfly j: which of a step's 4
// distinct branch metrics it uses (its byte in the packed word).
__device__ __forceinline__ int branch_class(int j) {
  return parity_of((2 * j) & kPoly0) * 2 + parity_of((2 * j) & kPoly1);
}

// A step's 4 distinct branch metrics ((a + b + 1) >> 3, each 0..63), byte
// c = e0 * 2 + e1 against expected bits (e0, e1).
__device__ __forceinline__ unsigned pack_branch_metrics(int s0, int s1) {
  const unsigned t0 = (s0 + s1 + 1) >> 3;
  const unsigned t1 = (s0 + 255 - s1 + 1) >> 3;
  const unsigned t2 = (255 - s0 + s1 + 1) >> 3;
  const unsigned t3 = (511 - s0 - s1) >> 3;
  return t0 | (t1 << 8) | (t2 << 16) | (t3 << 24);
}

// Byte c of w, zero-extended.
__device__ __forceinline__ int byte_of(unsigned w, int c) {
  return static_cast<int>(__byte_perm(w, 0u, 0x4440u | c));
}

// The ACS step variants of acs_ablate_kernel (see the note at the top).
enum AcsMode : int {
  kModeFull = 0,       // the production step
  kModeNoRenorm = 1,   // no renormalisation trigger or minimum
  kModeNoShuffle = 2,  // each lane's own metrics instead of the shuffles
  kModeNoStore = 3,    // no decision write
  kModeMinimal = 4,    // m = min(m + s0, 255), decision = (m <= 128)
  kModeUnrolled = 5,   // the production step (its 32-step loop is unrolled)
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
  const int cls_a = branch_class(j_lo);
  const int cls_b = branch_class(j_hi);
  const int cls_own = branch_class(lane);
  // the lo path's branch metric is t (even new state) or 63 - t (odd);
  // 63 - t == t ^ 63 for t in 0..63
  const int flip = (lane & 1) ? 63 : 0;
  constexpr bool kStore = Mode != kModeNoStore;
  constexpr bool kRenorm = Mode != kModeNoRenorm && Mode != kModeMinimal;

  // the metrics in offset form: the u8-semantics metric plus off, the
  // sum of the renormalisations not subtracted (the same in every lane)
  int m_lo = (lane == 0 && exact_init) ? 0 : 63;
  int m_hi = 63;
  int off = 0;

  int2 ahead = make_int2(0, 0);
  if (lane < n_steps) ahead = pairs[lane];
  for (int t0 = 0; t0 < n_steps; t0 += 32) {
    const int2 mine = ahead;
    if (t0 + 32 + lane < n_steps) ahead = pairs[t0 + 32 + lane];
    const int n_in = min(32, n_steps - t0);
    // step t0 + i's input sits in lane i: the packed branch metrics, or
    // s0 for the minimal variant
    const unsigned packed = Mode == kModeMinimal
        ? static_cast<unsigned>(mine.x) : pack_branch_metrics(mine.x, mine.y);
    unsigned long long word = 0ull;  // lane i: the decisions of step t0 + i
    unsigned cur_next = __shfl_sync(kFull, packed, 0);
    auto step = [&](int i) {
      const unsigned cur = cur_next;
      cur_next = __shfl_sync(kFull, packed, i + 1);
      bool d_a, d_b;
      if constexpr (Mode == kModeMinimal) {
        m_lo = min(m_lo + static_cast<int>(cur), 255);
        m_hi = min(m_hi + static_cast<int>(cur), 255);
        d_a = m_lo <= 128;
        d_b = m_hi <= 128;
      } else {
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
        const int x_a = byte_of(cur, cls_a) ^ flip;
        const int x_b = byte_of(cur, cls_b) ^ flip;
        // the saturation at 255, in the metrics' offset form
        const int cap = kRenorm ? 255 + off : 255;
        // even new state: (lo + t, hi + 63 - t); odd: (lo + 63 - t, hi + t)
        const int c_lo_a = min(old_lo_a + x_a, cap);
        const int c_hi_a = min(old_hi_a + (x_a ^ 63), cap);
        const int c_lo_b = min(old_lo_b + x_b, cap);
        const int c_hi_b = min(old_hi_b + (x_b ^ 63), cap);
        d_a = c_hi_a <= c_lo_a;
        d_b = c_hi_b <= c_lo_b;
        if constexpr (kRenorm) {
          // the minimum of the new metrics, from the old ones: the
          // smallest unsaturated candidate, saturated after the reduction
          int term;
          if constexpr (Mode == kModeNoShuffle) {
            // the lane's own metrics are its inputs: its four candidates
            term = min(m_lo + min(x_a, x_b), m_hi + (max(x_a, x_b) ^ 63));
          } else {
            // old states lane and lane + 32, both of butterfly lane
            const int t = byte_of(cur, cls_own);
            term = min(m_lo, m_hi) + min(t, t ^ 63);
          }
          const int low = min(__reduce_min_sync(kFull, term), cap);
          // new state 0 (butterfly 0, class 0) from lane 0's old metrics;
          // the saturation cannot change a comparison with 210
          const int z_lo = __shfl_sync(kFull, m_lo, 0);
          const int z_hi = __shfl_sync(kFull, m_hi, 0);
          const int t_0 = byte_of(cur, 0);
          // the renormalisation is deferred: it raises the offset to the
          // new minimum instead of lowering 64 metrics
          off = min(z_lo + t_0, z_hi + (t_0 ^ 63)) - off > 210 ? low : off;
        }
        m_lo = min(c_lo_a, c_hi_a);
        m_hi = min(c_lo_b, c_hi_b);
      }
      if constexpr (kStore) {
        const unsigned w_lo = __ballot_sync(kFull, d_a);
        const unsigned w_hi = __ballot_sync(kFull, d_b);
        const unsigned long long w = ((unsigned long long)w_hi << 32) | w_lo;
        word = lane == i ? w : word;
      }
    };
    if (n_in == 32) {
#pragma unroll
      for (int i = 0; i < 32; ++i) step(i);
    } else {
      for (int i = 0; i < n_in; ++i) step(i);
    }
    if constexpr (kStore) {
      if (lane < n_in) dec[(size_t)(t0 + lane) * batch + col] = word;
    }
  }
  if constexpr (kStore) {
    // steps past the trellis's count record zero decisions
    for (int t = n_steps + lane; t < total_steps; t += 32) {
      dec[(size_t)t * batch + col] = 0ull;
    }
  }
  if constexpr (kWriteFinal) {
    final_metrics[(size_t)col * 64 + lane] = m_lo - off;
    final_metrics[(size_t)col * 64 + 32 + lane] = m_hi - off;
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

// The chainback's step: the state at step t - 1 from the state at step t.
__device__ __forceinline__ int prev_state(int s, unsigned long long word) {
  return (s >> 1) | (static_cast<int>((word >> s) & 1ull) << 5);
}

// Segment k walks steps [lo, hi): lo = 6 + k * kSeg, hi = min(lo + kSeg, T).
struct Segment {
  int lo, hi;
  __device__ Segment(int k, int total_steps)
      : lo(kTail + k * kSeg), hi(min(kTail + (k + 1) * kSeg, total_steps)) {}
};

// Stage the words of steps [lo, hi) of frames f0 .. f0 + kGroup - 1 in
// tile[step - lo][frame - f0] (cp.async, 8 bytes each) and wait for them.
// Frames >= batch are not loaded.
__device__ __forceinline__ void stage_words(
    unsigned long long (*tile)[kGroup],
    const unsigned long long* __restrict__ dec, int batch, int f0,
    Segment seg) {
  const int n = (seg.hi - seg.lo) * kGroup;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = i / kGroup;
    const int f = i - r * kGroup;
    if (f0 + f < batch) {
      __pipeline_memcpy_async(&tile[r][f],
                              dec + (size_t)(seg.lo + r) * batch + f0 + f, 8);
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
}

// Segment k = blockIdx.x + 1 (every segment but the oldest) of frames
// blockIdx.y * kGroup + warp: maps[(k * batch + frame) * 64 + s] = the
// state at step lo - 1 reached from state s at step hi - 1.
__global__ void __launch_bounds__(kGroup * 32)
chainback_maps_kernel(const unsigned long long* __restrict__ dec,
                      unsigned char* __restrict__ maps, int batch,
                      int total_steps) {
  __shared__ unsigned long long tile[kSeg][kGroup];
  __shared__ int rest_t[kGroup], rest_s[kGroup];
  const int k = blockIdx.x + 1;
  const int f0 = blockIdx.y * kGroup;
  const Segment seg(k, total_steps);
  stage_words(tile, dec, batch, f0, seg);
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int frame = f0 + w;
  unsigned char* map = maps + ((size_t)k * batch + frame) * 64;
  int next_t = seg.lo - 1;  // the next step the merged path walks, if any
  int merged = 0;
  if (frame < batch) {
    // start states lane and lane + 32; every 8 steps, stop if they agree
    int sa = lane, sb = lane + 32, t = seg.hi - 1;
    bool agree = false;
    while (t >= seg.lo && !agree) {
      const int stop = max(seg.lo, t - 7);
#pragma unroll 8
      for (; t >= stop; --t) {
        const unsigned long long word = tile[t - seg.lo][w];
        sa = prev_state(sa, word);
        sb = prev_state(sb, word);
      }
      const int s0 = __shfl_sync(kFull, sa, 0);
      agree = __all_sync(kFull, sa == sb && sa == s0);
    }
    if (agree && t >= seg.lo) {
      next_t = t;
      merged = sa;
    } else {
      map[lane] = static_cast<unsigned char>(sa);
      map[lane + 32] = static_cast<unsigned char>(sb);
    }
  }
  if (lane == 0) {
    rest_t[w] = next_t;
    rest_s[w] = merged;
  }
  __syncthreads();
  // one lane per frame finishes the merged paths
  if (w == 0 && lane < kGroup) {
    const int my_t = rest_t[lane];
    int s = rest_s[lane];
    const int top = __reduce_max_sync(kGroupLanes, my_t);
    for (int t = top; t >= seg.lo; --t) {
      if (t <= my_t) s = prev_state(s, tile[t - seg.lo][lane]);
    }
    if (my_t >= seg.lo) {
      const unsigned v = 0x01010101u * static_cast<unsigned>(s);
      uint4* out = reinterpret_cast<uint4*>(
          maps + ((size_t)k * batch + f0 + lane) * 64);
#pragma unroll
      for (int q = 0; q < 4; ++q) out[q] = make_uint4(v, v, v, v);
    }
  }
}

// Frames blockIdx.x * kComposeFrames + thread: starts[k * batch + frame]
// = the state at step hi_k - 1 of segment k, for k = n_seg - 1 (state 0)
// down to 0, by composing the maps newest first. The maps of a chunk of
// kComposeSegs segments are staged in shared memory (cp.async, 16 bytes).
__global__ void __launch_bounds__(256)
chainback_compose_kernel(const unsigned char* __restrict__ maps,
                         int* __restrict__ starts, int batch, int n_seg) {
  __shared__ __align__(16) unsigned char stage[kComposeSegs][kComposeFrames][64];
  const int f0 = blockIdx.x * kComposeFrames;
  const int nf = min(kComposeFrames, batch - f0);
  const int f = threadIdx.x;
  int s = 0;
  for (int top = n_seg - 1; top >= 1; top -= kComposeSegs) {
    const int bottom = max(1, top - kComposeSegs + 1);
    const int n = (top - bottom + 1) * kComposeFrames * 4;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int c = i / (kComposeFrames * 4);
      const int ff = (i / 4) % kComposeFrames;
      const int q = i % 4;
      if (ff < nf) {
        __pipeline_memcpy_async(
            &stage[c][ff][q * 16],
            maps + ((size_t)(bottom + c) * batch + f0 + ff) * 64 + q * 16, 16);
      }
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    if (f < nf) {
      for (int k = top; k >= bottom; --k) {
        starts[(size_t)k * batch + f0 + f] = s;
        s = stage[k - bottom][f][s];
      }
    }
    __syncthreads();
  }
  if (f < nf) starts[f0 + f] = s;
}

// Segment blockIdx.x of frames blockIdx.y * kGroup + thread: from the
// segment's start state (state 0 when starts is null: one segment), the
// bits of its steps, out[(t - 6) * batch + frame].
__global__ void __launch_bounds__(128)
chainback_walk_kernel(const unsigned long long* __restrict__ dec,
                      const int* __restrict__ starts, int* __restrict__ out,
                      int batch, int total_steps) {
  __shared__ unsigned long long tile[kSeg][kGroup];
  const int k = blockIdx.x;
  const int f0 = blockIdx.y * kGroup;
  const Segment seg(k, total_steps);
  stage_words(tile, dec, batch, f0, seg);
  const int frame = f0 + threadIdx.x;
  if (threadIdx.x >= kGroup || frame >= batch) return;
  int s = starts == nullptr ? 0 : starts[(size_t)k * batch + frame];
#pragma unroll 8
  for (int t = seg.hi - 1; t >= seg.lo; --t) {
    const unsigned long long word = tile[t - seg.lo][threadIdx.x];
    const int bit = static_cast<int>((word >> s) & 1ull);
    out[(size_t)(t - kTail) * batch + frame] = bit;
    s = (s >> 1) | (bit << 5);
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

// The chainback's segment length in steps; the caller sizes its scratch
// with it.
int viterbi_chainback_segment(void) { return kSeg; }

// dec: (total_steps, batch) uint64; out: (total_steps - 6, batch) int32.
// With n_seg = ceil((total_steps - 6) / segment) > 1, the scratch maps:
// (n_seg, batch, 64) uint8, 16-byte aligned, and starts: (n_seg, batch)
// int32 (both unused, and may be null, for one segment). Launches the
// maps, compose and walk kernels (only the walk for one segment).
int viterbi_chainback(const unsigned long long* dec, int* out,
                      unsigned char* maps, int* starts, int batch,
                      int total_steps, void* stream) {
  const int nbits = total_steps - kTail;
  if (batch > 0 && nbits > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int n_seg = (nbits + kSeg - 1) / kSeg;
    const int groups = (batch + kGroup - 1) / kGroup;
    if (n_seg > 1) {
      chainback_maps_kernel<<<dim3(n_seg - 1, groups), kGroup * 32, 0, st>>>(
          dec, maps, batch, total_steps);
      chainback_compose_kernel<<<(batch + kComposeFrames - 1) / kComposeFrames,
                                 256, 0, st>>>(maps, starts, batch, n_seg);
    }
    chainback_walk_kernel<<<dim3(n_seg, groups), 128, 0, st>>>(
        dec, n_seg > 1 ? starts : nullptr, out, batch, total_steps);
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
