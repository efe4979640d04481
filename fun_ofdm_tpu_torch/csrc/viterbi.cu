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
// Block-overlap decode. `blocked_window_kernel` and `blocked_guard_kernel`,
// launched together by one C entry point, replace `_blocked_decode_impl`
// (fun_ofdm_tpu/ops/viterbi_pallas.py, entry
// `viterbi_decode_pallas_blocked`), which runs `_decode_tiles` over a
// gathered (frames, n_blocks, window) stack and splices the windows' bits
// in XLA. The window kernel is one warp per (frame, block) lane, as the
// ACS is one warp per trellis: it reads the frame's soft pairs in place
// at the window's offset, clamps the step count itself, and runs the
// unchanged ACS step with its decision words stored in the warp's shared
// memory ((win + 6) x 8 bytes, 8.1 KB at 1,012 steps), not in device
// memory. The traceback stays on chip and is exact, the chainback's
// segments moved into the warp: lane w owns the 32 steps whose bits form
// the window's output word w. Walking a segment's map of all 64 states,
// as the chainback does, costs 64 x 32 chain steps a lane, issue-bound,
// ~9 us a window; one lane walking the whole window is a ~1,012-step
// dependency chain, ~6 us (both measured, PERF.md and
// tools/blocked_variants_ab.py). So each lane walks its segment from
// a guessed state 0, keeping the state of every step, and then every lane
// whose true entry (the exit of the segment above; state 0 at the top)
// differs walks again from it only until its state meets the kept path's
// at the same step: from there the paths are one. The merge is observed,
// never assumed; rounds repeat until no entry changes, so a window whose
// paths never merge costs at worst a serial walk. At working SNR one round
// does, ~1 us a window. The warp then writes its own span of the output
// (coalesced int32 stores; no neighbour needed) and the two overlap
// regions of its cuts as packed 32-bit words. The guard kernel is a warp
// per frame and a lane per cut: an XOR of the two windows' words, masked
// to the trimmed region and the frame's live bits, and a vote. Survivors
// and bits never leave the chip; the bytes are the soft pairs in, the
// bits out and a few overlap words. What bounds it on this card is the
// serial step chain of one window: ~1,012 steps of ~77 cycles at the
// capture's geometry, about 0.040 ms at the boost clock, which is the
// decode's latency at the streaming chain's smallest bucket (4 frames, 64
// warps on 132 SMs). Nothing here does more about occupancy: 64 to 1,024
// warps do not fill the card, and the overlap adds 2 x 128 steps per
// window.
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

// Where acs_trellis puts the decision word of step t: column col of the
// (total_steps, batch) word array in device memory.
struct GlobalDecisions {
  unsigned long long* dec;
  int batch, col;
  __device__ __forceinline__ void operator()(int t,
                                             unsigned long long w) const {
    dec[(size_t)t * batch + col] = w;
  }
};

// One warp runs one trellis. Lane l holds the metrics of states l ("lo")
// and l + 32 ("hi"). New state s comes from butterfly j = s >> 1, i.e.
// from old states j and j + 32; lane l's new states l and l + 32 use
// butterflies l >> 1 and 16 + (l >> 1). The decision word of step t goes
// to store(t, word), zero for steps n_steps <= t < total_steps (Store:
// GlobalDecisions, or the block-overlap kernel's shared-memory store).
// Mode selects an ablation variant (kModeFull is the production step);
// with kWriteFinal the 64 metrics after the last step are written to
// final_metrics[lane] (lo) and [32 + lane] (hi).
template <int Mode = kModeFull, bool kWriteFinal = false, class Store>
__device__ __forceinline__ void acs_trellis(
    const int2* __restrict__ pairs, int n_steps, bool exact_init,
    Store store, int total_steps, int* __restrict__ final_metrics = nullptr) {
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
      if (lane < n_in) store(t0 + lane, word);
    }
  }
  if constexpr (kStore) {
    // steps past the trellis's count record zero decisions
    for (int t = n_steps + lane; t < total_steps; t += 32) store(t, 0ull);
  }
  if constexpr (kWriteFinal) {
    final_metrics[lane] = m_lo - off;
    final_metrics[32 + lane] = m_hi - off;
  }
}

// One warp per frame.
__global__ void __launch_bounds__(32)
acs_kernel(const int* __restrict__ soft, const int* __restrict__ steps,
           const int* __restrict__ init, unsigned long long* __restrict__ dec,
           int batch, int soft_stride, int total_steps) {
  const int frame = blockIdx.x;
  acs_trellis(reinterpret_cast<const int2*>(soft + (size_t)frame * soft_stride),
              steps[frame], init[frame] == 1,
              GlobalDecisions{dec, batch, frame}, total_steps);
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
      steps[frame], init[frame] == 1, GlobalDecisions{dec, batch, frame},
      total_steps, final_metrics + (size_t)frame * 64);
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

// Traceback scratch bytes per output word of a window: the path's 32
// states (a 36-byte stride, so the lanes' rows sit in distinct banks) and
// the segment's exit, entry and wanted entry.
constexpr int kTraceBytes = 48;

// The block-overlap decode's shared memory, one window per warp: the
// decision words of steps 6 .. 32 nw + 5 (word m, the word of step m + 6,
// at m + m / 32: each 32-step segment padded by one word, so the lanes'
// segments sit in distinct banks), the traceback's scratch (nw x
// kTraceBytes) and the packed output words (nw + 1, the last zero).
struct WindowSmem {
  unsigned long long* words;
  unsigned char* scratch;
  unsigned* out;
  __device__ WindowSmem(unsigned char* base, int nw)
      : words(reinterpret_cast<unsigned long long*>(base)),
        scratch(base + (size_t)nw * 33 * 8),
        out(reinterpret_cast<unsigned*>(scratch + (size_t)nw * kTraceBytes)) {}
  static constexpr int bytes(int nw) {
    return nw * 33 * 8 + nw * kTraceBytes + (nw + 1) * 4;
  }
};

// acs_trellis's store into the window's shared memory: the words of
// steps 6 and later (the traceback reads no earlier step).
struct SharedDecisions {
  unsigned long long* words;
  __device__ __forceinline__ void operator()(int t,
                                             unsigned long long w) const {
    const int m = t - kTail;
    if (m >= 0) words[m + (m >> 5)] = w;
  }
};

// One traceback step on a state kept in bits 26..31 of z (the bits below
// are stale and never read): the decision bit of state z >> 26 in word
// becomes the new top bit, and the state shifts down by one. Returns the
// new z; its bit 31 is the bit read.
__device__ __forceinline__ unsigned trace_step(unsigned z,
                                               unsigned long long word) {
  return __funnelshift_r(z, static_cast<unsigned>(word >> (z >> 26)), 1);
}

// Bits [lo, hi) of a 32-bit word, both clipped to 0..32.
__device__ __forceinline__ unsigned bit_range(int lo, int hi) {
  lo = max(lo, 0);
  hi = min(hi, 32);
  if (hi <= lo) return 0u;
  return (hi == 32 ? ~0u : (1u << hi) - 1u) & ~((1u << lo) - 1u);
}

// One warp per (frame, block) lane b = frame * n_blocks + blk: the window
// of win steps from trellis step off = max(0, blk * tb - wf) of the
// frame's row, min(max(min(steps[frame], T) - off, 0), win) of them
// (T = soft_stride / 2), exact init for block 0 and uniform for the
// others. The ACS keeps its decision words in shared memory; the warp
// then traces the window back from state 0 at step win + 5 in 32-step
// segments, one a lane (lane w owns output word w, bits 32 w .. 32 w + 31
// of the window, read at steps 32 w + 6 ..; two or more words a lane
// where win > 1,024): each lane walks its segment from state 0, then
// corrects it from its true entry until the paths meet (the note at the
// top). The warp writes the frame's output bits [blk * tb, min((blk + 1)
// * tb, nbits)) from window index n - blk * tb (+ wf for blk > 0) into
// bits[frame * nbits + n], and the two overlap regions the guard
// compares as packed words: overlaps[(b * 2 + 0) * ovw + k], bits
// [32 k, 32 k + 32) of window region [0, ov) (for blk > 0), and
// [(b * 2 + 1) * ovw + k], of region [p, p + ov), p = (blk + 1) * tb -
// wf - off (for blk < n_blocks - 1); zero past ov and elsewhere.
__global__ void __launch_bounds__(32)
blocked_window_kernel(const int* __restrict__ soft,
                      const int* __restrict__ steps, int* __restrict__ bits,
                      unsigned* __restrict__ overlaps, int soft_stride,
                      int n_blocks, int nbits, int tb, int wf, int win,
                      int ov, int ovw) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nw = (win + 31) >> 5;
  const WindowSmem sm(smem_raw, nw);
  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  const int frame = b / n_blocks;
  const int blk = b - frame * n_blocks;
  const int off = max(0, blk * tb - wf);
  const int frame_steps = min(max(steps[frame], 0), soft_stride / 2);
  const int n_steps = min(max(frame_steps - off, 0), win);
  // every lane runs every collective of the step, also for n_steps == 0
  acs_trellis(reinterpret_cast<const int2*>(soft + (size_t)frame * soft_stride
                                            + 2 * (size_t)off),
              n_steps, blk == 0, SharedDecisions{sm.words},
              32 * nw + kTail);
  __syncwarp();

  // the traceback. Lane w walks segment w from state 0 (a guess) and
  // keeps the path: the state at each of its reads, its bits, its exit.
  // The segment's true entry is the exit of the segment above (state 0
  // for the top one); in rounds, every lane whose entry changed walks
  // again from it until its state meets the kept path's at the same step
  // (from there the two paths are one), until no entry changes.
  unsigned char* path = sm.scratch;                         // nw x 36
  int* exits = reinterpret_cast<int*>(path + (size_t)nw * 36);
  int* entry = exits + nw;
  int* want = entry + nw;
  for (int w = lane; w < nw; w += 32) {
    const unsigned long long* seg = sm.words + w * 33;
    unsigned char* st = path + w * 36;
    unsigned z = 0u, acc = 0u;
#pragma unroll 8
    for (int i = 31; i >= 0; --i) {
      st[i] = static_cast<unsigned char>(z >> 26);
      z = trace_step(z, seg[i]);
      acc = (acc << 1) | (z >> 31);
    }
    sm.out[w] = acc;
    exits[w] = static_cast<int>(z >> 26);
    entry[w] = 0;
  }
  if (lane == 0) sm.out[nw] = 0u;
  __syncwarp();
  for (;;) {
    for (int w = lane; w < nw; w += 32) {
      want[w] = w + 1 < nw ? exits[w + 1] : 0;
    }
    __syncwarp();
    bool walked = false;
    for (int w = lane; w < nw; w += 32) {
      const int e = want[w];
      if (e == entry[w]) continue;
      walked = true;
      entry[w] = e;
      const unsigned long long* seg = sm.words + w * 33;
      unsigned char* st = path + w * 36;
      unsigned z = static_cast<unsigned>(e) << 26;
      unsigned acc = sm.out[w];
      int i = 31;
      for (; i >= 0 && (z >> 26) != st[i]; --i) {
        st[i] = static_cast<unsigned char>(z >> 26);
        z = trace_step(z, seg[i]);
        acc = (acc & ~(1u << i)) | ((z >> 31) << i);
      }
      sm.out[w] = acc;
      if (i < 0) exits[w] = static_cast<int>(z >> 26);
    }
    __syncwarp();
    if (!__any_sync(kFull, walked)) break;
  }

  // the window's span of the output
  const int n_lo = blk * tb;
  const int n_hi = min(n_lo + tb, nbits);
  const int lead = blk > 0 ? wf - n_lo : -n_lo;
  int* row = bits + (size_t)frame * nbits;
  for (int n = n_lo + lane; n < n_hi; n += 32) {
    const int m = n + lead;
    row[n] = static_cast<int>((sm.out[m >> 5] >> (m & 31)) & 1u);
  }
  // the overlap regions of cuts blk and blk + 1
  unsigned* head = overlaps + (size_t)b * 2 * ovw;
  unsigned* tail = head + ovw;
  const int p = (blk + 1) * tb - wf - off;
  for (int k = lane; k < ovw; k += 32) {
    const unsigned keep = bit_range(0, ov - 32 * k);
    head[k] = blk > 0 ? sm.out[k] & keep : 0u;
    unsigned t = 0u;
    if (blk < n_blocks - 1) {
      const int q = (p >> 5) + k;
      t = __funnelshift_r(sm.out[q], sm.out[q + 1], p & 31) & keep;
    }
    tail[k] = t;
  }
}

// The merge guard, one warp per frame, a lane per cut b (1 <= b <
// n_blocks): window b - 1's tail words XOR window b's head words, kept to
// the region bits i with trim <= i < ov - trim whose trellis bit
// b * tb - wf + i lies below the frame's live extent min(max(min(steps,
// T) - 6, 0), nbits); any bit left clears the frame's flag.
__global__ void __launch_bounds__(128)
blocked_guard_kernel(const unsigned* __restrict__ overlaps,
                     const int* __restrict__ steps, bool* __restrict__ ok,
                     int frames, int total, int n_blocks, int nbits, int tb,
                     int wf, int ov, int ovw, int trim) {
  const int frame = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (frame >= frames) return;  // the whole warp
  const int live_hi =
      min(max(min(max(steps[frame], 0), total) - kTail, 0), nbits);
  unsigned mism = 0u;
  for (int c = 1 + lane; c < n_blocks; c += 32) {
    const size_t cut = (size_t)frame * n_blocks + c;
    const unsigned* prev = overlaps + ((cut - 1) * 2 + 1) * ovw;
    const unsigned* cur = overlaps + cut * 2 * ovw;
    const int end = min(ov - trim, live_hi - (c * tb - wf));
    for (int k = 0; k < ovw; ++k) {
      mism |= (prev[k] ^ cur[k]) & bit_range(trim - 32 * k, end - 32 * k);
    }
  }
  const bool any = __any_sync(kFull, mism != 0u);
  if (lane == 0) ok[frame] = !any;
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

// The window kernel's dynamic shared memory in bytes, for a window of win
// steps.
int viterbi_blocked_smem(int win) {
  return WindowSmem::bytes((win + 31) / 32);
}

// The block-overlap decode: soft: (frames, soft_stride) int32, 8-byte
// aligned; steps: (frames,) int32; bits: (frames, nbits) int32; ok:
// (frames,) bool; overlaps: (frames * n_blocks, 2, ovw) 32-bit words,
// ovw = ceil(ov / 32). Launches blocked_window_kernel, then
// blocked_guard_kernel, on one stream.
int viterbi_blocked_decode(const int* soft, const int* steps, int* bits,
                           bool* ok, unsigned* overlaps, int frames,
                           int soft_stride, int n_blocks, int nbits, int tb,
                           int wf, int win, int ov, int trim, void* stream) {
  if (frames <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nw = (win + 31) / 32;
  const int ovw = (ov + 31) / 32;
  const int smem = WindowSmem::bytes(nw);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        blocked_window_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  blocked_window_kernel<<<frames * n_blocks, 32, smem, st>>>(
      soft, steps, bits, overlaps, soft_stride, n_blocks, nbits, tb, wf, win,
      ov, ovw);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  blocked_guard_kernel<<<(frames + 3) / 4, 128, 0, st>>>(
      overlaps, steps, ok, frames, soft_stride / 2, n_blocks, nbits, tb, wf,
      ov, ovw, trim);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
