// The block selection shared by every compression kernel of the port:
// error-feedback v = delta + err per (client, 8192-block), the bisection
// threshold of kernels/ref.bisect_threshold and the int8 round trip.
//
// fused_agg.cu (the dense fused path and the sparse wire), quant8.cu (the
// per-client compressor) and topk_ef.cu (the same without int8) include
// this one definition, so their survivor sets cannot drift apart.
// block_threshold (compress_q8, topk_ef) holds a whole padded block in 256
// threads; team_threshold (wire_emit and fused_agg's select) holds about
// the block's real width, in a team sized to it, counts the rest of the
// padding arithmetically, and gives the same threshold bit for bit.
//
// Numerics: lo = -1, hi = block max, mid = 0.5f * (lo + hi), strict >,
// cnt > k, 32 iterations, survivors |v| > hi.  Padding positions (>= d)
// are zeros that are counted, never loaded.  Additions, products and the
// division are explicit round-to-nearest intrinsics, so nvcc contracts no
// FMA and the kernels equal their plain versions bit for bit; rounding is
// rintf (half to even).  Never build with --use_fast_math.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 8192;                  // BLOCK_ELEMS in kernels/ops.py
constexpr int kThreads = 256;                 // threads per (client, block)
constexpr int kPerThread = kBlock / kThreads; // values of v held per thread
constexpr int kWarps = kThreads / 32;
constexpr int kIters = 32;                    // BISECT_ITERS in kernels/ref.py
constexpr float kInv127 = 1.0f / 127.0f;      // the int8 scale's factor

// The int8 code of v at this scale: rint(v / scale) clipped to +-127, 0
// when the scale is 0 (then v is 0 too).
__device__ __forceinline__ float code8(float v, float scale) {
  if (!(scale > 0.0f)) return 0.0f;
  return fminf(fmaxf(rintf(__fdiv_rn(v, scale)), -127.0f), 127.0f);
}

__device__ __forceinline__ float reconstruct(float v, float thr, float scale,
                                             bool quantize) {
  const float sparse = fabsf(v) > thr ? v : 0.0f;
  if (!quantize) return sparse;
  if (!(scale > 0.0f)) return 0.0f;
  return __fmul_rn(code8(sparse, scale), scale);
}

// One (client, 8192-block) of v = delta + err into registers (zeros past
// d, counted but never loaded), then the bisection of ref.bisect_threshold.
// Returns the threshold hi (survivors: |v| > hi) and the block max in
// *amax_out.  Ends with every thread holding the same hi and amax;
// contains barriers, so every thread of the block must call it.
__device__ __forceinline__ float block_threshold(
    const float* __restrict__ delta, const float* __restrict__ err,
    size_t row, int base, int d, int k, float (&v)[kPerThread],
    float* amax_out) {
  __shared__ float max_sm[kWarps];
  __shared__ unsigned cnt_sm[2][kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float amax = 0.0f;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int col = base + j * kThreads + tid;
    float x = 0.0f;
    if (col < d) x = __fadd_rn(delta[row + col], err[row + col]);
    v[j] = x;
    amax = fmaxf(amax, fabsf(x));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if (lane == 0) max_sm[warp] = amax;
  __syncthreads();
  amax = max_sm[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) amax = fmaxf(amax, max_sm[w]);

  // Bisection: every thread sees the same block-wide count, so lo and hi
  // stay uniform.  Two count slots alternate, so one barrier per step
  // suffices (a slot is rewritten two steps later, after every thread has
  // passed the barrier in between).
  float lo = -1.0f;
  float hi = amax;
  for (int it = 0; it < kIters; ++it) {
    const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    unsigned c = 0;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) c += fabsf(v[j]) > mid ? 1u : 0u;
    c = __reduce_add_sync(0xffffffffu, c);
    if (lane == 0) cnt_sm[it & 1][warp] = c;
    __syncthreads();
    unsigned total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += cnt_sm[it & 1][w];
    if (total > static_cast<unsigned>(k)) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  *amax_out = amax;
  return hi;
}


// --- team_threshold: the selection sized to the block's real width ------
//
// A team of kTeam threads (two warps for a block up to kSmallWidth wide,
// the whole block of kThreads otherwise; a named barrier of its own) holds
// one (client, block): element e = j * kTeam + t sits in slot j of team
// thread t, kSlots slots a thread.  Elements past the real width are held
// as zeros; the unheld rest of the padded block is zeros too, and |0| > mid
// exactly when mid < 0, so each bisection step adds their number times
// [mid < 0] to the held count: the count over the padded block, as
// ref.bisect_threshold takes it, so lo and hi move bit for bit as
// block_threshold's do.
constexpr int kSmallWidth = 2048;             // widest block a small team holds
template <int kTeam, int kSlotsPerThread>
struct TeamShape {
  static constexpr int kTeamWarps = kTeam / 32;
  static constexpr int kSlots = kSlotsPerThread;
  static constexpr int kHeld = kSlots * kTeam;          // elements held, zeros included
  static constexpr int kWords = (kSlots + 31) / 32;     // sign-bit words
  static_assert(kTeam % 64 == 0 && kTeam <= kThreads, "two or more warps of one block");
  static_assert(kHeld <= kBlock && kSlots <= 32, "at most a block, a (slot, warp) per thread");
};

// A team's reduction slots in shared memory.
struct TeamScratch {
  unsigned sum[2][kWarps];   // team_sum, alternating
  unsigned cnt[kWarps];      // candidates per warp
  unsigned above[kWarps];    // held values above hi per warp
  float max[kWarps];
};

// The team's barrier: bar.sync with the team's own id over its threads.
template <int kTeam>
__device__ __forceinline__ void team_sync(int bar) {
  asm volatile("bar.sync %0, %1;" ::"r"(bar), "n"(kTeam) : "memory");
}

// The sum (team_sum) or the max (team_max) of x over the team, the same
// value in every thread.  The sum alternates two shared slots, so one
// barrier a call suffices when successive calls alternate `parity`.
template <int kTeam>
__device__ __forceinline__ unsigned team_sum(unsigned x, int parity, TeamScratch& s, int bar,
                                             int t) {
  x = __reduce_add_sync(0xffffffffu, x);
  if ((t & 31) == 0) s.sum[parity][t >> 5] = x;
  team_sync<kTeam>(bar);
  unsigned total = 0;
#pragma unroll
  for (int w = 0; w < kTeam / 32; ++w) total += s.sum[parity][w];
  return total;
}

template <int kTeam>
__device__ __forceinline__ float team_max(float x, TeamScratch& s, int bar, int t) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  if ((t & 31) == 0) s.max[t >> 5] = x;
  team_sync<kTeam>(bar);
  x = s.max[0];
#pragma unroll
  for (int w = 1; w < kTeam / 32; ++w) x = fmaxf(x, s.max[w]);
  return x;
}

// |v| of the block's held elements into registers, v = delta + err (row
// points at the block's first column, width real columns), with the sign
// bits apart in neg (bit j % 32 of word j / 32): with_sign gives v back bit
// for bit.  Every slot is loaded (an index past the width reads the last
// real column, then is zeroed), so the loads issue back to back without a
// branch; holding |v| alone keeps one register a slot through the
// bisection.  Then the bisection of ref.bisect_threshold: kFullSteps steps
// over every held slot, without a branch.  The team then lists its
// candidates, lo < |v| <= hi, in cand (kHeld floats of shared memory):
// every later mid lies in [lo, hi], so the count above mid is the count
// above hi (fixed from there on) plus the candidates above mid, and the
// remaining steps read only the list (a few entries on Gaussian updates;
// up to 32 of them, one a lane, are counted by a ballot a step, with no
// barrier).  Returns hi (survivors: |v| > hi) and the block max in
// *amax_out, the same in every team thread; every team thread must call it.
constexpr int kFullSteps = 8;
template <int kTeam, int kSlots>
__device__ __forceinline__ float team_threshold(
    const float* __restrict__ delta, const float* __restrict__ err, size_t row, int width,
    int k, int t, int bar, TeamScratch& sc, float (&a)[kSlots],
    unsigned (&neg)[TeamShape<kTeam, kSlots>::kWords], float* cand, float* amax_out) {
  using S = TeamShape<kTeam, kSlots>;
  float m4[4] = {0.0f, 0.0f, 0.0f, 0.0f};         // independent partial maxima
#pragma unroll
  for (int w = 0; w < S::kWords; ++w) neg[w] = 0u;
#pragma unroll
  for (int j = 0; j < S::kSlots; ++j) {
    const int e = j * kTeam + t;
    const size_t at = row + min(e, width - 1);
    const float x = e < width ? __fadd_rn(delta[at], err[at]) : 0.0f;
    a[j] = fabsf(x);
    neg[j / 32] |= (__float_as_uint(x) >> 31) << (j % 32);
    m4[j % 4] = fmaxf(m4[j % 4], a[j]);
  }
  const float amax =
      team_max<kTeam>(fmaxf(fmaxf(m4[0], m4[1]), fmaxf(m4[2], m4[3])), sc, bar, t);
  constexpr unsigned kUnheld = kBlock - S::kHeld;
  float lo = -1.0f;
  float hi = amax;
  int it = 0;
#pragma unroll 1
  for (; it < kFullSteps; ++it) {
    const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    unsigned c[4] = {0u, 0u, 0u, 0u};             // independent partial counts
#pragma unroll
    for (int j = 0; j < S::kSlots; ++j) c[j % 4] += a[j] > mid ? 1u : 0u;
    const unsigned total = team_sum<kTeam>((c[0] + c[1]) + (c[2] + c[3]), it & 1, sc, bar, t) +
                           (mid < 0.0f ? kUnheld : 0u);
    if (total > static_cast<unsigned>(k)) {
      lo = mid;
    } else {
      hi = mid;
    }
  }

  // The candidate list, warp after warp in index order: a counting pass,
  // the warps' offsets, then a writing pass.
  const int lane = t & 31;
  const int warp = t >> 5;
  const unsigned lt = (1u << lane) - 1u;
  unsigned n_warp = 0;
  unsigned above = 0;
#pragma unroll
  for (int j = 0; j < S::kSlots; ++j) {
    n_warp += __popc(__ballot_sync(0xffffffffu, a[j] > lo && !(a[j] > hi)));
    above += a[j] > hi ? 1u : 0u;
  }
  above = __reduce_add_sync(0xffffffffu, above);
  if (lane == 0) {
    sc.cnt[warp] = n_warp;
    sc.above[warp] = above;
  }
  team_sync<kTeam>(bar);
  unsigned m = 0;
  unsigned run = 0;                               // candidates of the warps before
  above = 0;
#pragma unroll
  for (int w = 0; w < S::kTeamWarps; ++w) {
    run += w < warp ? sc.cnt[w] : 0u;
    m += sc.cnt[w];
    above += sc.above[w];
  }
#pragma unroll
  for (int j = 0; j < S::kSlots; ++j) {
    const bool in = a[j] > lo && !(a[j] > hi);
    const unsigned bal = __ballot_sync(0xffffffffu, in);
    if (in) cand[run + __popc(bal & lt)] = a[j];
    run += __popc(bal);
  }
  team_sync<kTeam>(bar);
  // A short list (up to a warp's lanes) is counted by one ballot a step,
  // candidate q in lane q of every warp (the same total in each thread, no
  // barrier; the pad, -1, is never above a mid); a long one a share a
  // thread.
  if (m <= 32) {
    const float r = lane < static_cast<int>(m) ? cand[lane] : -1.0f;
#pragma unroll 1
    for (; it < kIters; ++it) {
      const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
      const unsigned total = above + (mid < 0.0f ? kUnheld : 0u) +
                             __popc(__ballot_sync(0xffffffffu, r > mid));
      if (total > static_cast<unsigned>(k)) {
        lo = mid;
      } else {
        hi = mid;
      }
    }
  }
#pragma unroll 1
  for (; it < kIters; ++it) {
    const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    unsigned c = 0;
    for (unsigned p = t; p < m; p += kTeam) c += cand[p] > mid ? 1u : 0u;
    const unsigned total =
        team_sum<kTeam>(c, it & 1, sc, bar, t) + above + (mid < 0.0f ? kUnheld : 0u);
    if (total > static_cast<unsigned>(k)) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  team_sync<kTeam>(bar);                          // cand is reused by the caller
  *amax_out = amax;
  return hi;
}

// x, opaque to the compiler: what is computed from it afterwards is not
// merged with what was computed before, so a team's per-slot addresses and
// predicates are not held in registers through the bisection.
template <class T>
__device__ __forceinline__ T opaque(T x) {
  if constexpr (sizeof(T) == 8) {
    asm volatile("" : "+l"(x));
  } else {
    asm volatile("" : "+r"(x));
  }
  return x;
}

__device__ __forceinline__ float with_sign(float a, unsigned neg_word, int bit) {
  return __uint_as_float(__float_as_uint(a) | (((neg_word >> bit) & 1u) << 31));
}

}  // namespace
