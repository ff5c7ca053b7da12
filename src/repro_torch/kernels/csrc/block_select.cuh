// The block selection shared by every compression kernel of the port:
// error-feedback v = delta + err per (client, 8192-block), the bisection
// threshold of kernels/ref.bisect_threshold and the int8 code.
//
// fused_agg.cu (the dense fused path and the sparse wire), quant8.cu (the
// per-client compressor) and topk_ef.cu (the same without int8) include
// this one definition, so their survivor sets cannot drift apart.  There is
// one selection, team_threshold: a team sized to the block's real width
// (two warps up to kSmallWidth columns, else the whole block of kThreads)
// holds that width, counts the rest of the zero padding arithmetically, and
// gives ref.bisect_threshold's threshold bit for bit.  select_team and
// select_task are the launch layout of fused_agg's select, compress_q8 and
// topk_ef (a block team per full block, small teams for a narrow last
// block); the three differ only in what they write per element and per
// block (their Out types).  wire_emit runs team_threshold with launches of
// its own, since it packs survivors instead.
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

// --- team_threshold: the selection sized to the block's real width ------
//
// A team of kTeam threads (two warps for a block up to kSmallWidth wide,
// the whole block of kThreads otherwise; a named barrier of its own) holds
// one (client, block): element e = j * kTeam + t sits in slot j of team
// thread t, kSlots slots a thread.  Elements past the real width are held
// as zeros; the unheld rest of the padded block is zeros too, and |0| > mid
// exactly when mid < 0, so each bisection step adds their number times
// [mid < 0] to the held count: the count over the padded block, as
// ref.bisect_threshold takes it, so lo and hi move bit for bit as they do
// there.
constexpr int kSmallWidth = 2048;             // widest block a small team holds
constexpr int kNarrowTeam = 64;               // a small team: two warps
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
// candidates, 0 < |v| <= hi and |v| > lo, in cand (kHeld floats of shared
// memory).  Every later mid lies in [lo, hi].  A mid below 0 has the whole
// padded block above it (|v| >= 0 > mid), so its count is kBlock.  A mid
// of 0 or more has no zero above it, so its count is the count above hi
// (fixed from there on) plus the candidates above mid; so zeros, held
// padding or real, are never listed (when k reaches the width, lo and hi
// close in on 0 from both sides and each held zero would be a candidate).
// The remaining steps read only the list (a few entries on Gaussian updates;
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
  const float lo0 = fmaxf(lo, 0.0f);              // a candidate is nonzero
  unsigned n_warp = 0;
  unsigned above = 0;
#pragma unroll
  for (int j = 0; j < S::kSlots; ++j) {
    n_warp += __popc(__ballot_sync(0xffffffffu, a[j] > lo0 && !(a[j] > hi)));
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
    const bool in = a[j] > lo0 && !(a[j] > hi);
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
      const unsigned c = __popc(__ballot_sync(0xffffffffu, r > mid));
      const unsigned total = mid < 0.0f ? kBlock : above + c;
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
    c = team_sum<kTeam>(c, it & 1, sc, bar, t);
    const unsigned total = mid < 0.0f ? kBlock : above + c;
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

// --- The select launch: a team per (client, block), sized to its width --
//
// fused_agg's select, compress_q8 and topk_ef share this layout (the plan
// of kernels/teams.compress_plan): after `lead` blocks of the caller's own
// (fused_agg's fog lists), N * n_wide blocks each run a block team on one
// full block of a client, then narrow_grid blocks each run up to `teams`
// small teams, a team on the last block of a client (at most kSmallWidth
// wide, kNarrowTeam * kSlots held).  The kernels differ only in their Out:
//   out.block_scale(hi, amax)              the block's scale;
//   out.element(at, v, kept, scale)        one real column (at = its flat
//                                          index, kept = |v| > hi);
//   out.block(task, hi, scale)             once per (client, block), task
//                                          = client * nb + block.
// d, and a row's and a block's start, are 64-bit: a row may hold 2^31
// coordinates or more (compress_q8, topk_ef).  Offsets within a block stay
// int.
struct SelectArgs {
  const float* delta;                // (N, d)
  const float* err;                  // (N, d)
  int n;
  long long d;
  int k;
  int n_wide;                        // blocks of each row run by a block team (the first ones)
  int teams;                         // small teams a block
  int lead;                          // the caller's blocks ahead of the teams
  int nb;                            // ceil(d / kBlock), set by launch_select
};

// One (client i, block b) for a team of kTeam threads (thread t, named
// barrier bar): team_threshold, then what Out writes at each of the
// block's real columns and once for the block.
template <int kTeam, int kSlots, class Out>
__device__ __forceinline__ void select_team(SelectArgs a, int i, int b, int t, int bar,
                                            TeamScratch& sc, float* cand, Out out) {
  using S = TeamShape<kTeam, kSlots>;
  const long long base = static_cast<long long>(b) * kBlock;
  float abs_v[kSlots];                            // |v|
  unsigned neg[S::kWords];                        // v's sign bits
  float amax;
  const float hi = team_threshold<kTeam, kSlots>(
      a.delta, a.err, static_cast<size_t>(i) * a.d + base,
      static_cast<int>(min(static_cast<long long>(kBlock), a.d - base)), a.k, t, bar, sc, abs_v,
      neg, cand, &amax);
  const int width = opaque(static_cast<int>(min(static_cast<long long>(kBlock), a.d - base)));
  const size_t row = opaque(static_cast<size_t>(i) * a.d + base);
  const float scale = out.block_scale(hi, amax);
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int e = j * kTeam + t;
    if (e < width) out.element(row + e, with_sign(abs_v[j], neg[j / 32], j % 32), abs_v[j] > hi,
                               scale);
  }
  if (t == 0) out.block(static_cast<size_t>(i) * a.nb + b, hi, scale);
}

// Block `task` of the teams (the launch's block less `lead`): a block team
// when task < N * n_wide (kWide instances only: without it the block
// team's registers are not reserved), else small teams.  A team past the
// last client leaves at once; its barriers are its own (named, one per
// team), so no other team waits on it.
template <int kSlots, bool kWide, class Out>
__device__ __forceinline__ void select_task(SelectArgs a, long long task, Out out) {
  __shared__ float cand[kBlock];                  // the teams' bisection candidates
  __shared__ TeamScratch scratch[kThreads / kNarrowTeam];
  const long long wide_tasks = static_cast<long long>(a.n) * a.n_wide;
  if (kWide && task < wide_tasks) {
    const int i = static_cast<int>(task / a.n_wide);
    const int b = static_cast<int>(task - static_cast<long long>(i) * a.n_wide);
    select_team<kThreads, kPerThread>(a, i, b, threadIdx.x, 1, scratch[0], cand, out);
    return;
  }
  const int team = threadIdx.x / kNarrowTeam;
  const long long i = (task - wide_tasks) * a.teams + team;
  if (team >= a.teams || i >= a.n) return;        // the whole team; no barrier follows
  select_team<kNarrowTeam, kSlots>(a, static_cast<int>(i), a.nb - 1,
                                   threadIdx.x - team * kNarrowTeam, team + 1, scratch[team],
                                   cand + team * kNarrowTeam * kSlots, out);
}

// A kernel's instances by [slots / 8 - 1][kWide]: each selecting kernel is
// a template <int kSlots, bool kWide> taking (SelectArgs, its Out).
template <class Out>
using SelectKernel = void (*)(SelectArgs, Out);
#define SELECT_KERNELS(kernel)                                                               \
  {                                                                                          \
    {kernel<8, false>, kernel<8, true>}, {kernel<16, false>, kernel<16, true>},              \
        {kernel<24, false>, kernel<24, true>}, {kernel<32, false>, kernel<32, true>}         \
  }

// Checks a select launch's layout (N = a.n rows of a.d; n_wide, teams and
// `slots` from kernels/teams.compress_plan, narrow_grid blocks of small
// teams) and launches its instance on stream s: kThreads threads a block
// when the grid holds a leading block or a block team, else the small
// teams alone.  Returns the cudaError_t of the launch (0 on success).
template <class Out>
int launch_select(const SelectKernel<Out> (&kernels)[4][2], SelectArgs a, int slots,
                  int narrow_grid, cudaStream_t s, Out out) {
  const long long d = a.d;
  const long long nb = (d + kBlock - 1) / kBlock;
  if (d < 1 || nb > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  a.nb = static_cast<int>(nb);
  const long long grid = a.lead + static_cast<long long>(a.n) * a.n_wide + narrow_grid;
  const bool narrow = a.n_wide < a.nb;            // the last block goes to small teams
  if (a.n < 1 || a.k < 1 || a.lead < 0 || a.n_wide < a.nb - 1 || a.n_wide > a.nb ||
      a.teams < 1 || a.teams > kThreads / kNarrowTeam || slots < 8 || slots > 32 ||
      slots % 8 != 0 ||
      (narrow ? static_cast<long long>(narrow_grid) * a.teams < a.n ||
                    d - (nb - 1) * kBlock > kNarrowTeam * slots
              : narrow_grid != 0) ||
      grid > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = a.lead > 0 || a.n_wide > 0 ? kThreads : a.teams * kNarrowTeam;
  kernels[slots / 8 - 1][a.n_wide > 0 ? 1 : 0]<<<static_cast<unsigned>(grid), threads, 0, s>>>(
      a, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
