// Fused compress-and-aggregate for Hopper (sm_90a): error-feedback block
// Top-K, int8 round trip and the weighted per-fog sums of a federated round,
// densely (fused_agg) or through the sparse wire (wire_emit + wire_agg).
//
// Replaces the Pallas TPU kernels _fused_agg_kernel, _wire_emit_kernel and
// _wire_agg_kernel of src/repro/kernels/fused_agg.py.  Both paths select
// with team_threshold (block_select.cuh), the one bisection of every
// compression kernel, over the block's real width only, so their survivor
// sets cannot drift apart from each other or from compress_q8's and
// topk_ef's.  The dense select's layout and launch are block_select.cuh's
// select_task and launch_select, which compress_q8 and topk_ef run too.
//
// The dense path (fused_agg, two launches).  Per client i and 8192-element
// block b of the zero-padded flat update (d real coordinates):
//   v = delta + err; t = bisection threshold keeping at most k of |v|;
//   sparse = v * [|v| > t]; recon = int8 round trip of sparse with scale
//   max|v| * f32(1/127) (or sparse itself without quantisation);
//   new_err = v - recon; fog_sum[fog_id[i]] += w[i] * recon.
//
// Two launches behind one wrapper (fused_agg.py, dense_plan()):
//   select: three kinds of block in one grid.  First, n_fog + 1 list
//           blocks (fog_members.cuh): block m writes fog m's clients, in
//           index order, into a member list and its start into offsets, so
//           every fog's members are found once per call, not once per
//           column tile; ids outside [0, n_fog) belong to no fog.  Then a
//           team per (client, block) sized to the block's real width, as
//           wire_emit's: a block team of 256 threads for the full blocks of
//           a row, `teams` two-warp teams a block for a last block up to
//           kSmallWidth wide (d = 1,352 is one such block; d = 8,209 has
//           one of each).  A team reads delta and err once, bisects with
//           the unheld padding counted as n * [mid < 0] (the last steps by
//           one ballot each), and writes new_err and each real column's
//           code (int8, 0 off the survivors; the f32 sparse value without
//           quantisation), and the block's threshold (the bisection's hi)
//           and scale.  Only survivors divide.
//   sum:    a block of kSumThreads per (fog, tile of kSumThreads * cols
//           columns), on a 1-D grid (no fog limit); cols (1, 2 or 4) is the
//           widest that still gives one block per SM, so train-200's 20
//           fogs take 220 blocks.  A block reads its fog's slice of the
//           member list and takes the members kSumGroup at a time: their
//           scales, weights and codes are all loaded before the first add,
//           the next group's ids while this group adds; then each column
//           adds w * (code * scale) in member (client index) order, in
//           registers: one byte a coordinate read, no division.  Every fog
//           row is written, zeros for an empty fog.  Deterministic, no
//           atomics, the TPU kernel's order (client innermost).
//
// Numerics copy repro_torch.kernels.ref.compress_aggregate_ref: the
// bisection is ref.bisect_threshold (lo = -1, hi = block max, mid =
// 0.5f * (lo + hi), strict >, cnt > k, 32 iterations, survivors |v| > hi);
// rounding is rintf (half to even), clipped to +-127; division, the
// q * scale product and v - recon are explicit round-to-nearest
// intrinsics so nvcc cannot contract them into an FMA and new_err equals
// the plain version bit for bit.  Never build with --use_fast_math.  The
// scale is max|v| times the f32 reciprocal of 127, not max|v| / 127: the
// reference's jitted oracle gets that product (XLA folds a division by a
// constant into a multiply), and so does the plain version, explicitly.
// A one-ulp difference in the scale rarely flips an int8 code, and then
// new_err moves by a whole quantisation step.  The fog sums are
// acc = __fadd_rn(acc, __fmul_rn(w, recon)) from 0 in client index order:
// ref.dense_fold_ref replays that order bit for bit.
//
// Bound: bytes.  At N = 200, d = 1,352 the function reads delta and err
// (2 x 1.08 MB) and writes new_err (1.08 MB) and the fog sums (0.1 MB):
// ~1 us at 3.35 TB/s; the select pass does ~33 compares per element, far
// below the card's rate.  The codes add a byte a coordinate, written once
// and read once (0.27 MB here; at fleet-10k's N = 10,000 13.5 MB, where
// reading delta and err again would be 108 MB).  At a few hundred blocks
// both launches are latency-bound: the select's time is a team's loads,
// bisection and its survivors' divisions, the sum's a few dependent round
// trips (offsets, list, the members' codes).
// The first design's select held a whole padded block in 256 threads and
// counted all of it in 32 barrier-separated steps however narrow the row,
// and its sum blocks (fog, 1,024 columns) each rescanned all N ids with
// one warp while seven waited, then walked the members one load chain at a
// time: O(N n_fog ceil(d / 1024)) id reads.
//
// The wire (the client-chunked rounds of HFLConfig.client_chunk):
//   wire_emit: a team per (client, 8192-block) sized to the block's real
//           width (two warps up to 2,048 columns, else the block): the same
//           selection, then the survivors packed into k slots (int32
//           index, int8 code or f32 value, one f32 scale per block) in
//           ref.compress_wire_ref's order, and new_err, written at the
//           caller's row offset; one launch per team size.
//   wire_agg: a warp per (fog, 8192-block): the fog's clients of the call
//           found by ballots over the fog ids, then, in index order, each
//           adding w * q * scale at its k slots straight into the fog row
//           in device memory.  No atomics; deterministic.
// Bound: bytes for wire_emit (delta and err read, new_err written: 12 bytes
// per coordinate, the slots ~rho_s of that); for wire_agg the slots, ids and
// weights read and each touched coordinate read and written once (at
// fleet-10k's chunk of 512 clients into 1,000 fogs, ~35,000 coordinates:
// ~0.45 MB in all).  Both are latency-bound at these sizes.  wire_emit's
// first design (a block of 256 threads per (client, block)) spent most of
// its time counting the padding of a 1,352-wide block in 32
// barrier-separated steps; a two-warp team counts 24 held slots a thread
// for 8 steps, then only the few candidates left, with no barrier.  At
// fleet-10k's chunk its 512 teams are about two warps per scheduler, so
// each phase (loads, bisection, compaction, the O(s^2) rank of the <= k
// survivors) runs near one warp's latency, not at the card's rate.
// wire_agg's first design (a block of 256 threads per (block, fog), an
// 8192-float accumulator in shared memory) made every block scan the ids
// in 16 barrier-separated ballot steps, copied whole fog rows in and out
// and paid a block barrier per member; a warp now scans with one round
// trip per 512 ids, and a fog's time is the chain of its members' adds,
// one L2 round trip each.
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_select.cuh"
#include "fog_members.cuh"

namespace {

static_assert(kListWarps * 32 == kThreads, "a list block is a select block");

// What the dense path's select writes for one (client, block), the
// operations of the first design's select bit for bit: new_err at the
// block's real columns, each one's code, and the block's threshold (the
// bisection's hi) and scale.  A non-survivor's code and recon are +0 (0 /
// scale rounds to +0), so its new_err is v - 0; only survivors (at most k)
// take the division.  The code (int8, or the f32 value without
// quantisation) is what the sum launch reads: recon = code * scale, the
// same product.
struct DenseOut {
  const int* fog_id;
  int n_fog;
  bool quantize;
  float* new_err;
  float* thr;
  float* scale;
  void* codes;
  int* members;
  int* offsets;

  __device__ __forceinline__ float block_scale(float, float amax) const {
    return __fmul_rn(amax, kInv127);
  }
  __device__ __forceinline__ void element(size_t at, float v, bool kept, float sc) const {
    const float code = kept ? (quantize ? code8(v, sc) : v) : 0.0f;
    new_err[at] = __fsub_rn(v, quantize ? __fmul_rn(code, sc) : code);
    if (quantize) {
      static_cast<int8_t*>(codes)[at] = static_cast<int8_t>(code);
    } else {
      static_cast<float*>(codes)[at] = code;
    }
  }
  __device__ __forceinline__ void block(size_t task, float hi, float sc) const {
    thr[task] = hi;
    scale[task] = sc;
  }
};

// The select launch: its n_fog + 1 leading blocks list the fogs' members
// (block m bucket m); the rest are the teams of block_select.cuh's
// select_task.
template <int kSlots, bool kWide>
__global__ void __launch_bounds__(kThreads) select_kernel(SelectArgs a, DenseOut out) {
  if (static_cast<int>(blockIdx.x) < a.lead) {
    fog_members_block(out.fog_id, nullptr, a.n, out.n_fog, static_cast<int>(blockIdx.x),
                      out.members, out.offsets);
    return;
  }
  select_task<kSlots, kWide>(a, static_cast<long long>(blockIdx.x) - a.lead, out);
}

const SelectKernel<DenseOut> kSelectKernels[4][2] = SELECT_KERNELS(select_kernel);

// The fog sums: a block per (fog m, tile of kSumThreads * kCols columns),
// tile-minor on a 1-D grid; a tile lies inside one 8192-block.  Thread t
// owns columns tile0 + u * kSumThreads + t.  A member's recon is its code
// times its block's scale (CodeT int8), or the code itself (f32): the
// select launch's product, so no division here.
constexpr int kSumThreads = 128;
constexpr int kSumGroup = 8;                      // members whose loads fly together

template <int kCols, typename CodeT>
__global__ void __launch_bounds__(kSumThreads)
    sum_kernel(const CodeT* __restrict__ codes, const int* __restrict__ members,
               const int* __restrict__ offsets, const float* __restrict__ w, int d, int nb,
               int tiles, const float* __restrict__ scale, float* __restrict__ fog_sum) {
  static_assert(kBlock % (kSumThreads * kCols) == 0, "a tile inside one block");
  constexpr bool kQuantize = sizeof(CodeT) == 1;
  const long long task = blockIdx.x;
  const int m = static_cast<int>(task / tiles);
  const int tile0 = static_cast<int>(task - static_cast<long long>(m) * tiles) *
                    (kSumThreads * kCols);
  const int b = tile0 / kBlock;
  const int first = __ldg(offsets + m);
  const int last = __ldg(offsets + m + 1);

  float acc[kCols];
#pragma unroll
  for (int u = 0; u < kCols; ++u) acc[u] = 0.0f;
  int id[kSumGroup];
#pragma unroll
  for (int j = 0; j < kSumGroup; ++j) id[j] = first + j < last ? __ldg(members + first + j) : -1;
  for (int g0 = first; g0 < last; g0 += kSumGroup) {
    float sc[kSumGroup], wi[kSumGroup];
    CodeT c[kSumGroup][kCols];
#pragma unroll
    for (int j = 0; j < kSumGroup; ++j) {
      const bool in = id[j] >= 0;
      const size_t row = static_cast<size_t>(in ? id[j] : 0) * d;
      sc[j] = kQuantize && in ? __ldg(scale + static_cast<size_t>(id[j]) * nb + b) : 1.0f;
      wi[j] = in ? __ldg(w + id[j]) : 0.0f;
#pragma unroll
      for (int u = 0; u < kCols; ++u) {
        const int col = tile0 + u * kSumThreads + static_cast<int>(threadIdx.x);
        c[j][u] = in && col < d ? __ldg(codes + row + col) : CodeT(0);
      }
    }
    int next[kSumGroup];                          // the next group's ids, in flight
#pragma unroll
    for (int j = 0; j < kSumGroup; ++j) {
      const int p = g0 + kSumGroup + j;
      next[j] = p < last ? __ldg(members + p) : -1;
    }
#pragma unroll
    for (int j = 0; j < kSumGroup; ++j) {
      if (id[j] < 0) continue;
#pragma unroll
      for (int u = 0; u < kCols; ++u) {
        const float recon = kQuantize ? __fmul_rn(static_cast<float>(c[j][u]), sc[j])
                                      : static_cast<float>(c[j][u]);
        acc[u] = __fadd_rn(acc[u], __fmul_rn(wi[j], recon));
      }
    }
#pragma unroll
    for (int j = 0; j < kSumGroup; ++j) id[j] = next[j];
  }
#pragma unroll
  for (int u = 0; u < kCols; ++u) {
    const int col = tile0 + u * kSumThreads + static_cast<int>(threadIdx.x);
    if (col < d) fog_sum[static_cast<size_t>(m) * d + col] = acc[u];
  }
}

// int8 code of a survivor (or its value, without quantisation), as
// ref.compress_wire_ref computes it: rint(v / scale) clipped to +-127, 0
// when the scale is 0 (then v is 0 too).
template <bool kQuantize>
__device__ __forceinline__ float wire_code(float v, float scale) {
  return kQuantize ? code8(v, scale) : v;
}

template <bool kQuantize> struct CodeType { using T = float; };
template <> struct CodeType<true> { using T = int8_t; };

// Wire emit.  Each (client, block) is a task for a team sized to the
// block's real width (team_threshold, block_select.cuh): two warps when
// the width is at most kSmallWidth (the last block of a row, and every
// block of a row that narrow: fleet-10k's d = 1,352 is one 1,352-wide
// block), the whole block of kThreads otherwise.  One launch per team
// size: the wide blocks of every row, then the narrow last blocks, a
// client a team and blockDim.x / kTeam teams a block; a row with both (d =
// 8,209: a full block and a 17-wide one) takes both launches.
//
// After the selection a team packs its k slots in ref.compress_wire_ref's
// order: the ranked elements (|v| > max(hi, 0): every survivor with a
// nonzero value) by |v| descending with ties to the lower index, then the
// lowest-index other positions of the padded block, ascending.  (When hi
// < 0, k = 8192 and every position survives; its zeros then rank by index
// after the nonzero ones, which is the same order.)  The ranked elements,
// at most k, are compacted by ballots in index order into the team's
// shared memory as 64-bit keys (~bits(|v|), index) and values; each one's
// slot is the number of smaller keys.  An unranked position e fills slot
// s + e - (ranked elements below e) when that is below k, s the ranked
// count: only e < k can, and an unheld padding position e lands in slot e.
// Its code is its survivor code (a zero) or 0.  new_err is v at every real
// column, then v - q * scale at the ranked ones (the others' q * scale is
// 0): the operations of select_kernel and compress_q8, so the three agree
// bit for bit.
constexpr int kRankPad = 8;                   // keys the rank reads at a time
template <int kTeam, int kSlots, bool kQuantize>
__device__ __forceinline__ void wire_team(
    const float* __restrict__ delta, const float* __restrict__ err, int d, int nb, int k,
    int i, int b, int t, int bar, TeamScratch& sc, unsigned long long* keys, float* vals,
    float* cand, unsigned* pre, unsigned* bal_s, int* __restrict__ idx_out,
    typename CodeType<kQuantize>::T* __restrict__ q_out, float* __restrict__ scale_out,
    float* __restrict__ new_err) {
  using S = TeamShape<kTeam, kSlots>;
  using CodeT = typename CodeType<kQuantize>::T;
  constexpr int kTeamWarps = S::kTeamWarps;
  constexpr int kEntries = kSlots * kTeamWarps;   // (slot, warp) pairs, <= kTeam
  const int lane = t & 31;
  const int warp = t >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const int base = b * kBlock;
  const size_t task = static_cast<size_t>(i) * nb + b;
  const size_t slot0 = task * k;

  float a[S::kSlots];                             // |v|
  unsigned neg[S::kWords];                        // v's sign bits
  float amax;
  const float hi = team_threshold<kTeam, kSlots>(
      delta, err, static_cast<size_t>(i) * d + base, min(kBlock, d - base), k, t, bar, sc, a,
      neg, cand, &amax);
  const int width = opaque(min(kBlock, d - base));
  const size_t row = opaque(static_cast<size_t>(i) * d + base);
  const float scale = kQuantize ? __fmul_rn(amax, kInv127) : 1.0f;
  const float ranked_above = fmaxf(hi, 0.0f);

  // new_err = v at the real columns; the ranked ones are corrected below,
  // after a barrier, by the thread that codes them.
#pragma unroll
  for (int j = 0; j < S::kSlots; ++j) {
    const int e = j * kTeam + t;
    if (e < width) new_err[row + e] = with_sign(a[j], neg[j / 32], j % 32);
  }

  // Compaction.  bal_s takes each (slot, warp)'s ballot of ranked elements
  // (entry j * kTeamWarps + warp), pre the number of ranked elements
  // before it in index order (e = j * kTeam + t), for the compaction and
  // the fill.
#pragma unroll
  for (int j = 0; j < S::kSlots; ++j) {
    const unsigned bal = __ballot_sync(0xffffffffu, a[j] > ranked_above);
    if (lane == 0) bal_s[j * kTeamWarps + warp] = bal;
  }
  team_sync<kTeam>(bar);
  // An exclusive scan of the (slot, warp) counts, one a thread.
  const unsigned c = t < kEntries ? __popc(bal_s[t]) : 0u;
  unsigned inc = c;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned up = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += up;
  }
  if (lane == 31) sc.cnt[warp] = inc;
  team_sync<kTeam>(bar);
  unsigned before = 0;
  unsigned ranked = 0;                            // s, in every team thread
#pragma unroll
  for (int w = 0; w < kTeamWarps; ++w) {
    before += w < warp ? sc.cnt[w] : 0u;
    ranked += sc.cnt[w];
  }
  if (t < kEntries) pre[t] = before + inc - c;
  team_sync<kTeam>(bar);
#pragma unroll
  for (int j = 0; j < S::kSlots; ++j) {
    const bool r = a[j] > ranked_above;
    const unsigned below = pre[j * kTeamWarps + warp] + __popc(__ballot_sync(0xffffffffu, r) & lt);
    if (r) {
      keys[below] = (static_cast<unsigned long long>(~__float_as_uint(a[j])) << 32) |
                    static_cast<unsigned>(j * kTeam + t);
      vals[below] = with_sign(a[j], neg[j / 32], j % 32);
    }
  }
  if (t < kRankPad) keys[ranked + t] = ~0ull;     // the rank reads whole groups of keys
  team_sync<kTeam>(bar);

  // The ranked elements into slots 0 .. s - 1, kRankKeys keys a thread at a
  // time, and their new_err.  Every key is at least 2^63 (its high word is
  // ~bits(|v|)), so o < p exactly when the 64-bit difference key_o - key_p
  // is negative: a subtraction and a shift, no predicate.  The keys are
  // read kRankPad at a time by 16-byte loads, all in flight together; the
  // pad past s is ~0, never below a key.
  constexpr int kRankKeys = 2;
  const int s = static_cast<int>(ranked);
  for (int p0 = 0; p0 < s; p0 += kRankKeys * kTeam) {
    unsigned long long key[kRankKeys];
    unsigned r[kRankKeys];
#pragma unroll
    for (int h = 0; h < kRankKeys; ++h) {
      const int p = p0 + h * kTeam + t;
      key[h] = p < s ? keys[p] : ~0ull;
      r[h] = 0;
    }
    for (int o0 = 0; o0 < s; o0 += kRankPad) {
      unsigned long long ko[kRankPad];
#pragma unroll
      for (int u = 0; u < kRankPad / 2; ++u) {
        const ulonglong2 pair = reinterpret_cast<const ulonglong2*>(keys + o0)[u];
        ko[2 * u] = pair.x;
        ko[2 * u + 1] = pair.y;
      }
#pragma unroll
      for (int u = 0; u < kRankPad; ++u)
#pragma unroll
        for (int h = 0; h < kRankKeys; ++h) r[h] += static_cast<unsigned>((ko[u] - key[h]) >> 63);
    }
#pragma unroll
    for (int h = 0; h < kRankKeys; ++h) {
      const int p = p0 + h * kTeam + t;
      if (p < s) {
        const int e = static_cast<int>(key[h] & 0xffffffffu);
        const float v = vals[p];
        const float code = wire_code<kQuantize>(v, scale);
        idx_out[slot0 + r[h]] = e;
        q_out[slot0 + r[h]] = static_cast<CodeT>(code);
        new_err[row + e] = __fsub_rn(v, kQuantize ? __fmul_rn(code, scale) : code);
      }
    }
  }
  // The fill: held positions e < k, then unheld padding positions e < k.
  // An unranked position's v is 0 when it survives (hi < 0), so its code
  // is 0, or v itself (a signed zero) without quantisation.
  const int fill = k - s;
#pragma unroll
  for (int j = 0; j < S::kSlots; ++j) {
    if (j * kTeam >= k) break;                    // uniform; only e < k can fill
    const int e = j * kTeam + t;
    const bool ranked_e = a[j] > ranked_above;
    const int below = static_cast<int>(pre[j * kTeamWarps + warp] +
                                       __popc(__ballot_sync(0xffffffffu, ranked_e) & lt));
    if (!ranked_e) {
      if (e - below < fill) {
        const size_t slot = slot0 + s + (e - below);
        idx_out[slot] = e;
        q_out[slot] = static_cast<CodeT>(
            !kQuantize && a[j] > hi ? with_sign(a[j], neg[j / 32], j % 32) : 0.0f);
      }
    }
  }
  for (int e = S::kHeld + t; e < k; e += kTeam) {
    idx_out[slot0 + e] = e;
    q_out[slot0 + e] = static_cast<CodeT>(0);
  }
  if (t == 0) scale_out[task] = scale;
}

// A team's shared region in 8-byte words, an even number so each region
// starts 16-byte aligned (the rank reads keys in pairs): its candidate
// list (held floats), later its keys (cap of them and kRankPad pad keys)
// and values (cap), with a spare 16 bytes (team_region in fused_agg.py).
__host__ __device__ constexpr int wire_region(int held, int cap) {
  return ((held * 4 > (cap + kRankPad) * 8 + cap * 4 ? held * 4 : (cap + kRankPad) * 8 + cap * 4) /
              16 + 1) * 2;
}

// Teams of kTeam threads, blockDim.x / kTeam of them a block, each on one
// task: with `wide`, block b < n_wide of client task / n_wide; otherwise
// the last block of client task.  A team past the last task leaves at
// once; its barriers are its own.
template <bool kQuantize, int kTeam, int kSlots>
__global__ void __launch_bounds__(kThreads)
    wire_emit_kernel(const float* __restrict__ delta, const float* __restrict__ err, int n,
                     int d, int nb, int k, int n_wide, bool wide, int cap,
                     int* __restrict__ idx_out,
                     typename CodeType<kQuantize>::T* __restrict__ q_out,
                     float* __restrict__ scale_out, float* __restrict__ new_err) {
  extern __shared__ __align__(16) unsigned long long wire_sm[];
  __shared__ unsigned pre[kThreads];
  __shared__ unsigned bal_s[kThreads];
  __shared__ TeamScratch scratch[kThreads / kTeam];
  const int team = threadIdx.x / kTeam;
  const int t = threadIdx.x - team * kTeam;
  const int task = blockIdx.x * (blockDim.x / kTeam) + team;
  if (task >= (wide ? n * n_wide : n)) return;   // the whole team; no barrier follows
  const int i = wide ? task / n_wide : task;
  const int b = wide ? task - i * n_wide : nb - 1;
  unsigned long long* region = wire_sm + team * wire_region(kTeam * kSlots, cap);
  wire_team<kTeam, kSlots, kQuantize>(
      delta, err, d, nb, k, i, b, t, team + 1, scratch[team], region,
      reinterpret_cast<float*>(region + cap + kRankPad), reinterpret_cast<float*>(region),
      pre + team * kTeam, bal_s + team * kTeam, idx_out, q_out, scale_out, new_err);
}

// Every wire_emit kernel, for wire_emit_init's attribute.
template <bool kQuantize>
void wire_emit_kernels(const void** out) {
  out[0] = reinterpret_cast<const void*>(wire_emit_kernel<kQuantize, kThreads, kBlock / kThreads>);
  out[1] = reinterpret_cast<const void*>(wire_emit_kernel<kQuantize, kNarrowTeam, 8>);
  out[2] = reinterpret_cast<const void*>(wire_emit_kernel<kQuantize, kNarrowTeam, 16>);
  out[3] = reinterpret_cast<const void*>(wire_emit_kernel<kQuantize, kNarrowTeam, 24>);
  out[4] = reinterpret_cast<const void*>(wire_emit_kernel<kQuantize, kNarrowTeam, 32>);
}

template <bool kQuantize>
int launch_wire_emit(const float* delta, const float* err, int n, int d, int nb, int k,
                     int n_wide, int cap_wide, int smem_wide, int slots, int threads,
                     int narrow_grid, int cap_narrow, int smem_narrow, int* idx,
                     typename CodeType<kQuantize>::T* q, float* scale, float* new_err,
                     cudaStream_t s) {
  if (n_wide > 0) {
    wire_emit_kernel<kQuantize, kThreads, kBlock / kThreads>
        <<<n * n_wide, kThreads, smem_wide, s>>>(delta, err, n, d, nb, k, n_wide, true,
                                                 cap_wide, idx, q, scale, new_err);
    const cudaError_t rc = cudaGetLastError();
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  if (narrow_grid > 0) {
    switch (slots) {
#define WIRE_NARROW_CASE(S)                                                            \
  case S:                                                                              \
    wire_emit_kernel<kQuantize, kNarrowTeam, S><<<narrow_grid, threads, smem_narrow, s>>>( \
        delta, err, n, d, nb, k, n_wide, false, cap_narrow, idx, q, scale, new_err);   \
    break;
      WIRE_NARROW_CASE(8)
      WIRE_NARROW_CASE(16)
      WIRE_NARROW_CASE(24)
      WIRE_NARROW_CASE(32)
#undef WIRE_NARROW_CASE
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// Wire aggregate: a warp per (fog, 8192-block), kAggWarps warps a block on
// a 1-D grid (fog-major, so a fog's blocks sit in neighbouring warps).  The
// warp finds its fog's clients in batches of kScanIds * 32 ids: each lane
// issues all its kScanIds loads before the first ballot (one memory round
// trip a batch), the ballots append the members in client index order to
// the warp's list in shared memory, and the next batch's loads go out
// before this batch's members add.  For each member in order, lanes take
// slots lane, lane + 32, ... (kSlotRegs at a time) and add
// q * scale * w at their coordinates of the fog row, in device memory:
// one member's k slots of a block hold distinct coordinates, so no two
// lanes collide, and __syncwarp between members orders each coordinate's
// clients by index.  The next member's slots, scale and weight load while
// the current one adds.  Each coordinate thus takes its clients' products
// in index order after the value already there, the operations and order
// of the first design (a block per (block, fog) and an 8192-float
// accumulator in shared memory), so the sums are bit for bit what they
// were.  Rows of fogs without a member here are never touched; slots whose
// index lies outside the block's real columns (the padding) are skipped.
constexpr int kAggWarps = 4;    // wire_agg: warps per block
constexpr int kScanIds = 16;    // fog ids a lane loads per batch: 512 a warp
constexpr int kSlotRegs = 4;    // slots a lane holds per step: 128 a warp

template <typename CodeT>
struct MemberSlots {            // one step of a member: up to 128 of its slots
  int j[kSlotRegs];
  CodeT q[kSlotRegs];
  float scale;
  float w;
};

template <typename CodeT>
__global__ void __launch_bounds__(kAggWarps * 32)
    wire_agg_kernel(const int* __restrict__ idx, const CodeT* __restrict__ q,
                    const float* __restrict__ scale, const int* __restrict__ fog_id,
                    const float* __restrict__ w, int n, int nb, int k, int d, int n_fog,
                    float* __restrict__ fog_sum) {
  __shared__ int lists[kAggWarps][kScanIds * 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long unit = static_cast<long long>(blockIdx.x) * kAggWarps + warp;
  if (unit >= static_cast<long long>(n_fog) * nb) return;
  const int m = static_cast<int>(unit / nb);
  const int b = static_cast<int>(unit - static_cast<long long>(m) * nb);
  const int width = min(kBlock, d - b * kBlock);   // real columns of this block
  float* row = fog_sum + static_cast<size_t>(m) * d + static_cast<size_t>(b) * kBlock;
  int* list = lists[warp];
  const unsigned below = (1u << lane) - 1u;
  const int steps = (k + 32 * kSlotRegs - 1) / (32 * kSlotRegs);   // per member

  int ids[kScanIds];
  auto load_ids = [&](int c0) {
#pragma unroll
    for (int t = 0; t < kScanIds; ++t) {
      const int i = c0 + t * 32 + lane;
      ids[t] = i < n ? __ldg(fog_id + i) : -1;
    }
  };
  // Step `it` of the batch: member list[it / steps], slots from
  // (it % steps) * 128.
  auto fetch = [&](int it, MemberSlots<CodeT>& s) {
    const int t = it / steps;
    const int i = list[t];
    const size_t cb = static_cast<size_t>(i) * nb + b;
    s.scale = __ldg(scale + cb);
    s.w = __ldg(w + i);
    const int s0 = (it - t * steps) * 32 * kSlotRegs + lane;
#pragma unroll
    for (int r = 0; r < kSlotRegs; ++r) {
      const int slot = s0 + r * 32;
      const bool in = slot < k;
      s.j[r] = in ? __ldg(idx + cb * k + slot) : -1;
      s.q[r] = in ? __ldg(q + cb * k + slot) : CodeT(0);
    }
  };

  load_ids(0);
  for (int c0 = 0; c0 < n; c0 += kScanIds * 32) {
    int count = 0;
#pragma unroll
    for (int t = 0; t < kScanIds; ++t) {
      const bool mine = ids[t] == m;
      const unsigned ballot = __ballot_sync(0xffffffffu, mine);
      if (mine) list[count + __popc(ballot & below)] = c0 + t * 32 + lane;
      count += __popc(ballot);
    }
    if (c0 + kScanIds * 32 < n) load_ids(c0 + kScanIds * 32);
    __syncwarp();
    const int items = count * steps;
    MemberSlots<CodeT> cur, next;
    if (items > 0) fetch(0, cur);
    for (int it = 0; it < items; ++it) {
      if (it + 1 < items) fetch(it + 1, next);
      float v[kSlotRegs];
#pragma unroll
      for (int r = 0; r < kSlotRegs; ++r)
        v[r] = static_cast<unsigned>(cur.j[r]) < static_cast<unsigned>(width) ? row[cur.j[r]]
                                                                              : 0.0f;
#pragma unroll
      for (int r = 0; r < kSlotRegs; ++r)
        if (static_cast<unsigned>(cur.j[r]) < static_cast<unsigned>(width))
          row[cur.j[r]] = __fadd_rn(
              v[r], __fmul_rn(__fmul_rn(static_cast<float>(cur.q[r]), cur.scale), cur.w));
      __syncwarp();   // the next member may add at the same coordinates
      cur = next;
    }
  }
}

}  // namespace

extern "C" {

// Pass 1, the select launch (fused_agg.py's dense_plan() gives n_wide,
// slots, teams and narrow_grid, as wire_plan() does for wire_emit): new_err
// (n, d); thr and scale (n, nb) with nb = ceil(d / 8192); codes (n, d),
// int8 with quantize, else f32; members (n) and offsets (n_fog + 1), the
// fogs' member lists (fog_members.cuh).  Returns the cudaError_t of the
// launch (0 on success).
int fused_agg_select(const void* delta, const void* err, const void* fog_id, int n, int d,
                     int k, int quantize, int n_fog, int n_wide, int slots, int teams,
                     int narrow_grid, void* new_err, void* thr, void* scale, void* codes,
                     void* members, void* offsets, void* stream) {
  if (n_fog < 1 || n_fog == 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const SelectArgs a{static_cast<const float*>(delta), static_cast<const float*>(err), n, d, k,
                     n_wide, teams, n_fog + 1, 0};
  const DenseOut out{static_cast<const int*>(fog_id), n_fog, quantize != 0,
                     static_cast<float*>(new_err), static_cast<float*>(thr),
                     static_cast<float*>(scale), codes, static_cast<int*>(members),
                     static_cast<int*>(offsets)};
  return launch_select(kSelectKernels, a, slots, narrow_grid,
                       static_cast<cudaStream_t>(stream), out);
}

// Pass 2, the fog sums: fog_sum (n_fog, d), every row written, from pass
// 1's codes (n, d: int8 with quantize, else f32), scale, members and
// offsets; cols (1, 2 or 4) columns a thread.  Returns the cudaError_t.
int fused_agg_sum(const void* codes, const void* members, const void* offsets, const void* w,
                  int d, int n_fog, int quantize, int cols, const void* scale, void* fog_sum,
                  void* stream) {
  const int nb = (d + kBlock - 1) / kBlock;
  const int tile = kSumThreads * cols;
  const int tiles = (d + tile - 1) / tile;
  const long long grid = static_cast<long long>(n_fog) * tiles;
  if (d < 1 || n_fog < 1 || grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SUM_LAUNCH(C, T)                                                                    \
  sum_kernel<C, T><<<static_cast<unsigned>(grid), kSumThreads, 0, s>>>(                     \
      static_cast<const T*>(codes), static_cast<const int*>(members),                       \
      static_cast<const int*>(offsets), static_cast<const float*>(w), d, nb, tiles,         \
      static_cast<const float*>(scale), static_cast<float*>(fog_sum))
#define SUM_CASE(C)                                                                         \
  case C:                                                                                   \
    if (quantize) {                                                                         \
      SUM_LAUNCH(C, int8_t);                                                                \
    } else {                                                                                \
      SUM_LAUNCH(C, float);                                                                 \
    }                                                                                       \
    break;
  switch (cols) {
    SUM_CASE(1)
    SUM_CASE(2)
    SUM_CASE(4)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SUM_CASE
#undef SUM_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

// Opts the wire_emit kernels in to smem_bytes of dynamic shared memory on
// the current device; called once per device by the wrapper.  Returns the
// cudaError_t (0 on success).
int wire_emit_init(int smem_bytes) {
  const void* kernels[10];
  wire_emit_kernels<true>(kernels);
  wire_emit_kernels<false>(kernels + 5);
  for (const void* kernel : kernels) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  return 0;
}

// Wire emit.  idx (n, nb, k) int32, q (n, nb, k) int8 (quantize) or f32,
// scale (n, nb) f32 and new_err (n, d), each written from its pointer on
// (a row offset into the caller's buffers).  The launches come from
// fused_agg.py's wire_plan(): n_wide block-team blocks per row (one launch
// of n * n_wide blocks), then, when the last block is narrow, narrow_grid
// blocks of two-warp teams with `slots` slots a thread (a second launch).
// Returns the cudaError_t of the launches.
int wire_emit(const void* delta, const void* err, int n, int d, int k, int quantize,
              int n_wide, int cap_wide, int smem_wide, int slots, int threads,
              int narrow_grid, int cap_narrow, int smem_narrow, void* idx, void* q,
              void* scale, void* new_err, void* stream) {
  const int nb = (d + kBlock - 1) / kBlock;
  if (n < 1 || d < 1 || k < 1 || k > kBlock || n_wide < 0 || n_wide > nb ||
      static_cast<long long>(n) * n_wide > 0x7fffffffLL || narrow_grid < 0 ||
      (narrow_grid > 0 && (threads < kNarrowTeam || threads > kThreads ||
                           threads % kNarrowTeam != 0 ||
                           d - (nb - 1) * kBlock > kNarrowTeam * slots)))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* dp = static_cast<const float*>(delta);
  const float* ep = static_cast<const float*>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (quantize)
    return launch_wire_emit<true>(dp, ep, n, d, nb, k, n_wide, cap_wide, smem_wide, slots,
                                  threads, narrow_grid, cap_narrow, smem_narrow,
                                  static_cast<int*>(idx), static_cast<int8_t*>(q),
                                  static_cast<float*>(scale), static_cast<float*>(new_err), s);
  return launch_wire_emit<false>(dp, ep, n, d, nb, k, n_wide, cap_wide, smem_wide, slots,
                                 threads, narrow_grid, cap_narrow, smem_narrow,
                                 static_cast<int*>(idx), static_cast<float*>(q),
                                 static_cast<float*>(scale), static_cast<float*>(new_err), s);
}

// Wire aggregate: adds the wire of n clients into fog_sum (n_fog, d) in
// place; rows of fogs without a client here are not touched.  Returns the
// cudaError_t.
int wire_agg(const void* idx, const void* q, const void* scale,
             const void* fog_id, const void* w, int n, int nb, int k, int d,
             int n_fog, int quantize, void* fog_sum, void* stream) {
  const long long grid = (static_cast<long long>(n_fog) * nb + kAggWarps - 1) / kAggWarps;
  if (n < 1 || nb < 1 || k < 1 || d <= static_cast<long long>(nb - 1) * kBlock ||
      d > static_cast<long long>(nb) * kBlock || n_fog < 1 || grid > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>(grid);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (quantize) {
    wire_agg_kernel<int8_t><<<blocks, kAggWarps * 32, 0, s>>>(
        static_cast<const int*>(idx), static_cast<const int8_t*>(q),
        static_cast<const float*>(scale), static_cast<const int*>(fog_id),
        static_cast<const float*>(w), n, nb, k, d, n_fog, static_cast<float*>(fog_sum));
  } else {
    wire_agg_kernel<float><<<blocks, kAggWarps * 32, 0, s>>>(
        static_cast<const int*>(idx), static_cast<const float*>(q),
        static_cast<const float*>(scale), static_cast<const int*>(fog_id),
        static_cast<const float*>(w), n, nb, k, d, n_fog, static_cast<float*>(fog_sum));
  }
  return static_cast<int>(cudaGetLastError());
}

const char* fused_agg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
