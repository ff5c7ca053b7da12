// Fused compress-and-aggregate for Hopper (sm_90a): error-feedback block
// Top-K, int8 round trip and the weighted per-fog sums of a federated round,
// densely (fused_agg) or through the sparse wire (wire_emit + wire_agg).
//
// Replaces the Pallas TPU kernels _fused_agg_kernel, _wire_emit_kernel and
// _wire_agg_kernel of src/repro/kernels/fused_agg.py.  The dense path runs
// block_threshold (block_select.cuh), the bisection of every compression
// kernel; the wire's emit runs team_threshold beside it, the same bisection
// over the block's real width only, so their survivor sets cannot drift
// apart.
//
// The dense path (fused_agg, two launches).  Per client i and 8192-element block b of
// the zero-padded flat update (d real coordinates):
//   v = delta + err; t = bisection threshold keeping at most k of |v|;
//   sparse = v * [|v| > t]; recon = int8 round trip of sparse with scale
//   max|v| * f32(1/127) (or sparse itself without quantisation);
//   new_err = v - recon; fog_sum[fog_id[i]] += w[i] * recon.
//
// Two launches behind one wrapper (fused_agg.py):
//   select: one block per (client, 8192-block); reads delta and err once,
//           keeps v in registers (32 per thread), runs the 32-step
//           bisection with block-wide counts, writes new_err and the
//           block's threshold and scale.  Padding positions (>= d) are
//           zeros that are counted, never loaded.
//   sum:    one block per (fog, 1,024 columns); walks the clients of its
//           fog in index order (compacted 1,024 at a time with a warp
//           ballot), recomputes recon from delta + err, the threshold and
//           the scale, and writes each fog row once.  The sum is
//           deterministic, with no atomics, in the TPU kernel's order
//           (client innermost).  Fogs past the grid's 65,535 rows are
//           taken by a loop, so identity segments (n_fog = N, the robust
//           path's per-client compression) take any N; each block still
//           scans all N ids, O(N * n_fog) in all.
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
// new_err moves by a whole quantisation step.
//
// Bound: bytes.  At N = 200, d = 1,352 the function reads delta and err
// (2 x 1.08 MB) and writes new_err (1.08 MB) and the fog sums (0.1 MB):
// ~1 us at 3.35 TB/s; the select pass does ~33 compares per element, far
// below the card's rate.  The sum pass reads delta and err a second time
// (from L2 at these sizes); at a few hundred blocks both launches are
// latency-bound, not bandwidth-bound.
//
// The wire (the client-chunked rounds of HFLConfig.client_chunk):
//   wire_emit: a team per (client, 8192-block) sized to the block's real
//           width (two warps up to 2,048 columns, else the block): the same
//           selection, then the survivors packed into k slots (int32
//           index, int8 code or f32 value, one f32 scale per block) in
//           ref.compress_wire_ref's order, and new_err, written at the
//           caller's row offset; one launch per team size.
//   wire_agg: one block per (8192-block, fog): the fog's clients of the
//           chunk in index order, each adding w * q * scale at its k slots
//           into a shared-memory accumulator started from the running fog
//           row, then written back.  No atomics; deterministic.
// Bound: bytes for wire_emit (delta and err read, new_err written: 12 bytes
// per coordinate, the slots ~rho_s of that); for wire_agg the slots read
// and the touched fog rows read and written (at fleet-10k's chunk of 512
// clients into 1,000 fogs, ~400 rows of 5.4 KB).  Both are latency-bound at
// these sizes.  wire_emit's first design (a block of 256 threads per
// (client, block)) spent most of its time counting the padding of a
// 1,352-wide block in 32 barrier-separated steps; a two-warp team counts
// 24 held slots a thread for 8 steps, then only the few candidates left,
// with no barrier.  At fleet-10k's chunk its 512 teams are about two warps
// per scheduler, so each phase (loads, bisection, compaction, the O(s^2)
// rank of the <= k survivors) runs near one warp's latency, not at the
// card's rate.  wire_agg keeps a barrier per client.
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_select.cuh"

namespace {

constexpr int kSumThreads = 256;              // sum: threads per block
constexpr int kSumCols = 1024;                // sum: columns per block (divides kBlock)
constexpr int kColsPerThread = kSumCols / kSumThreads;
constexpr int kChunk = 1024;                  // sum: clients compacted per pass
constexpr int kMaxGridY = 65535;              // sum: fogs per launch row; more loop

__global__ void __launch_bounds__(kThreads)
    select_kernel(const float* __restrict__ delta,
                  const float* __restrict__ err, int d, int nb, int k,
                  bool quantize, float* __restrict__ new_err,
                  float* __restrict__ thr_out, float* __restrict__ scale_out) {
  const int i = blockIdx.x / nb;
  const int b = blockIdx.x - i * nb;
  const int tid = threadIdx.x;
  const size_t row = static_cast<size_t>(i) * d;
  const int base = b * kBlock;

  float v[kPerThread];
  float amax;
  const float hi = block_threshold(delta, err, row, base, d, k, v, &amax);
  const float scale = __fmul_rn(amax, kInv127);
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int col = base + j * kThreads + tid;
    if (col < d)
      new_err[row + col] = __fsub_rn(v[j], reconstruct(v[j], hi, scale, quantize));
  }
  if (tid == 0) {
    thr_out[blockIdx.x] = hi;
    scale_out[blockIdx.x] = scale;
  }
}

__global__ void __launch_bounds__(kSumThreads)
    sum_kernel(const float* __restrict__ delta, const float* __restrict__ err,
               const int* __restrict__ fog_id, const float* __restrict__ w,
               int n, int d, int nb, int n_fog, bool quantize,
               const float* __restrict__ thr, const float* __restrict__ scale,
               float* __restrict__ fog_sum) {
  __shared__ int members[kChunk];
  __shared__ int n_members;
  const int col0 = blockIdx.x * kSumCols;
  const int b = col0 / kBlock;
  const int tid = threadIdx.x;
  const int lane = tid & 31;

  // Fogs past the grid's rows (n_fog > 65,535: identity segments of a
  // large fleet) are taken by this loop; the barriers stay uniform.
  for (int m = blockIdx.y; m < n_fog; m += gridDim.y) {
    float acc[kColsPerThread];
#pragma unroll
    for (int u = 0; u < kColsPerThread; ++u) acc[u] = 0.0f;

    for (int c0 = 0; c0 < n; c0 += kChunk) {
      // Warp 0 lists this fog's clients of the chunk in index order.
      if (tid < 32) {
        int count = 0;
        for (int s = 0; s < kChunk && c0 + s < n; s += 32) {
          const int i = c0 + s + lane;
          const bool mine = i < n && fog_id[i] == m;
          const unsigned ballot = __ballot_sync(0xffffffffu, mine);
          if (mine) members[count + __popc(ballot & ((1u << lane) - 1u))] = i;
          count += __popc(ballot);
        }
        if (lane == 0) n_members = count;
      }
      __syncthreads();
      const int count = n_members;
      for (int t = 0; t < count; ++t) {
        const int i = members[t];
        const float th = thr[static_cast<size_t>(i) * nb + b];
        const float sc = scale[static_cast<size_t>(i) * nb + b];
        const float wi = w[i];
        const size_t row = static_cast<size_t>(i) * d;
#pragma unroll
        for (int u = 0; u < kColsPerThread; ++u) {
          const int col = col0 + u * kSumThreads + tid;
          if (col < d) {
            const float v = __fadd_rn(delta[row + col], err[row + col]);
            acc[u] = __fadd_rn(acc[u], __fmul_rn(wi, reconstruct(v, th, sc, quantize)));
          }
        }
      }
      __syncthreads();  // the member list is rewritten by the next chunk
    }
#pragma unroll
    for (int u = 0; u < kColsPerThread; ++u) {
      const int col = col0 + u * kSumThreads + tid;
      if (col < d) fog_sum[static_cast<size_t>(m) * d + col] = acc[u];
    }
  }
}


// int8 code of a survivor (or its value, without quantisation), as
// ref.compress_wire_ref computes it: rint(v / scale) clipped to +-127, 0
// when the scale is 0 (then v is 0 too).
template <bool kQuantize>
__device__ __forceinline__ float wire_code(float v, float scale) {
  if (!kQuantize) return v;
  if (!(scale > 0.0f)) return 0.0f;
  return fminf(fmaxf(rintf(__fdiv_rn(v, scale)), -127.0f), 127.0f);
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
constexpr int kNarrowTeam = 64;               // a small team: two warps
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

// Wire aggregate: one block per (8192-block, fog).  The block walks its
// fog's clients in index order (compacted as in sum_kernel) and adds
// q * scale * w at each of a client's k slots into an 8192-float
// accumulator in shared memory.  The k slots of one (client, block) hold
// distinct coordinates, so the threads of one client's pass never collide;
// a barrier separates clients, so every coordinate sums its clients in
// index order: deterministic, no atomics.  The accumulator starts from the
// fog row as it is (the caller's running sums, or zeros) and is written
// back over the real d columns only; a fog with no client here returns
// at once and leaves its row alone.
template <typename CodeT>
__global__ void __launch_bounds__(kSumThreads)
    wire_agg_kernel(const int* __restrict__ idx, const CodeT* __restrict__ q,
                    const float* __restrict__ scale,
                    const int* __restrict__ fog_id, const float* __restrict__ w,
                    int n, int nb, int k, int d, float* __restrict__ fog_sum) {
  __shared__ float acc[kBlock];
  __shared__ int members[kChunk];
  __shared__ int n_members;
  const int b = blockIdx.x;
  const int m = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const size_t frow = static_cast<size_t>(m) * d + static_cast<size_t>(b) * kBlock;
  const int width = min(kBlock, d - b * kBlock);   // real columns of this block
  bool started = false;                            // uniform across the block

  for (int c0 = 0; c0 < n; c0 += kChunk) {
    if (tid < 32) {
      int count = 0;
      for (int s = 0; s < kChunk && c0 + s < n; s += 32) {
        const int i = c0 + s + lane;
        const bool mine = i < n && fog_id[i] == m;
        const unsigned ballot = __ballot_sync(0xffffffffu, mine);
        if (mine) members[count + __popc(ballot & ((1u << lane) - 1u))] = i;
        count += __popc(ballot);
      }
      if (lane == 0) n_members = count;
    }
    __syncthreads();
    const int count = n_members;
    if (count > 0 && !started) {
      for (int j = tid; j < kBlock; j += kSumThreads)
        acc[j] = j < width ? fog_sum[frow + j] : 0.0f;
      started = true;
      __syncthreads();
    }
    for (int t = 0; t < count; ++t) {
      const int i = members[t];
      const size_t cb = static_cast<size_t>(i) * nb + b;
      const float sc = scale[cb];
      const float wi = w[i];
      for (int s = tid; s < k; s += kSumThreads) {
        const int j = idx[cb * k + s];
        if (static_cast<unsigned>(j) < static_cast<unsigned>(kBlock))
          acc[j] = __fadd_rn(acc[j], __fmul_rn(__fmul_rn(static_cast<float>(q[cb * k + s]), sc), wi));
      }
      __syncthreads();
    }
    __syncthreads();  // the member list is rewritten by the next chunk
  }
  if (!started) return;
  for (int j = tid; j < width; j += kSumThreads) fog_sum[frow + j] = acc[j];
}

}  // namespace

extern "C" {

// Pass 1.  new_err (n, d); thr and scale (n, nb) with nb = ceil(d / 8192).
// Returns the cudaError_t of the launch (0 on success).
int fused_agg_select(const void* delta, const void* err, int n, int d, int k,
                     int quantize, void* new_err, void* thr, void* scale,
                     void* stream) {
  if (n < 1 || d < 1 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int nb = (d + kBlock - 1) / kBlock;
  const long long grid = static_cast<long long>(n) * nb;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  select_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(delta), static_cast<const float*>(err), d, nb,
      k, quantize != 0, static_cast<float*>(new_err), static_cast<float*>(thr),
      static_cast<float*>(scale));
  return static_cast<int>(cudaGetLastError());
}

// Pass 2.  fog_sum (n_fog, d), every row written.  Returns the cudaError_t.
int fused_agg_sum(const void* delta, const void* err, const void* fog_id,
                  const void* w, int n, int d, int n_fog, int quantize,
                  const void* thr, const void* scale, void* fog_sum,
                  void* stream) {
  if (n < 1 || d < 1 || n_fog < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int nb = (d + kBlock - 1) / kBlock;
  const dim3 grid((d + kSumCols - 1) / kSumCols, n_fog < kMaxGridY ? n_fog : kMaxGridY);
  sum_kernel<<<grid, kSumThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(delta), static_cast<const float*>(err),
      static_cast<const int*>(fog_id), static_cast<const float*>(w), n, d, nb,
      n_fog, quantize != 0, static_cast<const float*>(thr),
      static_cast<const float*>(scale), static_cast<float*>(fog_sum));
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
  if (n < 1 || nb < 1 || k < 1 || d < 1 || d > nb * kBlock || n_fog < 1 ||
      n_fog > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(nb, n_fog);
  if (quantize) {
    wire_agg_kernel<int8_t><<<grid, kSumThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(idx), static_cast<const int8_t*>(q),
        static_cast<const float*>(scale), static_cast<const int*>(fog_id),
        static_cast<const float*>(w), n, nb, k, d, static_cast<float*>(fog_sum));
  } else {
    wire_agg_kernel<float><<<grid, kSumThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(idx), static_cast<const float*>(q),
        static_cast<const float*>(scale), static_cast<const int*>(fog_id),
        static_cast<const float*>(w), n, nb, k, d, static_cast<float*>(fog_sum));
  }
  return static_cast<int>(cudaGetLastError());
}

const char* fused_agg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
