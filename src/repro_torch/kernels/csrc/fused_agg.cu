// Fused compress-and-aggregate for Hopper (sm_90a): error-feedback block
// Top-K, int8 round trip and the weighted per-fog sums of a federated round,
// densely (fused_agg) or through the sparse wire (wire_emit + wire_agg).
//
// Replaces the Pallas TPU kernels _fused_agg_kernel, _wire_emit_kernel and
// _wire_agg_kernel of src/repro/kernels/fused_agg.py.  The dense and the
// wire paths share block_threshold (block_select.cuh), the one bisection of
// every compression kernel, so their survivor sets cannot drift apart.
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
//   wire_emit: one block per (client, 8192-block): the same selection, then
//           the survivors packed into k slots (int32 index, int8 code or
//           f32 value, one f32 scale per block) in ref.compress_wire_ref's
//           order, and new_err, written at the caller's row offset.
//   wire_agg: one block per (8192-block, fog): the fog's clients of the
//           chunk in index order, each adding w * q * scale at its k slots
//           into a shared-memory accumulator started from the running fog
//           row, then written back.  No atomics; deterministic.
// Bound: bytes for wire_emit (delta and err read, new_err written: 12 bytes
// per coordinate, the slots ~rho_s of that); for wire_agg the slots read
// and the touched fog rows read and written (at fleet-10k's chunk of 512
// clients into 1,000 fogs, ~400 rows of 5.4 KB).  Both are latency-bound at
// these sizes: a bisection of 32 barrier-separated steps per block, and a
// barrier per client in the aggregate.
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

// Wire emit: one block per (client, 8192-block), the selection of
// select_kernel (block_threshold), then the survivors packed into k slots:
// survivors first, by |v| descending with ties to the lower index, then
// the lowest-index non-survivors ascending with code 0 (the order of
// ref.compress_wire_ref's top_k).  Survivors are listed in shared memory
// in any order (an atomic counter); each one's slot is its rank under that
// strict total order, counted over the list (at most k survivors, so
// O(k^2 / threads) per thread).  A non-survivor j < k fills slot s + j -
// (survivors below j) when that is below k: the first k - s non-survivors
// all lie below k.  new_err = v - q * scale at the survivors and v
// elsewhere, exactly select_kernel's.
template <bool kQuantize>
__global__ void __launch_bounds__(kThreads)
    wire_emit_kernel(const float* __restrict__ delta,
                     const float* __restrict__ err, int d, int nb, int k,
                     int* __restrict__ idx_out,
                     typename CodeType<kQuantize>::T* __restrict__ q_out,
                     float* __restrict__ scale_out,
                     float* __restrict__ new_err) {
  extern __shared__ float wire_sm[];        // k survivor values, then k indices
  int* s_idx = reinterpret_cast<int*>(wire_sm + k);
  __shared__ unsigned n_surv;
  const int i = blockIdx.x / nb;
  const int b = blockIdx.x - i * nb;
  const int tid = threadIdx.x;
  const size_t row = static_cast<size_t>(i) * d;
  const int base = b * kBlock;
  const size_t slot0 = static_cast<size_t>(blockIdx.x) * k;

  if (tid == 0) n_surv = 0u;
  float v[kPerThread];
  float amax;
  const float hi = block_threshold(delta, err, row, base, d, k, v, &amax);
  const float scale = kQuantize ? __fmul_rn(amax, kInv127) : 1.0f;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int c = j * kThreads + tid;
    if (fabsf(v[j]) > hi) {
      const unsigned pos = atomicAdd(&n_surv, 1u);
      if (pos < static_cast<unsigned>(k)) {
        wire_sm[pos] = v[j];
        s_idx[pos] = c;
      }
    }
    if (base + c < d)
      new_err[row + base + c] = __fsub_rn(v[j], reconstruct(v[j], hi, scale, kQuantize));
  }
  __syncthreads();
  const int s = min(static_cast<int>(n_surv), k);   // n_surv <= k: the bisection's invariant
  for (int p = tid; p < s; p += kThreads) {
    const float vp = wire_sm[p];
    const float ap = fabsf(vp);
    const int ip = s_idx[p];
    int rank = 0;
    for (int o = 0; o < s; ++o) {
      const float ao = fabsf(wire_sm[o]);
      rank += (ao > ap || (ao == ap && s_idx[o] < ip)) ? 1 : 0;
    }
    idx_out[slot0 + rank] = ip;
    q_out[slot0 + rank] =
        static_cast<typename CodeType<kQuantize>::T>(wire_code<kQuantize>(vp, scale));
  }
  for (int j = tid; j < k; j += kThreads) {
    int below = 0;
    bool survivor = false;
    for (int o = 0; o < s; ++o) {
      below += s_idx[o] < j ? 1 : 0;
      survivor |= s_idx[o] == j;
    }
    const int r = j - below;
    if (!survivor && r < k - s) {
      idx_out[slot0 + s + r] = j;
      q_out[slot0 + s + r] = static_cast<typename CodeType<kQuantize>::T>(0);
    }
  }
  if (tid == 0) scale_out[blockIdx.x] = scale;
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

// Wire emit.  idx (n, nb, k) int32, q (n, nb, k) int8 (quantize) or f32,
// scale (n, nb) f32 and new_err (n, d), each written from its pointer on
// (a row offset into the caller's buffers).  Returns the cudaError_t.
int wire_emit(const void* delta, const void* err, int n, int d, int k,
              int quantize, void* idx, void* q, void* scale, void* new_err,
              void* stream) {
  if (n < 1 || d < 1 || k < 1 || k > kBlock)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nb = (d + kBlock - 1) / kBlock;
  const long long grid = static_cast<long long>(n) * nb;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = 2 * k * static_cast<int>(sizeof(float));
  cudaError_t rc;
  if (quantize) {
    rc = cudaFuncSetAttribute(wire_emit_kernel<true>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    wire_emit_kernel<true><<<static_cast<unsigned>(grid), kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(delta), static_cast<const float*>(err), d, nb,
        k, static_cast<int*>(idx), static_cast<int8_t*>(q),
        static_cast<float*>(scale), static_cast<float*>(new_err));
  } else {
    rc = cudaFuncSetAttribute(wire_emit_kernel<false>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    wire_emit_kernel<false><<<static_cast<unsigned>(grid), kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(delta), static_cast<const float*>(err), d, nb,
        k, static_cast<int*>(idx), static_cast<float*>(q),
        static_cast<float*>(scale), static_cast<float*>(new_err));
  }
  return static_cast<int>(cudaGetLastError());
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
