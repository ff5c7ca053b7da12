// Fused compress-and-aggregate for Hopper (sm_90a): error-feedback block
// Top-K, int8 round trip and the weighted per-fog sums of a federated round.
//
// Replaces the Pallas TPU kernel _fused_agg_kernel of
// src/repro/kernels/fused_agg.py.  Per client i and 8192-element block b of
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
//           (client innermost).
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
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 8192;                  // BLOCK_ELEMS in kernels/ops.py
constexpr int kThreads = 256;                 // select: threads per block
constexpr int kPerThread = kBlock / kThreads; // values of v held per thread
constexpr int kWarps = kThreads / 32;
constexpr int kIters = 32;                    // BISECT_ITERS in kernels/ref.py
constexpr int kSumThreads = 256;              // sum: threads per block
constexpr int kSumCols = 1024;                // sum: columns per block (divides kBlock)
constexpr int kColsPerThread = kSumCols / kSumThreads;
constexpr int kChunk = 1024;                  // sum: clients compacted per pass
constexpr float kInv127 = 1.0f / 127.0f;      // the int8 scale's factor

__device__ __forceinline__ float reconstruct(float v, float thr, float scale,
                                             bool quantize) {
  const float sparse = fabsf(v) > thr ? v : 0.0f;
  if (!quantize) return sparse;
  if (!(scale > 0.0f)) return 0.0f;
  float q = rintf(__fdiv_rn(sparse, scale));
  q = fminf(fmaxf(q, -127.0f), 127.0f);
  return __fmul_rn(q, scale);
}

__global__ void __launch_bounds__(kThreads)
    select_kernel(const float* __restrict__ delta,
                  const float* __restrict__ err, int d, int nb, int k,
                  bool quantize, float* __restrict__ new_err,
                  float* __restrict__ thr_out, float* __restrict__ scale_out) {
  __shared__ float max_sm[kWarps];
  __shared__ unsigned cnt_sm[2][kWarps];
  const int i = blockIdx.x / nb;
  const int b = blockIdx.x - i * nb;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t row = static_cast<size_t>(i) * d;
  const int base = b * kBlock;

  float v[kPerThread];
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
               int n, int d, int nb, bool quantize,
               const float* __restrict__ thr, const float* __restrict__ scale,
               float* __restrict__ fog_sum) {
  __shared__ int members[kChunk];
  __shared__ int n_members;
  const int m = blockIdx.y;
  const int col0 = blockIdx.x * kSumCols;
  const int b = col0 / kBlock;
  const int tid = threadIdx.x;
  const int lane = tid & 31;

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
  if (n < 1 || d < 1 || n_fog < 1 || n_fog > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nb = (d + kBlock - 1) / kBlock;
  const dim3 grid((d + kSumCols - 1) / kSumCols, n_fog);
  sum_kernel<<<grid, kSumThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(delta), static_cast<const float*>(err),
      static_cast<const int*>(fog_id), static_cast<const float*>(w), n, d, nb,
      quantize != 0, static_cast<const float*>(thr),
      static_cast<const float*>(scale), static_cast<float*>(fog_sum));
  return static_cast<int>(cudaGetLastError());
}

const char* fused_agg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
