// The block selection shared by every compression kernel of the port:
// error-feedback v = delta + err per (client, 8192-block), the bisection
// threshold of kernels/ref.bisect_threshold and the int8 round trip.
//
// fused_agg.cu (the dense fused path and the sparse wire), quant8.cu (the
// per-client compressor) and topk_ef.cu (the same without int8) include
// this one definition, so their survivor sets cannot drift apart.
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

__device__ __forceinline__ float reconstruct(float v, float thr, float scale,
                                             bool quantize) {
  const float sparse = fabsf(v) > thr ? v : 0.0f;
  if (!quantize) return sparse;
  if (!(scale > 0.0f)) return 0.0f;
  float q = rintf(__fdiv_rn(sparse, scale));
  q = fminf(fmaxf(q, -127.0f), 127.0f);
  return __fmul_rn(q, scale);
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

}  // namespace
