// Error-feedback block Top-K for Hopper (sm_90a), the per-client
// compressor without quantisation (quant_bits = 32).
//
// Replaces the Pallas TPU kernel _topk_ef_kernel of
// src/repro/kernels/topk_ef.py.  As in quant8.cu, one launch takes a batch
// of rows (N, d) at their real width instead of one zero-padded vector.
//
// topk_ef, one block of 256 threads per (client, 8192-block):
//   v = delta + err; hi = block_threshold (block_select.cuh, the bisection
//   of every compression kernel); sparse = v * [|v| > hi];
//   new_err = v - sparse, exactly v or 0.  Writes sparse and new_err
//   (N, d), real coordinates only; equal to kernels/ref.topk_ef_ref bit for
//   bit.
//
// Bound: bytes.  At train-200 (N = 200, d = 1,352) it reads delta and err
// and writes sparse and new_err, 16 bytes a coordinate: 4.3 MB, ~1.3 us at
// 3.35 TB/s.  Like compress_q8 it is latency-bound at a few hundred blocks
// of 32 barrier-separated bisection steps.
#include <cuda_runtime.h>

#include "block_select.cuh"

namespace {

__global__ void __launch_bounds__(kThreads)
    topk_ef_kernel(const float* __restrict__ delta,
                   const float* __restrict__ err, int d, int nb, int k,
                   float* __restrict__ sparse_out,
                   float* __restrict__ new_err) {
  const int i = blockIdx.x / nb;
  const int b = blockIdx.x - i * nb;
  const int tid = threadIdx.x;
  const size_t row = static_cast<size_t>(i) * d;
  const int base = b * kBlock;

  float v[kPerThread];
  float amax;
  const float hi = block_threshold(delta, err, row, base, d, k, v, &amax);
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int col = base + j * kThreads + tid;
    if (col < d) {
      const float sparse = fabsf(v[j]) > hi ? v[j] : 0.0f;
      sparse_out[row + col] = sparse;
      new_err[row + col] = __fsub_rn(v[j], sparse);
    }
  }
}

}  // namespace

extern "C" {

// sparse and new_err (n, d).  Returns the cudaError_t of the launch.
int topk_ef(const void* delta, const void* err, int n, int d, int k,
            void* sparse, void* new_err, void* stream) {
  if (n < 1 || d < 1 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int nb = (d + kBlock - 1) / kBlock;
  const long long grid = static_cast<long long>(n) * nb;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  topk_ef_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(delta), static_cast<const float*>(err), d, nb,
      k, static_cast<float*>(sparse), static_cast<float*>(new_err));
  return static_cast<int>(cudaGetLastError());
}

const char* topk_ef_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
