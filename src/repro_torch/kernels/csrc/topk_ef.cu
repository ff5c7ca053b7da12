// Error-feedback block Top-K for Hopper (sm_90a), the per-client
// compressor without quantisation (quant_bits = 32).
//
// Replaces the Pallas TPU kernel _topk_ef_kernel of
// src/repro/kernels/topk_ef.py.  As in quant8.cu, one launch takes a batch
// of rows (N, d) at their real width instead of one zero-padded vector.
//
// topk_ef, a team per (client, 8192-block) sized to the block's real width
// (block_select.cuh's select_task, as compress_q8's):
//   v = delta + err; hi = team_threshold (block_select.cuh, the one
//   bisection of every compression kernel); sparse = v * [|v| > hi];
//   new_err = v - sparse, exactly v or 0.  Writes sparse and new_err
//   (N, d), real coordinates only; equal to
//   kernels/ref.blockwise_topk_ef_ref bit for bit.  d is 64-bit, so a row
//   may hold 2^31 coordinates or more (block_select.cuh's SelectArgs).
//
// Bound: bytes.  At train-200 (N = 200, d = 1,352) it reads delta and err
// and writes sparse and new_err, 16 bytes a coordinate: 4.3 MB, ~1.3 us at
// 3.35 TB/s.  Like compress_q8 it is latency-bound at a few hundred teams:
// a team's loads, 8 barrier steps over its held slots, then the candidate
// list by one ballot a step.  The first design ran a block of 256 threads
// per (client, block) that held the whole padded block and counted all of
// it in 32 barrier-separated steps.
#include <cuda_runtime.h>

#include "block_select.cuh"

namespace {

// What topk_ef writes for one (client, block): each real column's sparse
// value and new_err; nothing per block.
struct TopkOut {
  float* sparse;
  float* new_err;

  __device__ __forceinline__ float block_scale(float, float) const { return 0.0f; }
  __device__ __forceinline__ void element(size_t at, float v, bool kept, float) const {
    const float s = kept ? v : 0.0f;
    sparse[at] = s;
    new_err[at] = __fsub_rn(v, s);
  }
  __device__ __forceinline__ void block(size_t, float, float) const {}
};

template <int kSlots, bool kWide>
__global__ void __launch_bounds__(kThreads) topk_ef_kernel(SelectArgs a, TopkOut out) {
  select_task<kSlots, kWide>(a, blockIdx.x, out);
}

const SelectKernel<TopkOut> kTopkKernels[4][2] = SELECT_KERNELS(topk_ef_kernel);

}  // namespace

extern "C" {

// sparse and new_err (n, d); n_wide, slots, teams and narrow_grid from
// kernels/teams.compress_plan.  Returns the cudaError_t of the launch.
int topk_ef(const void* delta, const void* err, int n, long long d, int k, int n_wide,
            int slots, int teams, int narrow_grid, void* sparse, void* new_err, void* stream) {
  const SelectArgs a{static_cast<const float*>(delta), static_cast<const float*>(err), n, d, k,
                     n_wide, teams, 0, 0};
  const TopkOut out{static_cast<float*>(sparse), static_cast<float*>(new_err)};
  return launch_select(kTopkKernels, a, slots, narrow_grid, static_cast<cudaStream_t>(stream),
                       out);
}

const char* topk_ef_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
