// The per-client blockwise compressor for Hopper (sm_90a): error-feedback
// block Top-K with an int8 round trip (compress_q8), and plain per-block
// symmetric int8 quantisation (quant8).
//
// Replaces the Pallas TPU kernels _compress_kernel and _quant8_kernel of
// src/repro/kernels/quant8.py.  The TPU kernels take (nb, 64, 128) tiles of
// one zero-padded flat vector per call (the reference vmaps the call over
// clients); these take a batch of rows (N, d) at their real width, one
// launch per round, and count the padding zeros of a row's last block
// without loading them.
//
// compress_q8, a team per (client, 8192-block) sized to the block's real
// width (block_select.cuh's select_task: a block team of 256 threads for a
// full block, a two-warp team for a last block up to 2,048 wide):
//   v = delta + err; hi = team_threshold (block_select.cuh, the one
//   bisection of every compression kernel, so the survivor sets of the
//   fused and the per-client paths are the same); sparse = v * [|v| > hi];
//   scale = max|sparse| * f32(1/127), which is the block max of |v| when
//   anything survives (the max survives too) and 0 when nothing does (more
//   than k entries tied at the block max): ref.compress_ref's rule, not
//   fused_agg's (which keeps the block max's scale over an all-zero sparse);
//   q = clip(rint(sparse / scale), +-127), 0 where scale is 0 (a
//   non-survivor's code is +0 under either scale, so only survivors
//   divide); new_err = v - q * scale.
//   Writes q int8 (N, d), scale (N, nb) and new_err (N, d), real
//   coordinates only.
// quant8, one block per (row, 8192-block):
//   scale = max|x| * f32(1/127); q = clip(rint(x / scale), +-127), 0 where
//   scale is 0.  Writes q int8 (N, nb * 8192), the padding as zeros (the
//   blocked layout of ref.quant8_ref), and scale (N, nb).
//
// Numerics: the division, the q * scale product and v - recon are explicit
// round-to-nearest intrinsics (no FMA contraction), rint is half to even,
// and the scale is a product with the f32 reciprocal of 127, as the
// reference's jitted oracles compute amax / 127; so both kernels equal
// their plain versions (kernels/ref.compress_ref, quant8_ref) bit for bit.
//
// Bound: bytes.  compress_q8 at train-200 (N = 200, d = 1,352) reads delta
// and err (8 bytes a coordinate) and writes new_err and q (5): 3.5 MB,
// ~1 us at 3.35 TB/s; the bisection's compares and adds per coordinate are
// far below the card's rate.  At 200 teams the kernel is latency-bound: a
// team's loads, 8 bisection steps over its held slots with a barrier each,
// the rest over a short candidate list by one ballot a step, and its
// survivors' divisions.  The first design ran a block of 256 threads per
// (client, block) that held the whole padded block (83% padding zeros at d
// = 1,352) and counted all of it in 32 barrier-separated steps.
// quant8 reads 4 and writes 1 byte a coordinate.
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_select.cuh"

namespace {

// What compress_q8 writes for one (client, block): each real column's code
// and new_err, and the block's scale.
struct CompressOut {
  int8_t* q;
  float* scale;
  float* new_err;

  __device__ __forceinline__ float block_scale(float hi, float amax) const {
    return amax > hi ? __fmul_rn(amax, kInv127) : 0.0f;
  }
  __device__ __forceinline__ void element(size_t at, float v, bool kept, float sc) const {
    const float code = kept ? code8(v, sc) : 0.0f;
    q[at] = static_cast<int8_t>(code);
    new_err[at] = __fsub_rn(v, __fmul_rn(code, sc));
  }
  __device__ __forceinline__ void block(size_t task, float, float sc) const { scale[task] = sc; }
};

template <int kSlots, bool kWide>
__global__ void __launch_bounds__(kThreads) compress_q8_kernel(SelectArgs a, CompressOut out) {
  select_task<kSlots, kWide>(a, blockIdx.x, out);
}

const SelectKernel<CompressOut> kCompressKernels[4][2] = SELECT_KERNELS(compress_q8_kernel);

__global__ void __launch_bounds__(kThreads)
    quant8_kernel(const float* __restrict__ x, int d, int nb,
                  int8_t* __restrict__ q_out, float* __restrict__ scale_out) {
  __shared__ float max_sm[kWarps];
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
    v[j] = col < d ? x[row + col] : 0.0f;
    amax = fmaxf(amax, fabsf(v[j]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if (lane == 0) max_sm[warp] = amax;
  __syncthreads();
  amax = max_sm[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) amax = fmaxf(amax, max_sm[w]);
  const float scale = __fmul_rn(amax, kInv127);
  int8_t* q = q_out + static_cast<size_t>(blockIdx.x) * kBlock;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j)
    q[j * kThreads + tid] = static_cast<int8_t>(code8(v[j], scale));
  if (tid == 0) scale_out[blockIdx.x] = scale;
}

}  // namespace

extern "C" {

// q int8 (n, d), scale (n, nb) with nb = ceil(d / 8192), new_err (n, d);
// n_wide, slots, teams and narrow_grid from kernels/teams.compress_plan.
// Returns the cudaError_t of the launch (0 on success).
int compress_q8(const void* delta, const void* err, int n, int d, int k, int n_wide, int slots,
                int teams, int narrow_grid, void* q, void* scale, void* new_err, void* stream) {
  const SelectArgs a{static_cast<const float*>(delta), static_cast<const float*>(err), n, d, k,
                     n_wide, teams, 0, 0};
  const CompressOut out{static_cast<int8_t*>(q), static_cast<float*>(scale),
                        static_cast<float*>(new_err)};
  return launch_select(kCompressKernels, a, slots, narrow_grid,
                       static_cast<cudaStream_t>(stream), out);
}

// q int8 (n, nb * 8192), zeros past d in each row's last block; scale
// (n, nb).  Returns the cudaError_t of the launch.
int quant8(const void* x, int n, int d, void* q, void* scale, void* stream) {
  if (n < 1 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int nb = (d + kBlock - 1) / kBlock;
  const long long grid = static_cast<long long>(n) * nb;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  quant8_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), d, nb, static_cast<int8_t*>(q),
      static_cast<float*>(scale));
  return static_cast<int>(cudaGetLastError());
}

const char* quant8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
