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
// quant8, one CTA of 512 threads per (row, 8192-block):
//   scale = max|x| * f32(1/127); q = clip(rint(x / scale), +-127), 0 where
//   scale is 0.  Writes q int8 (N, nb * 8192), the padding as zeros (the
//   blocked layout of ref.quant8_ref), and scale (N, nb).
//
// A row may hold 2^31 coordinates or more: d, a row's base and a block's
// start are 64-bit, offsets within a block stay int; the launch takes one
// task (a CTA or a team) per (row, block), so N x blocks stays below 2^31.
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
// quant8 reads 4 bytes a real coordinate and writes 1 a padded one (2^20
// coordinates: 5.2 MB, ~1.6 us).  The first design ran one CTA of 256
// threads per block with 32 scalar loads, 32 IEEE divisions and 32 one-byte
// stores a thread, the padding stored a byte at a time after the block's
// barrier.  This one issues 16-byte loads (scalar ones where a row starts
// off a 16-byte boundary: realigning them by shuffles measured slower),
// zero-fills the padding with 16-byte stores while they are in flight,
// divides only where a product with the reciprocal could round to another
// code (quick_code8), and writes four codes a 4-byte store, with 512
// threads a block (4 granules a thread; 256 and 1,024 measured slower).
// Splitting a block over a thread-block cluster (its max exchanged through
// distributed shared memory) was measured slower at every shape (about 1
// us more), so a block is one CTA.
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_select.cuh"

namespace {

constexpr int kGranules = kBlock / 4;        // 4-column granules of a block
constexpr int kQ8Threads = 512;              // a quant8 CTA: 4 granules a thread
constexpr int kQ8Warps = kQ8Threads / 32;
constexpr int kQ8Iter = kGranules / kQ8Threads;

// Four int8 codes (integral floats in [-127, 127]) packed little-endian.
__device__ __forceinline__ uint32_t pack4(float a, float b, float c, float d) {
  return (static_cast<uint32_t>(static_cast<int>(a)) & 0xffu) |
         ((static_cast<uint32_t>(static_cast<int>(b)) & 0xffu) << 8) |
         ((static_cast<uint32_t>(static_cast<int>(c)) & 0xffu) << 16) |
         (static_cast<uint32_t>(static_cast<int>(d)) << 24);
}

// code8(v, scale) with the division replaced by a product with r =
// rn(1 / scale) wherever that cannot change the code.  |v / scale| <= 127
// (1 + 2^-23), and y = rn(v * r) is within 2^-23 |v / scale| <= 1.6e-5 of
// the exact quotient, whose rounded value rn(v / scale) is within another
// 7.6e-6: so rint(y) = rint(rn(v / scale)) unless y lies within 2.3e-5 of a
// half-integer, where the IEEE division decides (code8).  r must be finite
// (a subnormal scale's reciprocal can overflow).
__device__ __forceinline__ float quick_code8(float v, float scale, float r) {
  const float y = __fmul_rn(v, r);
  const float k = rintf(y);
  if (fabsf(fabsf(__fsub_rn(y, k)) - 0.5f) > 3.0e-5f && r < 3.0e38f)
    return fminf(fmaxf(k, -127.0f), 127.0f);
  return code8(v, scale);
}

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

// quant8: one CTA of kQ8Threads per (row, 8192-block); granule g (columns
// 4g..4g+3 of the block) sits in slot g / kQ8Threads of thread g % kQ8Threads.
__global__ void __launch_bounds__(kQ8Threads)
    quant8_kernel(const float* __restrict__ x, long long d, int nb, int8_t* __restrict__ q_out,
                  float* __restrict__ scale_out) {
  __shared__ float warp_max[kQ8Warps];
  const int task = blockIdx.x;                    // (row, block)
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int i = task / nb;
  const long long base = static_cast<long long>(task - i * nb) * kBlock;   // may pass 2^31
  const int width = d - base < kBlock ? static_cast<int>(d - base) : kBlock;
  const int granules = (width + 3) >> 2;          // real granules, the last maybe partial
  const float* src = x + static_cast<size_t>(i) * d + base;
  const bool aligned = (reinterpret_cast<uintptr_t>(src) & 15) == 0;

  // 1. Every real load issued at once: 16 bytes a granule where the row
  // starts on a 16-byte boundary, four scalar loads where it does not (d %
  // 4 != 0) and for a last, partial granule.
  float4 v[kQ8Iter];
#pragma unroll
  for (int j = 0; j < kQ8Iter; ++j) {
    const int g = j * kQ8Threads + tid;
    const int col = 4 * g;
    if (g < granules && aligned && col + 4 <= width) {
      v[j] = __ldg(reinterpret_cast<const float4*>(src + col));
    } else if (g < granules) {
      v[j].x = __ldg(src + col);
      v[j].y = col + 1 < width ? __ldg(src + col + 1) : 0.0f;
      v[j].z = col + 2 < width ? __ldg(src + col + 2) : 0.0f;
      v[j].w = col + 3 < width ? __ldg(src + col + 3) : 0.0f;
    } else {
      v[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }

  // 2. While they fly, the padding's codes: zeros, never loaded, 16 bytes a
  // store from the first 16-byte boundary past the real granules (the up to
  // three granules before it 4 bytes each).
  int8_t* q = q_out + static_cast<size_t>(task) * kBlock;
  const int pad4 = (granules + 3) & ~3;
  if (tid < pad4 - granules) reinterpret_cast<uint32_t*>(q)[granules + tid] = 0u;
  for (int p4 = pad4 / 4 + tid; p4 < kGranules / 4; p4 += kQ8Threads)
    reinterpret_cast<uint4*>(q)[p4] = make_uint4(0u, 0u, 0u, 0u);

  // 3. The block max: each warp by shuffles, then the block's warps.
  float amax = 0.0f;
#pragma unroll
  for (int j = 0; j < kQ8Iter; ++j)
    amax = fmaxf(amax, fmaxf(fmaxf(fabsf(v[j].x), fabsf(v[j].y)),
                             fmaxf(fabsf(v[j].z), fabsf(v[j].w))));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if (lane == 0) warp_max[tid >> 5] = amax;
  __syncthreads();
  amax = warp_max[0];
#pragma unroll
  for (int w = 1; w < kQ8Warps; ++w) amax = fmaxf(amax, warp_max[w]);
  const float scale = __fmul_rn(amax, kInv127);
  const float r = scale > 0.0f ? __frcp_rn(scale) : 0.0f;

  // 4. The real granules' codes, four packed into one 4-byte store a
  // granule (a warp writes 128 contiguous bytes).
#pragma unroll
  for (int j = 0; j < kQ8Iter; ++j) {
    const int g = j * kQ8Threads + tid;
    if (g < granules)
      reinterpret_cast<uint32_t*>(q)[g] =
          pack4(quick_code8(v[j].x, scale, r), quick_code8(v[j].y, scale, r),
                quick_code8(v[j].z, scale, r), quick_code8(v[j].w, scale, r));
  }
  if (tid == 0) scale_out[task] = scale;
}

}  // namespace

extern "C" {

// q int8 (n, d), scale (n, nb) with nb = ceil(d / 8192), new_err (n, d);
// n_wide, slots, teams and narrow_grid from kernels/teams.compress_plan.
// Returns the cudaError_t of the launch (0 on success).
int compress_q8(const void* delta, const void* err, int n, long long d, int k, int n_wide,
                int slots, int teams, int narrow_grid, void* q, void* scale, void* new_err,
                void* stream) {
  const SelectArgs a{static_cast<const float*>(delta), static_cast<const float*>(err), n, d, k,
                     n_wide, teams, 0, 0};
  const CompressOut out{static_cast<int8_t*>(q), static_cast<float*>(scale),
                        static_cast<float*>(new_err)};
  return launch_select(kCompressKernels, a, slots, narrow_grid,
                       static_cast<cudaStream_t>(stream), out);
}

// q int8 (n, nb * 8192), zeros past d in each row's last block; scale
// (n, nb).  Returns the cudaError_t of the launch.
int quant8(const void* x, int n, long long d, void* q, void* scale, void* stream) {
  if (n < 1 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long nb = (d + kBlock - 1) / kBlock;
  const long long grid = static_cast<long long>(n) * nb;   // one CTA a task, an int index
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  quant8_kernel<<<static_cast<unsigned>(grid), kQ8Threads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), d, static_cast<int>(nb), static_cast<int8_t*>(q),
      static_cast<float*>(scale));
  return static_cast<int>(cudaGetLastError());
}

const char* quant8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
