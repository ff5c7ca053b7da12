// Single-token GQA sliding-window decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _swa_decode_kernel of
// src/repro/kernels/swa_attention.py.  The TPU kernel takes one sequence
// per call (the reference vmaps it over the batch), walks the whole cache
// in 512-position tiles on a sequential grid with the online-softmax state
// in VMEM scratch, and masks the positions outside the window.  This
// kernel takes the whole batch in one launch and visits only the window.
//
// Function: for batch row b, query head (kv head h, group member j),
//   len = cache_len[b], positions p in [max(0, len - window), min(len, S)),
//   s_p = <q[b, h*g + j] * d^-0.5, k[b, p, h]>            (q scaled first, in f32)
//   out = sum_p exp(s_p - m) v[b, p, h] / max(sum_p exp(s_p - m), 1e-20)
// with the TPU kernel's online recurrence and clips: m starts at -1e30,
// alpha = exp(clip(m_prev - m_new, -80, 0)), p = exp(clip(s - m_new, -80,
// 0)).  A row whose window holds no position gives zeros, as the TPU
// kernel does (kernels/ref.sliding_window_decode_attention_ref likewise).
// Positions outside the window are never loaded: in the TPU recurrence a
// masked position leaves m, l and acc unchanged, so skipping them is exact.
// cache_len is read on the device (no host sync).
//
// Work split: one block of 8 warps per (batch row, kv head, chunk of at
// most 16 of its g query heads; one chunk unless g > 16).  The chunk's
// query heads, pre-scaled in f32, sit in shared memory; each warp takes
// every 8th position of the window, loads its K and V rows once for all
// the chunk's heads (the point of MQA / GQA) with lane i holding elements
// i, i + 32, ... (coalesced), and keeps its own online-softmax state per
// head in registers.  At the end the 8 warps' states are merged through
// shared memory, one head at a time.  f32 and bf16 inputs, f32 arithmetic,
// the output in the inputs' dtype (round to nearest even).  head_dim a
// multiple of 32 up to 256; any S, any window >= 1, any g.
//
// Bound: bytes.  At the hybrid-window shape (batch 8, Hq 10, Hkv 1, d 256,
// len 2,200, window 2,048, bf16) the window's K and V are 16.8 MB, ~5 us at
// 3.35 TB/s; the ~4 d g operations per position and kv head are far below
// the card's rate.  This first version is far from that bound (PERF.md
// has its time on the H100): the grid is only B * Hkv blocks (8 at that
// shape), and each warp walks its positions one at a time, a shuffle
// reduction and two expf per position and head in a chain.  Tiles of
// positions with lanes over positions, and a split over the window
// (flash-decoding) with a merge pass, are the redesign.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxDim = 256;
constexpr int kMaxPerLane = kMaxDim / 32;
constexpr int kMaxHeads = 16;          // query heads of one block
constexpr float kNegInf = -1e30f;      // the TPU kernel's running-max start

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float clipped_exp(float x) {
  return expf(fminf(fmaxf(x, -80.0f), 0.0f));
}

template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
    swa_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v,
                      const int32_t* __restrict__ cache_len, int s_len,
                      int hkv, int g, int d, long long window, float scale,
                      T* __restrict__ out) {
  __shared__ float q_s[G][kMaxDim];
  __shared__ float acc_s[kWarps][kMaxDim];
  __shared__ float m_s[kWarps];
  __shared__ float l_s[kWarps];

  const int b = blockIdx.x / hkv;
  const int kvh = blockIdx.x - b * hkv;
  const int h0 = blockIdx.y * G;            // first head of this chunk in the group
  const int gc = min(G, g - h0);            // heads in this chunk
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int per_lane = d >> 5;
  const size_t q_row0 =
      (static_cast<size_t>(b) * hkv * g + static_cast<size_t>(kvh) * g + h0) * d;

  for (int i = tid; i < G * kMaxDim; i += kThreads) {
    const int h = i / kMaxDim;
    const int e = i - h * kMaxDim;
    q_s[h][e] = (h < gc && e < d)
                    ? to_f32(q[q_row0 + static_cast<size_t>(h) * d + e]) * scale
                    : 0.0f;
  }
  __syncthreads();

  const long long len = cache_len[b];
  const long long lo = max(0LL, len - window);
  const long long hi = min(len, static_cast<long long>(s_len));

  float m[G], l[G], acc[G][kMaxPerLane];
#pragma unroll
  for (int h = 0; h < G; ++h) {
    m[h] = kNegInf;
    l[h] = 0.0f;
#pragma unroll
    for (int j = 0; j < kMaxPerLane; ++j) acc[h][j] = 0.0f;
  }

  const size_t pos_stride = static_cast<size_t>(hkv) * d;
  const size_t base = static_cast<size_t>(b) * s_len * pos_stride +
                      static_cast<size_t>(kvh) * d;
  for (long long p = lo + warp; p < hi; p += kWarps) {
    const T* kr = k + base + static_cast<size_t>(p) * pos_stride;
    const T* vr = v + base + static_cast<size_t>(p) * pos_stride;
    float kf[kMaxPerLane], vf[kMaxPerLane];
#pragma unroll
    for (int j = 0; j < kMaxPerLane; ++j) {
      kf[j] = j < per_lane ? to_f32(kr[j * 32 + lane]) : 0.0f;
      vf[j] = j < per_lane ? to_f32(vr[j * 32 + lane]) : 0.0f;
    }
#pragma unroll
    for (int h = 0; h < G; ++h) {
      if (h < gc) {
        float s = 0.0f;
#pragma unroll
        for (int j = 0; j < kMaxPerLane; ++j)
          if (j < per_lane) s = fmaf(q_s[h][j * 32 + lane], kf[j], s);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        const float m_new = fmaxf(m[h], s);
        const float alpha = clipped_exp(m[h] - m_new);
        const float pr = clipped_exp(s - m_new);
        l[h] = l[h] * alpha + pr;
#pragma unroll
        for (int j = 0; j < kMaxPerLane; ++j) acc[h][j] = acc[h][j] * alpha + pr * vf[j];
        m[h] = m_new;
      }
    }
  }

  // Merge the warps' states, one head at a time (gc is the same for every
  // thread of the block, so the barriers are uniform).
#pragma unroll
  for (int h = 0; h < G; ++h) {
    if (h < gc) {
#pragma unroll
      for (int j = 0; j < kMaxPerLane; ++j)
        if (j < per_lane) acc_s[warp][j * 32 + lane] = acc[h][j];
      if (lane == 0) {
        m_s[warp] = m[h];
        l_s[warp] = l[h];
      }
      __syncthreads();
      if (tid < d) {
        float mx = m_s[0];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, m_s[w]);
        float den = 0.0f, num = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          const float f = clipped_exp(m_s[w] - mx);
          den += l_s[w] * f;
          num += acc_s[w][tid] * f;
        }
        store(out + q_row0 + static_cast<size_t>(h) * d + tid, num / fmaxf(den, 1e-20f));
      }
      __syncthreads();
    }
  }
}

template <typename T, int G>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* cache_len, int batch, int s_len, int hkv, int g,
                   int d, long long window, float scale, void* out,
                   cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(batch * hkv),
                  static_cast<unsigned>((g + G - 1) / G));
  swa_decode_kernel<T, G><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(cache_len), s_len,
      hkv, g, d, window, scale, static_cast<T*>(out));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* cache_len, int batch, int s_len, int hkv,
                     int g, int d, long long window, float scale, void* out,
                     cudaStream_t stream) {
  if (g <= 1) return launch<T, 1>(q, k, v, cache_len, batch, s_len, hkv, g, d, window, scale, out, stream);
  if (g <= 2) return launch<T, 2>(q, k, v, cache_len, batch, s_len, hkv, g, d, window, scale, out, stream);
  if (g <= 4) return launch<T, 4>(q, k, v, cache_len, batch, s_len, hkv, g, d, window, scale, out, stream);
  if (g <= 8) return launch<T, 8>(q, k, v, cache_len, batch, s_len, hkv, g, d, window, scale, out, stream);
  return launch<T, kMaxHeads>(q, k, v, cache_len, batch, s_len, hkv, g, d, window, scale, out, stream);
}

}  // namespace

extern "C" {

// q (batch, hkv * g, d), k / v (batch, s_len, hkv, d), all f32 (bf16 == 0)
// or all bf16 (bf16 == 1); cache_len (batch,) int32; out like q.  Returns
// the cudaError_t of the launch (0 on success).
int swa_decode(const void* q, const void* k, const void* v,
               const void* cache_len, int batch, int s_len, int hkv, int g,
               int d, long long window, float scale, int bf16, void* out,
               void* stream) {
  if (batch < 1 || s_len < 1 || hkv < 1 || g < 1 || window < 1 || d < 32 ||
      d > kMaxDim || d % 32 != 0 ||
      static_cast<long long>(batch) * hkv > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t rc =
      bf16 ? dispatch<__nv_bfloat16>(q, k, v, cache_len, batch, s_len, hkv, g, d, window, scale, out, s)
           : dispatch<float>(q, k, v, cache_len, batch, s_len, hkv, g, d, window, scale, out, s);
  return static_cast<int>(rc);
}

const char* swa_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
