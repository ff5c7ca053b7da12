// Fused anomaly scoring for Hopper (sm_90a): autoencoder forward,
// squared-L2 reconstruction error and threshold compare in one pass.
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/fused_score.py:
//   fused_score_f32 <- _fused_score_kernel     (f32 weights)
//   fused_score_q8  <- _fused_score_q8_kernel  (int8 weights, per-output-
//                                               channel f32 scales)
// Per telemetry row: h = x; h = tanh(h @ W_l + b_l) on hidden layers, a
// linear output layer; err = sum((x - h)^2); flag = err > tau[row].  Only
// err (R,) f32 and flag (R,) uint8 reach device memory; the reconstruction
// never does.  NaN rows give NaN > tau == false here; the serving wrapper
// flags non-finite errors, as the JAX package does.
//
// Bound: at the paper AE (32-16-8-16-32) a row reads 132 B (x and tau),
// writes 5 B and takes 2,560 FLOP, about 19 FLOP/B: right at the H100's
// f32 CUDA-core ridge (67 TFLOP/s / 3.35 TB/s = 20), and far below one
// launch's overhead at the service's 128- and 1,024-row buckets.
//
// Design (simple and right first):
//  * Each block stages every layer's weights and biases once in dynamic
//    shared memory (int8 weights are dequantised there, w = float(q) * s,
//    the same single rounding as the plain version), then a tile of
//    blockDim.x rows with coalesced loads.
//  * One thread computes one row.  The row tile and the hidden activations
//    live in per-thread shared-memory columns whose strides are odd, so
//    the 32 threads of a warp hit 32 different banks; weight reads are
//    warp-wide broadcasts.  Outputs are accumulated 8 at a time in
//    registers.
//  * The wrapper (fused_score.py) picks blockDim.x and the strides, sizes
//    the shared memory and refuses widths that do not fit.  It calls
//    fused_score_init once per device to opt both kernels in to the
//    largest dynamic shared memory, so a launch sets no attribute.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLayers = 8;  // MAX_LAYERS in fused_score.py
constexpr int kOutTile = 8;

struct Layers {
  const void* w[kMaxLayers];   // (d_in, d_out) row-major, f32 or int8
  const float* s[kMaxLayers];  // (d_out,) scales, int8 weights only
  const float* b[kMaxLayers];  // (d_out,)
  int dims[kMaxLayers + 1];    // d, hidden..., d
  int n_layers;
};

template <bool kQ8>
__global__ void fused_score_kernel(const float* __restrict__ x,
                                   const float* __restrict__ tau,
                                   const Layers p, int rows, int x_stride,
                                   int h_stride, float* __restrict__ err,
                                   uint8_t* __restrict__ flag) {
  extern __shared__ float smem[];
  const int n_layers = p.n_layers;
  const int d = p.dims[0];
  const int tid = threadIdx.x;
  const int tile = blockDim.x;

  // 1. Weights and biases, layer after layer.
  int off = 0;
  for (int l = 0; l < n_layers; ++l) {
    const int dout = p.dims[l + 1];
    const int n = p.dims[l] * dout;
    if constexpr (kQ8) {
      const int8_t* q = static_cast<const int8_t*>(p.w[l]);
      const float* s = p.s[l];
      for (int k = tid; k < n; k += tile)
        smem[off + k] = static_cast<float>(q[k]) * s[k % dout];
    } else {
      const float* w = static_cast<const float*>(p.w[l]);
      for (int k = tid; k < n; k += tile) smem[off + k] = w[k];
    }
    off += n;
    for (int k = tid; k < dout; k += tile) smem[off + k] = p.b[l][k];
    off += dout;
  }

  // 2. This block's rows: consecutive threads read consecutive floats.
  float* xt = smem + off;
  const int row0 = blockIdx.x * tile;
  const int n_rows = min(tile, rows - row0);
  const float* xg = x + static_cast<size_t>(row0) * d;
  for (int k = tid; k < n_rows * d; k += tile) {
    const int r = k / d;
    xt[r * x_stride + (k - r * d)] = xg[k];
  }
  __syncthreads();
  if (tid >= n_rows) return;  // ragged last tile; no barrier follows

  // 3. One row per thread.
  const float* xr = xt + tid * x_stride;
  float* hbuf0 = xt + tile * x_stride + tid * h_stride;
  float* hbuf1 = hbuf0 + tile * h_stride;
  const float* hin = xr;
  const float* wl = smem;
  float e = 0.0f;
  for (int l = 0; l < n_layers; ++l) {
    const int din = p.dims[l];
    const int dout = p.dims[l + 1];
    const float* bl = wl + din * dout;
    const bool last = (l == n_layers - 1);
    float* hout = (l & 1) ? hbuf1 : hbuf0;
    for (int j0 = 0; j0 < dout; j0 += kOutTile) {
      float acc[kOutTile];
#pragma unroll
      for (int u = 0; u < kOutTile; ++u) acc[u] = 0.0f;
      for (int i = 0; i < din; ++i) {
        const float hv = hin[i];
        const float* wr = wl + i * dout + j0;
#pragma unroll
        for (int u = 0; u < kOutTile; ++u)
          if (j0 + u < dout) acc[u] = fmaf(hv, wr[u], acc[u]);
      }
#pragma unroll
      for (int u = 0; u < kOutTile; ++u) {
        const int j = j0 + u;
        if (j < dout) {
          const float v = acc[u] + bl[j];
          if (last) {
            const float diff = xr[j] - v;
            e = fmaf(diff, diff, e);
          } else {
            hout[j] = tanhf(v);
          }
        }
      }
    }
    hin = hout;
    wl = bl + dout;
  }
  const int row = row0 + tid;
  err[row] = e;
  flag[row] = e > tau[row] ? 1 : 0;
}

template <bool kQ8>
int launch(const void* x, const void* tau, int rows, int n_layers,
           const int* dims, void* const* w, void* const* s, void* const* b,
           void* err, void* flag, int tile, int x_stride, int h_stride,
           int smem_bytes, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || rows < 1 || tile < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Layers p = {};
  p.n_layers = n_layers;
  for (int l = 0; l <= n_layers; ++l) p.dims[l] = dims[l];
  for (int l = 0; l < n_layers; ++l) {
    p.w[l] = w[l];
    if constexpr (kQ8) p.s[l] = static_cast<const float*>(s[l]);
    p.b[l] = static_cast<const float*>(b[l]);
  }
  const int grid = (rows + tile - 1) / tile;
  fused_score_kernel<kQ8><<<grid, tile, smem_bytes,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(tau), p, rows,
      x_stride, h_stride, static_cast<float*>(err),
      static_cast<uint8_t*>(flag));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Opts both kernels in to smem_bytes of dynamic shared memory on the
// current device; returns the cudaError_t (0 on success).
int fused_score_init(int smem_bytes) {
  cudaError_t rc = cudaFuncSetAttribute(
      fused_score_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (rc == cudaSuccess)
    rc = cudaFuncSetAttribute(fused_score_kernel<true>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_bytes);
  return static_cast<int>(rc);
}

// Both return the cudaError_t of the launch (0 on success).
int fused_score_f32(const void* x, const void* tau, int rows, int n_layers,
                    const int* dims, void* const* w, void* const* b,
                    void* err, void* flag, int tile, int x_stride,
                    int h_stride, int smem_bytes, void* stream) {
  return launch<false>(x, tau, rows, n_layers, dims, w, nullptr, b, err,
                       flag, tile, x_stride, h_stride, smem_bytes, stream);
}

int fused_score_q8(const void* x, const void* tau, int rows, int n_layers,
                   const int* dims, void* const* qw, void* const* sw,
                   void* const* b, void* err, void* flag, int tile,
                   int x_stride, int h_stride, int smem_bytes,
                   void* stream) {
  return launch<true>(x, tau, rows, n_layers, dims, qw, sw, b, err, flag,
                      tile, x_stride, h_stride, smem_bytes, stream);
}

const char* fused_score_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
