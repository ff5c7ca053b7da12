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
// launch's overhead at the service's 128- and 1,024-row buckets, where
// fused_score_f32 is one warp's latency through the four layers.  At large
// batches its lane-per-column layout reads one activation from shared
// memory per FMA (a float4 feeds four), so the shared-memory reads, not
// the FMAs, set its pace there.
//
// fused_score_f32: a warp per group of kGroupRows rows, one lane per output
// column.  Where a layer is narrower than 32 the group's rows share the
// lanes (2 rows at width 16, 4 at width 8), so no lane idles.  The group's
// rows and activations live in the warp's own strip of shared memory and
// are read as float4 broadcasts; __syncwarp separates the layers, and no
// block barrier follows the start.  Every output is one FMA chain over its
// inputs in index order, then the bias and tanhf, so a row's err is the
// same bit for bit whatever group, lane or launch it lands in.  The grid
// (fused_score.py's plan()) spreads 128 and 1,024 rows over as many SMs as
// there are groups; larger batches keep a fixed number of warps resident
// and each warp walks its groups with a stride.
//  * PaperAE, the paper's widths as compile-time constants: each lane loads
//    its weight column (72 floats over the four layers) and biases into
//    registers once per warp, all loads in flight together, so the row
//    chain reads nothing but its strip.  The output layer has all 32 lanes
//    on one row; the squares are summed by xor shuffles in a fixed order.
//  * Generic, every other width the wrapper takes (up to 8 layers): the
//    block stages the weights in dynamic shared memory once; a lane takes
//    columns lane, lane + 32, ... (or one column of a row slot for widths
//    below 32), keeps the group's rows in independent accumulators, and the
//    output layer's differences go to the strip, summed per row by one lane
//    in column order with fmaf.
//
// fused_score_q8 (the first design, unchanged): each block stages every
// layer's weights and biases once in dynamic shared memory, dequantised
// there (w = float(q) * s, the same single rounding as the plain version),
// then a tile of blockDim.x rows; one thread computes one row, rows and
// hidden activations in per-thread shared-memory columns with odd strides.
// The wrapper picks the tile and strides (layout()).
//
// fused_score_init, called once per device by the wrapper, opts the
// kernels that stage weights in to the largest dynamic shared memory, so a
// launch sets no attribute.
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

// --- fused_score_f32 ------------------------------------------------------

constexpr int kGroupRows = 4;     // ROWS_PER_WARP in fused_score.py
constexpr int kMaxWarps = 8;      // warps per block, at most

struct Net {
  const float* w[kMaxLayers];   // (d_in, d_out) row-major
  const float* b[kMaxLayers];   // (d_out,)
  int dims[kMaxLayers + 1];     // d, hidden..., d
  int n_layers;
  int rows;
  int x_stride;                 // strip row stride of x and the differences
  int h_stride;                 // strip row stride of the hidden activations
  int strip;                    // floats of shared memory per warp
  int w_floats;                 // floats of staged weights (Generic), 0 (PaperAE)
};

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// The paper AE.  One dense layer of DIN -> DOUT for the group's rows: lane
// (slot, column) with slot = lane / DOUT takes rows slot, slot + 32 / DOUT,
// ...; its column's weights are w[].  acc[p] is row p * (32 / DOUT) + slot.
template <int DIN, int DOUT>
struct Dense {
  static constexpr int kSlots = 32 / DOUT;
  static constexpr int kPasses = kGroupRows / kSlots;
  static_assert(32 % DOUT == 0 && kGroupRows % kSlots == 0 && DIN % 4 == 0, "paper widths");
  float w[DIN];
  float b;

  __device__ __forceinline__ void load(const float* __restrict__ W,
                                       const float* __restrict__ B, int lane) {
    const int c = lane % DOUT;
#pragma unroll
    for (int i = 0; i < DIN; ++i) w[i] = __ldg(W + i * DOUT + c);
    b = __ldg(B + c);
  }

  __device__ __forceinline__ void run(const float* in, int in_stride, int lane,
                                      float (&acc)[kPasses]) const {
    const int slot = lane / DOUT;
#pragma unroll
    for (int p = 0; p < kPasses; ++p) acc[p] = 0.0f;
#pragma unroll
    for (int i = 0; i < DIN; i += 4) {
#pragma unroll
      for (int p = 0; p < kPasses; ++p) {
        const float4 h = lds4(in + (p * kSlots + slot) * in_stride + i);
        acc[p] = fmaf(h.x, w[i], acc[p]);
        acc[p] = fmaf(h.y, w[i + 1], acc[p]);
        acc[p] = fmaf(h.z, w[i + 2], acc[p]);
        acc[p] = fmaf(h.w, w[i + 3], acc[p]);
      }
    }
  }

  // tanh(acc + b) into the group's rows of out, out_stride floats apart.
  __device__ __forceinline__ void hidden(const float* in, int in_stride, float* out,
                                         int out_stride, int lane) const {
    float acc[kPasses];
    run(in, in_stride, lane, acc);
    const int slot = lane / DOUT;
    const int c = lane % DOUT;
#pragma unroll
    for (int p = 0; p < kPasses; ++p)
      out[(p * kSlots + slot) * out_stride + c] = tanhf(acc[p] + b);
  }
};

// Strip row strides: the rows one float4 load reads together (2 of x, 4 of
// the first hidden layer) start 4 banks apart, so the load is one
// shared-memory wavefront.
struct PaperAE {
  static constexpr int kD = 32, kH1 = 16, kH2 = 8;
  static constexpr int kXs = 36, kH1s = 20, kH2s = 8;
  static constexpr int kStrip = kGroupRows * (kXs + kH1s + kH2s);
};

__global__ void __launch_bounds__(kMaxWarps * 32, 2)
    score_f32_paper(const float* __restrict__ x, const float* __restrict__ tau, const Net net,
                    float* __restrict__ err, uint8_t* __restrict__ flag) {
  __shared__ __align__(16) float strips[kMaxWarps * PaperAE::kStrip];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* xs = strips + warp * PaperAE::kStrip;          // (4, 32) rows
  float* h1 = xs + kGroupRows * PaperAE::kXs;           // (4, 16), then layer 2's out
  float* h2 = h1 + kGroupRows * PaperAE::kH1s;          // (4, 8)

  Dense<32, 16> l0;
  Dense<16, 8> l1;
  Dense<8, 16> l2;
  Dense<16, 32> l3;
  l0.load(net.w[0], net.b[0], lane);
  l1.load(net.w[1], net.b[1], lane);
  l2.load(net.w[2], net.b[2], lane);
  l3.load(net.w[3], net.b[3], lane);

  // A group's rows and tau are loaded one group ahead, so a warp that walks
  // several groups waits for device memory once.
  const int groups = (net.rows + kGroupRows - 1) / kGroupRows;
  const int stride = gridDim.x * blockDim.x / 32;
  float xn[kGroupRows];
  float tn = 0.0f;
  auto fetch = [&](int g) {
    const int row0 = g * kGroupRows;
    const int n = min(kGroupRows, net.rows - row0);
    const float* xg = x + static_cast<size_t>(row0) * PaperAE::kD;
#pragma unroll
    for (int r = 0; r < kGroupRows; ++r) xn[r] = r < n ? xg[r * PaperAE::kD + lane] : 0.0f;
    tn = lane < n ? tau[row0 + lane] : 0.0f;
  };
  int g = blockIdx.x * (blockDim.x / 32) + warp;
  if (g < groups) fetch(g);
  for (; g < groups; g += stride) {
    const int row0 = g * kGroupRows;
    const int n = min(kGroupRows, net.rows - row0);
#pragma unroll
    for (int r = 0; r < kGroupRows; ++r) xs[r * PaperAE::kXs + lane] = xn[r];
    const float t = tn;
    if (g + stride < groups) fetch(g + stride);
    __syncwarp();
    l0.hidden(xs, PaperAE::kXs, h1, PaperAE::kH1s, lane);
    __syncwarp();
    l1.hidden(h1, PaperAE::kH1s, h2, PaperAE::kH2s, lane);
    __syncwarp();
    l2.hidden(h2, PaperAE::kH2s, h1, PaperAE::kH1s, lane);
    __syncwarp();
    float acc[kGroupRows];
    l3.run(h1, PaperAE::kH1s, lane, acc);
    // Squares summed by a butterfly of uncontracted adds: every lane ends
    // with the same sum, so the row's err does not depend on its lane.
    float e_mine = 0.0f;
#pragma unroll
    for (int r = 0; r < kGroupRows; ++r) {
      const float diff = xs[r * PaperAE::kXs + lane] - (acc[r] + l3.b);
      float e = __fmul_rn(diff, diff);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) e = __fadd_rn(e, __shfl_xor_sync(0xffffffffu, e, o));
      if (lane == r) e_mine = e;
    }
    if (lane < n) {
      err[row0 + lane] = e_mine;
      flag[row0 + lane] = e_mine > t ? 1 : 0;
    }
    __syncwarp();  // the next group rewrites the strip
  }
}

// Every other width.  The strip holds x (4, x_stride), the output layer's
// differences (4, x_stride) and two hidden buffers (4, h_stride).
__global__ void __launch_bounds__(kMaxWarps * 32)
    score_f32_generic(const float* __restrict__ x, const float* __restrict__ tau,
                      const Net net, float* __restrict__ err, uint8_t* __restrict__ flag) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_layers = net.n_layers;
  const int d = net.dims[0];

  // Weights then biases of each layer, staged once by the block.
  int off = 0;
  for (int l = 0; l < n_layers; ++l) {
    const int n = net.dims[l] * net.dims[l + 1];
    const float* w = net.w[l];
#pragma unroll 4
    for (int k = threadIdx.x; k < n; k += blockDim.x) smem[off + k] = __ldg(w + k);
    off += n;
    for (int k = threadIdx.x; k < net.dims[l + 1]; k += blockDim.x)
      smem[off + k] = __ldg(net.b[l] + k);
    off += net.dims[l + 1];
  }
  __syncthreads();

  float* xs = smem + net.w_floats + warp * net.strip;
  float* ds = xs + kGroupRows * net.x_stride;
  float* h0 = ds + kGroupRows * net.x_stride;
  float* h1 = h0 + kGroupRows * net.h_stride;

  const int groups = (net.rows + kGroupRows - 1) / kGroupRows;
  const int stride = gridDim.x * blockDim.x / 32;
  for (int g = blockIdx.x * (blockDim.x / 32) + warp; g < groups; g += stride) {
    const int row0 = g * kGroupRows;
    const int n = min(kGroupRows, net.rows - row0);
    const float* xg = x + static_cast<size_t>(row0) * d;
#pragma unroll 4
    for (int k = lane; k < n * d; k += 32) {
      const int r = k / d;
      xs[r * net.x_stride + (k - r * d)] = xg[k];
    }
    __syncwarp();
    const float* in = xs;
    int in_stride = net.x_stride;
    const float* wl = smem;
    for (int l = 0; l < n_layers; ++l) {
      const int din = net.dims[l];
      const int dout = net.dims[l + 1];
      const float* bl = wl + din * dout;
      const bool last = l == n_layers - 1;
      float* out = last ? ds : (l & 1) ? h1 : h0;
      const int out_stride = last ? net.x_stride : net.h_stride;
      // Lane -> (row slot, first column): slots of dout lanes below 32.
      const int slots = dout < 32 ? 32 / dout : 1;
      const int slot = dout < 32 ? lane / dout : 0;
      const int c0 = dout < 32 ? lane % dout : lane;
      if (slot < slots) {
        for (int c = c0; c < dout; c += 32) {
          float acc[kGroupRows];
#pragma unroll
          for (int t = 0; t < kGroupRows; ++t) acc[t] = 0.0f;
          for (int i = 0; i < din; ++i) {
            const float w = wl[i * dout + c];
#pragma unroll
            for (int t = 0; t < kGroupRows; ++t) {
              const int r = slot + t * slots;
              if (r < kGroupRows) acc[t] = fmaf(in[r * in_stride + i], w, acc[t]);
            }
          }
#pragma unroll
          for (int t = 0; t < kGroupRows; ++t) {
            const int r = slot + t * slots;
            if (r < kGroupRows) {
              const float v = acc[t] + bl[c];
              out[r * out_stride + c] = last ? xs[r * net.x_stride + c] - v : tanhf(v);
            }
          }
        }
      }
      __syncwarp();
      in = out;
      in_stride = out_stride;
      wl = bl + dout;
    }
    if (lane < n) {
      const float* dr = ds + lane * net.x_stride;
      float e = 0.0f;
      for (int j = 0; j < d; ++j) e = fmaf(dr[j], dr[j], e);
      err[row0 + lane] = e;
      flag[row0 + lane] = e > tau[row0 + lane] ? 1 : 0;
    }
    __syncwarp();  // the next group rewrites the strip
  }
}

bool is_paper(int n_layers, const int* dims) {
  const int paper[5] = {PaperAE::kD, PaperAE::kH1, PaperAE::kH2, PaperAE::kH1, PaperAE::kD};
  if (n_layers != 4) return false;
  for (int l = 0; l <= 4; ++l)
    if (dims[l] != paper[l]) return false;
  return true;
}

}  // namespace

extern "C" {

// Opts the kernels that stage weights in shared memory (fused_score_q8 and
// fused_score_f32's generic instance) in to smem_bytes of dynamic shared
// memory on the current device; returns the cudaError_t (0 on success).
int fused_score_init(int smem_bytes) {
  cudaError_t rc = cudaFuncSetAttribute(
      score_f32_generic, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (rc == cudaSuccess)
    rc = cudaFuncSetAttribute(fused_score_kernel<true>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_bytes);
  return static_cast<int>(rc);
}

// fused_score_f32: paper != 0 runs the PaperAE instance (the widths must
// be 32-16-8-16-32); warps per block, blocks, strides, the strip and the
// staged weights' floats and the dynamic shared memory come from the
// wrapper's plan().  Returns the cudaError_t of the launch (0 on success).
int fused_score_f32(const void* x, const void* tau, int rows, int n_layers,
                    const int* dims, void* const* w, void* const* b,
                    void* err, void* flag, int paper, int warps, int blocks,
                    int x_stride, int h_stride, int strip, int w_floats,
                    int smem_bytes, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || rows < 1 || blocks < 1 ||
      warps < 1 || warps > kMaxWarps || (paper && !is_paper(n_layers, dims)))
    return static_cast<int>(cudaErrorInvalidValue);
  Net net = {};
  net.n_layers = n_layers;
  net.rows = rows;
  net.x_stride = x_stride;
  net.h_stride = h_stride;
  net.strip = strip;
  net.w_floats = w_floats;
  for (int l = 0; l <= n_layers; ++l) net.dims[l] = dims[l];
  for (int l = 0; l < n_layers; ++l) {
    net.w[l] = static_cast<const float*>(w[l]);
    net.b[l] = static_cast<const float*>(b[l]);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (paper) {
    score_f32_paper<<<blocks, warps * 32, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(tau), net,
        static_cast<float*>(err), static_cast<uint8_t*>(flag));
  } else {
    score_f32_generic<<<blocks, warps * 32, smem_bytes, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(tau), net,
        static_cast<float*>(err), static_cast<uint8_t*>(flag));
  }
  return static_cast<int>(cudaGetLastError());
}

// Returns the cudaError_t of the launch (0 on success).
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
