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
// a launch is one warp's latency through the four layers.  int8 weights
// read 1,368 B instead of 5,184 once per warp, which changes none of that.  At large
// batches its lane-per-column layout reads one activation from shared
// memory per FMA (a float4 feeds four), so the shared-memory reads, not
// the FMAs, set its pace there.
//
// Both kernels: a warp per group of kGroupRows rows, one lane per output
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
// fused_score_q8 runs the same two instances on int8 weights with
// per-output-column f32 scales: each weight is dequantised once as it is
// loaded, w = __fmul_rn(float(q), s[c]) (the single rounding of the plain
// version's q.to(f32) * s), into a lane's registers (PaperAE) or the
// block's staged weights (Generic).  From there the row chain is the f32
// kernel's, so a row's err equals fused_score_f32's on the dequantised
// weights bit for bit.  Its first design (a thread per row, every block
// dequantising all weights with a k % d_out per element) ran one thread's
// latency through the network at the serve buckets.
//
// fused_score_init, called once per device by the wrapper, opts the
// Generic instances in to the largest dynamic shared memory, so a launch
// sets no attribute.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLayers = 8;     // MAX_LAYERS in fused_score.py
constexpr int kGroupRows = 4;     // ROWS_PER_WARP in fused_score.py
constexpr int kMaxWarps = 8;      // warps per block, at most

struct Net {
  const void* w[kMaxLayers];    // (d_in, d_out) row-major: f32, or int8 codes
  const float* s[kMaxLayers];   // (d_out,) per-column scales (int8 weights only)
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

template <typename W>
constexpr bool kIsQ8 = sizeof(W) == 1;   // int8 codes with scales, else f32

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

  // Column c's weights, dequantised on the way in when W is int8.
  template <typename W>
  __device__ __forceinline__ void load(const void* Wp, const float* __restrict__ S,
                                       const float* __restrict__ B, int lane) {
    const int c = lane % DOUT;
    const W* __restrict__ Wt = static_cast<const W*>(Wp);
    if constexpr (kIsQ8<W>) {
      const float s = __ldg(S + c);
#pragma unroll
      for (int i = 0; i < DIN; ++i)
        w[i] = __fmul_rn(static_cast<float>(__ldg(Wt + i * DOUT + c)), s);
    } else {
#pragma unroll
      for (int i = 0; i < DIN; ++i) w[i] = __ldg(Wt + i * DOUT + c);
    }
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

template <typename W>
__global__ void __launch_bounds__(kMaxWarps * 32, 2)
    score_paper(const float* __restrict__ x, const float* __restrict__ tau, const Net net,
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
  l0.template load<W>(net.w[0], net.s[0], net.b[0], lane);
  l1.template load<W>(net.w[1], net.s[1], net.b[1], lane);
  l2.template load<W>(net.w[2], net.s[2], net.b[2], lane);
  l3.template load<W>(net.w[3], net.s[3], net.b[3], lane);

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
template <typename W>
__global__ void __launch_bounds__(kMaxWarps * 32)
    score_generic(const float* __restrict__ x, const float* __restrict__ tau,
                  const Net net, float* __restrict__ err, uint8_t* __restrict__ flag) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_layers = net.n_layers;
  const int d = net.dims[0];

  // Weights then biases of each layer, staged once by the block.  int8
  // codes are dequantised here: thread t takes columns t % cols, + cols,
  // ... and rows t / cols, + rstep, ...: a scale loaded once per column,
  // no division per element.
  int off = 0;
  for (int l = 0; l < n_layers; ++l) {
    const int din = net.dims[l];
    const int dout = net.dims[l + 1];
    const W* __restrict__ w = static_cast<const W*>(net.w[l]);
    if constexpr (kIsQ8<W>) {
      const int cols = min(dout, static_cast<int>(blockDim.x));
      const int rstep = blockDim.x / cols;
      const int r0 = threadIdx.x / cols;
      if (r0 < rstep) {
        for (int c = threadIdx.x - r0 * cols; c < dout; c += cols) {
          const float s = __ldg(net.s[l] + c);
#pragma unroll 4
          for (int r = r0; r < din; r += rstep)
            smem[off + r * dout + c] = __fmul_rn(static_cast<float>(__ldg(w + r * dout + c)), s);
        }
      }
    } else {
#pragma unroll 4
      for (int k = threadIdx.x; k < din * dout; k += blockDim.x) smem[off + k] = __ldg(w + k);
    }
    off += din * dout;
    for (int k = threadIdx.x; k < dout; k += blockDim.x) smem[off + k] = __ldg(net.b[l] + k);
    off += dout;
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

// One launch of either kernel: paper != 0 runs the PaperAE instance (the
// widths must be 32-16-8-16-32); warps per block, blocks, strides, the
// strip, the staged weights' floats and the dynamic shared memory come from
// the wrapper's plan().  s is null for f32 weights.
template <typename W>
int launch_score(const void* x, const void* tau, int rows, int n_layers, const int* dims,
                 void* const* w, void* const* s, void* const* b, void* err, void* flag,
                 int paper, int warps, int blocks, int x_stride, int h_stride, int strip,
                 int w_floats, int smem_bytes, void* stream) {
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
    net.w[l] = w[l];
    if constexpr (kIsQ8<W>) net.s[l] = static_cast<const float*>(s[l]);
    net.b[l] = static_cast<const float*>(b[l]);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  const float* tp = static_cast<const float*>(tau);
  float* ep = static_cast<float*>(err);
  uint8_t* fp = static_cast<uint8_t*>(flag);
  if (paper)
    score_paper<W><<<blocks, warps * 32, 0, st>>>(xp, tp, net, ep, fp);
  else
    score_generic<W><<<blocks, warps * 32, smem_bytes, st>>>(xp, tp, net, ep, fp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Opts both Generic instances in to smem_bytes of dynamic shared memory on
// the current device; returns the cudaError_t (0 on success).
int fused_score_init(int smem_bytes) {
  cudaError_t rc = cudaFuncSetAttribute(
      score_generic<float>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (rc == cudaSuccess)
    rc = cudaFuncSetAttribute(score_generic<int8_t>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  return static_cast<int>(rc);
}

// fused_score_f32: f32 weights.  Returns the cudaError_t of the launch.
int fused_score_f32(const void* x, const void* tau, int rows, int n_layers,
                    const int* dims, void* const* w, void* const* b,
                    void* err, void* flag, int paper, int warps, int blocks,
                    int x_stride, int h_stride, int strip, int w_floats,
                    int smem_bytes, void* stream) {
  return launch_score<float>(x, tau, rows, n_layers, dims, w, nullptr, b, err, flag, paper,
                             warps, blocks, x_stride, h_stride, strip, w_floats, smem_bytes,
                             stream);
}

// fused_score_q8: int8 weights qw with per-output-column f32 scales sw,
// the same plan as fused_score_f32.  Returns the cudaError_t of the launch.
int fused_score_q8(const void* x, const void* tau, int rows, int n_layers,
                   const int* dims, void* const* qw, void* const* sw, void* const* b,
                   void* err, void* flag, int paper, int warps, int blocks,
                   int x_stride, int h_stride, int strip, int w_floats,
                   int smem_bytes, void* stream) {
  return launch_score<int8_t>(x, tau, rows, n_layers, dims, qw, sw, b, err, flag, paper,
                              warps, blocks, x_stride, h_stride, strip, w_floats, smem_bytes,
                              stream);
}

const char* fused_score_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
