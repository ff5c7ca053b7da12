// Fused local training for Hopper (sm_90a): the whole client phase of a
// federated round (E epochs of minibatch SGD on the autoencoder, paper
// Eq. 12, optional FedProx term) for every client in one launch.
//
// Replaces the Pallas TPU kernel _local_train_kernel of
// src/repro/kernels/fused_local_train.py, without its TPU layout (128-lane
// padding, the one-hot gather matmul, the transposed -1-padded index
// table).  It computes exactly repro_torch.kernels.ref.local_train_ref:
// tanh hidden layers, a linear output, dL/dz_out = (2 / bsz)(recon - x),
// the gradient of layer l-1 from layer l's pre-update weights, FedProx
// adding mu (W - W_anchor); outputs the deltas (N, n_params) = trained -
// broadcast params in the ravel order (per layer the bias, then the
// row-major weight) and the mean step loss.
//
// Design.  One block of 8 warps per client keeps its working parameters,
// the minibatch's activations and gradients in shared memory
// (local_train.py's layout()).  A step is:
//  * Barrier.  The step's rows are already staged: at the start of each
//    step the block issues cp.async for the next step's rows (their index
//    row arrived one step earlier, also by cp.async, into a ring of three),
//    so the gather's device-memory latency overlaps a whole step.
//  * Forward and the data gradients, warp by warp: each warp owns a run of
//    (at most 4 of 32) rows of the batch and takes them through every layer
//    alone, with __syncwarp between layers.  Lane = (part, column): the
//    32 / width parts of a column split the sum over the layer's inputs,
//    each lane keeps the warp's rows in independent accumulators, and xor
//    shuffles finish the sums.  The loss and the output gradient are folded
//    into the last forward layer, tanh' = 1 - a^2 into each data gradient.
//  * Barrier, then every layer's weight gradient and SGD (+ FedProx) update
//    at once (the data gradients read the pre-update weights, all before
//    the barrier).  Warp w takes rows [w, w + 1) * din / 8 of every layer's
//    weight (warp 0 the biases besides), so the warps share the work
//    evenly; lane = (batch part, column): a layer narrower than 32 splits
//    the sum over the batch between 32 / width lanes, finished with
//    shuffles; each lane then updates its parameters in place.
// So a step has two __syncthreads, and no lane runs a dependent chain
// longer than ~32 FMAs between them (the widest sum over the batch).
// Shared memory is laid out for its banks: the working weights have rows
// of width + 4 floats (the backward reads their columns); activation and
// gradient rows of a width below 32 that divides it are packed and rows of
// 32 padded to 48 (the update reads consecutive rows at once).
//
// The paper AE (32-16-8-16-32) at batch 32 has its own instance, with
// every width and the batch compile-time constants: every loop of a step
// has a constant trip count and is unrolled, so the four layers' update
// loops are straight-line code the compiler interleaves, and shared-memory
// loads are float4.  Other widths and batches (up to 8 layers, within
// 227 KB) run the same design with run-time sizes.
//
// Occupancy: at train-200 (N = 200, batch 32) a paper-AE block holds 32 KB
// of shared memory and 256 threads, so all 200 blocks are resident in one
// wave on 132 SMs (68 SMs hold two).
//
// Bound: operations.  At the paper AE, N = 200, 40 steps of 32 rows, the
// function needs ~1.8 GFLOP of f32 FMAs and tanh against ~8.7 MB of input
// and output: ~27 us at 67 TFLOP/s if all 132 SMs were busy all the time.
// The 40 steps of a client are serial and 200 clients fill 132 SMs in 1.5
// blocks each, so an SM holding two clients runs both step chains side by
// side and the 64 SMs holding one idle half the time.  On an NVIDIA H100
// 80GB HBM3 at its 700.00 W power limit the kernel takes ~252 us there
// (chip_smoke.py phase 6), ~9x the bound: a warp's instructions are mostly
// addressing, shuffles, tanh and barriers around the FMAs, so the SMs
// holding two clients are bound by instruction issue.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLayers = 8;   // MAX_LAYERS in local_train.py
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kAcc = 4;         // rows per lane per pass of a row layer

// Offsets (in floats) and strides of the block's shared memory, from
// local_train.py's layout().
struct Layout {
  int n_layers;
  int n_params;
  int dims[kMaxLayers + 1];
  int stride[kMaxLayers + 1];    // row stride of the buffers of width dims[l]
  int seg_off[kMaxLayers];       // layer l's [bias | weight] in the ravel order
  int pseg_off[kMaxLayers];      // layer l's bias in shared memory ...
  int w_off[kMaxLayers];         // ... and its weight rows, after the bias
  int w_stride[kMaxLayers];      // row stride of layer l's weight
  int x_off[2];                  // the two gather buffers (width dims[0])
  int act_off[kMaxLayers + 1];   // hidden activations, l = 1 .. L-1
  int grad_off[kMaxLayers + 1];  // gradients at layer outputs, l = 1 .. L
  int idx_off;                   // three index rows (int32)
};

__host__ __device__ constexpr int align4(int n) { return (n + 3) / 4 * 4; }

// Widths known at run time.
struct Generic {
  static constexpr bool kFixed = false;
  static constexpr int kBatch = 0;
  static constexpr bool kVec = false;
  __device__ static int dim(const Layout& y, int l) { return y.dims[l]; }
  __device__ static int stride(const Layout& y, int l) { return y.stride[l]; }
  __device__ static int pseg(const Layout& y, int l) { return y.pseg_off[l]; }
  __device__ static int woff(const Layout& y, int l) { return y.w_off[l]; }
  __device__ static int wst(const Layout& y, int l) { return y.w_stride[l]; }
  __device__ static int seg(const Layout& y, int l) { return y.seg_off[l]; }
};

// The paper's autoencoder, 32-16-8-16-32: widths, strides and offsets are
// compile-time constants (layout() gives the same values; the host checks).
__host__ __device__ constexpr int paper_dim(int l) {
  return l == 0 ? 32 : l == 1 ? 16 : l == 2 ? 8 : l == 3 ? 16 : 32;
}
__host__ __device__ constexpr int row_stride(int w) {
  return w == 32 ? 48 : 32 % w == 0 ? w : align4(w) + 4;
}
__host__ __device__ constexpr int paper_seg(int l) {
  return (l > 0 ? 32 * 16 + 16 : 0) + (l > 1 ? 16 * 8 + 8 : 0) + (l > 2 ? 8 * 16 + 16 : 0);
}
__host__ __device__ constexpr int paper_wst(int l) { return align4(paper_dim(l + 1)) + 4; }
__host__ __device__ constexpr int paper_psize(int l) {
  return align4(paper_dim(l + 1)) + paper_dim(l) * paper_wst(l);
}
__host__ __device__ constexpr int paper_pseg(int l) {
  return (l > 0 ? paper_psize(0) : 0) + (l > 1 ? paper_psize(1) : 0) +
         (l > 2 ? paper_psize(2) : 0);
}
struct PaperAE {
  static constexpr bool kFixed = true;
  static constexpr int kLayers = 4;
  static constexpr int kBatch = 32;
  static constexpr bool kVec = true;   // widths and offsets multiples of 4
  __device__ static constexpr int dim(const Layout&, int l) { return paper_dim(l); }
  __device__ static constexpr int stride(const Layout&, int l) { return row_stride(paper_dim(l)); }
  __device__ static constexpr int pseg(const Layout&, int l) { return paper_pseg(l); }
  __device__ static constexpr int woff(const Layout&, int l) {
    return paper_pseg(l) + align4(paper_dim(l + 1));
  }
  __device__ static constexpr int wst(const Layout&, int l) { return paper_wst(l); }
  __device__ static constexpr int seg(const Layout&, int l) { return paper_seg(l); }
};

bool is_paper(const Layout& y, int batch) {
  if (y.n_layers != 4 || batch != PaperAE::kBatch) return false;
  for (int l = 0; l <= 4; ++l)
    if (y.dims[l] != paper_dim(l) || y.stride[l] != row_stride(paper_dim(l))) return false;
  for (int l = 0; l < 4; ++l)
    if (y.seg_off[l] != paper_seg(l) || y.pseg_off[l] != paper_pseg(l) ||
        y.w_off[l] != paper_pseg(l) + align4(paper_dim(l + 1)) || y.w_stride[l] != paper_wst(l))
      return false;
  return true;
}

template <class Net>
__device__ __forceinline__ int n_layers(const Layout& y) {
  if constexpr (Net::kFixed) return Net::kLayers;
  else return y.n_layers;
}

// A layer index known at compile time.
template <int I>
struct Int {
  __device__ constexpr operator int() const { return I; }
};

// f(Int<I>), f(Int<I + Step>), ... up to End (exclusive).
template <int I, int End, int Step, class F>
__device__ __forceinline__ void static_range(F& f) {
  if constexpr (Step > 0 ? I < End : I > End) {
    f(Int<I>{});
    static_range<I + Step, End, Step>(f);
  }
}

// f(l) for the layers l = 0 .. L-1 (kDown false) or L-1 .. 1 (kDown true);
// for fixed widths l is a compile-time constant, so every loop inside f has
// a constant trip count before the compiler unrolls it.
template <class Net, bool kDown, class F>
__device__ __forceinline__ void each_layer(int n_layers, F f) {
  if constexpr (Net::kFixed) {
    if constexpr (kDown) static_range<Net::kLayers - 1, 0, -1>(f);
    else static_range<0, Net::kLayers, 1>(f);
  } else {
    if (kDown) {
      for (int l = n_layers - 1; l >= 1; --l) f(l);
    } else {
      for (int l = 0; l < n_layers; ++l) f(l);
    }
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

enum Mode { kHidden, kLast, kBack };

// One layer for the warp's rows [r0, r0 + nrows): out[r][o] = epi(sum_c
// in[r][c] w(c, o)), c < nin, o < nout, the weight rows wst floats apart.
// Forward (kHidden, kLast): w(c, o) = W[c][o], plus the bias; kHidden
// stores tanh, kLast stores the output gradient gscale (recon - x) and adds
// (recon - x)^2 to the loss.  kBack: w(c, o) = W[o][c] (the transposed
// weight of the layer above), times tanh' = 1 - a^2 with a = aux[r][o].
//
// Where nout divides 32 (every width of the paper AE), lane = (part, o):
// the 32 / nout parts of a column split the sum over c, each lane keeps 4
// rows in independent accumulators, and xor shuffles finish the sums; part
// p then writes rows p, p + parts, ... of the 4.  Other widths: lane e
// takes outputs e, e + 32, ..., 4 at a time.
template <bool kVec, Mode M>
__device__ __forceinline__ void row_layer(const float* __restrict__ in, int sin, int nin,
                                          const float* __restrict__ w, int wst,
                                          const float* __restrict__ bias, int nout,
                                          float* __restrict__ out, int sout,
                                          const float* __restrict__ aux, int saux, int r0,
                                          int nrows, float gscale, float& loss, int lane) {
  auto epilogue = [&](int r, int o, float acc) {
    if (M == kHidden) {
      out[r * sout + o] = tanhf(acc + bias[o]);
    } else if (M == kLast) {
      const float diff = acc + bias[o] - aux[r * saux + o];
      loss = fmaf(diff, diff, loss);
      out[r * sout + o] = gscale * diff;
    } else {
      const float a = aux[r * saux + o];
      out[r * sout + o] = acc * (1.0f - a * a);
    }
  };
  auto weight = [&](int c, int o) { return M == kBack ? w[o * wst + c] : w[c * wst + o]; };
  const int parts = 32 % nout == 0 ? 32 / nout : 0;
  if (parts > 0 && nin % (kVec ? 4 * parts : parts) == 0) {
    const int o = lane % nout;
    const int part = lane / nout;
    const int cl = nin / parts;           // this lane's run of c
    const int c0 = part * cl;
    for (int k0 = 0; k0 < nrows; k0 += kAcc) {
      int row[kAcc];
#pragma unroll
      for (int u = 0; u < kAcc; ++u) row[u] = r0 + min(k0 + u, nrows - 1);
      float acc[kAcc];
#pragma unroll
      for (int u = 0; u < kAcc; ++u) acc[u] = 0.0f;
      if (kVec) {
#pragma unroll
        for (int cc = 0; cc < cl; cc += 4) {
          const int c = c0 + cc;
          const float4 wv = M == kBack
                                ? *reinterpret_cast<const float4*>(w + o * wst + c)
                                : make_float4(weight(c, o), weight(c + 1, o), weight(c + 2, o),
                                              weight(c + 3, o));
#pragma unroll
          for (int u = 0; u < kAcc; ++u) {
            const float4 iv = *reinterpret_cast<const float4*>(in + row[u] * sin + c);
            acc[u] = fmaf(iv.x, wv.x, acc[u]);
            acc[u] = fmaf(iv.y, wv.y, acc[u]);
            acc[u] = fmaf(iv.z, wv.z, acc[u]);
            acc[u] = fmaf(iv.w, wv.w, acc[u]);
          }
        }
      } else {
#pragma unroll 4
        for (int cc = 0; cc < cl; ++cc) {
          const int c = c0 + cc;
          const float wc = weight(c, o);
#pragma unroll
          for (int u = 0; u < kAcc; ++u) acc[u] = fmaf(in[row[u] * sin + c], wc, acc[u]);
        }
      }
      for (int m = nout; m < 32; m <<= 1)
#pragma unroll
        for (int u = 0; u < kAcc; ++u) acc[u] += __shfl_xor_sync(0xffffffffu, acc[u], m);
#pragma unroll
      for (int u = 0; u < kAcc; ++u)
        if (k0 + u < nrows && (parts <= kAcc ? u % parts == part : u == part))
          epilogue(row[u], o, acc[u]);
    }
    return;
  }
  const int per_lane = (nrows * nout + 31) / 32;
  for (int p0 = 0; p0 < per_lane; p0 += kAcc) {
    int row[kAcc], col[kAcc];
    bool live[kAcc];
#pragma unroll
    for (int u = 0; u < kAcc; ++u) {
      const int e = lane + 32 * (p0 + u);
      const int k = e / nout;
      live[u] = k < nrows;
      row[u] = r0 + (live[u] ? k : 0);
      col[u] = live[u] ? e - k * nout : 0;
    }
    float acc[kAcc];
#pragma unroll
    for (int u = 0; u < kAcc; ++u) acc[u] = 0.0f;
#pragma unroll 4
    for (int c = 0; c < nin; ++c) {
#pragma unroll
      for (int u = 0; u < kAcc; ++u)
        acc[u] = fmaf(in[row[u] * sin + c], weight(c, col[u]), acc[u]);
    }
#pragma unroll
    for (int u = 0; u < kAcc; ++u)
      if (live[u]) epilogue(row[u], col[u], acc[u]);
  }
}

// Weight gradient and SGD (+ FedProx) of rows i0 .. i0 + nr - 1 (nr <= R)
// of a layer's weight (din x dout), and of its bias when `with_bias`, for
// the columns of block jb.  Lane = (h, column j): with dout dividing 32,
// h < 32 / dout sums batch rows h, h + H, ... and shuffles finish the sums;
// wider layers take 32 columns a block.  a_in: the layer's input rows
// (stride sa); g_out: the gradient at its output (stride sg); bias / w:
// the working bias and weight rows (stride wst); anchor: the broadcast
// params of the layer (ravel order).
template <bool kVec, int R>
__device__ __forceinline__ void update_rows(int i0, int nr, bool with_bias, int jb, int din,
                                            int dout, const float* __restrict__ a_in, int sa,
                                            const float* __restrict__ g_out, int sg,
                                            float* __restrict__ bias, float* __restrict__ w,
                                            int wst, const float* __restrict__ anchor,
                                            int batch, float lr, float mu, bool prox,
                                            int lane) {
  const int cols = 32 % dout == 0 ? dout : 32;
  const int hs = 32 / cols;
  const int j = jb * cols + lane % cols;
  const int h = lane / cols;
  const bool jok = j < dout;
  // Row t of the block (t == R: the bias) is updated by lane part h.
  auto mine = [&](int t) {
    return jok && (t == R ? with_bias && h == 0 : t < nr && (hs <= R ? t % hs == h : t == h));
  };
  float anc[R + 1];
#pragma unroll
  for (int t = 0; t <= R; ++t)
    anc[t] = prox && mine(t) ? anchor[t == R ? j : dout + (i0 + t) * dout + j] : 0.0f;
  float acc[R + 1];
#pragma unroll
  for (int t = 0; t <= R; ++t) acc[t] = 0.0f;
  const float* ar = a_in + i0;
#pragma unroll
  for (int r = h; r < batch; r += hs) {
    const float g = jok ? g_out[r * sg + j] : 0.0f;
    float a[R];
    if constexpr (kVec && R == 4) {
      const float4 v = *reinterpret_cast<const float4*>(ar + r * sa);
      a[0] = v.x;
      a[1] = v.y;
      a[2] = v.z;
      a[3] = v.w;
    } else if constexpr (kVec && R == 2) {
      const float2 v = *reinterpret_cast<const float2*>(ar + r * sa);
      a[0] = v.x;
      a[1] = v.y;
    } else {
#pragma unroll
      for (int t = 0; t < R; ++t) a[t] = t < nr ? ar[r * sa + t] : 0.0f;
    }
#pragma unroll
    for (int t = 0; t < R; ++t) acc[t] = fmaf(a[t], g, acc[t]);
    if (with_bias) acc[R] += g;
  }
  for (int m = cols; m < 32; m <<= 1)
#pragma unroll
    for (int t = 0; t <= R; ++t) acc[t] += __shfl_xor_sync(0xffffffffu, acc[t], m);
#pragma unroll
  for (int t = 0; t <= R; ++t) {
    if (!mine(t)) continue;
    float* p = t == R ? bias + j : w + (i0 + t) * wst + j;
    float grad = acc[t];
    if (prox) grad += mu * (*p - anc[t]);
    *p -= lr * grad;
  }
}

// Rows of a layer's weight per warp in the update: din / 8 for the paper
// AE's layers (a compile-time constant), else blocks of 4.
template <class Net, class LI>
struct UpdateRows {
  static constexpr int value = 4;
};
template <int I>
struct UpdateRows<PaperAE, Int<I>> {
  static constexpr int value = (paper_dim(I) + kWarps - 1) / kWarps;
};
template <class Net>
__global__ void __launch_bounds__(kThreads)
    local_train_kernel(const float* __restrict__ x, int window,
                       const int* __restrict__ idx, int steps, int batch_arg,
                       const float* __restrict__ theta, const Layout lay, bool vec_rows,
                       float lr, float mu, float* __restrict__ delta,
                       float* __restrict__ loss) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[kWarps];
  const int L = n_layers<Net>(lay);
  const int batch = Net::kFixed ? Net::kBatch : batch_arg;
  const int client = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int d = Net::dim(lay, 0);
  int* ring = reinterpret_cast<int*>(smem + lay.idx_off);

  // The working parameters, from the ravel order into padded weight rows
  // (and back into deltas at the end).
  auto each_param = [&](auto body) {
    each_layer<Net, false>(L, [&](auto li) {
      const int l = li;
      const int din = Net::dim(lay, l), dout = Net::dim(lay, l + 1);
      for (int e = tid; e < dout + din * dout; e += kThreads) {
        const int i = e / dout - 1;
        const int j = e - (i + 1) * dout;
        body(Net::seg(lay, l) + e,
             i < 0 ? Net::pseg(lay, l) + j : Net::woff(lay, l) + i * Net::wst(lay, l) + j);
      }
    });
  };
  each_param([&](int e, int p) { smem[p] = theta[e]; });

  const float* xc = x + static_cast<size_t>(client) * window * d;
  const int* ic = idx + static_cast<size_t>(client) * steps * batch;
  const float inv_b = 1.0f / static_cast<float>(batch);
  const float gscale = 2.0f * inv_b;
  const bool prox = mu != 0.0f;
  float loss_acc = 0.0f;

  // The warp's rows of the batch.
  const int rpw = (batch + kWarps - 1) / kWarps;
  const int r0 = min(batch, warp * rpw);
  const int nrows = min(batch, r0 + rpw) - r0;

  auto issue_idx = [&](int s) {
    int* dst = ring + (s % 3) * batch;
    const int* src = ic + static_cast<size_t>(s) * batch;
    for (int r = tid; r < batch; r += kThreads) cp_async4(dst + r, src + r);
  };
  auto issue_rows = [&](int s) {
    float* dst = smem + (s & 1 ? lay.x_off[1] : lay.x_off[0]);
    const int* rows = ring + (s % 3) * batch;
    const int st = Net::stride(lay, 0);
    if (vec_rows) {
      const int chunks = d / 4;
      for (int e = tid; e < batch * chunks; e += kThreads) {
        const int r = e / chunks;
        const int c = (e - r * chunks) * 4;
        cp_async16(dst + r * st + c, xc + static_cast<size_t>(rows[r]) * d + c);
      }
    } else {
      for (int e = tid; e < batch * d; e += kThreads) {
        const int r = e / d;
        const int c = e - r * d;
        cp_async4(dst + r * st + c, xc + static_cast<size_t>(rows[r]) * d + c);
      }
    }
  };

  issue_idx(0);
  if (steps > 1) issue_idx(1);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  issue_rows(0);
  cp_async_commit();

  for (int s = 0; s < steps; ++s) {
    cp_async_wait_all();
    __syncthreads();   // step s's rows staged; step s-1's update done
    if (s + 2 < steps) issue_idx(s + 2);
    if (s + 1 < steps) issue_rows(s + 1);
    cp_async_commit();

    const float* xb = smem + (s & 1 ? lay.x_off[1] : lay.x_off[0]);
    // Forward, warp by warp; the last layer folds in the loss and dL/dz.
    each_layer<Net, false>(L, [&](auto li) {
      const int l = li;
      const int din = Net::dim(lay, l), dout = Net::dim(lay, l + 1);
      const float* in = l == 0 ? xb : smem + lay.act_off[l];
      const float* w = smem + Net::woff(lay, l);
      const float* b = smem + Net::pseg(lay, l);
      if (l < L - 1) {
        row_layer<Net::kVec, kHidden>(in, Net::stride(lay, l), din, w, Net::wst(lay, l), b,
                                      dout, smem + lay.act_off[l + 1], Net::stride(lay, l + 1),
                                      nullptr, 0, r0, nrows, gscale, loss_acc, lane);
      } else {
        row_layer<Net::kVec, kLast>(in, Net::stride(lay, l), din, w, Net::wst(lay, l), b, dout,
                                    smem + lay.grad_off[l + 1], Net::stride(lay, l + 1), xb,
                                    Net::stride(lay, 0), r0, nrows, gscale, loss_acc, lane);
      }
      __syncwarp();
    });
    // Data gradients, last layer first, from the pre-update weights.
    each_layer<Net, true>(L, [&](auto li) {
      const int l = li;
      const int din = Net::dim(lay, l), dout = Net::dim(lay, l + 1);
      row_layer<Net::kVec, kBack>(smem + lay.grad_off[l + 1], Net::stride(lay, l + 1), dout,
                                  smem + Net::woff(lay, l), Net::wst(lay, l), nullptr, din,
                                  smem + lay.grad_off[l], Net::stride(lay, l),
                                  smem + lay.act_off[l], Net::stride(lay, l), r0, nrows, gscale,
                                  loss_acc, lane);
      __syncwarp();
    });
    __syncthreads();

    // Every layer's weight gradient and update: warp w takes rows
    // [w * rpw, (w + 1) * rpw) of every layer's weight, warp 0 the biases
    // besides, so every warp has the same share.
    each_layer<Net, false>(L, [&](auto li) {
      const int l = li;
      constexpr int R = UpdateRows<Net, decltype(li)>::value;
      const int din = Net::dim(lay, l), dout = Net::dim(lay, l + 1);
      const int cols = 32 % dout == 0 ? dout : 32;
      const int rpw = (din + kWarps - 1) / kWarps;
      const int i_hi = min(din, (warp + 1) * rpw);
      const float* a_in = l == 0 ? xb : smem + lay.act_off[l];
      for (int jb = 0; jb * cols < dout; ++jb) {
        int i0 = warp * rpw;
        do {
          update_rows<Net::kVec, R>(i0, max(0, min(R, i_hi - i0)), warp == 0 && i0 == 0, jb,
                                    din, dout, a_in, Net::stride(lay, l),
                                    smem + lay.grad_off[l + 1], Net::stride(lay, l + 1),
                                    smem + Net::pseg(lay, l), smem + Net::woff(lay, l),
                                    Net::wst(lay, l), theta + Net::seg(lay, l), batch, lr, mu,
                                    prox, lane);
          i0 += R;
        } while (i0 < i_hi);
      }
    });
  }
  __syncthreads();

  // Deltas and the mean loss.
  float* dc = delta + static_cast<size_t>(client) * lay.n_params;
  each_param([&](int e, int p) { dc[e] = smem[p] - theta[e]; });
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) loss_acc += __shfl_xor_sync(0xffffffffu, loss_acc, o);
  if (lane == 0) red[warp] = loss_acc;
  __syncthreads();
  if (tid == 0) {
    float total = 0.0f;
    for (int w = 0; w < kWarps; ++w) total += red[w];
    loss[client] = total * inv_b / static_cast<float>(steps);
  }
}

template <class Net>
cudaError_t launch(const float* x, int n, int window, const int* idx, int steps, int batch,
                   const float* theta, const Layout& lay, float lr, float mu, float* delta,
                   float* loss, int smem_bytes, cudaStream_t stream) {
  cudaError_t rc = cudaFuncSetAttribute(local_train_kernel<Net>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        smem_bytes);
  if (rc != cudaSuccess) return rc;
  const bool vec_rows = lay.dims[0] % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  local_train_kernel<Net><<<n, kThreads, smem_bytes, stream>>>(
      x, window, idx, steps, batch, theta, lay, vec_rows, lr, mu, delta, loss);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (n, window, dims[0]) f32; idx (n, steps, batch) int32 rows of the
// window; theta (n_params,) f32 in the ravel order; delta (n, n_params) f32
// and loss (n,) f32 out.  The offsets and strides are local_train.py's
// layout(), per layer in `per_layer` (seg_off, pseg_off, w_off, w_stride:
// 4 x n_layers) and per width in `per_width` (stride, act_off, grad_off:
// 3 x (n_layers + 1)); smem_bytes its size.  Returns the cudaError_t of the
// launch (0 on success).
int local_train_f32(const void* x, int n, int window, const void* idx, int steps, int batch,
                    const void* theta, int n_layers, const int* dims, const int* per_layer,
                    const int* per_width, const int* x_off, int idx_off, int n_params,
                    float lr, float mu, void* delta, void* loss, int smem_bytes,
                    void* stream) {
  if (n < 1 || steps < 1 || batch < 1 || n_layers < 1 || n_layers > kMaxLayers)
    return static_cast<int>(cudaErrorInvalidValue);
  Layout lay = {};
  lay.n_layers = n_layers;
  lay.n_params = n_params;
  for (int l = 0; l <= n_layers; ++l) {
    lay.dims[l] = dims[l];
    lay.stride[l] = per_width[l];
    lay.act_off[l] = per_width[(n_layers + 1) + l];
    lay.grad_off[l] = per_width[2 * (n_layers + 1) + l];
  }
  for (int l = 0; l < n_layers; ++l) {
    lay.seg_off[l] = per_layer[l];
    lay.pseg_off[l] = per_layer[n_layers + l];
    lay.w_off[l] = per_layer[2 * n_layers + l];
    lay.w_stride[l] = per_layer[3 * n_layers + l];
  }
  lay.x_off[0] = x_off[0];
  lay.x_off[1] = x_off[1];
  lay.idx_off = idx_off;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const int* ip = static_cast<const int*>(idx);
  const float* tp = static_cast<const float*>(theta);
  float* dp = static_cast<float*>(delta);
  float* lp = static_cast<float*>(loss);
  if (is_paper(lay, batch))
    return static_cast<int>(launch<PaperAE>(xf, n, window, ip, steps, batch, tp, lay, lr, mu,
                                            dp, lp, smem_bytes, s));
  return static_cast<int>(launch<Generic>(xf, n, window, ip, steps, batch, tp, lay, lr, mu,
                                          dp, lp, smem_bytes, s));
}

const char* local_train_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
