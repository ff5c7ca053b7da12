// Fused local training for Hopper (sm_90a): the whole client phase of a
// federated round (E epochs of minibatch SGD on the autoencoder, paper
// Eq. 12, optional FedProx term) for every client in one launch.
//
// Replaces the Pallas TPU kernel _local_train_kernel of
// src/repro/kernels/fused_local_train.py, without its TPU layout (128-lane
// padding, the one-hot gather matmul, the transposed -1-padded index
// table).  It computes exactly repro_torch.kernels.ref.local_train_ref.
//
// Design (simple and right first):
//  * One block per client.  The block copies the broadcast parameters
//    theta (flat, in the ravel order: per layer the bias, then the
//    row-major weight) once into shared memory as its working parameters;
//    the anchor stays in device memory (read through L2 by FedProx and for
//    the final delta), which keeps wide autoencoders inside 227 KB.
//  * Per step the block gathers its minibatch rows straight from the
//    client's window through the index table and keeps every layer's
//    activations, and the gradient at every layer's output, for the batch
//    in shared memory (row strides padded to odd, so a warp's 32 rows fall
//    in 32 banks; consecutive threads take consecutive rows).
//  * Forward, manual backward and the SGD update run with one thread per
//    output element, with __syncthreads() between phases.  The gradient of
//    layer l-1 is computed from layer l's weights before they are updated
//    (the reference reads the step's weights once, up front); tanh' is
//    1 - a^2 from the stored tanh output; the output layer is linear;
//    dL/dz_out = (2 / bsz) (recon - x); FedProx adds mu (W - W_anchor) on
//    the pre-update W.  Layer l's update overlaps layer l-1's gradient
//    phase: they touch disjoint buffers.
//  * Outputs: deltas (N, d) = working - anchor in the ravel order, and the
//    mean step loss sum((recon - x)^2) / bsz over the steps.
//
// Bound: operations.  At the paper AE (32-16-8-16-32), N = 200, 40 steps of
// 32 rows, the function needs ~2 GFLOP of f32 FMAs and tanh against ~8.7 MB
// of input and output: ~29 us at 67 TFLOP/s.  The block's chain of ~13
// barrier-separated phases per step makes it latency-bound instead; a later
// PR can split the batch over warps and double-buffer the gather.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLayers = 8;   // MAX_LAYERS in local_train.py
constexpr int kThreads = 256;

struct Net {
  int dims[kMaxLayers + 1];      // d, hidden..., d
  int stride[kMaxLayers + 1];    // row stride of the buffers of width dims[l]
  int act_off[kMaxLayers + 1];   // activation buffer of width dims[l]
  int grad_off[kMaxLayers + 1];  // gradient buffer of width dims[l], l >= 1
  int seg_off[kMaxLayers];       // layer l's [bias | weight] in the flat params
  int n_layers;
  int n_params;
};

__global__ void __launch_bounds__(kThreads)
    local_train_kernel(const float* __restrict__ x, int window,
                       const int* __restrict__ idx, int steps, int batch,
                       const float* __restrict__ theta, const Net net,
                       float lr, float mu, float* __restrict__ delta,
                       float* __restrict__ loss) {
  extern __shared__ float smem[];
  __shared__ float red[kThreads / 32];
  const int client = blockIdx.x;
  const int tid = threadIdx.x;
  const int n_layers = net.n_layers;
  const int n_params = net.n_params;
  const int d = net.dims[0];
  float* work = smem;
  float* buf = smem + n_params;

  for (int e = tid; e < n_params; e += kThreads) work[e] = theta[e];

  const float* xc = x + static_cast<size_t>(client) * window * d;
  const int* ic = idx + static_cast<size_t>(client) * steps * batch;
  const float inv_b = 1.0f / static_cast<float>(batch);
  const float gscale = 2.0f * inv_b;
  const bool prox = mu != 0.0f;
  float loss_acc = 0.0f;
  __syncthreads();

  for (int s = 0; s < steps; ++s) {
    // 1. Gather the minibatch: consecutive threads read a row's features.
    {
      float* a0 = buf + net.act_off[0];
      const int st = net.stride[0];
      const int* is = ic + static_cast<size_t>(s) * batch;
      for (int e = tid; e < batch * d; e += kThreads) {
        const int r = e / d;
        const int j = e - r * d;
        a0[r * st + j] = xc[static_cast<size_t>(is[r]) * d + j];
      }
    }
    __syncthreads();

    // 2. Forward: out[r, j] = act(sum_i in[r, i] W[i, j] + b[j]).
    for (int l = 0; l < n_layers; ++l) {
      const int din = net.dims[l];
      const int dout = net.dims[l + 1];
      const float* in = buf + net.act_off[l];
      float* out = buf + net.act_off[l + 1];
      const int si = net.stride[l];
      const int so = net.stride[l + 1];
      const float* bl = work + net.seg_off[l];
      const float* wl = bl + dout;
      const bool hidden = l < n_layers - 1;
      for (int e = tid; e < batch * dout; e += kThreads) {
        const int j = e / batch;
        const int r = e - j * batch;
        const float* ir = in + r * si;
        float acc = 0.0f;
        for (int i = 0; i < din; ++i) acc = fmaf(ir[i], wl[i * dout + j], acc);
        acc += bl[j];
        out[r * so + j] = hidden ? tanhf(acc) : acc;
      }
      __syncthreads();
    }

    // 3. Loss and the gradient at the (linear) output.
    {
      const float* xb = buf + net.act_off[0];
      const float* rc = buf + net.act_off[n_layers];
      float* g = buf + net.grad_off[n_layers];
      const int st = net.stride[n_layers];
      for (int e = tid; e < batch * d; e += kThreads) {
        const int r = e / d;
        const int j = e - r * d;
        const float diff = rc[r * st + j] - xb[r * st + j];
        loss_acc = fmaf(diff, diff, loss_acc);
        g[r * st + j] = gscale * diff;
      }
    }
    __syncthreads();

    // 4. Backward, last layer first.
    for (int l = n_layers - 1; l >= 0; --l) {
      const int din = net.dims[l];
      const int dout = net.dims[l + 1];
      const int si = net.stride[l];
      const int so = net.stride[l + 1];
      const float* a_in = buf + net.act_off[l];
      const float* g_out = buf + net.grad_off[l + 1];
      float* bl = work + net.seg_off[l];
      float* wl = bl + dout;
      if (l > 0) {
        // Gradient at layer l-1's output, from the pre-update weights.
        float* g_in = buf + net.grad_off[l];
        for (int e = tid; e < batch * din; e += kThreads) {
          const int i = e / batch;
          const int r = e - i * batch;
          const float* gr = g_out + r * so;
          const float* wr = wl + i * dout;
          float acc = 0.0f;
          for (int j = 0; j < dout; ++j) acc = fmaf(gr[j], wr[j], acc);
          const float a = a_in[r * si + i];
          g_in[r * si + i] = acc * (1.0f - a * a);
        }
        __syncthreads();
      }
      // SGD (+ FedProx) on [bias | weight], in place.
      const float* anchor = theta + net.seg_off[l];
      for (int e = tid; e < dout + din * dout; e += kThreads) {
        float grad = 0.0f;
        if (e < dout) {
          for (int r = 0; r < batch; ++r) grad += g_out[r * so + e];
        } else {
          const int ee = e - dout;
          const int i = ee / dout;
          const int j = ee - i * dout;
          for (int r = 0; r < batch; ++r)
            grad = fmaf(a_in[r * si + i], g_out[r * so + j], grad);
        }
        const float p = bl[e];
        if (prox) grad += mu * (p - anchor[e]);
        bl[e] = p - lr * grad;
      }
    }
    __syncthreads();
  }

  // 5. Deltas and the mean loss.
  float* dc = delta + static_cast<size_t>(client) * n_params;
  for (int e = tid; e < n_params; e += kThreads) dc[e] = work[e] - theta[e];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    loss_acc += __shfl_xor_sync(0xffffffffu, loss_acc, o);
  if ((tid & 31) == 0) red[tid >> 5] = loss_acc;
  __syncthreads();
  if (tid == 0) {
    float total = 0.0f;
    for (int w = 0; w < kThreads / 32; ++w) total += red[w];
    loss[client] = total * inv_b / static_cast<float>(steps);
  }
}

}  // namespace

extern "C" {

// Opts the kernel in to smem_bytes of dynamic shared memory on the current
// device; returns the cudaError_t (0 on success).
int local_train_init(int smem_bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      local_train_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes));
}

// x (n, window, dims[0]) f32; idx (n, steps, batch) int32 rows of the
// window; theta (n_params,) f32 in the ravel order; delta (n, n_params) f32
// and loss (n,) f32 out.  The offsets and strides are local_train.py's
// layout().  Returns the cudaError_t of the launch (0 on success).
int local_train_f32(const void* x, int n, int window, const void* idx,
                    int steps, int batch, const void* theta, int n_layers,
                    const int* dims, const int* stride, const int* act_off,
                    const int* grad_off, const int* seg_off, int n_params,
                    float lr, float mu, void* delta, void* loss,
                    int smem_bytes, void* stream) {
  if (n < 1 || steps < 1 || batch < 1 || n_layers < 1 ||
      n_layers > kMaxLayers)
    return static_cast<int>(cudaErrorInvalidValue);
  Net net = {};
  net.n_layers = n_layers;
  net.n_params = n_params;
  for (int l = 0; l <= n_layers; ++l) {
    net.dims[l] = dims[l];
    net.stride[l] = stride[l];
    net.act_off[l] = act_off[l];
    net.grad_off[l] = grad_off[l];
  }
  for (int l = 0; l < n_layers; ++l) net.seg_off[l] = seg_off[l];
  local_train_kernel<<<n, kThreads, smem_bytes,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), window, static_cast<const int*>(idx),
      steps, batch, static_cast<const float*>(theta), net, lr, mu,
      static_cast<float*>(delta), static_cast<float*>(loss));
  return static_cast<int>(cudaGetLastError());
}

const char* local_train_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
