// Byzantine-robust fog aggregation for Hopper (sm_90a): the coordinate-wise
// weighted trimmed mean or weighted lower median of the clients'
// reconstructions, per fog.
//
// Replaces the Pallas TPU kernel _robust_agg_kernel of
// src/repro/kernels/robust_agg.py.  Per fog m and coordinate c, over the
// members i of m with weight w_i > 0 (values v_i = recon[i, c]):
//   A_i = member weight strictly below v_i, g_i = member weight tied at v_i,
//   W = the members' total weight;
//   trimmed: eff_i = w_i * max(min(A_i + g_i, (1 - beta) W)
//                              - max(A_i, beta W), 0) / max(g_i, 1e-30);
//   median:  eff_i = w_i / max(g_i, 1e-30) for the tie group with
//            A_i < W/2 <= A_i + g_i, else 0;
//   out[m, c] = sum eff_i v_i / max(sum eff_i, 1e-12)  (0 for an empty fog).
// This is the sort-free tie-group interval overlap of
// repro_torch.kernels.ref.robust_aggregate_ref.
//
// Two launches behind one wrapper (robust_agg.py).  The first lists every
// fog's members (weight > 0), in index order, as one compacted array with
// per-fog offsets: members_kernel, a block per fog (fog_members.cuh, the
// code that lists fused_agg's fogs), so no host sync, no sort and no
// PyTorch op runs on the card's route, and any fleet and fog size is
// taken.  Each list block reads all N ids and weights twice: O(N n_fog)
// reads, a few round trips deep at N = 200.  The list equals
// kernels/robust_agg.member_lists, the plain version, element for
// element.  (The first design built it with torch.where, a stable
// torch.sort, arange and searchsorted: 11 device ops before the kernel.)
//
// The second, robust_kernel: one block per (64-column tile, fog), one
// thread per column (fogs past the grid's 65,535 rows are taken by a
// loop).  A block reads only its own fog's slice of the list
// (members[offsets[m] .. offsets[m + 1])), so no fog size is too large.
// The block stages the ids and weights in shared memory 1,024 at a time: a
// fog of up to 1,024 members is staged once, a larger one is streamed tile
// by tile for every group below.  The TPU kernel looped over all N clients
// for every fog (O(N^2 M d)); this walks members only: O(sum_m n_m^2 d).
// Each thread takes the members in groups of 8 held in registers (values,
// A, g) and streams every member's value of its column once per group, so
// a member's value is read n_m / 8 times, not n_m.  There is no reuse
// across threads (each owns its column), so the values are read straight
// from device memory through L1 / L2, coalesced across the warp.  A, g and
// W accumulate in member index order, and so do num and den.
//
// Exactness: round weights are integers (n_samples * delivered), so A, g
// and W are exact in f32 in any order and the choice of which members
// survive the trim, or which group holds the median, equals the plain
// version's bit for bit.  beta arrives as the f32 trim fraction; it is
// clamped to [0, 0.4995] here and beta W, (1 - beta) W and W/2 are f32
// products, as ref.py computes them.  Every product, sum and quotient is
// an explicit round-to-nearest intrinsic (no FMA contraction).
//
// Bound: operations.  Per fog sum_m n_m^2 d compare-and-accumulate pairs
// (two compares, two selects, two adds) against N d reads of recon and
// M d writes (the member list's id reads are not counted).  At N = 200 in
// 20 fogs of ~10 members the whole function is a few microseconds of
// either; at one fog of 2,000 members it is 4 M pairs per column.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fog_members.cuh"

namespace {

constexpr int kTile = 64;       // columns (threads) per block
constexpr int kGroup = 8;       // members a thread holds in registers at once
constexpr int kList = 1024;     // member ids (and weights) staged at once
constexpr float kMaxBeta = 0.4995f;
constexpr int kMaxGridY = 65535;  // fogs per launch row; more loop

__global__ void __launch_bounds__(kTile)
    robust_kernel(const float* __restrict__ v, const int* __restrict__ members,
                  const int* __restrict__ offsets, const float* __restrict__ w,
                  int d, int n_fog, float beta, bool median, float* __restrict__ out) {
  __shared__ int ids_sm[kList];
  __shared__ float w_sm[kList];
  const int tid = threadIdx.x;
  const int c = blockIdx.x * kTile + tid;
  const bool live = c < d;
  const float b = fminf(fmaxf(beta, 0.0f), kMaxBeta);

  for (int m = blockIdx.y; m < n_fog; m += gridDim.y) {
    const int* ids = members + offsets[m];
    const int cnt = offsets[m + 1] - offsets[m];
    float big_w = 0.0f, lo_w = 0.0f, hi_w = 0.0f, half = 0.0f;
    float num = 0.0f;
    float den = 0.0f;
    for (int g0 = 0; g0 < cnt; g0 += kGroup) {
      const int gn = min(kGroup, cnt - g0);
      float vi[kGroup], wi[kGroup], a[kGroup], g[kGroup];
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        const int id = j < gn ? ids[g0 + j] : 0;
        vi[j] = live && j < gn ? v[static_cast<size_t>(id) * d + c] : 0.0f;
        wi[j] = j < gn ? w[id] : 0.0f;
        a[j] = 0.0f;
        g[j] = 0.0f;
      }
      // Every member against the group, the list staged kList at a time.
      // cnt is the block's, so the staging branch and its barriers are
      // uniform; the first barrier also frees the staging of the last fog.
      for (int t0 = 0; t0 < cnt; t0 += kList) {
        const int tn = min(kList, cnt - t0);
        if (g0 == 0 || cnt > kList) {
          __syncthreads();
          for (int t = tid; t < tn; t += kTile) {
            const int id = ids[t0 + t];
            ids_sm[t] = id;
            w_sm[t] = w[id];
          }
          __syncthreads();
          if (g0 == 0)
            for (int t = 0; t < tn; ++t) big_w = __fadd_rn(big_w, w_sm[t]);
        }
        if (!live) continue;
        for (int t = 0; t < tn; ++t) {
          const float vk = v[static_cast<size_t>(ids_sm[t]) * d + c];
          const float wk = w_sm[t];
#pragma unroll
          for (int j = 0; j < kGroup; ++j) {
            a[j] = __fadd_rn(a[j], vk < vi[j] ? wk : 0.0f);
            g[j] = __fadd_rn(g[j], vk == vi[j] ? wk : 0.0f);
          }
        }
      }
      if (g0 == 0) {    // W is complete after the first group's pass
        lo_w = __fmul_rn(b, big_w);
        hi_w = __fmul_rn(__fsub_rn(1.0f, b), big_w);
        half = __fmul_rn(0.5f, big_w);
      }
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        if (j < gn) {
          const float gs = fmaxf(g[j], 1e-30f);
          const float top = __fadd_rn(a[j], g[j]);
          float ratio;
          if (median) {
            ratio = (a[j] < half && half <= top) ? __fdiv_rn(1.0f, gs) : 0.0f;
          } else {
            const float lo = fmaxf(a[j], lo_w);
            const float hi = fminf(top, hi_w);
            ratio = __fdiv_rn(fmaxf(__fsub_rn(hi, lo), 0.0f), gs);
          }
          const float eff = __fmul_rn(wi[j], ratio);
          num = __fadd_rn(num, __fmul_rn(eff, vi[j]));
          den = __fadd_rn(den, eff);
        }
      }
    }
    if (live) out[static_cast<size_t>(m) * d + c] = __fdiv_rn(num, fmaxf(den, 1e-12f));
  }
}

// The member lists: block m lists bucket m (fog m, or n_fog: every client
// of no fog).
__global__ void __launch_bounds__(kListWarps * 32)
    members_kernel(const int* __restrict__ fog_id, const float* __restrict__ w, int n,
                   int n_fog, int* __restrict__ members, int* __restrict__ offsets) {
  fog_members_block(fog_id, w, n, n_fog, static_cast<int>(blockIdx.x), members, offsets);
}

}  // namespace

extern "C" {

// The launch before robust_agg: members (n) and offsets (n_fog + 1) int32,
// the fogs' clients of weight > 0 in index order (fog_members.cuh), the
// clients of no fog after them.  Returns the cudaError_t of the launch.
int robust_agg_members(const void* fog_id, const void* w, int n, int n_fog, void* members,
                       void* offsets, void* stream) {
  if (n < 1 || n_fog < 1 || n_fog == 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  members_kernel<<<static_cast<unsigned>(n_fog) + 1u, kListWarps * 32, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(fog_id), static_cast<const float*>(w), n, n_fog,
      static_cast<int*>(members), static_cast<int*>(offsets));
  return static_cast<int>(cudaGetLastError());
}

// out (n_fog, d), every row written.  members holds the fogs' member ids
// (weight > 0), fog by fog and in index order within a fog; fog m's are
// members[offsets[m] .. offsets[m + 1]).  beta is the f32 trim fraction
// (clamped to [0, 0.4995] in the kernel); median != 0 selects the lower
// median.  Returns the cudaError_t of the launch (0 on success).
int robust_agg(const void* v, const void* members, const void* offsets, const void* w,
               int d, int n_fog, float beta, int median, void* out, void* stream) {
  if (d < 1 || n_fog < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((d + kTile - 1) / kTile, n_fog < kMaxGridY ? n_fog : kMaxGridY);
  robust_kernel<<<grid, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(v), static_cast<const int*>(members),
      static_cast<const int*>(offsets), static_cast<const float*>(w), d, n_fog, beta,
      median != 0, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* robust_agg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
