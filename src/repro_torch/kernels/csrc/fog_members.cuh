// The fogs' member lists, built on the card: one block per bucket, no host
// sync, no atomics.
//
// fused_agg.cu (extra blocks of the select launch, ahead of the fog sums)
// and robust_agg.cu (a launch of its own, ahead of the robust reduce)
// include this one definition.  Client i's bucket is its fog when it is a
// member (0 <= fog_id[i] < n_fog and, with weights, w[i] > 0), else n_fog;
// bucket n_fog holds every client that belongs to no fog.  The lists are
// kernels/robust_agg.member_lists' (a stable sort by bucket), element for
// element: members[offsets[m] .. offsets[m + 1]) are bucket m's clients in
// index order, offsets[m] the number of clients of lower buckets, and
// bucket n_fog's clients follow offsets[n_fog], up to N.
//
// Block m (kListWarps warps) builds bucket m.  Each warp takes one
// contiguous share of the ids, so the warps' members come in index order
// warp after warp; a lane holds kListIds ids at a time, all loaded before
// they are used (one memory round trip per 512 ids a warp).  Pass 1 counts
// the share's clients of lower buckets and of bucket m; a block barrier
// turns the warps' counts into the bucket's start and each warp's place in
// it; pass 2 reads the share again and writes the bucket's clients there,
// compacted by ballots.  Every bucket reads all N ids twice: O(N n_fog) id
// reads per call (N^2 for identity segments, fog i = client i), spread over
// n_fog + 1 blocks, each with a latency of 2 N / (kListWarps * 512) round
// trips.  Needs blockDim.x == kListWarps * 32; contains a block barrier.
#pragma once

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kListWarps = 8;    // warps of a list block, each scanning a share of the ids
constexpr int kListIds = 16;     // ids a lane holds at a time: 512 a warp

// The bucket keys of ids [c0, c0 + 512) of a warp's share (INT_MAX, in no
// bucket and below none, past its end), every load issued before any is
// used.  Without weights (w == nullptr) every in-range id is a member.
__device__ __forceinline__ void bucket_keys(const int* __restrict__ fog_id,
                                            const float* __restrict__ w, int c0, int end,
                                            int n_fog, int lane, int (&key)[kListIds]) {
  int f[kListIds];
  float wi[kListIds];
#pragma unroll
  for (int t = 0; t < kListIds; ++t) {
    const int i = c0 + t * 32 + lane;
    f[t] = i < end ? __ldg(fog_id + i) : -1;
    wi[t] = i < end && w != nullptr ? __ldg(w + i) : 1.0f;
  }
#pragma unroll
  for (int t = 0; t < kListIds; ++t) {
    const bool in = f[t] >= 0 && f[t] < n_fog && wi[t] > 0.0f;
    key[t] = c0 + t * 32 + lane < end ? (in ? f[t] : n_fog) : INT_MAX;
  }
}

// Block m's part: bucket m's clients into members, its start into
// offsets[m].  Every thread of the block must call it.
__device__ __forceinline__ void fog_members_block(const int* __restrict__ fog_id,
                                                  const float* __restrict__ w, int n, int n_fog,
                                                  int m, int* __restrict__ members,
                                                  int* __restrict__ offsets) {
  __shared__ unsigned below_sm[kListWarps];
  __shared__ unsigned count_sm[kListWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const int share = (n + kListWarps - 1) / kListWarps;
  const int lo = min(n, warp * share);
  const int end = min(n, lo + share);

  unsigned below = 0;
  unsigned mine = 0;
  for (int c0 = lo; c0 < end; c0 += kListIds * 32) {
    int key[kListIds];
    bucket_keys(fog_id, w, c0, end, n_fog, lane, key);
#pragma unroll
    for (int t = 0; t < kListIds; ++t) {
      below += key[t] < m ? 1u : 0u;
      mine += key[t] == m ? 1u : 0u;
    }
  }
  below = __reduce_add_sync(0xffffffffu, below);
  mine = __reduce_add_sync(0xffffffffu, mine);
  if (lane == 0) {
    below_sm[warp] = below;
    count_sm[warp] = mine;
  }
  __syncthreads();
  unsigned pos = 0;    // the bucket's start, then the members of the warps before
#pragma unroll
  for (int v = 0; v < kListWarps; ++v) pos += below_sm[v];
  if (threadIdx.x == 0) offsets[m] = static_cast<int>(pos);
#pragma unroll
  for (int v = 0; v < kListWarps; ++v) pos += v < warp ? count_sm[v] : 0u;

  for (int c0 = lo; c0 < end; c0 += kListIds * 32) {
    int key[kListIds];
    bucket_keys(fog_id, w, c0, end, n_fog, lane, key);
#pragma unroll
    for (int t = 0; t < kListIds; ++t) {
      const bool in = key[t] == m;
      const unsigned ballot = __ballot_sync(0xffffffffu, in);
      if (in) members[pos + __popc(ballot & lt)] = c0 + t * 32 + lane;
      pos += __popc(ballot);
    }
  }
}

}  // namespace
