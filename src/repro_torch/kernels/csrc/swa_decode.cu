// Single-token GQA sliding-window decode attention for Hopper (sm_90a),
// flash-decoding: the window is split over the grid, and a second pass
// merges the splits in a fixed order.
//
// Replaces the Pallas TPU kernel _swa_decode_kernel of
// src/repro/kernels/swa_attention.py.  The TPU kernel takes one sequence
// per call (the reference vmaps it over the batch), walks the whole cache
// in 512-position tiles on a sequential grid with the online-softmax state
// in VMEM scratch, and masks the positions outside the window.  This
// kernel takes the whole batch in one call and visits only the window.
//
// Function: for batch row b, query head (kv head h, group member j),
//   len = cache_len[b], positions p in [max(0, len - window), min(len, S)),
//   s_p = d^-0.5 <q[b, h*g + j], k[b, p, h]>
//   out = sum_p exp(s_p - m) v[b, p, h] / max(sum_p exp(s_p - m), 1e-20)
// with the TPU kernel's online recurrence and clips: m starts at -1e30,
// alpha = exp(clip(m_prev - m_new, -80, 0)), p = exp(clip(s - m_new, -80,
// 0)).  A row whose window holds no position gives zeros, as the TPU kernel
// does (kernels/ref.sliding_window_decode_attention_ref likewise).
// Positions outside the window are never loaded: in the TPU recurrence a
// masked position leaves m, l and acc unchanged, so skipping them is exact.
// cache_len is read on the device (no host sync).
//
// Design.
//  * Split (flash-decoding).  Grid (B * Hkv, head chunks of <= 16, splits).
//    The host picks the split length `chunk` (a multiple of the 32-position
//    tile) from min(S, window) and B * Hkv alone (swa_attention.plan), so
//    that the grid holds about two blocks per SM; split z takes positions
//    [lo + z * chunk, lo + (z + 1) * chunk) of its row's window [lo, hi).
//    Each block writes its partial state (m, l, acc), in f32, to scratch
//    the wrapper allocates; a split with no position writes m = -1e30,
//    l = acc = 0, which adds exactly nothing.  swa_merge_kernel then
//    combines a head's splits in split order (no atomics: two calls are
//    bitwise equal).
//  * Tiles.  A block of 4 warps walks its split in tiles of 32 positions.
//    K and V tiles are staged in shared memory with cp.async (16 bytes a
//    thread), double-buffered: both stages are requested at the start, and
//    a stage is refilled with tile t + 2 as soon as tile t is done.
//    Positions past the split or the window are zero-filled, never read.
//    Per tile and head, one max and one sum (8 lanes a head, all heads at
//    once), not one per position.
//  * Scores.  bf16: S_tile = Q_chunk . K_tile^T on the tensor cores
//    (mma.sync.m16n8k16, bf16 in, f32 out), the chunk's <= 16 query heads as
//    the 16 rows (zero-padded), each warp 8 positions.  f32: CUDA cores,
//    lane = position, the K row read as float4s.  Both multiply the f32
//    scores by d^-0.5 after the product (exact for d = 256; for other d
//    this differs from "scale q first" by f32 rounding only).  q is staged
//    by cp.async with the first tile.
//  * P . V.  bf16: on the tensor cores too, f32 accumulators in the mma's
//    C fragments (warp w owns a quarter of d), P split into two bf16 halves
//    (p = hi + lo to ~2^-17; P rounded to one bf16 would cost the output
//    its last bit), V fragments by ldmatrix.trans.  f32: CUDA cores, warp w
//    owns heads w, w + 4, ..., each lane a pair of dims per 64.  The
//    accumulators are rescaled once per tile.
//  Rows of K/V in shared memory are padded by 16 bytes, so the mma's
//  B-fragment loads and ldmatrix rows (8 rows x 16 bytes) and the f32
//  lanes' float4 loads (32 rows, one column) fall in distinct banks.
//
// Bound: bytes.  At hybrid-window's shape (batch 8, Hq 10, Hkv 1, d 256,
// len 2,200, window 2,048, bf16) the window's K and V are 16.8 MB, ~5 us at
// 3.35 TB/s; the ~4 d g operations per position and kv head are far below
// the card's rate.  There the grid is 8 x 1 x 32 = 256 blocks of 64
// positions, two resident per SM (76 KB of shared memory each).  On an
// NVIDIA H100 80GB HBM3 at its 700.00 W power limit the two launches take
// ~11.7 us there (chip_smoke.py phase 14, which prints each launch's
// share), ~2.3x the bound: each block's chain of copy, scores, softmax and
// P . V runs with only 8 warps on its SM, and the merge is a second launch
// with its own latency (PERF.md has the times).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;              // positions per tile (= lanes)
constexpr int kMaxDim = 256;
constexpr int kMaxHeads = 16;          // query heads of one block (mma rows)
constexpr int kPad = 16;               // bytes of padding per staged row
constexpr int kSStride = kTile + 1;    // score rows in shared memory
constexpr int kMaxSplits = 4096;       // the merge stages a row's splits in shared memory
constexpr int kMergeBatch = 32;        // split accumulators a merge thread loads at once
constexpr float kNegInf = -1e30f;      // the TPU kernel's running-max start
constexpr float kMinusInf = -__builtin_huge_valf();

__device__ __forceinline__ float clipped_exp(float x) {
  return expf(fminf(fmaxf(x, -80.0f), 0.0f));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t* r, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}

// Elements of T per staged row (d plus the padding).
template <typename T>
__host__ __device__ constexpr int row_elems(int d) {
  return d + kPad / static_cast<int>(sizeof(T));
}

// Dynamic shared memory of a block: the chunk's query heads (bf16 rows
// padded like K for the mma's A fragments, f32 rows pre-scaled), then two
// stages of K and V tiles.
template <typename T>
__host__ __device__ constexpr size_t smem_bytes(int d) {
  return sizeof(T) * (static_cast<size_t>(kMaxHeads) * row_elems<T>(d) +
                      4ull * kTile * row_elems<T>(d));
}

// Stage positions [p0, p0 + kTile) of K and V (those < pend; the rest
// zero-filled without a read) into K_s / V_s, 16 bytes a copy: this thread
// takes row r0 piece c0 and every kThreads-th piece after it.
template <typename T>
__device__ __forceinline__ void load_tile(T* k_s, T* v_s, const T* kb, const T* vb,
                                          size_t pos_stride, long long p0, long long pend,
                                          long long p_safe, int d, int r0, int c0) {
  constexpr int per = 16 / static_cast<int>(sizeof(T));
  const int chunks = d / per;                      // 16-byte pieces of a row
  const int dr = kThreads / chunks, dc = kThreads - dr * chunks;
  const int re = row_elems<T>(d);
  for (int r = r0, c = c0; r < kTile;) {
    const long long p = p0 + r;
    const bool ok = p < pend;
    const size_t off = static_cast<size_t>(ok ? p : p_safe) * pos_stride + c * per;
    cp_async16(k_s + r * re + c * per, kb + off, ok ? 16 : 0);
    cp_async16(v_s + r * re + c * per, vb + off, ok ? 16 : 0);
    c += dc;
    r += dr;
    if (c >= chunks) {
      c -= chunks;
      ++r;
    }
  }
}

template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
    swa_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int32_t* __restrict__ cache_len,
                     int s_len, int hkv, int g, int d, long long window, long long chunk,
                     float scale, float* __restrict__ part_acc, float* __restrict__ part_ml) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float s_s[kMaxHeads * kSStride];   // the tile's scores, then its p
  __shared__ float alpha_s[kMaxHeads];
  __shared__ float m_s[kMaxHeads];
  __shared__ float l_s[kMaxHeads];

  constexpr bool kBf16 = sizeof(T) == 2;
  const int re = row_elems<T>(d);
  T* q_s = reinterpret_cast<T*>(smem_raw);
  T* stage_k[2];
  T* stage_v[2];
  stage_k[0] = q_s + kMaxHeads * re;
  stage_v[0] = stage_k[0] + kTile * re;
  stage_k[1] = stage_v[0] + kTile * re;
  stage_v[1] = stage_k[1] + kTile * re;

  const int b = blockIdx.x / hkv;
  const int kvh = blockIdx.x - b * hkv;
  const int h0 = blockIdx.y * kMaxHeads;    // first head of this chunk in the group
  const int gc = min(kMaxHeads, g - h0);    // heads in this chunk
  const int z = blockIdx.z;
  const int splits = gridDim.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t q_row0 =
      (static_cast<size_t>(b) * hkv * g + static_cast<size_t>(kvh) * g + h0) * d;

  // The chunk's query heads, by cp.async with tile 0 (rows past gc zero).
  {
    const int per = 16 / static_cast<int>(sizeof(T));
    const int chunks = d / per;
    for (int i = tid; i < kMaxHeads * chunks; i += kThreads) {
      const int h = i / chunks;
      const int c = (i - h * chunks) * per;
      const bool ok = h < gc;
      cp_async16(q_s + h * re + c, q + q_row0 + static_cast<size_t>(ok ? h : 0) * d + c,
                 ok ? 16 : 0);
    }
  }
  if (tid < kMaxHeads) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.0f;
    alpha_s[tid] = 1.0f;
  }

  const long long len = cache_len[b];
  const long long lo = max(0LL, len - window);
  const long long hi = min(len, static_cast<long long>(s_len));
  const long long pstart = lo + static_cast<long long>(z) * chunk;
  const long long pend = min(hi, pstart + chunk);
  const int n_tiles = pstart < pend ? static_cast<int>((pend - pstart + kTile - 1) / kTile) : 0;

  const size_t pos_stride = static_cast<size_t>(hkv) * d;
  const size_t base = static_cast<size_t>(b) * s_len * pos_stride +
                      static_cast<size_t>(kvh) * d;
  const T* kb = k + base;
  const T* vb = v + base;

  // P . V accumulators.  bf16: mma C fragments, warp w owning dims
  // [w, w + 1) * d / 4 in n-blocks of 8 (rows gr and gr + 8 of the 16
  // heads, dims 2 tq, 2 tq + 1 of each block).  f32: heads warp + kWarps * i,
  // dim pairs lane + 32 * j.
  constexpr int kHeadsPerWarp = (G + kWarps - 1) / kWarps;
  constexpr int kPairs = kMaxDim / 64;
  constexpr int kBlocks = kMaxDim / (8 * kWarps);   // n-blocks per warp
  constexpr int kAccRows = kBf16 ? kBlocks : kHeadsPerWarp;
  constexpr int kAccCols = kBf16 ? 4 : 2 * kPairs;
  float acc[kAccRows][kAccCols];
#pragma unroll
  for (int i = 0; i < kAccRows; ++i)
#pragma unroll
    for (int j = 0; j < kAccCols; ++j) acc[i][j] = 0.0f;
  const int gr = lane >> 2;          // mma fragment row group
  const int tq = lane & 3;
  const int n_blocks = d / (8 * kWarps);   // this warp's n-blocks (bf16)

  const int tile_r0 = tid / (d / (16 / static_cast<int>(sizeof(T))));
  const int tile_c0 = tid - tile_r0 * (d / (16 / static_cast<int>(sizeof(T))));
  // Both stages in flight from the start: q and tile 0, then tile 1.
  if (n_tiles > 0) load_tile(stage_k[0], stage_v[0], kb, vb, pos_stride, pstart, pend, pstart,
                             d, tile_r0, tile_c0);
  cp_async_commit();
  if (n_tiles > 1) {
    load_tile(stage_k[1], stage_v[1], kb, vb, pos_stride, pstart + kTile, pend, pstart, d,
              tile_r0, tile_c0);
    cp_async_commit();
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    const long long p0 = pstart + static_cast<long long>(t) * kTile;
    if (t + 1 < n_tiles) {
      cp_async_wait_one();     // tile t landed; tile t + 1 may still be in flight
    } else {
      cp_async_wait_all();
    }
    __syncthreads();
    const T* k_s = stage_k[st];
    const T* v_s = stage_v[st];

    // 1. Scores of the tile into s_s[head][position].
    if constexpr (kBf16) {
      // Warp w: positions 8w .. 8w + 7 for all 16 (padded) heads.
      // Two accumulator chains (even and odd k-steps; d is a multiple of 32).
      float c2[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
      const T* qa = q_s + gr * re + 2 * tq;
      const T* kr = k_s + (warp * 8 + gr) * re + 2 * tq;
#pragma unroll 4
      for (int k0 = 0; k0 < d; k0 += 16) {
        uint32_t a[4], bb[2];
        a[0] = *reinterpret_cast<const uint32_t*>(qa + k0);
        a[1] = *reinterpret_cast<const uint32_t*>(qa + 8 * re + k0);
        a[2] = *reinterpret_cast<const uint32_t*>(qa + k0 + 8);
        a[3] = *reinterpret_cast<const uint32_t*>(qa + 8 * re + k0 + 8);
        bb[0] = *reinterpret_cast<const uint32_t*>(kr + k0);
        bb[1] = *reinterpret_cast<const uint32_t*>(kr + k0 + 8);
        mma_bf16(c2[(k0 >> 4) & 1], a, bb);
      }
      float c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) c[i] = c2[0][i] + c2[1][i];
      const int col = warp * 8 + 2 * tq;
      s_s[gr * kSStride + col] = c[0] * scale;
      s_s[gr * kSStride + col + 1] = c[1] * scale;
      s_s[(gr + 8) * kSStride + col] = c[2] * scale;
      s_s[(gr + 8) * kSStride + col + 1] = c[3] * scale;
    } else {
      // Lane = position; warp w: heads w, w + 4, ...  The K row is read
      // once per float4 for all of the warp's heads.
      float sc[kHeadsPerWarp];
#pragma unroll
      for (int i = 0; i < kHeadsPerWarp; ++i) sc[i] = 0.0f;
      const float* kr = reinterpret_cast<const float*>(k_s) + lane * re;
      const float* qf = reinterpret_cast<const float*>(q_s);
      for (int e = 0; e < d; e += 4) {
        const float4 kv = *reinterpret_cast<const float4*>(kr + e);
#pragma unroll
        for (int i = 0; i < kHeadsPerWarp; ++i) {
          const int h = warp + kWarps * i;
          if (h < gc) {
            const float4 qv = *reinterpret_cast<const float4*>(qf + h * re + e);
            sc[i] = fmaf(qv.x, kv.x, sc[i]);
            sc[i] = fmaf(qv.y, kv.y, sc[i]);
            sc[i] = fmaf(qv.z, kv.z, sc[i]);
            sc[i] = fmaf(qv.w, kv.w, sc[i]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kHeadsPerWarp; ++i) {
        const int h = warp + kWarps * i;
        if (h < gc) s_s[h * kSStride + lane] = sc[i] * scale;
      }
    }
    __syncthreads();

    // 2. Online softmax, one max and one sum per tile and head: the 8 lanes
    //    of head tid / 8 take 4 positions each, so all heads reduce at once
    //    in 3 shuffle steps; p replaces the score.
    {
      const int hh = tid >> 3;
      const int c4 = (tid & 7) * 4;
      float sv[4], tmax = kMinusInf;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        sv[i] = s_s[hh * kSStride + c4 + i];
        if (p0 + c4 + i < pend) tmax = fmaxf(tmax, sv[i]);
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
      const float m_old = m_s[hh];
      const float m_new = fmaxf(m_old, tmax);
      float sum = 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = p0 + c4 + i < pend ? clipped_exp(sv[i] - m_new) : 0.0f;
        sum += p;
        sv[i] = p;
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (hh < gc) {
#pragma unroll
        for (int i = 0; i < 4; ++i) s_s[hh * kSStride + c4 + i] = sv[i];
        if ((tid & 7) == 0) {
          const float alpha = clipped_exp(m_old - m_new);
          alpha_s[hh] = alpha;
          l_s[hh] = l_s[hh] * alpha + sum;
          m_s[hh] = m_new;
        }
      }
    }
    __syncthreads();

    // 3. acc = acc * alpha + P . V.
    if constexpr (kBf16) {
      // Tensor cores: A = P (16 heads x 16 positions a k-step) split into
      // bf16 hi + lo (p = hi + lo to ~2^-17), B = V by ldmatrix.trans.  P
      // and V are zero past the tile's valid positions.
      const float a_lo = alpha_s[gr], a_hi = alpha_s[gr + 8];
#pragma unroll
      for (int nb = 0; nb < kBlocks; ++nb) {
        acc[nb][0] *= a_lo;
        acc[nb][1] *= a_lo;
        acc[nb][2] *= a_hi;
        acc[nb][3] *= a_hi;
      }
#pragma unroll
      for (int k0 = 0; k0 < kTile; k0 += 16) {
        uint32_t ahi[4], alo[4];
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const float* pr = s_s + (gr + 8 * (f & 1)) * kSStride + k0 + 2 * tq + 8 * (f >> 1);
          const __nv_bfloat162 hi = __floats2bfloat162_rn(pr[0], pr[1]);
          const __nv_bfloat162 lo = __floats2bfloat162_rn(pr[0] - __low2float(hi),
                                                          pr[1] - __high2float(hi));
          ahi[f] = *reinterpret_cast<const uint32_t*>(&hi);
          alo[f] = *reinterpret_cast<const uint32_t*>(&lo);
        }
        // ldmatrix.x4.trans: lanes 8m .. 8m + 7 address rows k0 + (m & 1) * 8
        // + (lane & 7) at the n-block's dims + (m >> 1) * 8.
        const T* vrow = v_s + (k0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * re +
                        warp * (d / kWarps) + (lane >> 4) * 8;
#pragma unroll
        for (int nb = 0; nb < kBlocks; nb += 2) {
          if (nb < n_blocks) {
            uint32_t b[4];
            if (nb + 1 < n_blocks) {
              ldmatrix_x4_trans(b, vrow + nb * 8);
            } else {
              ldmatrix_x2_trans(b, vrow + nb * 8);
            }
            mma_bf16(acc[nb], ahi, b);
            mma_bf16(acc[nb], alo, b);
            if (nb + 1 < n_blocks) {
              mma_bf16(acc[nb + 1], ahi, b + 2);
              mma_bf16(acc[nb + 1], alo, b + 2);
            }
          }
        }
      }
    } else {
      const int n_valid = static_cast<int>(min(static_cast<long long>(kTile), pend - p0));
#pragma unroll
      for (int i = 0; i < kHeadsPerWarp; ++i) {
        const int h = warp + kWarps * i;
        if (h < gc) {
          const float alpha = alpha_s[h];
#pragma unroll
          for (int j = 0; j < kAccCols; ++j) acc[i][j] *= alpha;
        }
      }
      for (int r = 0; r < n_valid; ++r) {
        float2 vv[kPairs];
#pragma unroll
        for (int j = 0; j < kPairs; ++j) {
          const int e = 2 * (lane + 32 * j);
          vv[j] = e < d ? *reinterpret_cast<const float2*>(v_s + r * re + e)
                        : make_float2(0.0f, 0.0f);
        }
#pragma unroll
        for (int i = 0; i < kHeadsPerWarp; ++i) {
          const int h = warp + kWarps * i;
          if (h < gc) {
            const float p = s_s[h * kSStride + r];
#pragma unroll
            for (int j = 0; j < kPairs; ++j) {
              if (64 * j < d) {      // the warp's pairs in this group hold a dim
                acc[i][2 * j] = fmaf(p, vv[j].x, acc[i][2 * j]);
                acc[i][2 * j + 1] = fmaf(p, vv[j].y, acc[i][2 * j + 1]);
              }
            }
          }
        }
      }
    }
    __syncthreads();   // every thread is done with this stage and with s_s
    if (t + 2 < n_tiles) {
      load_tile(stage_k[st], stage_v[st], kb, vb, pos_stride, p0 + 2 * kTile, pend, pstart, d,
                tile_r0, tile_c0);
      cp_async_commit();
    }
  }

  cp_async_wait_all();   // a split with no position still staged q

  // Partial state of this split: acc (rows, splits, d), (m, l) (rows, splits, 2).
  const size_t row0 = static_cast<size_t>(b) * hkv * g + static_cast<size_t>(kvh) * g + h0;
  if constexpr (kBf16) {
#pragma unroll
    for (int nb = 0; nb < kBlocks; ++nb) {
      if (nb < n_blocks) {
        const int e = warp * (d / kWarps) + nb * 8 + 2 * tq;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int h = gr + 8 * half;
          if (h < gc)
            *reinterpret_cast<float2*>(part_acc + ((row0 + h) * splits + z) * d + e) =
                make_float2(acc[nb][2 * half], acc[nb][2 * half + 1]);
        }
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < kHeadsPerWarp; ++i) {
      const int h = warp + kWarps * i;
      if (h < gc) {
        float* dst = part_acc + ((row0 + h) * splits + z) * d;
#pragma unroll
        for (int j = 0; j < kPairs; ++j) {
          const int e = 2 * (lane + 32 * j);
          if (e < d) *reinterpret_cast<float2*>(dst + e) = make_float2(acc[i][2 * j], acc[i][2 * j + 1]);
        }
      }
    }
  }
  if (tid < gc) {
    float* ml = part_ml + ((row0 + tid) * splits + z) * 2;
    ml[0] = m_s[tid];
    ml[1] = l_s[tid];
  }
}

// One block per query row, one thread per dim: the thread's split
// accumulators are loaded (up to kMergeBatch at a time) while the row's
// (m, l) of every split is staged in shared memory, then the splits are
// summed in order.
template <typename T>
__global__ void swa_merge_kernel(const float* __restrict__ part_acc,
                                 const float* __restrict__ part_ml, int splits, int d,
                                 T* __restrict__ out) {
  extern __shared__ float f_s[];      // [splits] m, then the weights f; [splits] l
  const size_t row = blockIdx.x;
  const int e = threadIdx.x;
  const float* ml = part_ml + row * splits * 2;
  const float* acc = part_acc + row * splits * d + e;
  float a[kMergeBatch];
#pragma unroll
  for (int z = 0; z < kMergeBatch; ++z)
    a[z] = z < splits ? acc[static_cast<size_t>(z) * d] : 0.0f;
  float* l_s = f_s + splits;
  for (int z = e; z < splits; z += blockDim.x) {
    f_s[z] = ml[2 * z];
    l_s[z] = ml[2 * z + 1];
  }
  __syncthreads();
  float mx = kNegInf;
  for (int z = 0; z < splits; ++z) mx = fmaxf(mx, f_s[z]);
  __syncthreads();
  for (int z = e; z < splits; z += blockDim.x) f_s[z] = clipped_exp(f_s[z] - mx);
  __syncthreads();
  float den = 0.0f, num = 0.0f;
  for (int z0 = 0; z0 < splits; z0 += kMergeBatch) {
    if (z0 > 0) {
#pragma unroll
      for (int z = 0; z < kMergeBatch; ++z)
        a[z] = z0 + z < splits ? acc[static_cast<size_t>(z0 + z) * d] : 0.0f;
    }
#pragma unroll
    for (int z = 0; z < kMergeBatch; ++z) {
      if (z0 + z < splits) {
        den += l_s[z0 + z] * f_s[z0 + z];
        num += a[z] * f_s[z0 + z];
      }
    }
  }
  store(out + row * d + e, num / fmaxf(den, 1e-20f));
}

template <typename T, int G>
cudaError_t launch(const void* q, const void* k, const void* v, const void* cache_len,
                   int batch, int s_len, int hkv, int g, int d, long long window,
                   long long chunk, int splits, float scale, float* part_acc,
                   float* part_ml, void* out, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(d);
  cudaError_t rc = cudaFuncSetAttribute(swa_split_kernel<T, G>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        static_cast<int>(smem));
  if (rc != cudaSuccess) return rc;
  const dim3 grid(static_cast<unsigned>(batch * hkv),
                  static_cast<unsigned>((g + kMaxHeads - 1) / kMaxHeads),
                  static_cast<unsigned>(splits));
  swa_split_kernel<T, G><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int32_t*>(cache_len), s_len, hkv, g, d, window, chunk, scale,
      part_acc, part_ml);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return rc;
  swa_merge_kernel<T><<<static_cast<unsigned>(batch * hkv * g), d, 2 * splits * sizeof(float),
                        stream>>>(part_acc, part_ml, splits, d, static_cast<T*>(out));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, const void* cache_len,
                     int batch, int s_len, int hkv, int g, int d, long long window,
                     long long chunk, int splits, float scale, float* part_acc,
                     float* part_ml, void* out, cudaStream_t s) {
  if (g <= 4)
    return launch<T, 4>(q, k, v, cache_len, batch, s_len, hkv, g, d, window, chunk, splits,
                        scale, part_acc, part_ml, out, s);
  if (g <= 8)
    return launch<T, 8>(q, k, v, cache_len, batch, s_len, hkv, g, d, window, chunk, splits,
                        scale, part_acc, part_ml, out, s);
  return launch<T, kMaxHeads>(q, k, v, cache_len, batch, s_len, hkv, g, d, window, chunk,
                              splits, scale, part_acc, part_ml, out, s);
}

}  // namespace

extern "C" {

// q (batch, hkv * g, d), k / v (batch, s_len, hkv, d), all f32 (bf16 == 0)
// or all bf16 (bf16 == 1), k / v 16-byte aligned; cache_len (batch,) int32;
// out like q.  splits * chunk must cover min(s_len, window), chunk a
// multiple of 32 (swa_attention.plan).  part_acc (batch * hkv * g, splits,
// d) and part_ml (batch * hkv * g, splits, 2) f32 scratch.  Two launches on
// `stream`: the splits, then the merge.  Returns the cudaError_t (0 on
// success).
int swa_decode(const void* q, const void* k, const void* v, const void* cache_len,
               int batch, int s_len, int hkv, int g, int d, long long window,
               long long chunk, int splits, float scale, int bf16, void* part_acc,
               void* part_ml, void* out, void* stream) {
  if (batch < 1 || s_len < 1 || hkv < 1 || g < 1 || window < 1 || d < 32 ||
      d > kMaxDim || d % 32 != 0 || splits < 1 || splits > kMaxSplits || chunk < 1 ||
      chunk % kTile != 0 ||
      static_cast<long long>(splits) * chunk < (window < s_len ? window : s_len) ||
      static_cast<long long>(batch) * hkv > 0x7fffffffLL ||
      (g + kMaxHeads - 1) / kMaxHeads > 65535 ||
      reinterpret_cast<uintptr_t>(q) % 16 != 0 || reinterpret_cast<uintptr_t>(k) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(v) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  const cudaError_t rc =
      bf16 ? dispatch<__nv_bfloat16>(q, k, v, cache_len, batch, s_len, hkv, g, d, window,
                                     chunk, splits, scale, pa, pm, out, s)
           : dispatch<float>(q, k, v, cache_len, batch, s_len, hkv, g, d, window, chunk,
                             splits, scale, pa, pm, out, s);
  return static_cast<int>(rc);
}

const char* swa_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
