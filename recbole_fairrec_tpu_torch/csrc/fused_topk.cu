// Fused full-catalog scoring + running top-k' for Hopper (sm_90a).
//
// Replaces the TPU kernel recbole_fairrec_tpu/ops/pallas/fused_topk.py
// (fused_topk_scores -> _merge_topk_kernel). For every user row b it returns
// the k' best items of U[b] . T^T, ordered by (score descending, item index
// ascending), without writing the [B, I] score matrix to device memory.
// Item 0 ([PAD]) is never selected; a slot left without an item (k' larger
// than the catalog) holds (-inf, 0).
//
// What bounds it on an H100. At the serving shapes (B = 6144, I = 3630,
// d = 64) the products are 2*B*I*d = 2.9 GFLOP of plain f32 FMA on the CUDA
// cores (67 TFLOP/s non-tensor f32 on the H100 SXM -> ~43 us), while the
// inputs are 2.5 MB and the output B*k'*8 bytes (a few us at 3.35 TB/s).
// The f32 operations bound it, not the bytes. Tensor cores are ruled out:
// TF32 keeps ~10 mantissa bits and reorders near-tied items, and the ranking
// contract is exact f32 (the JAX call asks for precision="highest").
// In practice the selection costs more than the products: k' is k + the
// longest history + 1 (~170 at ml-1M scale), so about 5% of all items end in
// some row's top-k', and the early tiles bring many entries.
//
// Design.
//  * A block of WARPS warps owns WARPS * W users and walks the whole item
//    axis itself, tile by tile; the TPU kernel's sequential item grid axis
//    becomes this loop, its parallel user axis the grid.
//  * Item tiles (kTile = 64 rows of T) are copied into shared memory with
//    cp.async into a double buffer: the next tile is in flight while the
//    current one is scored. Rows are padded (d + 4 floats) so the float4
//    reads of 8 lanes cover all 32 banks. This is the only block-wide
//    synchronisation: one barrier per tile.
//  * Each warp scores the tile for its own W users (lane l takes items l
//    and l + 32) and selects for them alone, with __syncwarp only:
//    - a running top-K buffer per user in shared memory (K = k' rounded up
//      to a power of two), sorted best-first;
//    - scores that beat the user's current k'-th entry are appended to its
//      candidate list (C = max(256, K) entries) at ballot-computed positions;
//    - when the list could overflow on the next tile, or after the last
//      tile (so about once per C appended entries: a merge costs ~K log K,
//      and at large K it must not run every few tiles), the candidates
//      (padded to S, the next power of two of their count) are
//      bitonic-sorted best-first, folded into the buffer with
//      buf[K-1-j] = best(buf[K-1-j], cand[j]) — the first step of a bitonic
//      merge, which leaves a bitonic sequence holding the top K of both —
//      and the buffer is restored with log2(K) half-cleaner stages.
//  * The order key (score desc, index asc) is a strict total order, so the
//    result equals a stable descending sort, the plain version's order, and
//    the TPU kernel's first-occurrence tie rule.
//  * Products are explicit fmaf in d order: plain f32, no TF32.
//  * VEC (d % 4 == 0 and T 16-byte aligned) copies 16 bytes per cp.async and
//    reads float4; otherwise 4-byte copies and scalar reads.
//
// C interface (ctypes, see ops/fused_topk.py):
//   int fused_topk_max_smem()  -> opt-in shared memory per block, bytes
//   int fused_topk_launch(U, T, out_scores, out_idx, B, I, d, k, K, upb, vec,
//                         smem_bytes, stream) -> cudaGetLastError() code
//   upb (users per block) 8, 4, 2, 1 -> (WARPS, W) = (4, 2), (4, 1), (2, 1), (1, 1)

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kTile = 64;       // items per tile
constexpr int kPerLane = kTile / 32;
constexpr int kCandMin = 256;   // candidate list entries per user, at least
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool better(float s1, int i1, float s2, int i2) {
  return s1 > s2 || (s1 == s2 && i1 < i2);
}

__device__ __forceinline__ void swap_entries(float* s, int* ix, int a, int b) {
  const float ts = s[a];
  s[a] = s[b];
  s[b] = ts;
  const int ti = ix[a];
  ix[a] = ix[b];
  ix[b] = ti;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Issue the copies of T[t0 : t0+kTile, :] into dst (rows of tstride floats).
// Rows past the catalogue repeat row I-1; their scores are never selected.
template <bool VEC, int THREADS>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ T, int t0,
                                          int I, int d, int tstride, int tid) {
  const int per_row = VEC ? (d >> 2) : d;  // copy units per row
  const int width = VEC ? 4 : 1;           // floats per copy unit
  int r = tid / per_row;
  int c = tid - r * per_row;
  const int dr = THREADS / per_row;
  const int dc = THREADS - dr * per_row;
  for (int e = tid; e < kTile * per_row; e += THREADS) {
    const int item = min(t0 + r, I - 1);
    const float* src = T + static_cast<size_t>(item) * d + c * width;
    float* out = dst + r * tstride + c * width;
    if (VEC) {
      cp_async16(out, src);
    } else {
      cp_async4(out, src);
    }
    c += dc;
    r += dr;
    if (c >= per_row) {
      c -= per_row;
      ++r;
    }
  }
}

// Merge one user's n candidates (cs/ci, unsorted) into its sorted top-K
// buffer (bs/bi). Called by the whole warp.
__device__ void warp_merge(float* cs, int* ci, float* bs, int* bi, int n, int K, int lane) {
  const float NEG_INF = -__int_as_float(0x7f800000);
  int S = 1;
  while (S < n) S <<= 1;
  for (int j = n + lane; j < S; j += 32) {
    cs[j] = NEG_INF;
    ci[j] = INT_MAX;
  }
  __syncwarp();
  // bitonic sort of the S candidates, best first
  for (int size = 2; size <= S; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int q = lane; q < (S >> 1); q += 32) {
        const int i = q + (q & ~(stride - 1));
        const int j = i + stride;
        const bool swap = ((i & size) == 0) ? better(cs[j], ci[j], cs[i], ci[i])
                                            : better(cs[i], ci[i], cs[j], ci[j]);
        if (swap) swap_entries(cs, ci, i, j);
      }
      __syncwarp();
    }
  }
  // fold: buf[K-1-j] = best(buf[K-1-j], cand[j]) -> bitonic, holds the top K
  for (int j = lane; j < n && j < K; j += 32) {
    const int b = K - 1 - j;
    if (better(cs[j], ci[j], bs[b], bi[b])) {
      bs[b] = cs[j];
      bi[b] = ci[j];
    }
  }
  __syncwarp();
  // bitonic merge back to best-first order
  for (int stride = K >> 1; stride > 0; stride >>= 1) {
    for (int q = lane; q < (K >> 1); q += 32) {
      const int i = q + (q & ~(stride - 1));
      const int j = i + stride;
      if (better(bs[j], bi[j], bs[i], bi[i])) swap_entries(bs, bi, i, j);
    }
    __syncwarp();
  }
}

template <int WARPS, int W, bool VEC>
__global__ void __launch_bounds__(WARPS * 32)
fused_topk_kernel(const float* __restrict__ U, const float* __restrict__ T,
                  float* __restrict__ out_s, int* __restrict__ out_i,
                  int B, int I, int d, int k, int K) {
  constexpr int kThreads = WARPS * 32;
  constexpr int UPB = WARPS * W;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // layout: tiles[2][kTile][tstride] | users[UPB][d] | buf_s[UPB][K] |
  //         buf_i[UPB][K] | cand_s[UPB][C] | cand_i[UPB][C]
  const int tstride = VEC ? d + 4 : d + 1;
  const int C = K > kCandMin ? K : kCandMin;
  float* tiles = reinterpret_cast<float*>(smem_raw);
  float* users = tiles + 2 * kTile * tstride;
  float* buf_s = users + UPB * d;
  int* buf_i = reinterpret_cast<int*>(buf_s + UPB * K);
  float* cand_s = reinterpret_cast<float*>(buf_i + UPB * K);
  int* cand_i = reinterpret_cast<int*>(cand_s + UPB * C);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int b0 = blockIdx.x * UPB;
  const float NEG_INF = -__int_as_float(0x7f800000);

  load_tile<VEC, kThreads>(tiles, T, 0, I, d, tstride, tid);
  cp_async_commit();
  for (int e = tid; e < UPB * d; e += kThreads) {
    const int u = e / d;
    const int c = e - u * d;
    users[e] = (b0 + u < B) ? U[static_cast<size_t>(b0 + u) * d + c] : 0.0f;
  }
  for (int e = tid; e < UPB * K; e += kThreads) {
    buf_s[e] = NEG_INF;
    buf_i[e] = INT_MAX;
  }

  int cnt[W];  // candidate counts of this warp's users (warp-uniform)
#pragma unroll
  for (int w = 0; w < W; ++w) cnt[w] = 0;

  for (int t0 = 0, cur = 0; t0 < I; t0 += kTile, cur ^= 1) {
    // the current tile has landed for every thread, and every warp is done
    // scoring the previous tile, whose buffer the next copies overwrite
    cp_async_wait_all();
    __syncthreads();
    if (t0 + kTile < I) load_tile<VEC, kThreads>(tiles + (cur ^ 1) * kTile * tstride, T,
                                                 t0 + kTile, I, d, tstride, tid);
    cp_async_commit();

    const float* tile = tiles + cur * kTile * tstride;
    float acc[W][kPerLane];
#pragma unroll
    for (int w = 0; w < W; ++w)
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) acc[w][j] = 0.0f;
    if (VEC) {
      for (int c = 0; c < d; c += 4) {
        float4 uv[W];
#pragma unroll
        for (int w = 0; w < W; ++w)
          uv[w] = *reinterpret_cast<const float4*>(users + (warp * W + w) * d + c);
#pragma unroll
        for (int j = 0; j < kPerLane; ++j) {
          const float4 x = *reinterpret_cast<const float4*>(tile + (lane + 32 * j) * tstride + c);
#pragma unroll
          for (int w = 0; w < W; ++w) {
            acc[w][j] = fmaf(x.x, uv[w].x, acc[w][j]);
            acc[w][j] = fmaf(x.y, uv[w].y, acc[w][j]);
            acc[w][j] = fmaf(x.z, uv[w].z, acc[w][j]);
            acc[w][j] = fmaf(x.w, uv[w].w, acc[w][j]);
          }
        }
      }
    } else {
      for (int c = 0; c < d; ++c) {
#pragma unroll
        for (int j = 0; j < kPerLane; ++j) {
          const float x = tile[(lane + 32 * j) * tstride + c];
#pragma unroll
          for (int w = 0; w < W; ++w)
            acc[w][j] = fmaf(x, users[(warp * W + w) * d + c], acc[w][j]);
        }
      }
    }

    const bool last = t0 + kTile >= I;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const int u = warp * W + w;
      if (b0 + u >= B) continue;  // warp-uniform
      float* bs = buf_s + u * K;
      int* bi = buf_i + u * K;
      float* cs = cand_s + u * C;
      int* ci = cand_i + u * C;
      const float thr_s = bs[k - 1];
      const int thr_i = bi[k - 1];
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {
        const int item = t0 + lane + 32 * j;
        // a score no better than the current k'-th entry can never enter
        const bool pass = item > 0 && item < I && better(acc[w][j], item, thr_s, thr_i);
        const unsigned mask = __ballot_sync(kFull, pass);
        if (pass) {
          const int pos = cnt[w] + __popc(mask & ((1u << lane) - 1u));
          cs[pos] = acc[w][j];
          ci[pos] = item;
        }
        cnt[w] += __popc(mask);
      }
      __syncwarp();
      if (cnt[w] > 0 && (last || cnt[w] > C - kTile)) {
        warp_merge(cs, ci, bs, bi, cnt[w], K, lane);
        cnt[w] = 0;
      }
    }
  }

#pragma unroll
  for (int w = 0; w < W; ++w) {
    const int u = warp * W + w;
    if (b0 + u >= B) continue;
    for (int slot = lane; slot < k; slot += 32) {
      const float s = buf_s[u * K + slot];
      const size_t o = static_cast<size_t>(b0 + u) * k + slot;
      out_s[o] = s;
      out_i[o] = (s == NEG_INF) ? 0 : buf_i[u * K + slot];
    }
  }
}

template <int WARPS, int W, bool VEC>
cudaError_t launch(const float* U, const float* T, float* out_s, int* out_i, int B, int I,
                   int d, int k, int K, size_t smem, cudaStream_t stream) {
  auto kernel = fused_topk_kernel<WARPS, W, VEC>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int upb = WARPS * W;
  const int grid = (B + upb - 1) / upb;
  kernel<<<grid, WARPS * 32, smem, stream>>>(U, T, out_s, out_i, B, I, d, k, K);
  return cudaGetLastError();
}

template <bool VEC>
cudaError_t launch_upb(int upb, const float* U, const float* T, float* out_s, int* out_i, int B,
                       int I, int d, int k, int K, size_t smem, cudaStream_t st) {
  switch (upb) {
    case 8: return launch<4, 2, VEC>(U, T, out_s, out_i, B, I, d, k, K, smem, st);
    case 4: return launch<4, 1, VEC>(U, T, out_s, out_i, B, I, d, k, K, smem, st);
    case 2: return launch<2, 1, VEC>(U, T, out_s, out_i, B, I, d, k, K, smem, st);
    case 1: return launch<1, 1, VEC>(U, T, out_s, out_i, B, I, d, k, K, smem, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int fused_topk_max_smem() {
  int dev = 0;
  int bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
      cudaSuccess)
    return -1;
  return bytes;
}

int fused_topk_launch(const void* U, const void* T, void* out_s, void* out_i, int B, int I,
                      int d, int k, int K, int upb, int vec, long long smem, void* stream) {
  if (B <= 0 || I <= 0 || d <= 0 || k <= 0 || K < k || (K & (K - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec && ((d & 3) != 0 || (reinterpret_cast<uintptr_t>(T) & 15) != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* u = static_cast<const float*>(U);
  const auto* t = static_cast<const float*>(T);
  auto* os = static_cast<float*>(out_s);
  auto* oi = static_cast<int*>(out_i);
  auto st = static_cast<cudaStream_t>(stream);
  const size_t sm = static_cast<size_t>(smem);
  const cudaError_t err = vec ? launch_upb<true>(upb, u, t, os, oi, B, I, d, k, K, sm, st)
                              : launch_upb<false>(upb, u, t, os, oi, B, I, d, k, K, sm, st);
  return static_cast<int>(err);
}

}  // extern "C"
