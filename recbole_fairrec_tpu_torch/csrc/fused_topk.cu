// Fused full-catalog scoring + top-k' for Hopper (sm_90a).
//
// Replaces the TPU kernel recbole_fairrec_tpu/ops/pallas/fused_topk.py:98
// (fused_topk_scores; pallas_call at :134, kernel body _merge_topk_kernel at
// :37). For every user row b it returns the k' best items of U[b] . T^T,
// ordered by (score descending, item index ascending), the Pallas kernel's
// and lax.top_k's first-occurrence tie rule. Item 0 ([PAD]) is never
// selected; a slot left without an item (k' larger than the catalog) holds
// (-inf, 0). Where k' is small against the chunk, the [B, I] score matrix is
// never written to device memory.
//
// Shard mode (the local stage of the item-sharded top-k,
// recbole_fairrec_tpu_torch/parallel/eval.py): T is rows [col_offset,
// col_offset + I) of a larger table; mask_pad = 0 leaves its row 0 (not the
// catalog's PAD) selectable, and col_offset is added to the index of every
// selected item. Slots without an item still hold (-inf, 0). The default
// call (col_offset 0, mask_pad 1) is the kernel above, unchanged.
//
// What bounds it on an H100. At the serving shape (B 6144, I 3630, d 64,
// k' 173) the products are 2*B*I*d = 2.855 GFLOP of plain f32 FMA on the
// CUDA cores: 42.6 us at the 67 TFLOP/s non-tensor f32 peak. The bytes
// (2.5 MB in, 8.5 MB out) take ~3 us at 3.35 TB/s. So f32 FMA bounds it.
// Tensor cores are ruled out: TF32 keeps ~10 mantissa bits and reorders
// near-tied items, and the ranking contract is exact f32 (the JAX call asks
// for precision="highest").
//
// Design: two kernels per call, on one stream.
//  1. score_select_kernel, grid (ceil(B/64), S), 256 threads. A block owns
//     kBM = 64 users and one chunk of the item axis (S chunks of `chunk`
//     items, a multiple of 256, at most 512).
//     * Products apart from selection: the block computes its whole
//       [64 x chunk] score block into shared memory before it selects
//       anything, as a register-blocked SGEMM. A warp covers 32 users x 64
//       items, its lanes 4 x 8 of them, and a thread keeps 8 users x 8
//       items = 64 accumulators: per 4-deep step 8 float4 of U and 8 of T
//       for 256 FMA. U's 64 rows (loaded once per block) and T's
//       [256 items x 16 depth] tiles arrive by cp.async, T through a
//       3-stage ring, with one block barrier per tile and no selection
//       between tiles. T then passes through L2 ceil(B/64) times (96 x
//       0.93 MB at the serving shape), not once per 8 users.
//     * Each score becomes a 32-bit key whose unsigned order is the float
//       order (-0.0 folded into +0.0 first: the float compare calls them
//       equal, the bits would not). Item 0 gets the key of -inf.
//     * Selection linear in the scores, without atomics or sorting: each
//       warp takes its 8 users 2 at a time, a chunk's keys in 16 registers
//       a lane. A threshold is built bit by bit from the top (one compare
//       per key and one warp reduction per bit) and the search stops as
//       soon as between k' and k' + kSlack keys lie at or above it; the
//       chunk's list then holds exactly those keys, in item order. Where
//       ties never let a count fall in that window, the threshold is the
//       k'-th key, and keys equal to it are taken in item order until k'
//       are found. k' = 1 is a warp arg-max. Unused list slots hold a key
//       of 0, below every real key; where k' >= the chunk's items the list
//       is the whole chunk. The threshold is also stored: the chunk alone
//       has k' keys at or above it, so it bounds the user's k'-th key over
//       the catalog from below.
//  2. merge_kernel, one team per user: a warp where k' <= 512, else the
//     whole 256-thread block. The user's S lists lie end to end in item
//     order; the team copies their keys into shared memory (cp.async, where
//     they fit) and finds the k'-th key by a binary search on the key value
//     from the largest stored bound to the largest key (an arg-max for
//     k' = 1). It compacts the winners (ties again in item order) and sorts
//     only those: a bitonic sort of 64-bit (~key, list position) words held
//     in registers (R per thread), exchanging across lanes with shuffles and
//     across warps through padded shared memory. List positions follow item
//     order, so equal scores come out by ascending index. It then reads the
//     winners' items and writes the outputs, -inf slots with index 0.
//  * Cost per score is a fixed number of compares (a few tens of search
//    steps at most, usually about ten), not log^2 K compare-exchanges as a
//    merge of sorted lists costs, and no contended shared atomics.
//  * Filling the card: ceil(B/64) blocks alone are 96 at the serving shape,
//    fewer than the 132 SMs. The item axis is split into S chunks so the
//    grid holds at least 2 blocks per SM (S 8 there: 768 blocks of
//    64 x 512).
//  * Scratch (allocated by the wrapper with torch.empty; the kernels
//    allocate nothing): B * S * list_len(k', chunk) entries of 8 bytes
//    (item, key), then B * S 4-byte bounds. 81 MB at the serving shape,
//    201 MB at k' 2048 (I 3630), 805 MB at k' 4096 (I 16384, where every
//    list is a whole chunk).
//  * Products are explicit fmaf: plain f32, no TF32.
//  * VEC (d % 4 == 0, U and T 16-byte aligned) copies U and T with 16-byte
//    cp.async; otherwise 4-byte copies. Depth past d, users past B and items
//    past the chunk are zero-filled.
//
// C interface (ctypes, see ops/fused_topk.py):
//   int fused_topk_max_smem()  -> opt-in shared memory per block, bytes
//   int fused_topk_launch(U, T, scratch, out_s, out_i, B, I, d, k, chunk, S,
//                         n, Kp, team, keys_in_smem, vec, smem1, smem2,
//                         col_offset, mask_pad, stream)
//     -> cudaGetLastError() code of the first launch that failed, else 0

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kBM = 64;        // users per block
constexpr int kBN = 256;       // items per T tile
constexpr int kBK = 16;        // depth per T tile
constexpr int kStages = 3;     // T tiles in flight
constexpr int kThreads = 256;  // threads per block, both kernels
constexpr int kWarps = kThreads / 32;
constexpr int kTM = 8;             // users per thread
constexpr int kTN = 8;             // items per thread
constexpr int kTStride = kBK + 4;  // floats per T tile row: rows r..r+7 hit 8 bank groups
constexpr int kKeyPad = 8;         // key rows are chunk + 8 words: 4 rows x 8 columns, 32 banks
constexpr int kMaxChunk = 512;     // items per chunk, at most: its keys fit 16 registers a lane
constexpr int kKeysPerLane = kMaxChunk / 32;
constexpr int kUsersAtOnce = 2;    // users a warp selects for together
constexpr int kSlack = 32;         // keys a chunk's list may hold beyond k' (for k' > 1)
// static shared memory of merge_kernel, at most; the wrapper keeps its
// dynamic bytes within the opt-in limit less this (MERGE_STATIC_SMEM)
constexpr int kMergeStaticSmem = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNegInfKey = 0x007fffffu;  // order_key(-inf)

// warp tile 32 users x 64 items; lane (lane & 3, lane >> 2) takes users
// 4 i + (lane & 3) and items (lane >> 2) + 8 j of it
static_assert(2 * 32 == kBM && 4 * 64 == kBN && kWarps == 8, "8 warps of 32 x 64");
static_assert(kTM * 4 == 32 && kTN * 8 == 64, "thread tile is 8 users x 8 items");

// 32-bit key whose unsigned order is the float order; -0.0 maps to +0.0.
__device__ __forceinline__ unsigned order_key(float s) {
  unsigned u = __float_as_uint(s);
  if ((u << 1) == 0u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// A list entry: the item in the high word, its key in the low one.
__device__ __forceinline__ unsigned long long entry(unsigned key, int item) {
  return (static_cast<unsigned long long>(static_cast<unsigned>(item)) << 32) | key;
}

// Entries of one chunk's list: k' and up to kSlack more (k' > 1), at most
// the chunk. Slots past a list's keys hold entry(0, 0), below every key.
__host__ __device__ __forceinline__ int list_len(int k, int chunk) {
  const int len = k > 1 ? k + kSlack : k;
  return len < chunk ? len : chunk;
}

__device__ __forceinline__ float key_score(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy T[n0 : n0+kBN, k0 : k0+kBK] into a ring slot; items >= n_end and
// depth >= d are zero-filled. A thread's copies are a fixed pattern (rows
// tid / copies-per-row + a multiple of the rows per pass), unrolled, so a
// tile costs a few instructions beside its step's 1,024 FMA.
template <bool VEC>
__device__ __forceinline__ void load_t_tile(float* dst, const float* __restrict__ T, int n0,
                                            int n_end, int k0, int d, int tid) {
  constexpr int kWidth = VEC ? 4 : 1;           // floats per copy
  constexpr int kPerRow = kBK / kWidth;         // copies per row
  constexpr int kRowsPerPass = kThreads / kPerRow;
  static_assert(kThreads % kPerRow == 0 && kBN % kRowsPerPass == 0, "copy pattern");
  const int r0 = tid / kPerRow;
  const int c = tid % kPerRow * kWidth;
  const bool col_ok = k0 + c < d;
  const float* src = T + static_cast<size_t>(n0 + r0) * d + k0 + c;
  float* out = dst + r0 * kTStride + c;
#pragma unroll
  for (int q = 0; q < kBN / kRowsPerPass; ++q) {
    const bool valid = col_ok && n0 + r0 + q * kRowsPerPass < n_end;
    const float* from = valid ? src + static_cast<size_t>(q) * kRowsPerPass * d : T;
    if (VEC) {
      cp_async16(out + q * kRowsPerPass * kTStride, from, valid);
    } else {
      cp_async4(out + q * kRowsPerPass * kTStride, from, valid);
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads, 1)
score_select_kernel(const float* __restrict__ U, const float* __restrict__ T,
                    unsigned long long* __restrict__ lists, unsigned* __restrict__ bounds,
                    int B, int I, int d,
                    int k, int chunk, int mask_pad) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // layout: us[kBM][ustride] | ring[kStages][kBN][kTStride] | keys[kBM][kstride]
  const int dpad = (d + kBK - 1) / kBK * kBK;
  const int ustride = dpad + 4;
  const int kstride = chunk + kKeyPad;
  float* us = reinterpret_cast<float*>(smem_raw);
  float* ring = us + kBM * ustride;
  unsigned* keys = reinterpret_cast<unsigned*>(ring + kStages * kBN * kTStride);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int b0 = blockIdx.x * kBM;
  const int S = gridDim.y;
  const int c0 = blockIdx.y * chunk;
  const int n = min(chunk, I - c0);  // items of this chunk
  const int n_end = c0 + n;
  const int ntiles = (n + kBN - 1) / kBN;
  const int nk = dpad / kBK;
  const int nsteps = ntiles * nk;

  // ---- products: [64 users x n items] into keys ----
  // U's rows join the first copy group (zero-filled past d and past B)
  if (VEC) {
    for (int e = tid; e < kBM * (dpad / 4); e += kThreads) {
      const int m = e / (dpad / 4);
      const int c = (e % (dpad / 4)) * 4;
      const bool valid = b0 + m < B && c < d;
      cp_async16(us + m * ustride + c, valid ? U + static_cast<size_t>(b0 + m) * d + c : U, valid);
    }
  } else {
    for (int e = tid; e < kBM * dpad; e += kThreads) {
      const int m = e / dpad;
      const int c = e % dpad;
      const bool valid = b0 + m < B && c < d;
      cp_async4(us + m * ustride + c, valid ? U + static_cast<size_t>(b0 + m) * d + c : U, valid);
    }
  }
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nsteps) {
      const int tile = s / nk;
      load_t_tile<VEC>(ring + s * kBN * kTStride, T, c0 + tile * kBN, n_end,
                       (s - tile * nk) * kBK, d, tid);
    }
    cp_async_commit();
  }

  const int wu = (warp & 1) * 32 + (lane & 3);   // this thread's users: wu + 4 i
  const int wi = (warp >> 1) * 64 + (lane >> 2);  // its items in a tile: wi + 8 j
  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;

  int tile = 0;
  int ks = 0;
  int slot = 0;
  int ld_tile = (kStages - 1) / nk;  // the next copy: step + kStages - 1
  int ld_ks = (kStages - 1) % nk;
  for (int step = 0; step < nsteps; ++step) {
    // this step's tile has landed for every thread, and every thread is done
    // with the slot that the next copy overwrites (read in step - 1)
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (ld_tile < ntiles) {
      const int nslot = slot == 0 ? kStages - 1 : slot - 1;  // (step + kStages - 1) % kStages
      load_t_tile<VEC>(ring + nslot * kBN * kTStride, T, c0 + ld_tile * kBN, n_end,
                       ld_ks * kBK, d, tid);
    }
    cp_async_commit();
    if (++ld_ks == nk) {
      ld_ks = 0;
      ++ld_tile;
    }

    const float* ts = ring + slot * kBN * kTStride + wi * kTStride;
    const float* uw = us + wu * ustride + ks * kBK;
#pragma unroll
    for (int q = 0; q < kBK; q += 4) {
      float4 t[kTN];
#pragma unroll
      for (int j = 0; j < kTN; ++j)
        t[j] = *reinterpret_cast<const float4*>(ts + 8 * j * kTStride + q);
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const float4 u = *reinterpret_cast<const float4*>(uw + 4 * i * ustride + q);
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          acc[i][j] = fmaf(u.x, t[j].x, acc[i][j]);
          acc[i][j] = fmaf(u.y, t[j].y, acc[i][j]);
          acc[i][j] = fmaf(u.z, t[j].z, acc[i][j]);
          acc[i][j] = fmaf(u.w, t[j].w, acc[i][j]);
        }
      }
    }

    if (ks == nk - 1) {  // the tile's products are complete: store their keys
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          const int col = tile * kBN + wi + 8 * j;
          keys[(wu + 4 * i) * kstride + col] =
              (mask_pad && c0 + col == 0) ? kNegInfKey : order_key(acc[i][j]);
          acc[i][j] = 0.0f;
        }
      }
      ks = 0;
      ++tile;
    } else {
      ++ks;
    }
    slot = slot == kStages - 1 ? 0 : slot + 1;
  }
  cp_async_wait<0>();
  __syncthreads();

  // ---- selection: each warp takes its 8 users 2 at a time, keys in registers ----
  const int L = min(k, n);
  const int lmax = list_len(k, chunk);
  for (int g = 0; g < kBM / kWarps; g += kUsersAtOnce) {
    unsigned r[kUsersAtOnce][kKeysPerLane];  // r[u][t] is item c0 + lane + 32 t; 0 past n
    bool live[kUsersAtOnce];                 // warp-uniform: the user exists
#pragma unroll
    for (int u = 0; u < kUsersAtOnce; ++u) {
      const int m = warp + kWarps * (g + u);
      live[u] = b0 + m < B;
#pragma unroll
      for (int t = 0; t < kKeysPerLane; ++t)
        r[u][t] = lane + 32 * t < n ? keys[m * kstride + lane + 32 * t] : 0u;
    }
    unsigned thr[kUsersAtOnce];  // keys above thr are taken, keys equal to it by item order
    int krem[kUsersAtOnce];      // how many keys equal to thr are taken
    bool all_eq[kUsersAtOnce];   // warp-uniform: every key >= thr is taken (no tie to break)
#pragma unroll
    for (int u = 0; u < kUsersAtOnce; ++u) {
      thr[u] = 0u;  // L == n: every key (all are > 0) is taken
      krem[u] = 0;
      all_eq[u] = true;
    }
    if (L == 1) {  // arg-max: the best key, at its lowest item
#pragma unroll
      for (int u = 0; u < kUsersAtOnce; ++u) {
        unsigned best = 0u;
        int at = 0x7fffffff;
#pragma unroll
        for (int t = 0; t < kKeysPerLane; ++t) {
          if (r[u][t] > best) {
            best = r[u][t];
            at = lane + 32 * t;
          }
        }
        const unsigned top = __reduce_max_sync(kFull, best);
        const int first = __reduce_min_sync(kFull, best == top ? at : 0x7fffffff);
        if (live[u] && lane == 0) {
          const size_t base =
              (static_cast<size_t>(b0 + warp + kWarps * (g + u)) * S + blockIdx.y) * lmax;
          lists[base] = entry(top, c0 + first);
          bounds[static_cast<size_t>(b0 + warp + kWarps * (g + u)) * S + blockIdx.y] = top;
        }
      }
      continue;
    }
    if (L < n) {
      // a threshold with between L and L + kSlack keys at or above it (the
      // L-th largest key where ties allow none), bit by bit from the top;
      // the users' steps are independent, so their latencies overlap
      bool done[kUsersAtOnce];
#pragma unroll
      for (int u = 0; u < kUsersAtOnce; ++u) done[u] = !live[u];
      for (int bit = 31; bit >= 0; --bit) {
        int cnt[kUsersAtOnce];
#pragma unroll
        for (int u = 0; u < kUsersAtOnce; ++u) {
          const unsigned c = thr[u] | (1u << bit);
          int a[4] = {0, 0, 0, 0};
#pragma unroll
          for (int t = 0; t < kKeysPerLane; ++t) a[t & 3] += r[u][t] >= c ? 1 : 0;
          cnt[u] = __reduce_add_sync(kFull, (a[0] + a[1]) + (a[2] + a[3]));
        }
        bool all = true;
#pragma unroll
        for (int u = 0; u < kUsersAtOnce; ++u) {
          if (!done[u] && cnt[u] >= L) {
            thr[u] |= 1u << bit;
            done[u] = cnt[u] <= L + kSlack;  // the keys >= thr fit the list
          }
          all = all && done[u];
        }
        if (all) break;
      }
#pragma unroll
      for (int u = 0; u < kUsersAtOnce; ++u) {
        all_eq[u] = done[u];  // the search stopped inside the window
        if (all_eq[u]) continue;
        int a[4] = {0, 0, 0, 0};
#pragma unroll
        for (int t = 0; t < kKeysPerLane; ++t) a[t & 3] += r[u][t] > thr[u] ? 1 : 0;
        krem[u] = L - __reduce_add_sync(kFull, (a[0] + a[1]) + (a[2] + a[3]));
      }
    }
    // keys above thr, then keys equal to it in item order, into the list:
    // all ballots first, so the 16 slots' votes are independent; the rest of
    // the list is filled with entry(0, 0)
#pragma unroll
    for (int u = 0; u < kUsersAtOnce; ++u) {
      if (!live[u]) continue;  // warp-uniform
      const int b = b0 + warp + kWarps * (g + u);
      const size_t base = (static_cast<size_t>(b) * S + blockIdx.y) * lmax;
      unsigned vote[kKeysPerLane];
      bool take[kKeysPerLane];
      if (all_eq[u]) {  // every key >= thr (thr > 0 unless all are taken)
#pragma unroll
        for (int t = 0; t < kKeysPerLane; ++t) take[t] = r[u][t] >= thr[u] && lane + 32 * t < n;
      } else {
#pragma unroll
        for (int t = 0; t < kKeysPerLane; ++t)
          vote[t] = __ballot_sync(kFull, r[u][t] == thr[u] && lane + 32 * t < n);
        int ties = 0;
#pragma unroll
        for (int t = 0; t < kKeysPerLane; ++t) {
          take[t] = r[u][t] > thr[u] ||
                    ((vote[t] >> lane) & 1u && ties + __popc(vote[t] & lanemask_lt()) < krem[u]);
          ties += __popc(vote[t]);
        }
      }
#pragma unroll
      for (int t = 0; t < kKeysPerLane; ++t) vote[t] = __ballot_sync(kFull, take[t]);
      int pos = 0;
#pragma unroll
      for (int t = 0; t < kKeysPerLane; ++t) {
        if (take[t]) {
          const int p = pos + __popc(vote[t] & lanemask_lt());
          lists[base + p] = entry(r[u][t], c0 + lane + 32 * t);
        }
        pos += __popc(vote[t]);
      }
      for (int j = pos + lane; j < min(lmax, n); j += 32) lists[base + j] = entry(0u, 0);
      // the chunk holds at least min(k', n) keys >= thr: a lower bound on the
      // user's k'-th key over the catalogue (0 where the list is the chunk)
      if (lane == 0) bounds[static_cast<size_t>(b) * S + blockIdx.y] = thr[u];
    }
  }
}

// Word i of a team's shared buffer lives at i + i / 16: the R consecutive
// words of one thread then start in another bank for each lane.
__device__ __forceinline__ int pad_index(int i) { return i + (i >> 4); }

template <int TEAM>
__device__ __forceinline__ void team_sync() {
  if (TEAM == 32) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

// Sum of v over the team. red holds 2 x (TEAM / 32) ints; parity alternates
// between calls, so one barrier per call suffices.
template <int TEAM>
__device__ __forceinline__ int team_sum(int v, int* red, int parity, int tw, int lane) {
  v = __reduce_add_sync(kFull, v);
  if (TEAM == 32) return v;
  constexpr int kW = TEAM / 32;
  if (lane == 0) red[parity * kW + tw] = v;
  __syncthreads();
  int s = 0;
#pragma unroll
  for (int w = 0; w < kW; ++w) s += red[parity * kW + w];
  return s;
}

// Largest v over the team; red and parity as for team_sum.
template <int TEAM>
__device__ __forceinline__ unsigned team_max(unsigned v, int* red, int parity, int tw, int lane) {
  v = __reduce_max_sync(kFull, v);
  if (TEAM == 32) return v;
  constexpr int kW = TEAM / 32;
  if (lane == 0) red[parity * kW + tw] = static_cast<int>(v);
  __syncthreads();
  unsigned m = 0u;
#pragma unroll
  for (int w = 0; w < kW; ++w) m = max(m, static_cast<unsigned>(red[parity * kW + w]));
  return m;
}

// One compare-exchange step of a bitonic network for the element this
// thread holds at index i, whose partner (i ^ stride) holds o.
__device__ __forceinline__ unsigned long long bitonic_keep(unsigned long long v,
                                                           unsigned long long o, int i,
                                                           int stride, int size) {
  const bool lower = (i & stride) == 0;
  const bool up = (i & size) == 0;
  return (lower == up) ? (v < o ? v : o) : (v < o ? o : v);
}

// Ascending bitonic sort of TEAM * R words, element i = tt * R + r in v[r].
// Strides below R stay in a thread, below 32 R cross lanes by shuffles, the
// rest cross warps through buf (pad_index(TEAM * R) words of shared memory).
template <int TEAM, int R>
__device__ __forceinline__ void team_bitonic(unsigned long long (&v)[R],
                                             unsigned long long* buf, int tt) {
  constexpr int N = TEAM * R;
#pragma unroll
  for (int size = 2; size <= N; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride < R) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int p = r ^ stride;
          if (p > r) {
            const unsigned long long a = v[r];
            const unsigned long long c = v[p];
            if ((a > c) == (((tt * R + r) & size) == 0)) {
              v[r] = c;
              v[p] = a;
            }
          }
        }
      } else if (stride < 32 * R) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const unsigned long long o = __shfl_xor_sync(kFull, v[r], stride / R);
          v[r] = bitonic_keep(v[r], o, tt * R + r, stride, size);
        }
      } else {
        team_sync<TEAM>();  // the last cross-warp step's reads are done
#pragma unroll
        for (int r = 0; r < R; ++r) buf[pad_index(tt * R + r)] = v[r];
        team_sync<TEAM>();
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int i = tt * R + r;
          v[r] = bitonic_keep(v[r], buf[pad_index(i ^ stride)], i, stride, size);
        }
      }
    }
  }
}

// One team of TEAM threads (a warp, or the whole block) per user: the
// k = min(k', n) best of the user's S lists (n entries, in item order),
// sorted. Kp = TEAM * R >= k slots.
template <int TEAM, int R>
__global__ void __launch_bounds__(kThreads)
merge_kernel(const unsigned long long* __restrict__ lists, const unsigned* __restrict__ bounds,
             float* __restrict__ out_s, int* __restrict__ out_i, int B, int kout, int S,
             int per_user, int n, int keys_in_smem, int col_offset) {
  constexpr int kTeams = kThreads / TEAM;
  constexpr int kTeamWarps = TEAM / 32;
  constexpr int Kp = TEAM * R;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_red[kTeams][2 * kTeamWarps];
  __shared__ int s_warp_ties[kTeams][2][kTeamWarps];
  __shared__ int s_gt[kTeams];
  static_assert(sizeof(s_red) + sizeof(s_warp_ties) + sizeof(s_gt) <= kMergeStaticSmem,
                "merge_kernel's static shared memory outgrew kMergeStaticSmem");

  const int team = threadIdx.x / TEAM;
  const int tt = threadIdx.x % TEAM;
  const int tw = tt >> 5;  // warp within the team
  const int lane = tt & 31;
  const int b = blockIdx.x * kTeams + team;
  if (b >= B) return;  // the whole team: a warp, or a block with one user

  // per team: words[pad_index(Kp)] (u64) | keys[n], the lists' keys where they fit
  const size_t team_bytes = static_cast<size_t>(pad_index(Kp)) * 8 +
                            (keys_in_smem ? static_cast<size_t>((n + 1) & ~1) * 4 : 0);
  unsigned long long* words = reinterpret_cast<unsigned long long*>(smem_raw + team * team_bytes);
  const unsigned long long* ents = lists + static_cast<size_t>(b) * per_user;
  unsigned* copy = reinterpret_cast<unsigned*>(words + pad_index(Kp));
  if (keys_in_smem) {  // every copy in flight at once; the key is an entry's low word
    for (int e = tt; e < n; e += TEAM) cp_async4(copy + e, ents + e, true);
    cp_async_commit();
    cp_async_wait<0>();
    team_sync<TEAM>();
  }
  auto key_at = [&](int e) {
    return keys_in_smem ? copy[e] : static_cast<unsigned>(ents[e]);
  };
  const int k = min(kout, n);
  int* red = s_red[team];
  int parity = 0;
  auto count_from = [&](unsigned c) {  // keys >= c over the team
    int a[4] = {0, 0, 0, 0};
    int e = tt;
    for (; e + 3 * TEAM < n; e += 4 * TEAM) {
#pragma unroll
      for (int q = 0; q < 4; ++q) a[q] += key_at(e + q * TEAM) >= c ? 1 : 0;
    }
    for (; e < n; e += TEAM) a[0] += key_at(e) >= c ? 1 : 0;
    parity ^= 1;
    return team_sum<TEAM>((a[0] + a[1]) + (a[2] + a[3]), red, parity, tw, lane);
  };

  // the k-th largest key (none needed when k == n: every key is > 0)
  unsigned thr = 0u;
  int krem = 0;
  if (k == 1 && n > 1) {  // the best key; its first entry in item order is taken
    unsigned best = 0u;
    for (int e = tt; e < n; e += TEAM) best = max(best, key_at(e));
    parity ^= 1;
    thr = team_max<TEAM>(best, red, parity, tw, lane);
    krem = 1;
  } else if (k < n) {
    // binary search on the key value, from the chunks' bounds (every chunk
    // with k' keys >= its bound puts the user's k'-th key at or above it) to
    // the largest key; it stops once a count is exactly k
    unsigned lo = 0u;
    unsigned top = 0u;
    for (int c = tt; c < S; c += TEAM) lo = max(lo, bounds[static_cast<size_t>(b) * S + c]);
    for (int e = tt; e < n; e += TEAM) top = max(top, key_at(e));
    parity ^= 1;
    lo = team_max<TEAM>(lo, red, parity, tw, lane);
    parity ^= 1;
    top = team_max<TEAM>(top, red, parity, tw, lane);
    lo = min(lo, top);  // holds for lists this call wrote; keeps the search finite regardless
    unsigned long long hi = static_cast<unsigned long long>(top) + 1;  // count(>= hi) = 0 < k
    while (hi - lo > 1) {  // count(>= lo) >= k
      const unsigned mid = lo + static_cast<unsigned>((hi - lo) >> 1);
      const int cnt = count_from(mid);
      if (cnt >= k) {
        lo = mid;
        if (cnt == k) break;  // exactly the keys >= mid
      } else {
        hi = mid;
      }
    }
    thr = lo;
    krem = k - (thr == kFull ? 0 : count_from(thr + 1u));
  }

  // compaction: keys above thr anywhere in [0, k - krem), keys equal to it
  // in item order into [k - krem, k); a slot left empty (the lists' padding
  // made n larger than their keys) keeps ~0, which sorts last
  for (int j = tt; j < Kp; j += TEAM) words[pad_index(j)] = ~0ull;
  if (tt == 0) s_gt[team] = 0;
  team_sync<TEAM>();
  int ties = 0;
  for (int e0 = 0; e0 < n; e0 += TEAM) {
    const int e = e0 + tt;
    const unsigned key = e < n ? key_at(e) : 0u;
    const bool gt = e < n && key > thr;
    const bool eq = e < n && key == thr;
    const unsigned eqm = __ballot_sync(kFull, eq);
    int rank = ties + __popc(eqm & lanemask_lt());
    int tile_ties = __popc(eqm);
    if (kTeamWarps > 1) {  // double-buffered: one barrier per tile
      int* wt = s_warp_ties[team][(e0 / TEAM) & 1];
      if (lane == 0) wt[tw] = tile_ties;
      team_sync<TEAM>();
      tile_ties = 0;
#pragma unroll
      for (int w = 0; w < kTeamWarps; ++w) {
        const int c = wt[w];
        if (w < tw) rank += c;
        tile_ties += c;
      }
    }
    const unsigned gtm = __ballot_sync(kFull, gt);  // one atomic per warp places its gt keys
    int gt_base = 0;
    if (lane == 0 && gtm != 0u) gt_base = atomicAdd(&s_gt[team], __popc(gtm));
    gt_base = __shfl_sync(kFull, gt_base, 0);
    if (gt || (eq && rank < krem)) {
      const unsigned long long word =
          (static_cast<unsigned long long>(~key) << 32) | static_cast<unsigned>(e);
      words[pad_index(gt ? gt_base + __popc(gtm & lanemask_lt()) : k - krem + rank)] = word;
    }
    ties += tile_ties;
  }
  team_sync<TEAM>();

  unsigned long long v[R];
#pragma unroll
  for (int r = 0; r < R; ++r) v[r] = words[pad_index(tt * R + r)];
  team_bitonic<TEAM, R>(v, words, tt);  // score descending, then index ascending

  const float neg_inf = -__int_as_float(0x7f800000);
  const size_t o = static_cast<size_t>(b) * kout;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int j = tt * R + r;
    if (j < kout) {
      float s = neg_inf;
      int item = 0;
      if (j < k && v[r] != ~0ull) {
        s = key_score(~static_cast<unsigned>(v[r] >> 32));
        item = (s == neg_inf) ? 0 : static_cast<int>(ents[v[r] & 0xffffffffu] >> 32) + col_offset;
      }
      out_s[o + j] = s;
      out_i[o + j] = item;
    }
  }
  for (int j = Kp + tt; j < kout; j += TEAM) {
    out_s[o + j] = neg_inf;
    out_i[o + j] = 0;
  }
}

// Raise a kernel's dynamic shared memory limit where this device has not
// seen that much yet (the attribute call costs host time on every launch).
template <auto Kernel>
cudaError_t set_smem(long long smem) {
  constexpr int kMaxDevices = 64;
  static long long granted[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && smem <= granted[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err == cudaSuccess && dev < kMaxDevices) granted[dev] = smem;
  return err;
}

template <int TEAM, int R>
cudaError_t launch_merge(const unsigned long long* ls, const unsigned* bd, float* os, int* oi,
                         int B, int k,
                         int S, int per_user, int n, int keys_in_smem, int col_offset,
                         long long smem, cudaStream_t st) {
  const cudaError_t err = set_smem<merge_kernel<TEAM, R>>(smem);
  if (err != cudaSuccess) return err;
  constexpr int kTeams = kThreads / TEAM;
  merge_kernel<TEAM, R><<<(B + kTeams - 1) / kTeams, kThreads, smem, st>>>(
      ls, bd, os, oi, B, k, S, per_user, n, keys_in_smem, col_offset);
  return cudaGetLastError();
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

int fused_topk_launch(const void* U, const void* T, void* scratch, void* out_s, void* out_i, int B, int I, int d, int k, int chunk, int S,
                      int n, int Kp, int team, int keys_in_smem, int vec, long long smem1,
                      long long smem2, int col_offset, int mask_pad, void* stream) {
  const int lmax = list_len(k, chunk);
  const int last = I - (S - 1) * chunk;
  if (B <= 0 || I <= 0 || d <= 0 || k <= 0 || chunk <= 0 || chunk % kBN != 0 ||
      chunk > kMaxChunk || S <= 0 || last <= 0 || last > chunk ||
      n != (S - 1) * lmax + (lmax < last ? lmax : last) || Kp < (k < n ? k : n))
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec && ((d & 3) != 0 || (reinterpret_cast<uintptr_t>(T) & 15) != 0 ||
              (reinterpret_cast<uintptr_t>(U) & 15) != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* u = static_cast<const float*>(U);
  const auto* t = static_cast<const float*>(T);
  auto* ls = static_cast<unsigned long long*>(scratch);
  // B * S bounds follow the B * S * lmax list entries
  auto* bd = reinterpret_cast<unsigned*>(ls + static_cast<size_t>(B) * S * lmax);
  auto* os = static_cast<float*>(out_s);
  auto* oi = static_cast<int*>(out_i);
  auto st = static_cast<cudaStream_t>(stream);

  const dim3 grid1((B + kBM - 1) / kBM, S);
  cudaError_t err;
  if (vec) {
    err = set_smem<score_select_kernel<true>>(smem1);
    if (err != cudaSuccess) return static_cast<int>(err);
    score_select_kernel<true><<<grid1, kThreads, smem1, st>>>(u, t, ls, bd, B, I, d, k, chunk, mask_pad);
  } else {
    err = set_smem<score_select_kernel<false>>(smem1);
    if (err != cudaSuccess) return static_cast<int>(err);
    score_select_kernel<false><<<grid1, kThreads, smem1, st>>>(u, t, ls, bd, B, I, d, k, chunk, mask_pad);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int pu = S * lmax;
  const int ks = keys_in_smem;
  if (team == 32) {
    switch (Kp) {
      case 32: err = launch_merge<32, 1>(ls, bd, os, oi, B, k, S, pu, n, ks, col_offset, smem2, st); break;
      case 64: err = launch_merge<32, 2>(ls, bd, os, oi, B, k, S, pu, n, ks, col_offset, smem2, st); break;
      case 128: err = launch_merge<32, 4>(ls, bd, os, oi, B, k, S, pu, n, ks, col_offset, smem2, st); break;
      case 256: err = launch_merge<32, 8>(ls, bd, os, oi, B, k, S, pu, n, ks, col_offset, smem2, st); break;
      case 512: err = launch_merge<32, 16>(ls, bd, os, oi, B, k, S, pu, n, ks, col_offset, smem2, st); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  } else if (team == kThreads) {
    switch (Kp) {
      case 1024: err = launch_merge<kThreads, 4>(ls, bd, os, oi, B, k, S, pu, n, ks, col_offset, smem2, st); break;
      case 2048: err = launch_merge<kThreads, 8>(ls, bd, os, oi, B, k, S, pu, n, ks, col_offset, smem2, st); break;
      case 4096: err = launch_merge<kThreads, 16>(ls, bd, os, oi, B, k, S, pu, n, ks, col_offset, smem2, st); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

}  // extern "C"
