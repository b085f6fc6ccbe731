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
// Types: the item table T is float32, bfloat16 or float16, and so are the
// users U, in any pairing (the JAX kernel takes any float dtype and
// accumulates in f32, preferred_element_type=float32). A half-precision
// table is read as it is stored. Every product of two bf16, two f16 or an
// f16 and a bf16 value is exact in f32, so the scores are f32 sums of exact
// products, as on the TPU up to summation order. Two paths:
//  * same-type half calls (bf16 x bf16, f16 x f16) run the products on the
//    tensor cores (mma.sync m16n8k16, f32 accumulators), which keep them
//    exact; only the order and rounding of the d additions differ from a
//    chain of fmaf;
//  * every call with an f32 operand, and the mixed bf16 / f16 pairs, run
//    explicit fmaf on the CUDA cores, each half value widened to f32 where
//    it enters the register tile (bf16 by a shift, f16 by __half2float).
//    An f32 call's products and selection are those of the float32 kernel
//    alone, so its outputs hold bit for bit (chip_smoke.py's parity check).
//
// Shard mode (the local stage of the item-sharded top-k,
// recbole_fairrec_tpu_torch/parallel/eval.py): T is rows [col_offset,
// col_offset + I) of a larger table; mask_pad = 0 leaves its row 0 (not the
// catalog's PAD) selectable, and col_offset is added to the index of every
// selected item. Slots without an item still hold (-inf, 0). The default
// call (col_offset 0, mask_pad 1) is the kernel above, unchanged.
//
// What bounds it on an H100. At the serving shape (B 6144, I 3630, d 64,
// k' 173, f32) the products are 2*B*I*d = 2.855 GFLOP of plain f32 FMA on
// the CUDA cores: 42.6 us at the 67 TFLOP/s non-tensor f32 peak. The bytes
// (2.5 MB in, 8.5 MB out) take ~3 us at 3.35 TB/s. So f32 FMA bounds it.
// Tensor cores are ruled out for f32 tables: TF32 keeps ~10 mantissa bits
// and reorders near-tied items, and the ranking contract is exact f32 (the
// JAX call asks for precision="highest"). At catalog scale (a half table of
// 2M items x 128, 537 MB) the table's bytes bound B 128 (0.16 ms at 3.35
// TB/s) and the products bound B 1024 (549.8 GFLOP, 0.56 ms at the 989
// TFLOP/s dense bf16 / f16 peak); there the tensor cores are the only way
// near the bound. Beside the products, every one of the B x I scores is
// turned into a key in shared memory and compared at least once (2.1G at B
// 1024); range mode keeps the lists themselves small (k' per range instead
// of 42 per chunk: 17.5 MB at B 1024 instead of 1.41 GB).
//
// Design: two kernels per call, on one stream.
//  1. score + select, grid (ceil(B/64), S), 256 threads. A block owns kBM =
//     64 users and one chunk of the item axis (S chunks of `chunk` items, a
//     multiple of 256, at most 512).
//     * Products apart from selection: the block computes its whole
//       [64 x chunk] score block into shared memory before it selects
//       anything. A warp covers 32 users x 64 items of a 256-item T tile;
//       T's tiles arrive by cp.async through a 3-stage ring, with one block
//       barrier per tile and no selection between tiles. T then passes
//       through L2 ceil(B/64) times, not once per 8 users.
//       - score_select_kernel (CUDA cores): a register-blocked SGEMM; a
//         thread keeps 8 users x 8 items = 64 accumulators, per 4-deep step
//         8 float4 of U and 8 of T for 256 FMA; U is staged in f32 (half
//         users widened once), T tiles are 16 deep.
//       - score_select_mma_kernel (tensor cores): U stays in its half type
//         in shared memory; T tiles are 32 deep in 80-byte rows. A warp's
//         32 x 64 tile is 2 x 8 m16n8k16 products per 16 of depth, fed by
//         ldmatrix (rows of 16 bytes on disjoint bank groups: U rows are
//         d_pad + 8 halves, an odd number of 16-byte units); a thread keeps
//         the same 64 accumulators. Depth past d is zero on both sides.
//     * Each score becomes a 32-bit key whose unsigned order is the float
//       order (-0.0 folded into +0.0 first: the float compare calls them
//       equal, the bits would not). Item 0 gets the key of -inf.
//     * Range mode (tensor cores, k' <= 32, catalogs of many chunks): a
//       block walks cpb consecutive chunks (U staged once; the next chunk's
//       first T tiles copied while the current one's keys are selected),
//       and each warp keeps, for each of its 8 users, the exact top k' seen
//       so far as one 64-bit word a lane, (key, then smaller item). The
//       range's first chunk fills it (the threshold below takes at most
//       k' + 32 keys, which a 64-element warp sort orders); a later chunk
//       costs one compare per key against the set's worst key for all 8
//       users, and only a key above it is offered (a warp reduction
//       replaces the worst entry). A key equal to the worst belongs to a
//       later item and ranks below it. The range then writes one list of k'
//       entries in item order, its bound (the k'-th key) and largest key:
//       a user's lists shrink from 42 entries per chunk to 10 per range.
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
//  2. The merge, in one of two forms the plan picks.
//     * merge_kernel, where the user's lists fit shared memory (S small, as
//       at the serving shapes): one team per user, a warp where k' <= 512,
//       else the whole 256-thread block. The team copies the keys into
//       shared memory (cp.async) and finds the k'-th key by a binary search
//       on the key value from the largest stored bound to the largest key
//       (an arg-max for k' = 1). It compacts the winners (ties again in item
//       order) and sorts only those: a bitonic sort of 64-bit (~key, list
//       position) words held in registers (R per thread), exchanging across
//       lanes with shuffles and across warps through padded shared memory.
//       List positions follow item order, so equal scores come out by
//       ascending index.
//     * merge_split_kernel, where they do not (catalog scale in chunk mode:
//       S 4,096 lists, 172,032 entries a user), or where one team per user
//       would leave SMs idle in range mode (B 128: 16 blocks): `parts`
//       blocks per user, each over a slice of the user's lists, so that B
//       128 fills the card. Each block bounds the user's k'-th key from
//       below by the larger of the lists' largest bound and the k'-th
//       largest of the lists' largest keys (k' lists each hold a key at or
//       above it; built bit by bit over the S maxima, which the score kernel
//       stores beside the bounds). It then reads only the lists whose
//       largest key reaches that bound, once each, and appends their
//       entries at or above it (about k' for scores without mass ties) to
//       the user's candidates (one atomic per warp that has any). The
//       user's last block to finish (a ticket counter) sorts the candidates
//       in shared memory as (~key, item) words, which gives (score desc,
//       item asc), and writes the first k'. Where more than kCandCap
//       candidates arrive (scores the bounds do not separate, such as a
//       constant table) it runs merge_kernel's search over the lists in
//       place instead, so every input is ranked exactly.
//  * Cost per score is a fixed number of compares (a few tens of search
//    steps at most, usually about ten), not log^2 K compare-exchanges as a
//    merge of sorted lists costs, and no contended shared atomics.
//  * Filling the card: ceil(B/64) blocks alone are 96 at the serving shape,
//    fewer than the 132 SMs. The item axis is split into S chunks so the
//    grid holds at least 2 blocks per SM (S 8 there: 768 blocks of
//    64 x 512).
//  * Scratch (allocated by the wrapper with torch.empty; the kernels
//    allocate nothing): B * L lists (L = S, or the ranges) of
//    list_len(k', chunk) or k' entries of 8 bytes (item, key), then B * L
//    4-byte bounds; for the split merge, then B * L 4-byte largest keys, B
//    * kCandCap candidate entries and B pairs of 4-byte counters (zeroed by
//    the score kernel's first chunk of each user block). 81 MB at the
//    serving shape, 201 MB at k' 2048 (I 3630), 805 MB at k' 4096 (I
//    16384, where every list is a whole chunk); at the 2M-item catalog,
//    k' 10, B 1024: 1.41 GB with a list per chunk, 17.5 MB in range mode.
//  * VEC (16 bytes of T a whole number of elements of d: d % 4 == 0 for
//    f32, d % 8 == 0 for half; T, and U where it is read by cp.async (f32
//    users, and the tensor-core path), 16-byte aligned) copies with 16-byte
//    cp.async; otherwise f32 takes 4-byte cp.async and half values plain
//    2-byte loads. Half users of the CUDA-core path are read with plain
//    loads and widened (once per block). Depth past d, users past B and
//    items past the chunk are zero-filled.
//  * Catalog scale: S = ceil(I / chunk) is the grid's y extent, at most
//    65,535 (I up to 33.5M at chunk 512); the wrapper refuses more by name.
//
// C interface (ctypes, see ops/fused_topk.py). Element types: 0 float32,
// 1 bfloat16, 2 float16.
//   int fused_topk_max_smem()  -> opt-in shared memory per block, bytes
//   long long fused_topk_smem_bytes(d, chunk, u_type, t_type) -> score block bytes
//   int fused_topk_launch(U, T, scratch, out_s, out_i, B, I, d, k, chunk, S,
//                         cpb, n, Kp, team, keys_in_smem, parts, vec, smem1,
//                         smem2, col_offset, mask_pad, u_type, t_type, stream)
//     -> cudaGetLastError() code of the first launch that failed, else 0

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kBM = 64;        // users per block
constexpr int kBN = 256;       // items per T tile
constexpr int kBK = 16;        // depth per T tile (CUDA-core path)
constexpr int kBKM = 32;       // depth per T tile (tensor-core path): two k16 steps
constexpr int kStages = 3;     // T tiles in flight
constexpr int kThreads = 256;  // threads per block, every kernel
constexpr int kWarps = kThreads / 32;
constexpr int kTM = 8;             // users per thread (CUDA-core path)
constexpr int kTN = 8;             // items per thread (CUDA-core path)
constexpr int kF32 = 0, kBF16 = 1, kF16 = 2;  // element type codes of the C interface
// elements of a CUDA-core T ring row. f32: kBK + 4 = 80 B; half: kBK + 8 =
// 48 B (12 words). Either way the 8 rows r..r+7 that a warp reads at one
// depth fall on 8 disjoint bank groups, and every row starts 16-byte aligned.
template <typename TT>
__host__ __device__ constexpr int t_stride() {
  return std::is_same<TT, float>::value ? kBK + 4 : kBK + 8;
}
// elements of a tensor-core T ring row: 80 B, five 16-byte units, so the 8
// rows of an ldmatrix 8x8 fall on 8 disjoint 16-byte bank groups
constexpr int kTSM = kBKM + 8;
constexpr int kKeyPad = 8;         // key rows are chunk + 8 words: 4 rows x 8 columns, 32 banks
constexpr int kMaxChunk = 512;     // items per chunk, at most: its keys fit 16 registers a lane
constexpr int kKeysPerLane = kMaxChunk / 32;
constexpr int kUsersAtOnce = 2;    // users a warp selects for together
constexpr int kSlack = 32;         // keys a chunk's list may hold beyond k' (for k' > 1)
constexpr int kMaxSplits = 65535;  // gridDim.y
// candidates a user may bring to the split merge's sort (CAND_CAP)
constexpr int kCandCap = 2048;
// static shared memory of a merge kernel, at most; the wrapper keeps its
// dynamic bytes within the opt-in limit less this (MERGE_STATIC_SMEM)
constexpr int kMergeStaticSmem = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNegInfKey = 0x007fffffu;  // order_key(-inf)

// warp tile 32 users x 64 items; CUDA-core lane (lane & 3, lane >> 2) takes
// users 4 i + (lane & 3) and items (lane >> 2) + 8 j of it
static_assert(2 * 32 == kBM && 4 * 64 == kBN && kWarps == 8, "8 warps of 32 x 64");
static_assert(kTM * 4 == 32 && kTN * 8 == 64, "thread tile is 8 users x 8 items");

// Dynamic shared memory of a score + select block, in the order of its
// layout. CUDA cores (MMA false): us[kBM][dpad16 + 4] f32 |
// ring[kStages][kBN][t_stride] TT | keys[kBM][chunk + kKeyPad] u32. Tensor
// cores (MMA true, TT the half type of U and T): us[kBM][dpad32 + 8] TT |
// ring[kStages][kBN][kTSM] TT | keys. ops/fused_topk.py::smem_bytes mirrors
// it; the launch refuses a plan whose bytes differ.
template <typename TT, bool MMA>
__host__ __device__ constexpr long long score_smem_bytes(int d, int chunk) {
  return MMA ? 2ll * kBM * ((d + kBKM - 1) / kBKM * kBKM + 8) + 2ll * kStages * kBN * kTSM +
                   4ll * kBM * (chunk + kKeyPad)
             : 4ll * kBM * ((d + kBK - 1) / kBK * kBK + 4) +
                   static_cast<long long>(sizeof(TT)) * kStages * kBN * t_stride<TT>() +
                   4ll * kBM * (chunk + kKeyPad);
}
static_assert(score_smem_bytes<float, false>(64, 512) == 211968, "the serving shape's f32 block");
static_assert(score_smem_bytes<__nv_bfloat16, false>(128, 512) == 203776, "a d 128 bf16 block");
static_assert(score_smem_bytes<__half, false>(128, 512) == 203776, "a d 128 f16 block");
static_assert(score_smem_bytes<__nv_bfloat16, true>(128, 512) == 211968,
              "a d 128 tensor-core block");
static_assert(score_smem_bytes<__half, true>(30, 512) == 199680, "a d 30 tensor-core block");
static_assert((kStages * kBN * t_stride<__nv_bfloat16>() * 2) % 16 == 0 &&
                  (kStages * kBN * t_stride<float>() * 4) % 16 == 0 &&
                  (kStages * kBN * kTSM * 2) % 16 == 0 && (kBM * 8 * 2) % 16 == 0,
              "the ring and the key block start 16-byte aligned");

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

// One compare-exchange step of a bitonic network for the element this
// thread holds at index i, whose partner (i ^ stride) holds o.
__device__ __forceinline__ unsigned long long bitonic_keep(unsigned long long v,
                                                           unsigned long long o, int i,
                                                           int stride, int size) {
  const bool lower = (i & stride) == 0;
  const bool up = (i & size) == 0;
  return (lower == up) ? (v < o ? v : o) : (v < o ? o : v);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const int n = valid ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Half values as f32 (exact), and a zero of a type.
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float widen(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T zero_of() {
  if constexpr (std::is_same<T, float>::value) {
    return 0.0f;
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return __float2bfloat16(0.0f);
  } else {
    return __float2half(0.0f);
  }
}

// Copy T[n0 : n0+kBN, k0 : k0+KBK] into a ring slot of rows of TS elements;
// items >= n_end and depth >= d are zero-filled. A thread's copies are a
// fixed pattern (rows tid / copies-per-row + a multiple of the rows per
// pass), unrolled, so a tile costs a few instructions beside its step's
// products. VEC copies 16 bytes (4 f32 or 8 half values) by cp.async;
// otherwise f32 copies 4 bytes by cp.async and a half type one element by a
// plain load and store (cp.async has no 2-byte form), which the ring's
// barriers order like the copies.
template <typename TT, bool VEC, int KBK = kBK, int TS = t_stride<TT>()>
__device__ __forceinline__ void load_t_tile(TT* dst, const TT* __restrict__ T, int n0,
                                            int n_end, int k0, int d, int tid) {
  constexpr int kWidth = VEC ? 16 / static_cast<int>(sizeof(TT)) : 1;  // elements per copy
  constexpr int kPerRow = KBK / kWidth;                                 // copies per row
  constexpr int kRowsPerPass = kThreads / kPerRow;
  static_assert(kThreads % kPerRow == 0 && kBN % kRowsPerPass == 0, "copy pattern");
  const int r0 = tid / kPerRow;
  const int c = tid % kPerRow * kWidth;
  const bool col_ok = k0 + c < d;
  const TT* src = T + static_cast<size_t>(n0 + r0) * d + k0 + c;
  TT* out = dst + r0 * TS + c;
#pragma unroll
  for (int q = 0; q < kBN / kRowsPerPass; ++q) {
    const bool valid = col_ok && n0 + r0 + q * kRowsPerPass < n_end;
    const TT* from = valid ? src + static_cast<size_t>(q) * kRowsPerPass * d : T;
    if constexpr (VEC) {
      cp_async16(out + q * kRowsPerPass * TS, from, valid);
    } else if constexpr (std::is_same<TT, float>::value) {
      cp_async4(out + q * kRowsPerPass * TS, from, valid);
    } else {
      out[q * kRowsPerPass * TS] = valid ? *from : zero_of<TT>();
    }
  }
}

// Four consecutive elements of a ring row (depth q..q+3) as f32. A bf16 is
// the high half of its f32: widening is a shift, exact. An f16 is widened by
// __half2float, also exact.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(w.x << 16), __uint_as_float(w.x & 0xffff0000u),
                     __uint_as_float(w.y << 16), __uint_as_float(w.y & 0xffff0000u));
}

__device__ __forceinline__ float4 load4(const __half* p) {
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(p));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(p + 2));
  return make_float4(a.x, a.y, b.x, b.y);
}

// The split merge's per-user counters (candidates, finished blocks) start
// at 0: the first chunk's blocks clear them for their users, before the
// merge launches on the same stream.
__device__ __forceinline__ void clear_counters(unsigned* counters, int b0, int B, int tid) {
  if (counters != nullptr && blockIdx.y == 0 && tid < kBM && b0 + tid < B)
    reinterpret_cast<uint2*>(counters)[b0 + tid] = make_uint2(0u, 0u);
}

// The threshold of a chunk's selection for kUsersAtOnce users (keys r,
// item c0 + lane + 32 t in r[u][t], 0 past the chunk's n items), L =
// min(k', n) > 1: keys above thr[u] are taken, keys equal to it in item
// order until krem[u] are; where all_eq[u], every key >= thr[u] is taken,
// between L and L + slack of them. Built bit by bit from the top (one
// compare per key and one warp reduction per bit); the search stops as soon
// as a count falls in that window, else thr is the L-th key. L == n takes
// every key.
__device__ __forceinline__ void chunk_threshold(const unsigned (&r)[kUsersAtOnce][kKeysPerLane],
                                                const bool (&live)[kUsersAtOnce], int L, int n,
                                                unsigned (&thr)[kUsersAtOnce],
                                                int (&krem)[kUsersAtOnce],
                                                bool (&all_eq)[kUsersAtOnce]) {
#pragma unroll
  for (int u = 0; u < kUsersAtOnce; ++u) {
    thr[u] = 0u;  // L == n: every key (all are > 0) is taken
    krem[u] = 0;
    all_eq[u] = true;
  }
  if (L >= n) return;
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

// Which of a user's keys the threshold takes: keys above thr, then keys
// equal to it in item order (ballots over the 16 slots) while krem last.
__device__ __forceinline__ void take_mask(const unsigned (&r)[kKeysPerLane], unsigned thr,
                                          int krem, bool all_eq, int n, int lane,
                                          bool (&take)[kKeysPerLane]) {
  if (all_eq) {  // every key >= thr (thr > 0 unless all are taken)
#pragma unroll
    for (int t = 0; t < kKeysPerLane; ++t) take[t] = r[t] >= thr && lane + 32 * t < n;
    return;
  }
  unsigned vote[kKeysPerLane];
#pragma unroll
  for (int t = 0; t < kKeysPerLane; ++t)
    vote[t] = __ballot_sync(kFull, r[t] == thr && lane + 32 * t < n);
  int ties = 0;
#pragma unroll
  for (int t = 0; t < kKeysPerLane; ++t) {
    take[t] = r[t] > thr ||
              ((vote[t] >> lane) & 1u && ties + __popc(vote[t] & lanemask_lt()) < krem);
    ties += __popc(vote[t]);
  }
}

// A warp's keys of two users of the block: r[u][t] is item c0 + lane + 32 t
// of user row warp + kWarps (g + u), 0 past n; live[u] (warp-uniform): the
// user exists.
__device__ __forceinline__ void load_user_keys(const unsigned* keys, int kstride, int b0, int B,
                                               int n, int g, int warp, int lane,
                                               unsigned (&r)[kUsersAtOnce][kKeysPerLane],
                                               bool (&live)[kUsersAtOnce]) {
#pragma unroll
  for (int u = 0; u < kUsersAtOnce; ++u) {
    const int m = warp + kWarps * (g + u);
    live[u] = b0 + m < B;
#pragma unroll
    for (int t = 0; t < kKeysPerLane; ++t)
      r[u][t] = lane + 32 * t < n ? keys[m * kstride + lane + 32 * t] : 0u;
  }
}

// Selection over a block's [kBM x n] keys (rows of kstride words), one
// chunk per block (blockIdx.y): each warp takes its 8 users 2 at a time,
// keys in registers, and writes each user's list for this chunk, its bound
// and, where maxes is not null, its largest key.
__device__ __forceinline__ void select_lists(const unsigned* keys, int kstride,
                                             unsigned long long* __restrict__ lists,
                                             unsigned* __restrict__ bounds,
                                             unsigned* __restrict__ maxes, int b0, int B, int n,
                                             int k, int chunk, int c0, int warp, int lane) {
  const int S = gridDim.y;
  const int L = min(k, n);
  const int lmax = list_len(k, chunk);
  for (int g = 0; g < kBM / kWarps; g += kUsersAtOnce) {
    unsigned r[kUsersAtOnce][kKeysPerLane];
    bool live[kUsersAtOnce];
    load_user_keys(keys, kstride, b0, B, n, g, warp, lane, r, live);
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
          const size_t list = static_cast<size_t>(b0 + warp + kWarps * (g + u)) * S + blockIdx.y;
          bounds[list] = top;
          if (maxes != nullptr) maxes[list] = top;
        }
      }
      continue;
    }
    unsigned thr[kUsersAtOnce];
    int krem[kUsersAtOnce];
    bool all_eq[kUsersAtOnce];  // warp-uniform
    chunk_threshold(r, live, L, n, thr, krem, all_eq);
    // keys above thr, then keys equal to it in item order, into the list;
    // the rest of the list is filled with entry(0, 0)
#pragma unroll
    for (int u = 0; u < kUsersAtOnce; ++u) {
      if (!live[u]) continue;  // warp-uniform
      const int b = b0 + warp + kWarps * (g + u);
      const size_t base = (static_cast<size_t>(b) * S + blockIdx.y) * lmax;
      bool take[kKeysPerLane];
      take_mask(r[u], thr[u], krem[u], all_eq[u], n, lane, take);
      unsigned vote[kKeysPerLane];
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
      // user's k'-th key over the catalogue (0 where the list is the chunk);
      // and, for the split merge, the chunk's largest key
      unsigned top = 0u;
      if (maxes != nullptr) {  // warp-uniform
#pragma unroll
        for (int t = 0; t < kKeysPerLane; ++t) top = max(top, r[u][t]);
        top = __reduce_max_sync(kFull, top);
      }
      if (lane == 0) {
        bounds[static_cast<size_t>(b) * S + blockIdx.y] = thr[u];
        if (maxes != nullptr) maxes[static_cast<size_t>(b) * S + blockIdx.y] = top;
      }
    }
  }
}

// Word i of a team's shared buffer lives at i + i / 16: the R consecutive
// words of one thread then start in another bank for each lane.
__host__ __device__ __forceinline__ int pad_index(int i) { return i + (i >> 4); }

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

// Range mode (the tensor-core kernel with k' <= 32): a block walks cpb
// chunks, and each warp keeps, for each of its 8 users, the exact top-k' of
// the keys seen so far as a set of 64-bit words (key << 32 | ~item), one a
// lane: lanes < k' hold an entry (0 where none yet), lanes >= k' hold ~0.
// The word order is (key, then smaller item), so the set's least word lo
// is its worst entry, and lo's key a lower bound on the user's k'-th key.
constexpr int kRangeMaxK = 32;
constexpr int kUsersPerWarp = kBM / kWarps;

__device__ __forceinline__ unsigned long long warp_min64(unsigned long long v) {
  const unsigned hi = __reduce_min_sync(kFull, static_cast<unsigned>(v >> 32));
  const unsigned lo =
      __reduce_min_sync(kFull, static_cast<unsigned>(v >> 32) == hi ? static_cast<unsigned>(v)
                                                                    : kFull);
  return (static_cast<unsigned long long>(hi) << 32) | lo;
}

// Offer (key, item) to a set (warp-uniform arguments): it replaces the
// worst entry where it ranks above it.
__device__ __forceinline__ void offer(unsigned long long& set, unsigned long long& lo,
                                      unsigned key, int item, int lane) {
  const unsigned long long w =
      (static_cast<unsigned long long>(key) << 32) | static_cast<unsigned>(~item);
  if (w > lo) {
    const unsigned holders = __ballot_sync(kFull, set == lo);  // empty slots tie at 0
    if (lane == __ffs(holders) - 1) set = w;
    lo = warp_min64(set);
  }
}

// A sort word (~key << 32 | item: score descending, then item ascending)
// as a set word; ~0 (no entry) as an empty slot.
__device__ __forceinline__ unsigned long long set_word(unsigned long long w) {
  if (w == ~0ull) return 0ull;
  return (static_cast<unsigned long long>(~static_cast<unsigned>(w >> 32)) << 32) |
         static_cast<unsigned>(~static_cast<unsigned>(w));
}

// The first chunk of a range: each user's set is the exact top k' of the
// keys the chunk's threshold takes (at most k' + kSlack <= 64, which hold
// the chunk's top k'), staged at the start of the user's own key row and
// sorted by a 64-element warp bitonic sort.
__device__ __forceinline__ void range_first(unsigned* keys, int kstride,
                                            unsigned long long (&set)[kUsersPerWarp],
                                            unsigned long long (&lo)[kUsersPerWarp], int b0,
                                            int B, int n, int k, int c0, int warp, int lane) {
  const int L = min(k, n);
#pragma unroll
  for (int g = 0; g < kUsersPerWarp; g += kUsersAtOnce) {
    unsigned r[kUsersAtOnce][kKeysPerLane];
    bool live[kUsersAtOnce];
    load_user_keys(keys, kstride, b0, B, n, g, warp, lane, r, live);
    unsigned thr[kUsersAtOnce];
    int krem[kUsersAtOnce];
    bool all_eq[kUsersAtOnce];
    if (L == 1) {  // the best key, its first occurrence
#pragma unroll
      for (int u = 0; u < kUsersAtOnce; ++u) {
        unsigned best = 0u;
#pragma unroll
        for (int t = 0; t < kKeysPerLane; ++t) best = max(best, r[u][t]);
        thr[u] = __reduce_max_sync(kFull, best);
        krem[u] = 1;
        all_eq[u] = false;
      }
    } else {
      chunk_threshold(r, live, L, n, thr, krem, all_eq);
    }
    __syncwarp();  // every lane holds both users' keys before a row is overwritten
#pragma unroll
    for (int u = 0; u < kUsersAtOnce; ++u) {
      if (!live[u]) continue;  // warp-uniform
      bool take[kKeysPerLane];
      take_mask(r[u], thr[u], krem[u], all_eq[u], n, lane, take);
      auto* row = reinterpret_cast<unsigned long long*>(keys + (warp + kWarps * (g + u)) * kstride);
      int pos = 0;
#pragma unroll
      for (int t = 0; t < kKeysPerLane; ++t) {
        const unsigned vote = __ballot_sync(kFull, take[t]);
        if (take[t])
          row[pos + __popc(vote & lanemask_lt())] =
              (static_cast<unsigned long long>(~r[u][t]) << 32) |
              static_cast<unsigned>(c0 + lane + 32 * t);
        pos += __popc(vote);
      }
      __syncwarp();
      unsigned long long v[2] = {2 * lane < pos ? row[2 * lane] : ~0ull,
                                 2 * lane + 1 < pos ? row[2 * lane + 1] : ~0ull};
      team_bitonic<32, 2>(v, nullptr, lane);  // strides below 64 stay in registers and lanes
      // element j of the order is lane j / 2's v[j % 2]
      const unsigned long long e0 = __shfl_sync(kFull, v[0], lane >> 1);
      const unsigned long long e1 = __shfl_sync(kFull, v[1], lane >> 1);
      set[g + u] = lane < k ? set_word((lane & 1) ? e1 : e0) : ~0ull;
      lo[g + u] = warp_min64(set[g + u]);
    }
  }
}

// A later chunk of a range: a key equal to lo's key belongs to a later item
// than every entry of the set, so it ranks below lo; only keys above it are
// offered. The warp first tests all 8 users (16-byte loads, any order),
// then offers the keys of those that have one, in item order.
__device__ __forceinline__ void range_next(const unsigned* keys, int kstride,
                                           unsigned long long (&set)[kUsersPerWarp],
                                           unsigned long long (&lo)[kUsersPerWarp], int b0,
                                           int B, int n, int c0, int warp, int lane) {
  unsigned hits = 0u;
#pragma unroll
  for (int u = 0; u < kUsersPerWarp; ++u) {
    const int m = warp + kWarps * u;
    const unsigned lk = static_cast<unsigned>(lo[u] >> 32);
    const uint4* row = reinterpret_cast<const uint4*>(keys + m * kstride);
    unsigned mx = 0u;
#pragma unroll
    for (int q = 0; q < kKeysPerLane / 4; ++q) {
      const int i0 = 4 * (lane + 32 * q);  // items i0 .. i0 + 3 of the chunk
      if (i0 < n) {
        const uint4 w = row[lane + 32 * q];
        mx = max(mx, max(max(w.x, i0 + 1 < n ? w.y : 0u), max(i0 + 2 < n ? w.z : 0u,
                                                              i0 + 3 < n ? w.w : 0u)));
      }
    }
    if (__any_sync(kFull, mx > lk) && b0 + m < B) hits |= 1u << u;
  }
#pragma unroll
  for (int u = 0; u < kUsersPerWarp; ++u) {
    if (((hits >> u) & 1u) == 0u) continue;  // warp-uniform
    const int m = warp + kWarps * u;
    const unsigned lk = static_cast<unsigned>(lo[u] >> 32);
#pragma unroll
    for (int t = 0; t < kKeysPerLane; ++t) {
      const unsigned key = lane + 32 * t < n ? keys[m * kstride + lane + 32 * t] : 0u;
      unsigned vote = __ballot_sync(kFull, key > lk);
      while (vote != 0u) {
        const int src = __ffs(vote) - 1;
        vote &= vote - 1;
        offer(set[u], lo[u], __shfl_sync(kFull, key, src), c0 + src + 32 * t, lane);
      }
    }
  }
}

// The end of a range: each user's set becomes its list for the range (k'
// entries in item order, entry(0, 0) where empty), its bound (lo's key: the
// range holds k' keys at or above it; 0 where it holds fewer items) and,
// where maxes is not null, its largest key.
__device__ __forceinline__ void write_range(unsigned long long* __restrict__ lists,
                                            unsigned* __restrict__ bounds,
                                            unsigned* __restrict__ maxes,
                                            const unsigned long long (&set)[kUsersPerWarp],
                                            const unsigned long long (&lo)[kUsersPerWarp],
                                            int b0, int B, int k, int warp, int lane) {
  const int S = gridDim.y;  // ranges
#pragma unroll
  for (int u = 0; u < kUsersPerWarp; ++u) {
    const int b = b0 + warp + kWarps * u;
    if (b >= B) continue;  // warp-uniform
    const unsigned key = lane < k ? static_cast<unsigned>(set[u] >> 32) : 0u;
    // (item << 32 | key), an entry; empty slots and lanes >= k' sort last
    unsigned long long w =
        key != 0u ? (static_cast<unsigned long long>(~static_cast<unsigned>(set[u])) << 32) | key
                  : ~0ull;
#pragma unroll
    for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
      for (int stride = size >> 1; stride > 0; stride >>= 1)
        w = bitonic_keep(w, __shfl_xor_sync(kFull, w, stride), lane, stride, size);
    }
    const size_t at = static_cast<size_t>(b) * S + blockIdx.y;
    if (lane < k) lists[at * k + lane] = w == ~0ull ? entry(0u, 0) : w;
    const unsigned top = __reduce_max_sync(kFull, key);
    if (lane == 0) {
      bounds[at] = static_cast<unsigned>(lo[u] >> 32);
      if (maxes != nullptr) maxes[at] = top;
    }
  }
}

template <typename TU, typename TT, bool VEC>
__global__ void __launch_bounds__(kThreads, 1)
score_select_kernel(const TU* __restrict__ U, const TT* __restrict__ T,
                    unsigned long long* __restrict__ lists, unsigned* __restrict__ bounds,
                    unsigned* __restrict__ maxes, unsigned* __restrict__ counters, int B, int I,
                    int d, int k, int chunk, int mask_pad) {
  constexpr int kTS = t_stride<TT>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // layout (score_smem_bytes<TT, false>): us[kBM][ustride] f32 |
  // ring[kStages][kBN][kTS] TT | keys[kBM][kstride]
  const int dpad = (d + kBK - 1) / kBK * kBK;
  const int ustride = dpad + 4;
  const int kstride = chunk + kKeyPad;
  float* us = reinterpret_cast<float*>(smem_raw);
  TT* ring = reinterpret_cast<TT*>(us + kBM * ustride);
  unsigned* keys = reinterpret_cast<unsigned*>(ring + kStages * kBN * kTS);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int b0 = blockIdx.x * kBM;
  const int c0 = blockIdx.y * chunk;
  const int n = min(chunk, I - c0);  // items of this chunk
  const int n_end = c0 + n;
  const int ntiles = (n + kBN - 1) / kBN;
  const int nk = dpad / kBK;
  const int nsteps = ntiles * nk;
  clear_counters(counters, b0, B, tid);

  // ---- products: [64 users x n items] into keys ----
  // U's rows join the first copy group (zero-filled past d and past B);
  // half rows are widened here, by plain loads
  if constexpr (!std::is_same<TU, float>::value) {
    for (int e = tid; e < kBM * dpad; e += kThreads) {
      const int m = e / dpad;
      const int c = e % dpad;
      const bool valid = b0 + m < B && c < d;
      us[m * ustride + c] = valid ? widen(U[static_cast<size_t>(b0 + m) * d + c]) : 0.0f;
    }
  } else if constexpr (VEC) {
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
      load_t_tile<TT, VEC>(ring + s * kBN * kTS, T, c0 + tile * kBN, n_end,
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
      load_t_tile<TT, VEC>(ring + nslot * kBN * kTS, T, c0 + ld_tile * kBN, n_end,
                           ld_ks * kBK, d, tid);
    }
    cp_async_commit();
    if (++ld_ks == nk) {
      ld_ks = 0;
      ++ld_tile;
    }

    const TT* ts = ring + slot * kBN * kTS + wi * kTS;
    const float* uw = us + wu * ustride + ks * kBK;
#pragma unroll
    for (int q = 0; q < kBK; q += 4) {
      float4 t[kTN];
#pragma unroll
      for (int j = 0; j < kTN; ++j) t[j] = load4(ts + 8 * j * kTS + q);
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

  select_lists(keys, kstride, lists, bounds, maxes, b0, B, n, k, chunk, c0, warp, lane);
}

// Four 8x8 b16 matrices from shared memory; lane l gives the row address of
// matrix l / 8, row l % 8, and receives (row l / 4, elements 2 (l % 4), +1)
// of each, as mma.sync's fragments expect.
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a (16 x 16, row-major) . b (16 x 8, column-major): products exact,
// sums in f32.
template <typename TH>
__device__ __forceinline__ void mma16816(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  if constexpr (std::is_same<TH, __nv_bfloat16>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// score_select_kernel with the products on the tensor cores, for U and T of
// one half type TH. Layout (score_smem_bytes<TH, true>): us[kBM][dpad + 8]
// TH | ring[kStages][kBN][kTSM] TH | keys[kBM][kstride] u32. A warp's
// 32 users x 64 items are m-tiles mi (users wm + 16 mi + {g, g + 8}) by
// n-tiles nj (items wn + 8 nj + {2 t, 2 t + 1}), g = lane / 4, t = lane % 4.
// A block takes cpb consecutive chunks (blockIdx.y: chunks [cpb y, cpb y +
// cpb)): with cpb 1 it selects each chunk's list as the CUDA-core kernel
// does; with cpb > 1 (range mode, k' <= 32) it keeps each user's top k'
// over the chunks in registers and writes one list of k' per range.
template <typename TH, bool VEC>
__global__ void __launch_bounds__(kThreads, 1)
score_select_mma_kernel(const TH* __restrict__ U, const TH* __restrict__ T,
                        unsigned long long* __restrict__ lists, unsigned* __restrict__ bounds,
                        unsigned* __restrict__ maxes, unsigned* __restrict__ counters, int B,
                        int I, int d, int k, int chunk, int cpb, int mask_pad) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int dpad = (d + kBKM - 1) / kBKM * kBKM;
  const int ustride = dpad + 8;  // an odd number of 16-byte units
  const int kstride = chunk + kKeyPad;
  TH* us = reinterpret_cast<TH*>(smem_raw);
  TH* ring = us + kBM * ustride;
  unsigned* keys = reinterpret_cast<unsigned*>(ring + kStages * kBN * kTSM);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int b0 = blockIdx.x * kBM;
  const int nk = dpad / kBKM;
  const int ch0 = blockIdx.y * cpb;
  const int ch1 = min((I + chunk - 1) / chunk, ch0 + cpb);
  const bool range = cpb > 1;
  clear_counters(counters, b0, B, tid);

  // U's rows, in their own type, join the first copy group and stay for
  // every chunk
  if constexpr (VEC) {
    const int per_row = dpad / 8;
    for (int e = tid; e < kBM * per_row; e += kThreads) {
      const int m = e / per_row;
      const int c = e % per_row * 8;
      const bool valid = b0 + m < B && c < d;
      cp_async16(us + m * ustride + c, valid ? U + static_cast<size_t>(b0 + m) * d + c : U, valid);
    }
  } else {
    for (int e = tid; e < kBM * dpad; e += kThreads) {
      const int m = e / dpad;
      const int c = e % dpad;
      const bool valid = b0 + m < B && c < d;
      us[m * ustride + c] = valid ? U[static_cast<size_t>(b0 + m) * d + c] : zero_of<TH>();
    }
  }

  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int wm = (warp & 1) * 32;   // the warp's users
  const int wn = (warp >> 1) * 64;  // its items in a tile
  // ldmatrix rows: U row wm + (lane & 15) at depth (lane >> 4) * 8 gives
  // a0..a3 of an m-tile; T row wn + (lane >> 4) * 8 + (lane & 7) at depth
  // ((lane >> 3) & 1) * 8 gives b0, b1 of n-tile 2 p and of n-tile 2 p + 1
  const unsigned a_base = smem_addr(us + (wm + (lane & 15)) * ustride + (lane >> 4) * 8);
  const int b_off = (wn + ((lane >> 4) << 3) + (lane & 7)) * kTSM + ((lane >> 3) & 1) * 8;
  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 8; ++nj)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][nj][q] = 0.0f;
  unsigned long long set[kUsersPerWarp];  // range mode: the warp's users' top k'
  unsigned long long lo[kUsersPerWarp];
#pragma unroll
  for (int u = 0; u < kUsersPerWarp; ++u) {
    set[u] = lane < k ? 0ull : ~0ull;
    lo[u] = 0ull;
  }

  // a chunk's first kStages - 1 T tiles: for the next chunk of a range they
  // are copied while this chunk's keys are selected
  auto prologue = [&](int ch) {
    const int c0 = ch * chunk;
    const int n_end = c0 + min(chunk, I - c0);
    const int nsteps = (n_end - c0 + kBN - 1) / kBN * nk;
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < nsteps) {
        const int tile = s / nk;
        load_t_tile<TH, VEC, kBKM, kTSM>(ring + s * kBN * kTSM, T, c0 + tile * kBN, n_end,
                                         (s - tile * nk) * kBKM, d, tid);
      }
      cp_async_commit();
    }
  };
  prologue(ch0);
  for (int ch = ch0; ch < ch1; ++ch) {
    const int c0 = ch * chunk;
    const int n = min(chunk, I - c0);  // items of this chunk
    const int n_end = c0 + n;
    const int ntiles = (n + kBN - 1) / kBN;
    const int nsteps = ntiles * nk;

    int tile = 0;
    int ks = 0;
    int slot = 0;
    int ld_tile = (kStages - 1) / nk;
    int ld_ks = (kStages - 1) % nk;
    for (int step = 0; step < nsteps; ++step) {
      cp_async_wait<kStages - 2>();
      __syncthreads();
      if (ld_tile < ntiles) {
        const int nslot = slot == 0 ? kStages - 1 : slot - 1;
        load_t_tile<TH, VEC, kBKM, kTSM>(ring + nslot * kBN * kTSM, T, c0 + ld_tile * kBN,
                                         n_end, ld_ks * kBKM, d, tid);
      }
      cp_async_commit();
      if (++ld_ks == nk) {
        ld_ks = 0;
        ++ld_tile;
      }

      const unsigned b_base = smem_addr(ring + slot * kBN * kTSM + b_off);
#pragma unroll
      for (int kk = 0; kk < kBKM; kk += 16) {
        unsigned a[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          ldmatrix_x4(a[mi], a_base + 2 * (mi * 16 * ustride + ks * kBKM + kk));
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          unsigned bq[4];
          ldmatrix_x4(bq, b_base + 2 * (p * 16 * kTSM + kk));
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            mma16816<TH>(acc[mi][2 * p], a[mi], bq[0], bq[1]);
            mma16816<TH>(acc[mi][2 * p + 1], a[mi], bq[2], bq[3]);
          }
        }
      }

      if (ks == nk - 1) {  // the tile's products are complete: store their keys
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
          for (int nj = 0; nj < 8; ++nj) {
            const int col = tile * kBN + wn + 8 * nj + 2 * t4;
            const int row = wm + 16 * mi + g;
            const bool pad = mask_pad && c0 + col == 0;
            *reinterpret_cast<uint2*>(keys + row * kstride + col) =
                make_uint2(pad ? kNegInfKey : order_key(acc[mi][nj][0]),
                           order_key(acc[mi][nj][1]));
            *reinterpret_cast<uint2*>(keys + (row + 8) * kstride + col) =
                make_uint2(pad ? kNegInfKey : order_key(acc[mi][nj][2]),
                           order_key(acc[mi][nj][3]));
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[mi][nj][q] = 0.0f;
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
    __syncthreads();  // every T tile read and every key written
    if (ch + 1 < ch1) prologue(ch + 1);

    if (!range) {
      select_lists(keys, kstride, lists, bounds, maxes, b0, B, n, k, chunk, c0, warp, lane);
    } else if (ch == ch0) {
      range_first(keys, kstride, set, lo, b0, B, n, k, c0, warp, lane);
    } else {
      range_next(keys, kstride, set, lo, b0, B, n, c0, warp, lane);
    }
    __syncthreads();  // the next chunk's keys overwrite these
  }
  if (range) write_range(lists, bounds, maxes, set, lo, b0, B, k, warp, lane);
}

// One user's merge by a team of TEAM threads (thread tt of it): the k =
// min(k', n) best of the user's S lists (n entries ents, in item order;
// their keys also in copy where that is not null), sorted, into out_s /
// out_i (kout slots). Kp = TEAM * R >= k slots of words (pad_index(Kp)
// u64 of shared memory); red, warp_ties (2 x TEAM / 32) and gt are the
// team's shared scratch.
template <int TEAM, int R>
__device__ __forceinline__ void merge_user(const unsigned long long* __restrict__ ents,
                                           const unsigned* __restrict__ ubounds,
                                           unsigned long long* words, const unsigned* copy,
                                           int* red, int* warp_ties, int* gt_count,
                                           float* __restrict__ out_s, int* __restrict__ out_i,
                                           int kout, int S, int n, int col_offset, int tt) {
  constexpr int kTeamWarps = TEAM / 32;
  constexpr int Kp = TEAM * R;
  const int tw = tt >> 5;  // warp within the team
  const int lane = tt & 31;
  auto key_at = [&](int e) {
    return copy != nullptr ? copy[e] : static_cast<unsigned>(ents[e]);
  };
  const int k = min(kout, n);
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
    for (int c = tt; c < S; c += TEAM) lo = max(lo, ubounds[c]);
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
  if (tt == 0) *gt_count = 0;
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
      int* wt = warp_ties + ((e0 / TEAM) & 1) * kTeamWarps;
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
    if (lane == 0 && gtm != 0u) gt_base = atomicAdd(gt_count, __popc(gtm));
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
      out_s[j] = s;
      out_i[j] = item;
    }
  }
  for (int j = Kp + tt; j < kout; j += TEAM) {
    out_s[j] = neg_inf;
    out_i[j] = 0;
  }
}

// One team of TEAM threads (a warp, or the whole block) per user, the
// lists' keys copied into shared memory where keys_in_smem.
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
  merge_user<TEAM, R>(ents, bounds + static_cast<size_t>(b) * S, words,
                      keys_in_smem ? copy : nullptr, s_red[team], &s_warp_ties[team][0][0],
                      &s_gt[team], out_s + static_cast<size_t>(b) * kout,
                      out_i + static_cast<size_t>(b) * kout, kout, S, n, col_offset, tt);
}

// Ascending bitonic sort of w[0, N) in shared memory by the whole block (N
// a power of two).
__device__ __forceinline__ void block_bitonic(unsigned long long* w, int N, int tid) {
  for (int size = 2; size <= N; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < N / 2; i += kThreads) {
        const int lo = 2 * i - (i & (stride - 1));  // the pair (lo, lo + stride)
        const unsigned long long a = w[lo];
        const unsigned long long c = w[lo + stride];
        if ((a > c) == ((lo & size) == 0)) {
          w[lo] = c;
          w[lo + stride] = a;
        }
      }
      __syncthreads();
    }
  }
}

// The merge where a user's lists do not fit shared memory: `parts` blocks
// per user (block x: user x / parts, slice x % parts of its S lists).
// Shared memory: max(pad_index(Kp), kCandCap) u64 words, the candidates'
// sort or merge_user's words.
template <int R>
__global__ void __launch_bounds__(kThreads)
merge_split_kernel(const unsigned long long* __restrict__ lists,
                   const unsigned* __restrict__ bounds, const unsigned* __restrict__ maxes,
                   unsigned long long* __restrict__ cands, unsigned* __restrict__ counters,
                   float* __restrict__ out_s, int* __restrict__ out_i, int kout, int S,
                   int per_user, int n, int parts, int col_offset) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_red[2 * kWarps];
  __shared__ int s_warp_ties[2][kWarps];
  __shared__ int s_gt;
  __shared__ unsigned s_lo[kWarps];
  __shared__ unsigned s_m;
  __shared__ int s_last;
  static_assert(sizeof(s_red) + sizeof(s_warp_ties) + sizeof(s_gt) + sizeof(s_lo) + sizeof(s_m) +
                        sizeof(s_last) <=
                    kMergeStaticSmem,
                "merge_split_kernel's static shared memory outgrew kMergeStaticSmem");
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int b = blockIdx.x / parts;
  const int part = blockIdx.x - b * parts;
  const int lmax = per_user / S;  // entries of a list; the last holds n - (S - 1) lmax
  const unsigned long long* ents = lists + static_cast<size_t>(b) * per_user;
  const unsigned* ub = bounds + static_cast<size_t>(b) * S;
  const unsigned* um = maxes + static_cast<size_t>(b) * S;
  unsigned* count = counters + 2 * static_cast<size_t>(b);  // candidates, then finished blocks
  unsigned long long* cu = cands + static_cast<size_t>(b) * kCandCap;

  // Two lower bounds on the user's k'-th key: the largest list bound (a
  // list with k' keys at or above it), and the k'-th largest of the lists'
  // largest keys (k' lists each hold a key at or above it), built bit by
  // bit over the S maxima (read through L1) and stopped once exactly k' lie
  // at or above it
  unsigned lo = 0u;
  for (int c = tid; c < S; c += kThreads) lo = max(lo, ub[c]);
  lo = __reduce_max_sync(kFull, lo);
  if (lane == 0) s_lo[warp] = lo;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) lo = max(lo, s_lo[w]);
  if (kout <= S) {
    unsigned lo_m = 0u;
    int parity = 0;
    for (int bit = 31; bit >= 0; --bit) {
      const unsigned c = lo_m | (1u << bit);
      int a = 0;
      for (int i = tid; i < S; i += kThreads) a += __ldg(um + i) >= c ? 1 : 0;
      parity ^= 1;
      const int cnt = team_sum<kThreads>(a, s_red, parity, warp, lane);
      if (cnt >= kout) {
        lo_m = c;
        if (cnt == kout) break;
      }
    }
    lo = max(lo, lo_m);
  }

  // this block's lists: those whose largest key reaches lo are read, once,
  // and their entries at or above lo (padding, key 0, never) join the
  // user's candidates, one atomic per warp that has any; the others are
  // never read
  const int per_part = (S + parts - 1) / parts;
  const int l0 = part * per_part;
  const int l1 = min(S, l0 + per_part);
  for (int base = l0 + 32 * warp; base < l1; base += kThreads) {  // warp-uniform bounds
    const int c = base + lane;
    unsigned hits = __ballot_sync(kFull, c < l1 && __ldg(um + c) >= lo);
    while (hits != 0u) {
      const int list = base + __ffs(hits) - 1;
      hits &= hits - 1;
      const int len = min(lmax, n - list * lmax);
      const unsigned long long* lp = ents + static_cast<size_t>(list) * lmax;
      for (int j0 = 0; j0 < len; j0 += 32) {
        const int j = j0 + lane;
        const unsigned long long v = j < len ? __ldcs(lp + j) : 0ull;
        const unsigned key = static_cast<unsigned>(v);
        const bool take = key != 0u && key >= lo;
        const unsigned vote = __ballot_sync(kFull, take);
        if (vote == 0u) continue;
        unsigned at = 0u;
        if (lane == 0) at = atomicAdd(count, static_cast<unsigned>(__popc(vote)));
        at = __shfl_sync(kFull, at, 0) + __popc(vote & lanemask_lt());
        if (take && at < kCandCap) cu[at] = v;
      }
    }
  }

  // the user's last block to finish ranks the candidates
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    s_last = atomicAdd(count + 1, 1u) == static_cast<unsigned>(parts - 1);
    if (s_last) s_m = atomicAdd(count, 0u);
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const unsigned m = s_m;
  float* os = out_s + static_cast<size_t>(b) * kout;
  int* oi = out_i + static_cast<size_t>(b) * kout;
  unsigned long long* w = reinterpret_cast<unsigned long long*>(smem_raw);
  if (m > static_cast<unsigned>(kCandCap)) {
    // more candidates than the sort holds (scores the bounds do not
    // separate): the search over the lists in place
    merge_user<kThreads, R>(ents, ub, w, nullptr, s_red, &s_warp_ties[0][0], &s_gt, os, oi,
                            kout, S, n, col_offset, tid);
    return;
  }
  int N = 1;
  while (N < static_cast<int>(m)) N <<= 1;
  for (int j = tid; j < N; j += kThreads) {
    if (j < static_cast<int>(m)) {  // (~key, item): score descending, then item ascending
      const unsigned long long e = __ldcg(cu + j);
      w[j] = (static_cast<unsigned long long>(~static_cast<unsigned>(e)) << 32) | (e >> 32);
    } else {
      w[j] = ~0ull;
    }
  }
  __syncthreads();
  block_bitonic(w, N, tid);
  const float neg_inf = -__int_as_float(0x7f800000);
  for (int j = tid; j < kout; j += kThreads) {
    float s = neg_inf;
    int item = 0;
    if (j < static_cast<int>(m)) {
      s = key_score(~static_cast<unsigned>(w[j] >> 32));
      item = (s == neg_inf) ? 0 : static_cast<int>(w[j] & 0xffffffffu) + col_offset;
    }
    os[j] = s;
    oi[j] = item;
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

struct ScoreArgs {
  const void* U;
  const void* T;
  unsigned long long* lists;
  unsigned* bounds;
  unsigned* maxes;     // null unless the split merge follows
  unsigned* counters;  // null unless the split merge follows
  int B, I, d, k, chunk, cpb, mask_pad, vec;
  dim3 grid;
  long long smem;
  cudaStream_t st;
};

template <auto Kernel, typename TU, typename TT>
cudaError_t launch_score_kernel(const ScoreArgs& a) {
  const cudaError_t err = set_smem<Kernel>(a.smem);
  if (err != cudaSuccess) return err;
  Kernel<<<a.grid, kThreads, a.smem, a.st>>>(static_cast<const TU*>(a.U),
                                             static_cast<const TT*>(a.T), a.lists, a.bounds,
                                             a.maxes, a.counters, a.B, a.I, a.d, a.k, a.chunk,
                                             a.mask_pad);
  return cudaGetLastError();
}

template <auto Kernel, typename TH>
cudaError_t launch_mma_kernel(const ScoreArgs& a) {
  const cudaError_t err = set_smem<Kernel>(a.smem);
  if (err != cudaSuccess) return err;
  Kernel<<<a.grid, kThreads, a.smem, a.st>>>(static_cast<const TH*>(a.U),
                                             static_cast<const TH*>(a.T), a.lists, a.bounds,
                                             a.maxes, a.counters, a.B, a.I, a.d, a.k, a.chunk,
                                             a.cpb, a.mask_pad);
  return cudaGetLastError();
}

// U of type TU, T of type TT: the tensor cores for one half type on both
// sides, else the CUDA cores.
template <typename TU, typename TT>
cudaError_t launch_score(const ScoreArgs& a) {
  if constexpr (std::is_same<TU, TT>::value && !std::is_same<TT, float>::value) {
    return a.vec ? launch_mma_kernel<score_select_mma_kernel<TT, true>, TT>(a)
                 : launch_mma_kernel<score_select_mma_kernel<TT, false>, TT>(a);
  } else {
    return a.vec ? launch_score_kernel<score_select_kernel<TU, TT, true>, TU, TT>(a)
                 : launch_score_kernel<score_select_kernel<TU, TT, false>, TU, TT>(a);
  }
}

template <typename TU>
cudaError_t launch_score_for(int t_type, const ScoreArgs& a) {
  switch (t_type) {
    case kF32: return launch_score<TU, float>(a);
    case kBF16: return launch_score<TU, __nv_bfloat16>(a);
    case kF16: return launch_score<TU, __half>(a);
    default: return cudaErrorInvalidValue;
  }
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

template <int R>
cudaError_t launch_split(const unsigned long long* ls, const unsigned* bd, const unsigned* mx,
                         unsigned long long* cands, unsigned* counters, float* os, int* oi,
                         int B, int k, int S, int per_user, int n, int parts, int col_offset,
                         long long smem, cudaStream_t st) {
  const cudaError_t err = set_smem<merge_split_kernel<R>>(smem);
  if (err != cudaSuccess) return err;
  merge_split_kernel<R><<<B * parts, kThreads, smem, st>>>(ls, bd, mx, cands, counters, os, oi,
                                                          k, S, per_user, n, parts, col_offset);
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

long long fused_topk_smem_bytes(int d, int chunk, int u_type, int t_type) {
  if (u_type == t_type && t_type == kBF16) return score_smem_bytes<__nv_bfloat16, true>(d, chunk);
  if (u_type == t_type && t_type == kF16) return score_smem_bytes<__half, true>(d, chunk);
  if (t_type == kF32) return score_smem_bytes<float, false>(d, chunk);
  return t_type == kBF16 ? score_smem_bytes<__nv_bfloat16, false>(d, chunk)
                         : score_smem_bytes<__half, false>(d, chunk);
}

int fused_topk_launch(const void* U, const void* T, void* scratch, void* out_s, void* out_i,
                      int B, int I, int d, int k, int chunk, int S, int cpb, int n, int Kp,
                      int team, int keys_in_smem, int parts, int vec, long long smem1,
                      long long smem2, int col_offset, int mask_pad, int u_type, int t_type,
                      void* stream) {
  if (u_type < kF32 || u_type > kF16 || t_type < kF32 || t_type > kF16)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool mma = u_type == t_type && t_type != kF32;
  // range mode (cpb > 1): the tensor-core kernel, k' <= 32, one list of k'
  // per range of cpb chunks; otherwise one list per chunk
  if (cpb < 1 || (cpb > 1 && (!mma || k > kRangeMaxK || S < 2)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int lists_per_user = (S + cpb - 1) / cpb;
  const int lmax = cpb > 1 ? k : list_len(k, chunk);
  const int last = I - (S - 1) * chunk;
  if (B <= 0 || I <= 0 || d <= 0 || k <= 0 || chunk <= 0 || chunk % kBN != 0 ||
      chunk > kMaxChunk || S <= 0 || S > kMaxSplits || last <= 0 || last > chunk ||
      n != (cpb > 1 ? lists_per_user * k : (S - 1) * lmax + (lmax < last ? lmax : last)) ||
      Kp < (k < n ? k : n) || smem1 != fused_topk_smem_bytes(d, chunk, u_type, t_type))
    return static_cast<int>(cudaErrorInvalidValue);
  // the split merge: one block team, its sort within kCandCap, blocks within the grid
  if (parts < 0 || (parts > 0 && (team != kThreads || keys_in_smem || Kp > kCandCap ||
                                  static_cast<long long>(B) * parts > 0x7fffffffll)))
    return static_cast<int>(cudaErrorInvalidValue);
  // 16 bytes of a T row must be whole elements of d, and every 16-byte copy aligned
  if (vec && ((d & (t_type == kF32 ? 3 : 7)) != 0 || (reinterpret_cast<uintptr_t>(T) & 15) != 0 ||
              ((u_type == kF32 || mma) && (reinterpret_cast<uintptr_t>(U) & 15) != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* ls = static_cast<unsigned long long*>(scratch);
  // B * L bounds (L lists a user) follow the B * L * lmax list entries; for
  // the split merge, B * L maxima, B * kCandCap candidates and B counter
  // pairs follow, each at a word boundary
  const int L = lists_per_user;
  const size_t n_lists = static_cast<size_t>(B) * L * lmax;
  const size_t half_words = (static_cast<size_t>(B) * L + 1) / 2;  // B * L 4-byte values
  auto* bd = reinterpret_cast<unsigned*>(ls + n_lists);
  auto* mx = reinterpret_cast<unsigned*>(ls + n_lists + half_words);
  unsigned long long* cands = ls + n_lists + 2 * half_words;
  auto* counters = reinterpret_cast<unsigned*>(cands + static_cast<size_t>(B) * kCandCap);
  auto* os = static_cast<float*>(out_s);
  auto* oi = static_cast<int*>(out_i);
  auto st = static_cast<cudaStream_t>(stream);

  const ScoreArgs args{U, T, ls, bd, parts > 0 ? mx : nullptr, parts > 0 ? counters : nullptr,
                       B, I, d, k, chunk, cpb, mask_pad, vec, dim3((B + kBM - 1) / kBM, L),
                       smem1, st};
  cudaError_t err;
  switch (u_type) {
    case kF32: err = launch_score_for<float>(t_type, args); break;
    case kBF16: err = launch_score_for<__nv_bfloat16>(t_type, args); break;
    default: err = launch_score_for<__half>(t_type, args); break;
  }
  if (err != cudaSuccess) return static_cast<int>(err);

  const int pu = L * lmax;
  const int ks = keys_in_smem;
  if (parts > 0) {
    switch (Kp) {
      case 256: err = launch_split<1>(ls, bd, mx, cands, counters, os, oi, B, k, L, pu, n, parts, col_offset, smem2, st); break;
      case 512: err = launch_split<2>(ls, bd, mx, cands, counters, os, oi, B, k, L, pu, n, parts, col_offset, smem2, st); break;
      case 1024: err = launch_split<4>(ls, bd, mx, cands, counters, os, oi, B, k, L, pu, n, parts, col_offset, smem2, st); break;
      case 2048: err = launch_split<8>(ls, bd, mx, cands, counters, os, oi, B, k, L, pu, n, parts, col_offset, smem2, st); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  } else if (team == 32) {
    switch (Kp) {
      case 32: err = launch_merge<32, 1>(ls, bd, os, oi, B, k, L, pu, n, ks, col_offset, smem2, st); break;
      case 64: err = launch_merge<32, 2>(ls, bd, os, oi, B, k, L, pu, n, ks, col_offset, smem2, st); break;
      case 128: err = launch_merge<32, 4>(ls, bd, os, oi, B, k, L, pu, n, ks, col_offset, smem2, st); break;
      case 256: err = launch_merge<32, 8>(ls, bd, os, oi, B, k, L, pu, n, ks, col_offset, smem2, st); break;
      case 512: err = launch_merge<32, 16>(ls, bd, os, oi, B, k, L, pu, n, ks, col_offset, smem2, st); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  } else if (team == kThreads) {
    switch (Kp) {
      case 1024: err = launch_merge<kThreads, 4>(ls, bd, os, oi, B, k, L, pu, n, ks, col_offset, smem2, st); break;
      case 2048: err = launch_merge<kThreads, 8>(ls, bd, os, oi, B, k, L, pu, n, ks, col_offset, smem2, st); break;
      case 4096: err = launch_merge<kThreads, 16>(ls, bd, os, oi, B, k, L, pu, n, ks, col_offset, smem2, st); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

}  // extern "C"
