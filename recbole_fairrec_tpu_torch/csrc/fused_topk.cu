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
// products, as on the TPU up to summation order. Three paths:
//  * same-type half calls (bf16 x bf16, f16 x f16) with k' <= 32 over many
//    chunks, whose table TMA can read (d % 8 == 0, d <= 128, 16-byte
//    aligned users and table), run the Hopper range kernel
//    (score_select_wgmma_kernel: TMA, wgmma with f32 accumulators, the
//    selection in registers; below);
//  * the other same-type half calls run the products on the tensor cores
//    through mma.sync m16n8k16 (f32 accumulators), a list per chunk
//    (score_select_mma_kernel). Either way the products
//    stay exact; only the order and rounding of the d additions differ
//    from a chain of fmaf;
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
// The Hopper range kernel at catalog scale (kernel_sweep.py --scale --modes,
// H100 80GB HBM3 at 700 W, bf16, k' 10): B 128 0.508 ms a call back to back
// (score + select 0.490, merge 0.017) against the 0.160 ms bytes bound, B
// 1024 1.727 ms (1.675 + 0.035) against the 0.556 ms operations bound. A
// call alone: 0.580 / 1.782 ms; the plain version 111 / 276 ms,
// topk(mm(out_dtype=f32)) 3.88 / 30.7 ms. Against
// the bytes at B 128, TMA streams each tile once, 5 in flight an SM (the
// products and a vote a tile alone take ~0.18 ms). Against the operations
// at B 1024, wgmma runs with the users held in registers and no barrier in
// the depth loop (products and vote alone ~0.97 ms). The rest, at both
// sizes, is selection: a score above its user's running threshold (about
// k' ln(items / k') of them a user and range) turns a warp's tile from 64
// maxima and a vote into a scan, and a warpgroup's next products wait for
// its slowest warp.
//
// Design: two kernels per call, on one stream.
//  1. score + select. The Hopper range kernel is described where it is
//     defined (score_select_wgmma_kernel); the others: grid (ceil(B/64),
//     S), 256 threads. A block owns kBM =
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

#include <cuda.h>
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

// range mode (the Hopper range kernel): k' at most this, a user's top k'
// kept in registers over a range of chunks
constexpr int kRangeMaxK = 32;

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
template <typename TH, bool VEC>
__global__ void __launch_bounds__(kThreads, 1)
score_select_mma_kernel(const TH* __restrict__ U, const TH* __restrict__ T,
                        unsigned long long* __restrict__ lists, unsigned* __restrict__ bounds,
                        unsigned* __restrict__ maxes, unsigned* __restrict__ counters, int B,
                        int I, int d, int k, int chunk, int mask_pad) {
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
  const int c0 = blockIdx.y * chunk;
  const int n = min(chunk, I - c0);  // items of this chunk
  const int n_end = c0 + n;
  const int ntiles = (n + kBN - 1) / kBN;
  const int nk = dpad / kBKM;
  const int nsteps = ntiles * nk;
  clear_counters(counters, b0, B, tid);

  // U's rows, in their own type, join the first copy group
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
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nsteps) {
      const int tile = s / nk;
      load_t_tile<TH, VEC, kBKM, kTSM>(ring + s * kBN * kTSM, T, c0 + tile * kBN, n_end,
                                       (s - tile * nk) * kBKM, d, tid);
    }
    cp_async_commit();
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
      load_t_tile<TH, VEC, kBKM, kTSM>(ring + nslot * kBN * kTSM, T, c0 + ld_tile * kBN, n_end,
                                       ld_ks * kBKM, d, tid);
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

  select_lists(keys, kstride, lists, bounds, maxes, b0, B, n, k, chunk, c0, warp, lane);
}

// ---------------------------------------------------------------------------
// The Hopper range kernel (score_select_wgmma_kernel): range mode, on TMA
// and wgmma, for same-type half calls with k' <= 32, 16-byte aligned
// tensors, d % 8 == 0 and d <= kWgMaxD. A block of 384 threads holds
// kWgUsers = 128 users: warps 0-3 and 4-7 are two consumer warpgroups of 64
// users each (wgmma's M side), warps 8-11 the producer warpgroup, one thread
// of which keeps kWgStages T tiles of kWgTile items in flight (TMA into a
// ring of mbarrier stages; setmaxnreg moves its registers to the
// consumers). A tile is the full depth: ceil(d / 64) panels of 128 rows x
// 128 bytes, 128-byte swizzled, so no barrier falls inside the depth loop.
// Both warpgroups read the same tiles; each runs its 64 x 128 products
// (m64n128k16, A = its users from registers, loaded once, B = the tile from
// shared memory, f32 accumulators) and then selects from them.
constexpr int kWgUsers = 128;          // users per block: two warpgroups of 64
constexpr int kWgTile = 128;           // items per T tile (wgmma's N)
constexpr int kWgStages = 5;           // T tiles in flight
constexpr int kWgConsumerWarps = 8;    // two warpgroups
constexpr int kWgThreads = 32 * kWgConsumerWarps + 128;  // and the producer warpgroup
// registers a thread of the producer and of a consumer warpgroup holds after
// setmaxnreg: 128 x 40 + 256 x 232 <= 65,536
constexpr int kWgProducerRegs = 40;
constexpr int kWgConsumerRegs = 232;
constexpr int kWgMaxD = 128;           // depth the layout holds: two panels
constexpr int kPanel = 64;             // elements of a 128-byte swizzled row
constexpr int kCandWords = 64;         // a user's top-k' set and its candidates
constexpr int kWgWarpUsers = 16;       // users of a consumer warp

// Dynamic shared memory of a block, in the order of its layout after up to
// 1,024 bytes that align it (the swizzle repeats every 1,024 bytes):
// ring[kWgStages][panels][kWgTile][128 B] | cand[kWgUsers][kCandWords] u64
// (each user's buffer) | full[kWgStages], empty[kWgStages] mbarriers.
// ops/fused_topk.py::wgmma_smem_bytes mirrors it; the launch refuses a plan
// whose bytes differ.
__host__ __device__ constexpr long long wgmma_smem_bytes(int d) {
  return 1024ll + static_cast<long long>((d + kPanel - 1) / kPanel) * 128 * kWgStages * kWgTile +
         8ll * kWgUsers * kCandWords + 16ll * kWgStages;
}
static_assert(wgmma_smem_bytes(128) == 230480, "the catalog's d 128 block");
static_assert(wgmma_smem_bytes(64) == 148560, "a d 64 block");
static_assert(wgmma_smem_bytes(8) == 148560, "a d 8 block: one panel");
static_assert(128 * kWgProducerRegs + 32 * kWgConsumerWarps * kWgConsumerRegs <= 65536,
              "the warpgroups' registers fit the SM's");
static_assert(kWgUsers == 2 * 64 && kWgConsumerWarps * kWgWarpUsers == kWgUsers,
              "two warpgroups of 64 users, 16 a warp");
static_assert((kCandWords - kRangeMaxK) / 4 >= 8, "a lane's region holds 8 words at k' 32");

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed. The
// loop is inside the asm, so the compiler sees no divergent path around the
// wgmma that follows.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// rows [y, y + kWgTile) x columns [x, x + kPanel) of the table into shared
// memory, 128-byte swizzled; out-of-range rows and columns arrive as zeros
__device__ __forceinline__ void tma_load_tile(unsigned dst, const CUtensorMap* map, unsigned bar,
                                              int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(x), "r"(y), "r"(bar)
      : "memory");
}

// wgmma's view of a K-major operand whose rows are 128 bytes, 128-byte
// swizzled, 8-row groups 1,024 bytes apart
__device__ __forceinline__ unsigned long long sw128_desc(unsigned addr) {
  return static_cast<unsigned long long>((addr & 0x3ffffu) >> 4) | (1ull << 16) |
         (static_cast<unsigned long long>(1024 >> 4) << 32) | (1ull << 62);
}

#define WGMMA_D64(d) \
    "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
    "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
    "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
    "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
    "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
    "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
    "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
    "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// d[64 x 128] (+)= A[64 x 16] . B[128 x 16]^T for one warpgroup, A from
// registers (warp w of it holds rows 16 w .. 16 w + 15 as mma.m16n8k16's A
// fragment: a[0] row g columns 2 q, 2 q + 1; a[1] row g + 8; a[2], a[3] the
// same 8 columns on), B from shared memory. Thread t of the warpgroup holds
// rows 16 (t / 32) + (t % 32) / 4 + {0, 8} and columns 8 j + 2 (t % 4) +
// {0, 1}, j < 16, as d[4 j + {0, 1}] (row +0) and d[4 j + {2, 3}] (row +8).
// Products exact, sums in f32.
template <typename TH>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], const unsigned (&a)[4],
                                           unsigned long long db, int accumulate) {
  if constexpr (std::is_same<TH, __nv_bfloat16>::value) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : WGMMA_D64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
  } else {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : WGMMA_D64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
  }
}

// Sums over the 4 lanes of a quad: all of them, and those of lower lanes.
__device__ __forceinline__ int quad_sum(int v) {
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
}

__device__ __forceinline__ int quad_before(int v, int q) {
  int y = v;
  int o = __shfl_up_sync(kFull, y, 1, 4);
  if (q >= 1) y += o;
  o = __shfl_up_sync(kFull, y, 2, 4);
  if (q >= 2) y += o;
  return y - v;
}

constexpr int kQuadWords = kCandWords / 4;  // buffer words a lane reads in a cut

// A user's buffer: kCandWords words, entries (item << 32 | key), 0 where
// empty (every real key is above 0). Logical word p lies at (p + rot) % 64,
// rot = 4 (g % 4) for the users of quad g, so that the 16 lanes of a
// half-warp, reading word q + 4 i of their users at once, fall on 16
// distinct 8-byte bank pairs. The set takes words [0, k'), then lane q of
// the quad has a candidate region of R = (kCandWords - k') / 4 words at k' +
// q R: a lane appends the items of its own columns that beat the user's
// threshold there, with no exchange between lanes.
struct Buf {
  unsigned long long* w;
  int rot;
  __device__ __forceinline__ unsigned long long& operator[](int p) const {
    return w[(p + rot) & (kCandWords - 1)];
  }
};
static_assert((kCandWords & (kCandWords - 1)) == 0, "a buffer's words wrap by a mask");

// A lane's selection state for its two users (rows g and g + 8 of its
// warp): thresholds (the k'-th best score of the set at its last cut; -inf
// until the user has held k', +inf for a row past B), words in the sets,
// words in the lane's own regions, and the sets' bounds (the k'-th key, 0
// where fewer).
struct Sel {
  float t0, t1;
  int ns0, ns1, c0, c1;
  unsigned tau0, tau1;
};

// The k'-th largest of the values a quad holds for one user (16 a lane, 0
// for none), bit by bit from the top; 0 where it has fewer than k' values
// above 0. Four partial counts per step, for independent chains.
__device__ __forceinline__ unsigned quad_kth(const unsigned (&x)[kQuadWords], int k) {
  unsigned a = 0u;
#pragma unroll 2
  for (int bit = 31; bit >= 0; --bit) {
    const unsigned c = a | (1u << bit);
    int part[4] = {0, 0, 0, 0};
#pragma unroll
    for (int i = 0; i < kQuadWords; ++i) part[i & 3] += x[i] >= c ? 1 : 0;
    if (quad_sum((part[0] + part[1]) + (part[2] + part[3])) >= k) a = c;
  }
  return a;
}

// One user's buffer cut to its best min(n, k') words (lane q of its quad
// holds the keys of words q + 4 i in key): every word above tau, the k'-th
// largest key, and of those equal to it the ones whose item is item_max or
// below (the smallest ones: a later item ranks below an equal earlier one).
// They are written, in no order, to [0, ns) and every other word cleared.
// Returns tau where k' remain (the key of the user's new threshold), else 0.
__device__ __forceinline__ unsigned quad_cut(const Buf& ub, const unsigned (&key)[kQuadWords],
                                             unsigned tau, unsigned item_max, int& ns, int k,
                                             int q) {
  unsigned long long w[kQuadWords];
  unsigned keep = 0u;
#pragma unroll
  for (int i = 0; i < kQuadWords; ++i) {
    w[i] = ub[q + 4 * i];
    const bool kp = key[i] != 0u && (key[i] > tau || (key[i] == tau &&
                                                      static_cast<unsigned>(w[i] >> 32) <= item_max));
    keep |= static_cast<unsigned>(kp) << i;
  }
  const int kept = __popc(keep);
  int at = quad_before(kept, q);
  ns = quad_sum(kept);
  __syncwarp();  // every lane has read its words
#pragma unroll
  for (int i = 0; i < kQuadWords; ++i) ub[q + 4 * i] = 0ull;
  __syncwarp();
#pragma unroll
  for (int i = 0; i < kQuadWords; ++i)
    if ((keep >> i) & 1u) ub[at++] = w[i];
  __syncwarp();
  return ns >= k ? tau : 0u;
}

// One user's buffer cut to its best min(n, k') words (quad_cut): its
// threshold t rises to the k'-th best score where it holds k' words, its
// bound tau is that score's key (0 where fewer), its candidate count c
// restarts at 0. The items of keys tied at the k'-th are searched only
// where more ties than places remain. Every lane of the warp takes part,
// each quad for its own user.
__device__ __forceinline__ void quad_keep_one(const Buf& ub, float& t, int& ns, int& c,
                                              unsigned& tau, int k, int q) {
  unsigned key[kQuadWords];
#pragma unroll
  for (int i = 0; i < kQuadWords; ++i) key[i] = static_cast<unsigned>(ub[q + 4 * i]);
  const unsigned a = quad_kth(key, k);
  int above = 0, tie = 0;
#pragma unroll
  for (int i = 0; i < kQuadWords; ++i) {
    above += key[i] > a;
    tie += key[i] == a && a != 0u;
  }
  const int m = k - quad_sum(above);  // places left for ties
  const bool many = quad_sum(tie) > m;
  // the ties' items; the m-th smallest of them is the largest one kept
  unsigned mx = ~0u;
  if (__any_sync(kFull, many)) {
    unsigned it[kQuadWords];
#pragma unroll
    for (int i = 0; i < kQuadWords; ++i)  // ~item: the m-th largest is the m-th smallest item
      it[i] = key[i] == a && a != 0u ? ~static_cast<unsigned>(ub[q + 4 * i] >> 32) : 0u;
    const unsigned b = quad_kth(it, max(m, 1));
    if (many) mx = ~b;
  }
  tau = quad_cut(ub, key, a, mx, ns, k, q);
  if (tau != 0u) t = key_score(tau);
  c = 0;
}

// Both users of a lane cut to their best min(n, k') words, one after the
// other (quad_keep_one).
__device__ __forceinline__ void quad_keep(const Buf& ub0, const Buf& ub1, Sel& st, int k, int q) {
  quad_keep_one(ub0, st.t0, st.ns0, st.c0, st.tau0, k, q);
  quad_keep_one(ub1, st.t1, st.ns1, st.c1, st.tau1, k, q);
}

// One pass of a lane over its columns of a tile (column 8 j + 2 q + e, item
// item0 + 8 j + e, at acc[4 j + e] for user 0 and acc[4 j + 2 + e] for user
// 1; columns [c_lo, c_hi) hold items), over the n8 blocks j in jmask (the
// same for the whole warp) and from bit 2 j + e = from0 / from1 of each
// user on: a score above the user's threshold (at or above it where not
// STRICT) joins the lane's region, in column order, until the region is
// full; stop0 / stop1 then hold the first bit left out.
template <bool STRICT>
__device__ __forceinline__ void scan_tile(const float (&acc)[64], Sel& st, const Buf& ub0,
                                          const Buf& ub1, int reg, int R, int item0, int c_lo,
                                          int c_hi, int q, unsigned jmask, int from0, int from1,
                                          int& stop0, int& stop1) {
  auto beats = [](float v, float t) { return STRICT ? v > t : v >= t; };
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if (!((jmask >> j) & 1u)) continue;  // warp-uniform
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int bit = 2 * j + e;
      const int col = 8 * j + 2 * q + e;
      const bool in = col >= c_lo && col < c_hi;
      const float v0 = acc[4 * j + e];
      const float v1 = acc[4 * j + 2 + e];
      if (in && bit >= from0 && beats(v0, st.t0)) {
        if (st.c0 < R)
          ub0[reg + st.c0++] = entry(order_key(v0), item0 + 8 * j + e);
        else
          stop0 = min(stop0, bit);
      }
      if (in && bit >= from1 && beats(v1, st.t1)) {
        if (st.c1 < R)
          ub1[reg + st.c1++] = entry(order_key(v1), item0 + 8 * j + e);
        else
          stop1 = min(stop1, bit);
      }
    }
  }
}

// The selection of one tile whose scores a lane holds in acc (scan_tile's
// layout). A tile whose scores are all at or below their users' thresholds
// costs 64 maxima and one vote. Otherwise the warp scans the n8 blocks in
// which any lane has a score above a threshold, and each lane appends
// those scores to its regions, in column order. Where a region filled, the
// warp's buffers are cut to their best k' (raising the thresholds) and the
// lanes that stopped go on from the first column they left out, now taking
// scores at or above the threshold: the cut's set may hold items of this
// tile later than theirs, and an equal score of an earlier item ranks above
// those; the next cut ranks them by item.
__device__ __forceinline__ void select_tile(const float (&acc)[64], Sel& st, const Buf& ub0,
                                            const Buf& ub1, int reg, int R, int k, int q,
                                            int item0, int c_lo, int c_hi) {
  float x[4], y[4];  // four partial maxima a user, for independent chains
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    x[j] = fmaxf(acc[4 * j], acc[4 * j + 1]);
    y[j] = fmaxf(acc[4 * j + 2], acc[4 * j + 3]);
  }
#pragma unroll
  for (int j = 4; j < 16; ++j) {
    x[j & 3] = fmaxf(x[j & 3], fmaxf(acc[4 * j], acc[4 * j + 1]));
    y[j & 3] = fmaxf(y[j & 3], fmaxf(acc[4 * j + 2], acc[4 * j + 3]));
  }
  const float m0 = fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3]));
  const float m1 = fmaxf(fmaxf(y[0], y[1]), fmaxf(y[2], y[3]));
  if (!__any_sync(kFull, m0 > st.t0 || m1 > st.t1)) return;  // the common case
  unsigned jm[4] = {0u, 0u, 0u, 0u};  // bit j: n8 block j holds a score above a threshold
#pragma unroll
  for (int j = 0; j < 16; ++j)
    jm[j & 3] |= (fmaxf(acc[4 * j], acc[4 * j + 1]) > st.t0 ||
                  fmaxf(acc[4 * j + 2], acc[4 * j + 3]) > st.t1 ? 1u : 0u) << j;
  const unsigned jmask = __reduce_or_sync(kFull, (jm[0] | jm[1]) | (jm[2] | jm[3]));
  int stop0 = 32, stop1 = 32;
  scan_tile<true>(acc, st, ub0, ub1, reg, R, item0, c_lo, c_hi, q, jmask, 0, 0, stop0, stop1);
  while (__any_sync(kFull, stop0 < 32 || stop1 < 32)) {
    quad_keep(ub0, ub1, st, k, q);
    const int from0 = stop0, from1 = stop1;
    stop0 = 32;
    stop1 = 32;
    scan_tile<false>(acc, st, ub0, ub1, reg, R, item0, c_lo, c_hi, q, 0xffffu, from0, from1,
                     stop0, stop1);
  }
}

// The end of a range for one user (its quad): its set, min(n, k') words in
// [0, ns) in no order, becomes its list for the range (k' entries in item
// order, each word at its rank by item; entry(0, 0) where empty), with its
// bound tau (the k'-th key, 0 where the range held fewer) and, where maxes
// is not null, its largest key: the format the merge reads for a range.
__device__ __forceinline__ void quad_write(const Buf& ub, int ns, unsigned tau, int b, int k,
                                           int q, unsigned long long* __restrict__ lists,
                                           unsigned* __restrict__ bounds,
                                           unsigned* __restrict__ maxes, bool live) {
  const size_t at = static_cast<size_t>(b) * gridDim.y + blockIdx.y;
  unsigned top = 0u;
  for (int p = q; p < k; p += 4) {
    const unsigned long long w = p < ns ? ub[p] : 0ull;  // 0 is entry(0, 0)
    top = max(top, static_cast<unsigned>(w));
    int rank = p;
    if (p < ns) {
      rank = 0;
      for (int r = 0; r < ns; ++r) rank += (ub[r] >> 32) < (w >> 32);
    }
    if (live) lists[at * k + rank] = w;
  }
  top = max(top, __shfl_xor_sync(kFull, top, 1));
  top = max(top, __shfl_xor_sync(kFull, top, 2));
  if (live && q == 0) {
    bounds[at] = tau;
    if (maxes != nullptr) maxes[at] = top;
  }
}

__device__ __forceinline__ void fence_acc(float (&acc)[64]) {
#pragma unroll
  for (int j = 0; j < 64; ++j) asm volatile("" : "+f"(acc[j])::"memory");
}

// Range mode on Hopper (see kWgUsers above). Grid (ceil(B / kWgUsers),
// ranges): block (x, y) takes users [128 x, 128 x + 128) and the items of
// chunks [cpb y, cpb y + cpb), tiles of kWgTile in ascending order, and
// writes one list of k' entries per (range, user).
// Selection in registers (select_tile): a thread's accumulators hold 2
// users (rows g and g + 8 of its warp's 16), 32 items each, and each user's
// threshold sits in a register of each of the 4 lanes of its quad. A lane
// appends its scores above it to its own region of the user's buffer in
// shared memory; where a region fills, the warp's buffers are cut to their
// best k' (quad_keep) and the thresholds raised. Items arrive in
// ascending order, so a score equal to the threshold belongs to a later
// item than k' words at or above it and ranks below them all: it is
// rejected, across tiles, warpgroups and ranges alike. Item 0 (mask_pad)
// and columns past the range are masked where scores are taken; the
// accumulators are never written outside wgmma.
template <typename TH>
__global__ void __launch_bounds__(kWgThreads, 1)
score_select_wgmma_kernel(const __grid_constant__ CUtensorMap tmap, const TH* __restrict__ U,
                          unsigned long long* __restrict__ lists, unsigned* __restrict__ bounds,
                          unsigned* __restrict__ maxes, unsigned* __restrict__ counters, int B,
                          int I, int d, int k, int chunk, int cpb, int mask_pad) {
  extern __shared__ __align__(16) unsigned char smem_raw[];  // aligned to 1,024 below
  const unsigned raw = smem_addr(smem_raw);
  unsigned char* base = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  const int panels = (d + kPanel - 1) / kPanel;
  const int panel_rows = kWgTile * 128;  // bytes of one panel of a tile
  unsigned char* ring = base;
  auto* cand = reinterpret_cast<unsigned long long*>(ring + kWgStages * panels * panel_rows);
  const unsigned bars = smem_addr(cand + kWgUsers * kCandWords);  // full[s] at 8 s, empty[s] at 8 (kWgStages + s)

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int b0 = blockIdx.x * kWgUsers;
  const int S = (I + chunk - 1) / chunk;
  const int r_begin = blockIdx.y * cpb * chunk;
  const int r_end = min(I, min(S, (blockIdx.y + 1) * cpb) * chunk);
  const int ntiles = (r_end - r_begin + kWgTile - 1) / kWgTile;
  // the split merge's per-user counters start at 0 (the first range's
  // blocks clear them, before the merge launches on the same stream)
  if (counters != nullptr && blockIdx.y == 0 && tid < kWgUsers && b0 + tid < B)
    reinterpret_cast<uint2*>(counters)[b0 + tid] = make_uint2(0u, 0u);
  for (int i = tid; i < kWgUsers * kCandWords; i += kWgThreads) cand[i] = 0ull;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (kWgStages + s), 32 * kWgConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kWgConsumerWarps) {  // the producer warpgroup: one thread issues the loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kWgProducerRegs));
    if (warp == kWgConsumerWarps && lane == 0) {
      const unsigned ring_s = smem_addr(ring);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % kWgStages;
        mbar_wait(bars + 8 * (kWgStages + s), ((t / kWgStages) & 1) ^ 1);  // the slot is free
        mbar_expect_tx(bars + 8 * s, panels * panel_rows);
        for (int p = 0; p < panels; ++p)
          tma_load_tile(ring_s + (s * panels + p) * panel_rows, &tmap, bars + 8 * s, p * kPanel,
                        r_begin + t * kWgTile);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kWgConsumerRegs));
  const int wg = warp >> 2;
  const int g = lane >> 2;
  const int q = lane & 3;
  const int row0 = 64 * wg + kWgWarpUsers * (warp & 3);  // the warp's first user in the block
  const Buf buf0{cand + (row0 + g) * kCandWords, 4 * (g & 3)};      // user row0 + g
  const Buf buf1{cand + (row0 + g + 8) * kCandWords, 4 * (g & 3)};  // user row0 + g + 8
  const int R = (kCandWords - k) / 4;  // a lane's candidate region
  const int reg = k + q * R;
  const bool live0 = b0 + row0 + g < B;
  const bool live1 = b0 + row0 + g + 8 < B;
  const float inf = __int_as_float(0x7f800000);
  Sel st{live0 ? -inf : inf, live1 ? -inf : inf, 0, 0, 0, 0, 0u, 0u};
  const unsigned ring_s = smem_addr(ring);
  const int nk = (d + 15) / 16;
  // the warp's 16 users as wgmma's A fragments, 16 of depth a step (zeros
  // past d and past B), held for the whole range
  unsigned afrag[kWgMaxD / 16][4];
  const auto* U32 = reinterpret_cast<const unsigned*>(U);
#pragma unroll
  for (int ks = 0; ks < kWgMaxD / 16; ++ks) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = b0 + row0 + g + 8 * (r & 1);
      const int col = 16 * ks + 2 * q + 8 * (r >> 1);
      afrag[ks][r] = row < B && col < d ? __ldg(U32 + (static_cast<size_t>(row) * d + col) / 2) : 0u;
    }
  }
  float acc[64];
#pragma unroll
  for (int j = 0; j < 64; ++j) acc[j] = 0.0f;
  for (int t = 0; t < ntiles; ++t) {
    const int s = t % kWgStages;
    mbar_wait(bars + 8 * s, (t / kWgStages) & 1);  // the tile has landed
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < kWgMaxD / 16; ++ks) {
      if (ks < nk) {
        const unsigned bt = ring_s + (s * panels + (ks >> 2)) * panel_rows + (ks & 3) * 32;
        wgmma_n128<TH>(acc, afrag[ks], sw128_desc(bt), ks > 0);
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);
    mbar_arrive(bars + 8 * (kWgStages + s));  // the slot may be refilled
    const int tile0 = r_begin + t * kWgTile;
    select_tile(acc, st, buf0, buf1, reg, R, k, q, tile0 + 2 * q,
                mask_pad && tile0 == 0 ? 1 : 0,  // PAD: item 0
                min(kWgTile, r_end - tile0));    // past the range: zero rows
  }
  quad_keep(buf0, buf1, st, k, q);
  const int b = b0 + row0 + g;
  quad_write(buf0, st.ns0, st.tau0, b, k, q, lists, bounds, maxes, live0);
  quad_write(buf1, st.ns1, st.tau1, b + 8, k, q, lists, bounds, maxes, live1);
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

// The Hopper range kernel's tensor map of the table: encoded once per
// (pointer, rows, d, type, device) through the CUDA driver's entry point (no
// link against libcuda) and kept; null where the CUDA driver refuses it.
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

struct TableMap {
  const void* ptr;
  int rows, d, type, dev;
  CUtensorMap map;
};

const CUtensorMap* table_map(const void* T, int rows, int d, int type) {
  constexpr int kSlots = 8;
  static TableMap slots[kSlots];
  static int used = 0;
  static int next = 0;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return nullptr;
  for (int i = 0; i < used; ++i) {
    const TableMap& m = slots[i];
    if (m.ptr == T && m.rows == rows && m.d == d && m.type == type && m.dev == dev) return &m.map;
  }
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return nullptr;
  TableMap& m = slots[next];
  next = (next + 1) % kSlots;
  used = used < kSlots ? used + 1 : kSlots;
  m.ptr = nullptr;
  // rows of d elements, 2d bytes apart; a box is kWgTile rows x kPanel
  // elements (128 bytes, the 128-byte swizzle's span)
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(d) * 2};
  const cuuint32_t box[2] = {kPanel, kWgTile};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult res = encode(
      &m.map, type == kBF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16, 2,
      const_cast<void*>(T), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return nullptr;
  m.ptr = T;
  m.rows = rows;
  m.d = d;
  m.type = type;
  m.dev = dev;
  return &m.map;
}

template <typename TH>
cudaError_t launch_wgmma_kernel(const ScoreArgs& a, int t_type) {
  const CUtensorMap* map = table_map(a.T, a.I, a.d, t_type);
  if (map == nullptr) return cudaErrorNotSupported;
  const cudaError_t err = set_smem<score_select_wgmma_kernel<TH>>(a.smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.B + kWgUsers - 1) / kWgUsers, a.grid.y);
  score_select_wgmma_kernel<TH><<<grid, kWgThreads, a.smem, a.st>>>(
      *map, static_cast<const TH*>(a.U), a.lists, a.bounds, a.maxes, a.counters, a.B, a.I, a.d,
      a.k, a.chunk, a.cpb, a.mask_pad);
  return cudaGetLastError();
}

// U of type TU, T of type TT: the tensor cores for one half type on both
// sides, else the CUDA cores.
template <typename TU, typename TT>
cudaError_t launch_score(const ScoreArgs& a) {
  if constexpr (std::is_same<TU, TT>::value && !std::is_same<TT, float>::value) {
    return a.vec ? launch_score_kernel<score_select_mma_kernel<TT, true>, TT, TT>(a)
                 : launch_score_kernel<score_select_mma_kernel<TT, false>, TT, TT>(a);
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
                      int wgmma, void* stream) {
  if (u_type < kF32 || u_type > kF16 || t_type < kF32 || t_type > kF16)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool mma = u_type == t_type && t_type != kF32;
  // range mode (cpb > 1): the Hopper range kernel, k' <= 32, one list of k'
  // per range of cpb chunks; otherwise one list per chunk
  if (cpb < 1 || (cpb > 1 && (!wgmma || !mma || k > kRangeMaxK || S < 2)))
    return static_cast<int>(cudaErrorInvalidValue);
  // the Hopper range kernel: range mode with TMA's 16-byte rows and
  // addresses, at a depth its layout holds
  if (wgmma && (cpb < 2 || (d & 7) != 0 || d > kWgMaxD ||
                (reinterpret_cast<uintptr_t>(T) & 15) != 0 ||
                (reinterpret_cast<uintptr_t>(U) & 15) != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int lists_per_user = (S + cpb - 1) / cpb;
  const int lmax = cpb > 1 ? k : list_len(k, chunk);
  const int last = I - (S - 1) * chunk;
  if (B <= 0 || I <= 0 || d <= 0 || k <= 0 || chunk <= 0 || chunk % kBN != 0 ||
      chunk > kMaxChunk || S <= 0 || S > kMaxSplits || last <= 0 || last > chunk ||
      n != (cpb > 1 ? lists_per_user * k : (S - 1) * lmax + (lmax < last ? lmax : last)) ||
      Kp < (k < n ? k : n) ||
      smem1 != (wgmma ? wgmma_smem_bytes(d) : fused_topk_smem_bytes(d, chunk, u_type, t_type)))
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
  if (wgmma) {
    err = t_type == kBF16 ? launch_wgmma_kernel<__nv_bfloat16>(args, t_type)
                          : launch_wgmma_kernel<__half>(args, t_type);
  } else {
    switch (u_type) {
      case kF32: err = launch_score_for<float>(t_type, args); break;
      case kBF16: err = launch_score_for<__nv_bfloat16>(t_type, args); break;
      default: err = launch_score_for<__half>(t_type, args); break;
    }
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
