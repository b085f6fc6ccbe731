// CSR sparse x dense product, y = A @ x, for the port's graph propagation
// (ops/spmm_csr.py, behind ops/spmm.py::propagate on CUDA tensors).
//
// It replaces no Pallas kernel: the JAX package's COO hop
// (recbole_fairrec_tpu/ops/spmm.py, its COO product) is a gather and a
// segment_sum that XLA lowers to a scatter-add. It was added because the
// port's COO hop on the card (gather -> multiply -> index_add_) wrote an
// [E, d] float32 temporary, read and wrote it again, scattered it with float
// atomics, and took a sort-based backward: each hop moved its gathered rows
// through device memory about four times.
//
// Bound: bytes. A hop over E entries, n rows and d float32 columns reads
// each entry's column index and value (8 B) and the source row it names
// (4d B), and writes each output row once (4d B): E (8 + 4d) + n 4d bytes.
// At E 29,369,508, n 651,938, d 64 that is 7.92 GB, 2.36 ms at 3.35 TB/s;
// the 2 E d operations are ~60x under the card's float32 rate. A source row
// read again may come from the 50 MB L2 instead, so on a graph with popular
// columns a hop can take less than that count says.
//
// How the design meets it:
// * Pieces of equal work. The merge path of the row ends and the entries
//   (Merrill and Garland, "Merge-based parallel sparse matrix-vector
//   multiplication", SC 2016) is cut into pieces of `items` (row ends plus
//   entries); each piece is one group of G lanes. A row of 40 entries and a
//   row of 10^5 cost the same per piece, so no group reads megabytes while
//   the card idles. The wrapper finds each piece's first row once per matrix
//   (`splits`).
// * A group's lanes hold VEC columns each (a float4 where d % 4 == 0 and x is
//   16-byte aligned); G is the next power of two of the lanes a row needs, at
//   most 32 (128 columns). Wider rows take more grid rows (blockIdx.y), each
//   128 columns. Each entry's source row is read once, straight into
//   registers: kUnroll entries a batch, their indices and values first (every
//   lane of the group reads the same words: one L1 line), then their rows, so
//   that each lane has kUnroll 16-byte loads in flight. No [E, d] temporary,
//   no shared memory: random 256-byte rows need loads in flight, not reuse.
// * A row that ends in a piece is summed in entry order and written once, by
//   that piece. The row a piece stops inside (its carry) goes to a scratch
//   row; a second, small kernel adds each run of one row's carries, in piece
//   order, to that row. No float atomics: the same inputs give the same bits.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;

template <int VEC>
struct Lane;
template <>
struct Lane<4> {
  using T = float4;
};
template <>
struct Lane<1> {
  using T = float;
};

__device__ __forceinline__ void set_zero(float4& a) { a = make_float4(0.f, 0.f, 0.f, 0.f); }
__device__ __forceinline__ void set_zero(float& a) { a = 0.f; }

__device__ __forceinline__ void fma_into(float4& a, float s, const float4& b) {
  a.x = fmaf(s, b.x, a.x);
  a.y = fmaf(s, b.y, a.y);
  a.z = fmaf(s, b.z, a.z);
  a.w = fmaf(s, b.w, a.w);
}
__device__ __forceinline__ void fma_into(float& a, float s, float b) { a = fmaf(s, b, a); }

__device__ __forceinline__ void add_into(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}
__device__ __forceinline__ void add_into(float& a, float b) { a += b; }

// sum over entries [start, end) of vals[k] * x[cols[k], col : col + VEC], in
// entry order
template <int VEC>
__device__ __forceinline__ typename Lane<VEC>::T row_sum(
    const int* __restrict__ cols, const float* __restrict__ vals, const float* __restrict__ x,
    size_t stride, int col, bool active, int start, int end) {
  using V = typename Lane<VEC>::T;
  V acc;
  set_zero(acc);
  for (int k = start; k < end; k += kUnroll) {
    int c[kUnroll];
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool ok = k + u < end;
      c[u] = ok ? __ldg(cols + k + u) : 0;
      v[u] = ok ? __ldg(vals + k + u) : 0.f;
    }
    V xv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (active && k + u < end) {
        xv[u] = __ldg(reinterpret_cast<const V*>(x + static_cast<size_t>(c[u]) * stride + col));
      } else {
        set_zero(xv[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (k + u < end) fma_into(acc, v[u], xv[u]);
    }
  }
  return acc;
}

// one group of G lanes per piece: the rows that end in the piece into y, the
// row it stops inside into its carry
template <int VEC, int G>
__global__ void __launch_bounds__(kThreads)
    spmm_csr_kernel(const int* __restrict__ rowptr, const int* __restrict__ cols,
                    const float* __restrict__ vals, const int* __restrict__ splits,
                    const float* __restrict__ x, float* __restrict__ y,
                    float* __restrict__ carry, int* __restrict__ carry_row, int n_rows, int d,
                    int pieces, int items, long long total) {
  using V = typename Lane<VEC>::T;
  const int lane = threadIdx.x % G;
  const long long piece = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / G;
  if (piece >= pieces) return;
  const int col = blockIdx.y * (32 * VEC) + lane * VEC;
  const bool active = col < d;
  const size_t stride = static_cast<size_t>(d);
  const long long diag0 = piece * items;
  const long long diag1 = min(diag0 + items, total);
  const int row0 = __ldg(splits + piece);
  const int row1 = __ldg(splits + piece + 1);
  const int entry1 = static_cast<int>(diag1 - row1);
  int start = static_cast<int>(diag0 - row0);  // row0 may have begun in an earlier piece
  for (int r = row0; r < row1; ++r) {
    const int end = __ldg(rowptr + r + 1);
    const V acc = row_sum<VEC>(cols, vals, x, stride, col, active, start, end);
    if (active) *reinterpret_cast<V*>(y + static_cast<size_t>(r) * stride + col) = acc;
    start = end;
  }
  // row1's entries in this piece: none where the piece stops at a row's end
  // or at the matrix's end
  const bool carries = row1 < n_rows && start < entry1;
  if (lane == 0 && blockIdx.y == 0) carry_row[piece] = carries ? row1 : -1;
  if (carries) {
    const V acc = row_sum<VEC>(cols, vals, x, stride, col, active, start, entry1);
    if (active) *reinterpret_cast<V*>(carry + static_cast<size_t>(piece) * stride + col) = acc;
  }
}

// the first carry of each row's run adds the run, in piece order, to the row
// (a row's carries are consecutive pieces)
template <int VEC, int G>
__global__ void __launch_bounds__(kThreads)
    spmm_csr_carry_kernel(const float* __restrict__ carry, const int* __restrict__ carry_row,
                          float* __restrict__ y, int d, int pieces) {
  using V = typename Lane<VEC>::T;
  const int lane = threadIdx.x % G;
  const long long piece = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / G;
  if (piece >= pieces) return;
  const int r = __ldg(carry_row + piece);
  if (r < 0 || (piece > 0 && __ldg(carry_row + piece - 1) == r)) return;
  const int col = blockIdx.y * (32 * VEC) + lane * VEC;
  if (col >= d) return;
  const size_t stride = static_cast<size_t>(d);
  V sum = __ldg(reinterpret_cast<const V*>(carry + static_cast<size_t>(piece) * stride + col));
  bool more = true;
  for (long long q = piece + 1; more && q < pieces; q += kUnroll) {
    int rr[kUnroll];
    V cv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) rr[u] = q + u < pieces ? __ldg(carry_row + q + u) : -1;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (rr[u] == r) {
        cv[u] = __ldg(reinterpret_cast<const V*>(carry + static_cast<size_t>(q + u) * stride +
                                                  col));
      } else {
        set_zero(cv[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      more = more && rr[u] == r;
      if (more) add_into(sum, cv[u]);
    }
  }
  V* out = reinterpret_cast<V*>(y + static_cast<size_t>(r) * stride + col);
  V acc = *out;
  add_into(acc, sum);
  *out = acc;
}

template <int VEC, int G>
int launch(const int* rowptr, const int* cols, const float* vals, const int* splits,
           const float* x, float* y, float* carry, int* carry_row, int n_rows, int d, int pieces,
           int items, long long total, cudaStream_t stream) {
  const long long threads = static_cast<long long>(pieces) * G;
  const dim3 grid(static_cast<unsigned>((threads + kThreads - 1) / kThreads),
                  static_cast<unsigned>((d + 32 * VEC - 1) / (32 * VEC)));
  spmm_csr_kernel<VEC, G><<<grid, kThreads, 0, stream>>>(
      rowptr, cols, vals, splits, x, y, carry, carry_row, n_rows, d, pieces, items, total);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  spmm_csr_carry_kernel<VEC, G><<<grid, kThreads, 0, stream>>>(carry, carry_row, y, d, pieces);
  return static_cast<int>(cudaGetLastError());
}

template <int VEC>
int launch_lanes(int lanes, const int* rowptr, const int* cols, const float* vals,
                 const int* splits, const float* x, float* y, float* carry, int* carry_row,
                 int n_rows, int d, int pieces, int items, long long total, cudaStream_t stream) {
#define SPMM_CSR_LANES(G)                                                                      \
  case G:                                                                                      \
    return launch<VEC, G>(rowptr, cols, vals, splits, x, y, carry, carry_row, n_rows, d, pieces, \
                          items, total, stream);
  switch (lanes) {
    SPMM_CSR_LANES(1)
    SPMM_CSR_LANES(2)
    SPMM_CSR_LANES(4)
    SPMM_CSR_LANES(8)
    SPMM_CSR_LANES(16)
    SPMM_CSR_LANES(32)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SPMM_CSR_LANES
}

}  // namespace

extern "C" {

// y [n_rows, d] = A @ x [n_cols, d] for A in CSR form (rowptr [n_rows + 1],
// cols and vals [nnz]) cut into `pieces` pieces of `items` merge-path items
// (splits [pieces + 1]: the rows ended before each piece); carry [pieces, d]
// and carry_row [pieces] are scratch. `vec` is 4 (float4 columns) or 1,
// `lanes` the group's width (1 to 32, a power of two). Two launches on
// `stream`; returns the first CUDA error, or 0.
int spmm_csr_launch(const void* rowptr, const void* cols, const void* vals, const void* splits,
                    const void* x, void* y, void* carry, void* carry_row, int n_rows, int d,
                    int pieces, int items, long long total, int vec, int lanes, void* stream) {
  if (pieces <= 0 || items <= 0 || d <= 0 || n_rows <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* rp = static_cast<const int*>(rowptr);
  const auto* c = static_cast<const int*>(cols);
  const auto* v = static_cast<const float*>(vals);
  const auto* s = static_cast<const int*>(splits);
  const auto* xin = static_cast<const float*>(x);
  auto* out = static_cast<float*>(y);
  auto* cv = static_cast<float*>(carry);
  auto* cr = static_cast<int*>(carry_row);
  auto st = static_cast<cudaStream_t>(stream);
  if (vec == 4)
    return launch_lanes<4>(lanes, rp, c, v, s, xin, out, cv, cr, n_rows, d, pieces, items, total,
                           st);
  if (vec == 1)
    return launch_lanes<1>(lanes, rp, c, v, s, xin, out, cv, cr, n_rows, d, pieces, items, total,
                           st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
