// CSR-form SpMM, C = A @ B, for Hopper (sm_90a).
//
// A second body for the Pallas TPU kernel csr_tpu/ops/spmm.py:_spmm_kernel
// (and its launcher _spmm_call): the same product, read straight from the
// matrix's own CSR tensors, with no packing and no second copy of the
// matrix.  rowptrs is int32 or int64 (ptr64), colinds int32, values f32 (or
// null: a structure-only matrix, every value 1); B is f32 (ncols, n) with
// rows ldb floats apart, C f32 (nrows, n), contiguous.
//
// Why a second body: the micro-block layout (spmm_microblock.cu) spends a
// 772 B micro-row on every (128-row, 256-column) tile that holds an entry
// and pads every stripe to 32 micro-rows, so a hypersparse or thin-row
// matrix costs hundreds of bytes an entry there, and a matrix of more than
// 32,767 row windows does not pack at all.  The CSR form costs 8 B an entry
// (kernels/cuda.py routes between the two).
//
// What bounds it on this card: bytes.  Each stored entry is read once
// (4 B column, 4 B value), each row pointer once, C written once (at 8.4M
// rows and n = 50 C alone is 1.68 GB); each entry gathers its row of B, n
// floats, which L2 serves where the columns repeat.  What the design does:
//   * Split (merge path, Merrill & Garland, SC16; merge_path.cuh): the
//     merge of the row ends with the entry indices is cut into shares of
//     kTile items, one a block, so a row of 29K entries and a million
//     empty rows both balance.  Two warps find the share's edges by 32-way
//     searches of rowptrs.
//   * Staging: the block copies its share's row ends and (column, value)
//     pairs into shared memory once, for all its warps and all passes over
//     C's columns.  Each warp then takes kWarpItems items of the share (its
//     start found by a binary search in shared memory).
//   * Lanes along B's row: a pass covers kCols = 128 columns of C, four a
//     lane: one 16 B load a lane where n % 4 == 0 and B's and C's rows lie
//     on 16 B boundaries (vec), else four scalar loads a lane, columns
//     lane + 32 j, so any n and any 4 B aligned B run with no padded copy.
//     A warp walks its items row by row; within a row the gathers of four
//     entries are issued before any is used.  A walk of eight entries at
//     a time across row ends, so that a thin row's gathers overlap the
//     next rows', was tried on the H100 and was slower at 4.3M x 4,096
//     (PERF.md).  At thin rows the walk's instructions a row, not the
//     gathers, bound the kernel.
//   * Rows: a row's sums stay in registers across its entries, and only a
//     row's own products are added, in f32: no prefix differences, so an
//     inf in B reaches only the rows whose entries use its row.  A row that
//     a warp starts and ends is stored once with a plain store; an empty
//     row stores zeros.  Every row's end lies in exactly one share, so
//     every row of C is written by the first launch and C needs no memset.
//   * Cut rows: a warp leaves its first ended row and its unended tail in
//     shared memory; after the walk 128 threads add them in warp order and
//     store the rows that the share ends (a row cut between warps).  What a
//     share holds of the row it does not end (its tail, cut by the share's
//     edge) goes to carry[share] (n floats), and the row to
//     carry_row[share] (-1: no tail).  A second launch, a block a share,
//     takes the first share of each run of equal carry_row, sums the run's
//     carries in share order and adds them to the row, which the first
//     launch stored.  No atomics anywhere: the result is bitwise
//     repeatable.
// wgmma and TMA have no role in a gather-bound SpMM of this kind yet.

#include <cstdint>
#include <cuda_runtime.h>

#include "merge_path.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kWarpItems = 128;             // merge items a warp
constexpr int kTile = kWarps * kWarpItems;  // merge items a share (SPMM_CSR_TILE)
constexpr int kCols = 128;                  // columns of C a pass, 4 a lane
constexpr int kFixThreads = 128;

// Column j (0..3) of a lane's four, from the pass's first column: 4 lane + j
// with 16 B loads, lane + 32 j with scalar ones.
template <bool kVec>
__device__ __forceinline__ int col_of(int lane, int j) {
  return kVec ? 4 * lane + j : lane + 32 * j;
}

// acc[j] += vals[u] * B[cols[u], c0 + col_of(lane, j)] for the kU entries
// and the columns below n; all kU gathers are issued before any is used.
template <bool kVec, int kU>
__device__ __forceinline__ void accumulate(const float* __restrict__ b,
                                           int64_t ldb, int c0, int n,
                                           int lane, const int32_t* cols,
                                           const float* vals, float acc[4]) {
  float q[kU][4];
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const float* row = b + int64_t(cols[u]) * ldb + c0;
    if (kVec) {
      float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c0 + 4 * lane < n) t = __ldg(reinterpret_cast<const float4*>(row) + lane);
      q[u][0] = t.x;
      q[u][1] = t.y;
      q[u][2] = t.z;
      q[u][3] = t.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        q[u][j] = c0 + lane + 32 * j < n ? __ldg(row + lane + 32 * j) : 0.f;
    }
  }
#pragma unroll
  for (int u = 0; u < kU; ++u)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[j] += vals[u] * q[u][j];
}

// C[row, c0 + col_of(lane, j)] = acc[j] for the columns below n.
template <bool kVec>
__device__ __forceinline__ void store_row(float* __restrict__ c, int n,
                                          int64_t row, int c0, int lane,
                                          const float acc[4]) {
  float* out = c + row * n + c0;
  if (kVec) {
    if (c0 + 4 * lane < n)
      reinterpret_cast<float4*>(out)[lane] =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (c0 + lane + 32 * j < n) out[lane + 32 * j] = acc[j];
  }
}

// Rows of the share wholly consumed at share-relative merge diagonal d: the
// first i with ends[i] + i + 1 > d (ends relative to the share's first
// entry), by a binary search in shared memory.
__device__ __forceinline__ int rows_at(const int32_t* ends, int nr, int ne,
                                       int d) {
  int lo = d > ne ? d - ne : 0, hi = d < nr ? d : nr;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (ends[mid] <= d - mid - 1) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// One block a share: rows r0 .. r1 - 1 end in it (r0, r1 the rows wholly
// consumed at its edges), its entries are k0 .. k1 - 1.
template <typename P, bool kVec>
__global__ void __launch_bounds__(kThreads)
spmm_csr_kernel(const P* __restrict__ rowptrs,
                const int32_t* __restrict__ colinds,
                const float* __restrict__ values, const float* __restrict__ b,
                int64_t ldb, float* __restrict__ c, int n, int64_t nrows,
                int64_t nnz, float* __restrict__ carry,
                int32_t* __restrict__ carry_row) {
  __shared__ int32_t ends[kTile];  // row ends, relative to entry k0
  __shared__ int32_t cols[kTile];
  __shared__ float vals[kTile];
  __shared__ float first[kWarps][kCols];  // a warp's first ended row
  __shared__ float last[kWarps][kCols];   // a warp's unended tail
  __shared__ int32_t first_row[kWarps];   // -1: the warp ended no row
  __shared__ int64_t edge[2];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t total = nrows + nnz;
  const int64_t s = blockIdx.x;
  const int64_t d0 = s * kTile;
  const int64_t d1 = d0 + kTile < total ? d0 + kTile : total;
  if (warp < 2) {
    const int64_t r = merge_search(rowptrs, warp ? d1 : d0, nrows, nnz);
    if (lane == 0) edge[warp] = r;
  }
  __syncthreads();
  const int64_t r0 = edge[0], r1 = edge[1];
  const int64_t k0 = d0 - r0;
  const int nr = int(r1 - r0);         // rows that end in the share
  const int ne = int(d1 - r1 - k0);    // entries in the share
  for (int i = threadIdx.x; i < nr; i += kThreads)
    ends[i] = int32_t(int64_t(rowptrs[r0 + 1 + i]) - k0);
  for (int i = threadIdx.x; i < ne; i += kThreads) {
    cols[i] = __ldcs(colinds + k0 + i);
    vals[i] = values ? __ldcs(values + k0 + i) : 1.f;
  }
  __syncthreads();

  // the share's tail: entries of row r1 (which a later share ends)
  const bool tail = nr ? ne > ends[nr - 1] : ne > 0;
  if (threadIdx.x == 0) carry_row[s] = tail ? int32_t(r1) : -1;
  const int n_items = nr + ne;
  const int wd0 = warp * kWarpItems < n_items ? warp * kWarpItems : n_items;
  const int wd1 = wd0 + kWarpItems < n_items ? wd0 + kWarpItems : n_items;
  const int ra = rows_at(ends, nr, ne, wd0), rb = rows_at(ends, nr, ne, wd1);

  for (int c0 = 0; c0 < n; c0 += kCols) {
    int ri = ra, ki = wd0 - ra, fr = -1;
    const int k_stop = wd1 - rb;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    while (true) {
      const int stop = ri < rb ? ends[ri] : k_stop;  // row ri's last entry here
      for (; ki + 4 <= stop; ki += 4)
        accumulate<kVec, 4>(b, ldb, c0, n, lane, cols + ki, vals + ki, acc);
      for (; ki < stop; ++ki)
        accumulate<kVec, 1>(b, ldb, c0, n, lane, cols + ki, vals + ki, acc);
      if (ri >= rb) break;  // the warp's tail: a later warp or share ends it
      if (fr < 0) {         // may have parts in earlier warps: resolved below
        fr = ri;
#pragma unroll
        for (int j = 0; j < 4; ++j) first[warp][col_of<kVec>(lane, j)] = acc[j];
      } else {
        store_row<kVec>(c, n, r0 + ri, c0, lane, acc);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] = 0.f;
      ++ri;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) last[warp][col_of<kVec>(lane, j)] = acc[j];
    if (lane == 0) first_row[warp] = fr;
    __syncthreads();

    // the rows cut between warps, in warp order: a warp's tail and the
    // whole of any warp that ends no row belong to the next ended row
    if (threadIdx.x < kCols) {
      const int t = threadIdx.x;
      float run = 0.f;
      for (int w = 0; w < kWarps; ++w) {
        if (first_row[w] >= 0) {
          if (c0 + t < n) c[(r0 + first_row[w]) * n + c0 + t] = run + first[w][t];
          run = last[w][t];
        } else {
          run += last[w][t];
        }
      }
      if (tail && c0 + t < n) carry[s * n + c0 + t] = run;
    }
    __syncthreads();  // the next pass reuses first, last and first_row
  }
}

// The second launch, a block a share: the first share of each run of
// shares that carry into one row sums the run's carries in share order and
// adds them to the row.
__global__ void __launch_bounds__(kFixThreads)
spmm_csr_carries(const float* __restrict__ carry,
                 const int32_t* __restrict__ carry_row, float* __restrict__ c,
                 int n, int64_t n_shares) {
  const int64_t s = blockIdx.x;
  const int32_t row = carry_row[s];
  if (row < 0 || (s > 0 && carry_row[s - 1] == row)) return;
  int64_t e = s + 1;
  while (e < n_shares && carry_row[e] == row) ++e;
  for (int col = threadIdx.x; col < n; col += kFixThreads) {
    float sum = 0.f;
    for (int64_t t = s; t < e; ++t) sum += carry[t * n + col];
    c[int64_t(row) * n + col] += sum;
  }
}

template <typename P>
int launch(const P* rowptrs, const int32_t* colinds, const float* values,
           const float* b, int64_t ldb, float* c, int n, int64_t nrows,
           int64_t nnz, float* carry, int32_t* carry_row, int vec,
           cudaStream_t stream) {
  const int64_t n_shares = (nrows + nnz + kTile - 1) / kTile;
  if (vec)
    spmm_csr_kernel<P, true><<<dim3{static_cast<unsigned>(n_shares)}, kThreads,
                               0, stream>>>(rowptrs, colinds, values, b, ldb, c,
                                            n, nrows, nnz, carry, carry_row);
  else
    spmm_csr_kernel<P, false><<<dim3{static_cast<unsigned>(n_shares)}, kThreads,
                                0, stream>>>(rowptrs, colinds, values, b, ldb,
                                             c, n, nrows, nnz, carry, carry_row);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  spmm_csr_carries<<<dim3{static_cast<unsigned>(n_shares)}, kFixThreads, 0,
                     stream>>>(carry, carry_row, c, n, n_shares);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C = A @ B for an nrows-row CSR matrix of nnz entries (rowptrs[0] == 0,
// rowptrs[nrows] == nnz) and B of n columns, rows ldb floats apart.  All
// pointers are device pointers, 4 B aligned; values may be null (every
// value 1); with vec, n and ldb are multiples of 4 and B and C lie on 16 B
// boundaries.  carry holds ceil((nrows + nnz) / kTile) rows of n floats and
// carry_row as many int32; C needs no zeroing.  Launches both kernels on
// `stream` and returns the CUDA error (0 on success).
extern "C" int csrt_spmm_csr(const void* rowptrs, int ptr64,
                             const void* colinds, const void* values,
                             const void* b, int64_t ldb, void* c, int64_t n,
                             int64_t nrows, int64_t nnz, void* carry,
                             void* carry_row, int vec, void* stream) {
  if (nrows <= 0 || nnz <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  const auto ci = static_cast<const int32_t*>(colinds);
  const auto v = static_cast<const float*>(values);
  const auto bp = static_cast<const float*>(b);
  const auto cp = static_cast<float*>(c);
  const auto cy = static_cast<float*>(carry);
  const auto cr = static_cast<int32_t*>(carry_row);
  const auto s = static_cast<cudaStream_t>(stream);
  if (ptr64)
    return launch(static_cast<const int64_t*>(rowptrs), ci, v, bp, ldb, cp,
                  int(n), nrows, nnz, cy, cr, vec, s);
  return launch(static_cast<const int32_t*>(rowptrs), ci, v, bp, ldb, cp,
                int(n), nrows, nnz, cy, cr, vec, s);
}
