// CSR-form SpMV, y += A @ x, for Hopper (sm_90a).
//
// A second body for the Pallas TPU kernel csr_tpu/ops/spmv.py:_spmv_kernel
// (and its launcher _spmv_call): the same product, read straight from the
// matrix's own CSR tensors, with no packing and no second copy of the
// matrix.  rowptrs is int32 or int64 (ptr64), colinds int32, values f32 (or
// null: a structure-only matrix, every value 1), x and y f32.
//
// Why a second body: the micro-block layout (spmv_microblock.cu) spends a
// 772 B micro-row on every (128-row, 256-column) tile that holds an entry,
// and pads every stripe to 32 micro-rows.  The TPU needs that shape for
// lane-dense vectors; this card does not, since a warp gathers x at any
// column.  Where a tile holds about one entry (hypersparse and thin-row
// matrices) the layout costs hundreds of bytes an entry; the CSR form
// costs 8 (kernels/cuda.py routes between the two).
//
// What bounds it on this card: bytes.  Each stored entry is read once
// (4 B column, 4 B value), each row pointer once, y written once; x is
// gathered by __ldg and stays in L2 (4 MB at 2^20 columns, 33.5 MB at
// 8,388,608, against 50 MB of L2).  What the design does about it:
//   * Balance entries and rows together (merge path, Merrill & Garland,
//     SC16): the merge of the row ends with the entry indices is cut into
//     shares of kTile items, one a block, so a block of power-law rows
//     does as much work as a block of empty rows.  A share's edges are
//     found by 32-way searches of rowptrs, a warp an edge (five rounds of
//     32 dependent loads at 2^25 rows), which the block waits for.  Where
//     the shares fill two waves of resident blocks or more, a block takes
//     up to three shares in a row and searches all their edges at once
//     (4.3M x 4,096 at 8 a row: 0.156 ms against 0.204 at one share a
//     block, on the H100; PERF.md).
//   * The block streams its share's entries 16 B at a time where colinds
//     (and values) lie on a 16 B boundary, with a scalar head and tail,
//     gathers x, and keeps the products and the row ends in shared
//     memory.  Each thread then walks kItems items of the merge from its
//     own point (a binary search in shared memory): a row end stores the
//     running sum, an entry adds its product.  Only a row's own products
//     are ever added together, in f32: no prefix differences, so an inf in
//     x reaches only the rows whose entries use it, and a slot past a
//     row's end reads nothing.
//   * A thread's unfinished row (its carry) is summed across the warp by a
//     segmented shuffle scan and added to the row's slot in shared memory
//     (one shared atomic a row a warp).  A row that lies inside the share
//     is then written once; the share's first and last rows, which a
//     share's edge may cut, add their parts to y with atomicAdd.  Empty
//     rows write nothing (y is zeroed by the caller or accumulated into).
//     The order of the atomics varies, so results are not bitwise
//     repeatable, as the micro-block kernel's are not.
//   * One launch whatever the size: (rows + entries) / kTile shares, on
//     grid.x (up to 2^31 - 1 blocks), with no 65,535-block or packing
//     limit.
// wgmma and TMA have no role in a gather-bound SpMV.

#include <cstdint>
#include <cuda_runtime.h>

#include "merge_path.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;                  // merge items a thread
constexpr int kTile = kThreads * kItems;   // merge items a share (CSR_TILE)
constexpr int kMaxShares = 3;              // shares a block at most
constexpr unsigned kFull = 0xffffffffu;

// The share's items: the row ends first (relative to the share's first
// entry), then the entries' products.
union Item {
  int32_t end;
  float prod;
};

__device__ __forceinline__ float product(const int32_t* __restrict__ colinds,
                                         const float* __restrict__ values,
                                         const float* __restrict__ x,
                                         int64_t k) {
  const float v = values ? __ldcs(values + k) : 1.f;
  return v * __ldg(x + __ldcs(colinds + k));
}

// One share: the merge items d0 .. d1 - 1, rows r0 .. r1 (r0 and r1 the
// rows wholly consumed at d0 and d1).  Every thread of the block calls it.
template <typename P>
__device__ __forceinline__ void share_product(
    const P* __restrict__ rowptrs, const int32_t* __restrict__ colinds,
    const float* __restrict__ values, const float* __restrict__ x,
    float* __restrict__ y, int64_t nrows, int zeroed, int64_t d0, int64_t d1,
    int64_t r0, int64_t r1, Item* items, float* sums) {
  const int lane = threadIdx.x & 31;
  const int64_t k0 = d0 - r0, k1 = d1 - r1;
  const int nr = int(r1 - r0);  // row ends in the share: rows r0 .. r1 - 1
  const int ne = int(k1 - k0);  // entries in the share: k0 .. k1 - 1

  for (int i = threadIdx.x; i < nr; i += kThreads)
    items[i].end = int32_t(int64_t(rowptrs[r0 + 1 + i]) - k0);
  if (threadIdx.x == 0) sums[nr] = 0.f;  // row r1's part, cut at the end

  // The products, 16 B of colinds and values at a time where entry k lies
  // on a 16 B boundary of both (they are 4 B aligned; a is k's offset).
  Item* prods = items + nr;
  const int a = int(reinterpret_cast<uintptr_t>(colinds) >> 2) & 3;
  const bool vec = !values ||
                   (int(reinterpret_cast<uintptr_t>(values) >> 2) & 3) == a;
  int64_t kb = k1, ke = k1;  // [kb, ke): whole aligned quads
  if (vec) {
    kb = k0 + ((4 - int((a + k0) & 3)) & 3);
    if (kb > k1) kb = k1;
    ke = kb + ((k1 - kb) & ~int64_t(3));
  }
  for (int64_t k = k0 + threadIdx.x; k < kb; k += kThreads)
    prods[k - k0].prod = product(colinds, values, x, k);
  for (int64_t k = ke + threadIdx.x; k < k1; k += kThreads)
    prods[k - k0].prod = product(colinds, values, x, k);
  const int nq = int((ke - kb) >> 2);
  for (int q = threadIdx.x; q < nq; q += kThreads) {
    const int64_t k = kb + 4 * int64_t(q);
    const int4 c = __ldcs(reinterpret_cast<const int4*>(colinds + k));
    const float4 v = values
        ? __ldcs(reinterpret_cast<const float4*>(values + k))
        : make_float4(1.f, 1.f, 1.f, 1.f);
    Item* out = prods + (k - k0);
    out[0].prod = v.x * __ldg(x + c.x);
    out[1].prod = v.y * __ldg(x + c.y);
    out[2].prod = v.z * __ldg(x + c.z);
    out[3].prod = v.w * __ldg(x + c.w);
  }
  __syncthreads();

  // This thread's kItems items of the merge, from its own point.
  const int n = nr + ne;
  const int dt = int(threadIdx.x) * kItems < n ? int(threadIdx.x) * kItems : n;
  int lo = dt > ne ? dt - ne : 0, hi = dt < nr ? dt : nr;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (items[mid].end <= dt - mid - 1) lo = mid + 1;
    else hi = mid;
  }
  int ri = lo, ki = dt - lo;
  float acc = 0.f;
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    if (dt + it >= n) break;
    if (ri < nr && items[ri].end <= ki) {  // row ri ends: every entry taken
      sums[ri] = acc;
      acc = 0.f;
      ++ri;
    } else {
      acc += prods[ki].prod;
      ++ki;
    }
  }
  __syncthreads();  // every row end stored before the carries add in

  // The carry: this thread's part of row ri, which a later thread ends
  // (ri == nr: row r1, which the share's end cuts).  ri does not fall
  // across the lanes, so a shuffle scan over runs of equal ri sums them.
  float c = acc;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float up = __shfl_up_sync(kFull, c, off);
    const int up_row = __shfl_up_sync(kFull, ri, off);
    if (lane >= off && up_row == ri) c += up;
  }
  const int next_row = __shfl_down_sync(kFull, ri, 1);
  if ((lane == 31 || next_row != ri) && c != 0.f) atomicAdd(sums + ri, c);
  __syncthreads();

  // Rows r0 .. r1: inner rows are the share's alone; the first and the
  // last may have parts in other shares.
  for (int i = threadIdx.x; i <= nr; i += kThreads) {
    const int64_t row = r0 + i;
    const float v = sums[i];
    if (row >= nrows || v == 0.f) continue;
    if (i == 0 || i == nr) atomicAdd(y + row, v);
    else if (zeroed) y[row] = v;
    else y[row] += v;
  }
  __syncthreads();  // the next share reuses items and sums
}

// A block takes `shares` consecutive shares (fewer at the end): warp j
// finds the rows at the block's edge j, all edges at once, then the
// shares run in turn.

template <typename P>
__global__ void __launch_bounds__(kThreads)
spmv_csr_kernel(const P* __restrict__ rowptrs,
                const int32_t* __restrict__ colinds,
                const float* __restrict__ values, const float* __restrict__ x,
                float* __restrict__ y, int64_t nrows, int64_t nnz,
                int shares, int zeroed) {
  __shared__ Item items[kTile];
  __shared__ float sums[kTile + 1];         // a slot a row of the share
  __shared__ int64_t edge[kMaxShares + 1];  // rows consumed at the edges
  const int warp = threadIdx.x >> 5;
  const int64_t total = nrows + nnz;
  const int64_t first = int64_t(blockIdx.x) * shares * kTile;
  if (warp <= shares) {
    const int64_t d = first + int64_t(warp) * kTile;
    const int64_t r = merge_search(rowptrs, d < total ? d : total, nrows, nnz);
    if ((threadIdx.x & 31) == 0) edge[warp] = r;
  }
  __syncthreads();
  for (int j = 0; j < shares; ++j) {
    const int64_t d0 = first + int64_t(j) * kTile;
    if (d0 >= total) break;
    const int64_t d1 = d0 + kTile < total ? d0 + kTile : total;
    share_product(rowptrs, colinds, values, x, y, nrows, zeroed, d0, d1,
                  edge[j], edge[j + 1], items, sums);
  }
}

// Shares a block: one, unless the shares fill two waves of the card's
// resident blocks or more (so the last wave's tail stays short); then as
// many as fill two waves, up to kMaxShares.
template <typename P>
int launch(const P* rowptrs, const int32_t* colinds, const float* values,
           const float* x, float* y, int64_t nrows, int64_t nnz, int zeroed,
           cudaStream_t stream) {
  int dev = 0, sms = 0, resident = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &resident, spmv_csr_kernel<P>, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n_shares = (nrows + nnz + kTile - 1) / kTile;
  const int64_t slots = int64_t(sms) * (resident > 0 ? resident : 1);
  int64_t shares = n_shares / (2 * slots);
  shares = shares < 1 ? 1 : shares > kMaxShares ? kMaxShares : shares;
  const int64_t blocks = (n_shares + shares - 1) / shares;
  spmv_csr_kernel<P><<<dim3{static_cast<unsigned>(blocks)}, kThreads, 0,
                       stream>>>(rowptrs, colinds, values, x, y, nrows, nnz,
                                 int(shares), zeroed);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y += A @ x for an nrows-row CSR matrix of nnz entries (rowptrs[0] == 0,
// rowptrs[nrows] == nnz).  All pointers are device pointers, 4 B aligned;
// values may be null (every value 1).  With zeroed, y holds zeros on entry
// and rows wholly inside a share are stored, not added.  Launches on
// `stream` and returns the CUDA error (0 on success).
extern "C" int csrt_spmv_csr(const void* rowptrs, int ptr64,
                             const void* colinds, const void* values,
                             const void* x, void* y, int64_t nrows,
                             int64_t nnz, int zeroed, void* stream) {
  if (nrows <= 0 || nnz <= 0) return static_cast<int>(cudaGetLastError());
  const auto ci = static_cast<const int32_t*>(colinds);
  const auto v = static_cast<const float*>(values);
  const auto xp = static_cast<const float*>(x);
  const auto yp = static_cast<float*>(y);
  const auto s = static_cast<cudaStream_t>(stream);
  if (ptr64)
    return launch(static_cast<const int64_t*>(rowptrs), ci, v, xp, yp, nrows,
                  nnz, zeroed, s);
  return launch(static_cast<const int32_t*>(rowptrs), ci, v, xp, yp, nrows,
                nnz, zeroed, s);
}
