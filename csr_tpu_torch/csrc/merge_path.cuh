// The merge-path split of a CSR matrix (Merrill & Garland, SC16), shared by
// the CSR-form kernels spmv_csr.cu and spmm_csr.cu: the merge of the row
// ends with the entry indices, cut into shares of a fixed number of items.
// The kernels read the rows at the share edges from an array
// (ops/spmv.py:csr_shares computes it with one searchsorted; kernels/cuda.py
// caches it on the matrix); for a caller without one, share_edges fills it
// in a launch of its own.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Rows wholly consumed at merge diagonal d (a count of row ends and
// entries): the first row i with rowptrs[i + 1] + i + 1 > d, which is
// strictly increasing in i.  A 32-way search by the calling warp (all 32
// lanes call it); every lane returns the answer.
template <typename P>
__device__ int64_t merge_search(const P* __restrict__ rowptrs, int64_t d,
                                int64_t nrows, int64_t nnz) {
  const int lane = threadIdx.x & 31;
  int64_t lo = d > nnz ? d - nnz : 0;   // the answer lies in [lo, hi]
  int64_t hi = d < nrows ? d : nrows;
  while (lo < hi) {
    const int64_t step = (hi - lo + 31) >> 5;
    const int64_t p = lo + lane * step;
    const bool below = p < hi && int64_t(rowptrs[p + 1]) + p + 1 <= d;
    const int c = __popc(__ballot_sync(0xffffffffu, below));  // a prefix of lanes
    if (c == 0) {
      hi = lo;
    } else {
      const int64_t next = lo + c * step;
      lo += (c - 1) * step + 1;
      hi = next < hi ? next : hi;
    }
  }
  return lo;
}

// edges[e] = the rows consumed at diagonal min(e * tile, nrows + nnz), a
// warp an edge.
template <typename P>
__global__ void share_edges_kernel(const P* __restrict__ rowptrs, int64_t nrows,
                                   int64_t nnz, int64_t tile, int64_t n_edges,
                                   int64_t* __restrict__ edges) {
  const int64_t e = (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (e >= n_edges) return;  // the whole warp: e is the warp's
  const int64_t total = nrows + nnz;
  const int64_t d = e * tile < total ? e * tile : total;
  const int64_t r = merge_search(rowptrs, d, nrows, nnz);
  if ((threadIdx.x & 31) == 0) edges[e] = r;
}

// Launches share_edges_kernel for the ceil((nrows + nnz) / tile) + 1 share
// edges on `stream`.
template <typename P>
cudaError_t share_edges(const P* rowptrs, int64_t nrows, int64_t nnz,
                        int64_t tile, int64_t* edges, cudaStream_t stream) {
  const int64_t n_edges = (nrows + nnz + tile - 1) / tile + 1;
  const int64_t blocks = (n_edges * 32 + 255) / 256;
  share_edges_kernel<P><<<dim3{static_cast<unsigned>(blocks)}, 256, 0, stream>>>(
      rowptrs, nrows, nnz, tile, n_edges, edges);
  return cudaGetLastError();
}

}  // namespace
