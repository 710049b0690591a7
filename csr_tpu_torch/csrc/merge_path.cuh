// The merge-path split of a CSR matrix (Merrill & Garland, SC16), shared by
// the CSR-form kernels spmv_csr.cu and spmm_csr.cu: the merge of the row
// ends with the entry indices, cut into shares of a fixed number of items
// (ops/spmv.py:csr_shares computes the same edges on the host side).
#pragma once

#include <cstdint>

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

}  // namespace
