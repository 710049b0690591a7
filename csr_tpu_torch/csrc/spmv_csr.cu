// CSR-form SpMV, y = A @ x (or y += A @ x), for Hopper (sm_90a).
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
// lane-dense vectors; this card does not, since a thread gathers x at any
// column.  Where a tile holds about one entry (hypersparse and thin-row
// matrices) the layout costs hundreds of bytes an entry; the CSR form
// costs 8 (kernels/cuda.py routes between the two).
//
// What bounds it on this card: bytes.  Each stored entry is read once
// (4 B column, 4 B value), each row pointer once, y written once; x is
// gathered at each entry's column, from L1 or L2 (4 MB at 2^20 columns).
// What the design does about it:
//   * Split (merge path, Merrill & Garland, SC16): the merge of the row
//     ends with the entry indices is cut into shares of kTile items, so a
//     run of power-law rows does as much work as a run of empty rows.  The
//     rows at the share edges come in (`edges`, ops/spmv.py:csr_shares,
//     cached on the matrix by kernels/cuda.py): no block searches before
//     it reads; a caller without them gets them from one launch of
//     merge_path.cuh's search first.
//   * Persistent blocks, as many as the card holds at once (kBlocksPerSm
//     an SM: the build is held to 32 registers), each over a contiguous
//     run of shares, the next share's edge read a share ahead.  A share's
//     row ends and products (16 B loads of colinds and values where both
//     allow) go to shared memory, x gathered by __ldg.
//   * Rows, not merge items, within a share: a share holds at most kTile
//     items, so its rows are summed directly, each in entry order: a
//     thread a row of up to kShort entries (rows t, t + 256, ...: the
//     stores of y are coalesced), a warp a longer one (lanes over its
//     entries, then a butterfly), so a long row does not hold a thread for
//     2,048 entries.  A walk of the merge by each thread (a search, a
//     walk and a scan a share) spends more instructions than the bytes
//     take.  Only a row's own products are added, in f32: an inf in x
//     reaches only the rows whose entries use it.
//   * Every row is written once, and no atomics: a share's open row (cut
//     by its end) is carried into the block's next share; the block's last
//     open row goes to carry[block], and a second launch adds each run of
//     carries into one row, in block order.  Empty rows store 0, so y
//     needs no memset (zeroed: stored; otherwise added to what y holds),
//     and the result is bitwise repeatable.
// cp.async staging a share ahead (double or triple buffered), x in shared
// memory and other L1 carveouts were measured slower on the H100: each
// costs the residency that hides the gathers' latency (PERF.md).  wgmma
// and TMA have no role in a gather-bound SpMV.

#include <cstdint>
#include <cuda_runtime.h>

#include "merge_path.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 2048;     // merge items a share (CSR_TILE)
constexpr int kShort = 16;      // entries a thread sums alone
constexpr int kBlocksPerSm = 8; // the residency the build is held to: 32 registers
constexpr unsigned kFull = 0xffffffffu;

// The share's items: the row ends first (relative to the share's first
// entry), then the entries' products.
union Item {
  int32_t end;
  float prod;
};

// Block b takes shares [b S / B, (b + 1) S / B) of the S shares, in turn.
// Share s: merge items d0 .. d1 - 1; rows r0 .. r1 - 1 end in it (r0, r1
// the rows wholly consumed at its edges, from `edges`), its entries are k0
// .. k1 - 1.  The row the share leaves open (r1) is carried into the next
// share; the block's last open row goes to carry[b] (carry_row[b] the row,
// -1 past the last row).
template <typename P>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
spmv_csr_kernel(const P* __restrict__ rowptrs, const int64_t* __restrict__ edges,
                const int32_t* __restrict__ colinds,
                const float* __restrict__ values, const float* __restrict__ x,
                float* __restrict__ y, int64_t nrows, int64_t nnz, int zeroed,
                float* __restrict__ carry, int64_t* __restrict__ carry_row) {
  __shared__ Item items[kTile];
  __shared__ int longs[kTile + 1];  // the share's long segments
  __shared__ int n_long;
  __shared__ float carry_in;    // the open row's sum, from the share before
  __shared__ float carry_next;  // and from this one
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t total = nrows + nnz;
  const int64_t n_shares = (total + kTile - 1) / kTile;
  const int64_t s_begin = n_shares * blockIdx.x / gridDim.x;
  const int64_t s_end = n_shares * (blockIdx.x + 1) / gridDim.x;
  if (threadIdx.x == 0) carry_in = 0.f;
  // 16 B loads of colinds and values where entry k lies on a 16 B boundary
  // of both (they are 4 B aligned; a is the offset of entry 0)
  const int a = int(reinterpret_cast<uintptr_t>(colinds) >> 2) & 3;
  const bool vec = !values ||
                   (int(reinterpret_cast<uintptr_t>(values) >> 2) & 3) == a;

  int64_t ea = __ldg(edges + s_begin), eb = __ldg(edges + s_begin + 1);
  for (int64_t s = s_begin; s < s_end; ++s) {
    const int64_t d0 = s * kTile;
    const int64_t d1 = d0 + kTile < total ? d0 + kTile : total;
    const int64_t r0 = ea, r1 = eb;
    const int64_t ec = s + 1 < s_end ? __ldg(edges + s + 2) : 0;  // read a share ahead
    const int64_t k0 = d0 - r0, k1 = d1 - r1;
    const int nr = int(r1 - r0);  // row ends in the share: rows r0 .. r1 - 1
    const int ne = int(k1 - k0);  // entries in the share: k0 .. k1 - 1

    for (int i = threadIdx.x; i < nr; i += kThreads)
      items[i].end = int32_t(int64_t(rowptrs[r0 + 1 + i]) - k0);
    Item* prods = items + nr;
    int64_t kb = k1, ke = k1;  // [kb, ke): whole aligned quads
    if (vec) {
      kb = k0 + ((4 - int((a + k0) & 3)) & 3);
      if (kb > k1) kb = k1;
      ke = kb + ((k1 - kb) & ~int64_t(3));
    }
    for (int64_t k = k0 + threadIdx.x; k < kb; k += kThreads)
      prods[k - k0].prod = (values ? __ldcs(values + k) : 1.f) *
                           __ldg(x + __ldcs(colinds + k));
    for (int64_t k = ke + threadIdx.x; k < k1; k += kThreads)
      prods[k - k0].prod = (values ? __ldcs(values + k) : 1.f) *
                           __ldg(x + __ldcs(colinds + k));
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
    if (threadIdx.x == 0) n_long = 0;
    __syncthreads();  // the share staged

    // Segment i of the share's entries: row r0 + i for i < nr (its entries
    // from the end of row i - 1, or from the share's first entry), and the
    // open row r1 for i == nr (the entries past the last row end).  The
    // first segment starts with the part of its row that the block's
    // earlier shares hold.  A thread sums each short segment, in entry
    // order; a long one is left to a warp.
    for (int i = threadIdx.x; i <= nr; i += kThreads) {
      const int k_lo = i ? items[i - 1].end : 0;
      const int k_hi = i < nr ? items[i].end : ne;
      if (k_hi - k_lo > kShort) {
        longs[atomicAdd(&n_long, 1)] = i;
        continue;
      }
      float sum = i ? 0.f : carry_in;
      for (int k = k_lo; k < k_hi; ++k) sum += prods[k].prod;
      if (i == nr) carry_next = sum;
      else if (zeroed) y[r0 + i] = sum;
      else y[r0 + i] += sum;
    }
    __syncthreads();  // the long segments listed
    // A warp a long segment: lane l sums entries l, l + 32, ..., then a
    // butterfly over the lanes (the same order whichever warp takes it).
    for (int j = warp; j < n_long; j += kWarps) {
      const int i = longs[j];
      const int k_lo = i ? items[i - 1].end : 0;
      const int k_hi = i < nr ? items[i].end : ne;
      float sum = 0.f;
      for (int k = k_lo + lane; k < k_hi; k += 32) sum += prods[k].prod;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(kFull, sum, off);
      if (i == 0) sum = carry_in + sum;
      if (lane == 0) {
        if (i == nr) carry_next = sum;
        else if (zeroed) y[r0 + i] = sum;
        else y[r0 + i] += sum;
      }
    }
    __syncthreads();  // the share's items read; the open row's sum
    if (threadIdx.x == 0) carry_in = carry_next;
    ea = eb;
    eb = ec;
  }
  if (threadIdx.x == 0) {  // ea: the rows consumed at the run's end
    carry[blockIdx.x] = carry_in;
    carry_row[blockIdx.x] = ea < nrows ? ea : -1;
  }
}

// The second launch, a thread a block of the first: the first block of
// each run of blocks that leave one row open sums the run's carries in
// block order and adds them to the row, which a later block stored.
__global__ void spmv_csr_carries(const float* __restrict__ carry,
                                 const int64_t* __restrict__ carry_row,
                                 float* __restrict__ y, int blocks) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= blocks) return;
  const int64_t row = carry_row[b];
  if (row < 0 || (b > 0 && carry_row[b - 1] == row)) return;
  float sum = carry[b];
  for (int e = b + 1; e < blocks && carry_row[e] == row; ++e) sum += carry[e];
  y[row] += sum;
}

template <typename P>
int launch(const P* rowptrs, int64_t* edges, int search,
           const int32_t* colinds, const float* values, const float* x,
           float* y, int64_t nrows, int64_t nnz, int zeroed, float* carry,
           int64_t* carry_row, int64_t slots, cudaStream_t stream) {
  const auto kernel = spmv_csr_kernel<P>;
  static int last_dev = -1, last_blocks = 0;  // the grid on the last device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev != last_dev) {
    int sms = 0, resident = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel,
                                                          kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (resident < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    last_dev = dev;
    last_blocks = sms * resident;
  }
  const int64_t n_shares = (nrows + nnz + kTile - 1) / kTile;
  int64_t blocks = last_blocks < n_shares ? last_blocks : n_shares;
  blocks = blocks < slots ? blocks : slots;
  if (search) {
    err = share_edges(rowptrs, nrows, nnz, kTile, edges, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<dim3{static_cast<unsigned>(blocks)}, kThreads, 0, stream>>>(
      rowptrs, edges, colinds, values, x, y, nrows, nnz, zeroed, carry,
      carry_row);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  spmv_csr_carries<<<dim3{static_cast<unsigned>((blocks + 255) / 256)}, 256, 0,
                     stream>>>(carry, carry_row, y, int(blocks));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y = A @ x (zeroed) or y += A @ x for an nrows-row CSR matrix of nnz
// entries (rowptrs[0] == 0, rowptrs[nrows] == nnz).  All pointers are
// device pointers, 4 B aligned; values may be null (every value 1).  edges
// holds the rows consumed at the ceil((nrows + nnz) / kTile) + 1 share
// edges (ops/spmv.py:csr_shares), or, with search, room for them, which a
// first launch fills.  carry (f32) and carry_row (int64) hold `slots`
// entries, at least the blocks of the launch (the card's SMs times the
// blocks it holds at once).  Launches on `stream` and returns the CUDA
// error (0 on success).
extern "C" int csrt_spmv_csr(const void* rowptrs, int ptr64, void* edges,
                             int search, const void* colinds,
                             const void* values, const void* x, void* y,
                             int64_t nrows, int64_t nnz, int zeroed,
                             void* carry, void* carry_row, int64_t slots,
                             void* stream) {
  if (nrows <= 0 || nnz <= 0) return static_cast<int>(cudaGetLastError());
  const auto e = static_cast<int64_t*>(edges);
  const auto ci = static_cast<const int32_t*>(colinds);
  const auto v = static_cast<const float*>(values);
  const auto xp = static_cast<const float*>(x);
  const auto yp = static_cast<float*>(y);
  const auto cy = static_cast<float*>(carry);
  const auto cr = static_cast<int64_t*>(carry_row);
  const auto s = static_cast<cudaStream_t>(stream);
  if (ptr64)
    return launch(static_cast<const int64_t*>(rowptrs), e, search, ci, v, xp, yp,
                  nrows, nnz, zeroed, cy, cr, slots, s);
  return launch(static_cast<const int32_t*>(rowptrs), e, search, ci, v, xp, yp,
                nrows, nnz, zeroed, cy, cr, slots, s);
}
