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
//     empty rows both balance.  The rows at the share edges come in
//     (`edges`, cached on the matrix by kernels/cuda.py), or one launch of
//     merge_path.cuh's search fills them first.
//   * Staging: the block copies its share's row ends and (column, value)
//     pairs into shared memory once, for all its warps and all passes over
//     C's columns.
//   * A sub-warp a row: `lanes` lanes (4, 8, 16 or 32; ops/spmm.py:
//     csr_plan picks the fewest that cover n) walk one row, 4 columns of C
//     a lane, so a pass covers 4 lanes columns and a warp walks 32 / lanes
//     rows at once (two at ALS's n = 50, eight at n <= 16).  A lane loads
//     kW floats at a time: 16 B where n % 4 == 0 and B's and C's rows lie
//     on 16 B boundaries, 8 B where n is even and they lie on 8 B ones
//     (n = 50: 200 B rows), else 4 B; so any n and any 4 B aligned B run
//     with no padded copy.  Each sub-warp (a unit) takes kWarpItems /
//     (32 / lanes) items of the share, from its own point (a binary search
//     in shared memory), and walks them row by row.
//   * Within a row the gathers of kU entries are issued together, whole
//     batches first and the rest of the row in one batch predicated past
//     its end, so a row of up to kU entries waits for its gathers once
//     (kU = 8 cost more registers than it saved).  C
//     is stored with streaming stores (st.global.cs), B read by __ldg.  An
//     L2 evict-last hint on B gained nothing in a kernel's own time on the
//     H100 and left its lines in L2 after the kernel, where they cost the
//     kernels that followed (PERF.md).
//   * Rows: a row's sums stay in registers across its entries, and only a
//     row's own products are added, in f32: no prefix differences, so an
//     inf in B reaches only the rows whose entries use its row.  A row that
//     a unit starts and ends is stored once; an empty row stores zeros.
//     Every row's end lies in exactly one share, so every row of C is
//     written by the first launch and C needs no memset.
//   * Cut rows: a unit leaves its first ended row and its unended tail in
//     shared memory; after the walk a thread a column of the pass adds
//     them in unit order and stores the rows that the share ends (a row
//     cut between units).
//     What a share holds of the row it does not end (its tail, cut by the
//     share's edge) goes to carry[share] (n floats), and the row to
//     carry_row[share] (-1: no tail).  A second launch, a block a share,
//     takes the first share of each run of equal carry_row, sums the run's
//     carries in share order and adds them to the row, which the first
//     launch stored.  No atomics anywhere: the result is bitwise
//     repeatable.
//   * Column panels (where B is larger than a slab of L2 and rows are long;
//     kernels/cuda.py's rule): A's columns are cut into K contiguous
//     panels, and the product runs panel after panel on the stream, C =
//     A_0 B_0, then C += A_k B_k, so every block in flight gathers from
//     one panel's rows of B, which L2 holds.  A row's entries in a panel
//     are a run of the row (its columns come in order): panel k has row
//     pointers of its own (int32, the runs' lengths summed) and each run's
//     first entry less its row pointer (`base`), so the block stages its
//     share's entries from their runs, with no copy of the matrix
//     (ops/spmm.py:Panels).  Every panel is its own merge path, with its
//     own share edges, walked as above; the first launch stores every row,
//     later ones add a row's sum into C only where the panel holds entries
//     of it.  Each row's sum is still its own products in f32, in a fixed
//     order: the result is bitwise repeatable.
// wgmma and TMA have no role in a gather-bound SpMM of this kind yet.

#include <cstdint>
#include <cuda_runtime.h>

#include "merge_path.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kWarpItems = 128;             // merge items a warp
constexpr int kTile = kWarps * kWarpItems;  // merge items a share (SPMM_CSR_TILE)
constexpr int kPass = 4 * kThreads;         // columns of C a pass, over all units
constexpr int kMaxUnits = kWarps * 8;       // units at 4 lanes a row
constexpr int kU = 4;                       // entries whose gathers fly together
constexpr int kFixThreads = 128;

// kW floats of B at p.
template <int kW>
__device__ __forceinline__ void load_b(const float* p, float* q) {
  if (kW == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    q[0] = t.x;
    q[1] = t.y;
    q[2] = t.z;
    q[3] = t.w;
  } else if (kW == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    q[0] = t.x;
    q[1] = t.y;
  } else {
    q[0] = __ldg(p);
  }
}

// kW floats to C at p, by streaming stores.
template <int kW>
__device__ __forceinline__ void store_c(float* p, const float* v) {
  if (kW == 4) __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  else if (kW == 2) __stcs(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
  else __stcs(p, v[0]);
}

// The column, from the pass's first, of a lane's value i (0..3): lane l of
// a unit of `lanes` lanes loads kW floats at kW (l + lanes j), j < 4 / kW.
template <int kW>
__device__ __forceinline__ int col_of(int l, int lanes, int i) {
  return kW * (l + lanes * (i / kW)) + i % kW;
}

// acc[i] += vals[u] * B[cols[u], c0 + col_of(i)] for the first `count` of
// kU entries and the columns below n; all their gathers are issued before
// any is used.
template <int kW>
__device__ __forceinline__ void accumulate(const float* __restrict__ b,
                                           int64_t ldb, int c0, int n, int l,
                                           int lanes, const int32_t* cols,
                                           const float* vals, int count,
                                           float acc[4]) {
  float q[kU][4];
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const float* row = b + int64_t(u < count ? cols[u] : 0) * ldb + c0;
#pragma unroll
    for (int j = 0; j < 4 / kW; ++j) {
      const int col = kW * (l + lanes * j);
      if (u < count && c0 + col < n) {
        load_b<kW>(row + col, &q[u][kW * j]);
      } else {
#pragma unroll
        for (int e = 0; e < kW; ++e) q[u][kW * j + e] = 0.f;
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kU; ++u)
    if (u < count) {
      const float v = vals[u];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] += v * q[u][i];
    }
}

// C[row, c0 + col_of(i)] = acc[i] for the columns below n.
template <int kW>
__device__ __forceinline__ void store_row(float* __restrict__ c, int n,
                                          int64_t row, int c0, int l, int lanes,
                                          const float acc[4]) {
  float* out = c + row * n + c0;
#pragma unroll
  for (int j = 0; j < 4 / kW; ++j) {
    const int col = kW * (l + lanes * j);
    if (c0 + col < n) store_c<kW>(out + col, acc + kW * j);
  }
}

// C[row, c0 + col_of(i)] += acc[i] for the columns below n (a panel after
// the first), C read and written by streaming accesses, so that C's lines
// do not take the L2 that holds the panel's rows of B.
template <int kW>
__device__ __forceinline__ void add_row(float* __restrict__ c, int n,
                                        int64_t row, int c0, int l, int lanes,
                                        const float acc[4]) {
  float* out = c + row * n + c0;
#pragma unroll
  for (int j = 0; j < 4 / kW; ++j) {
    const int col = kW * (l + lanes * j);
    if (c0 + col < n) {
      float q[kW];
      if (kW == 4) {
        const float4 t = __ldcs(reinterpret_cast<const float4*>(out + col));
        q[0] = t.x;
        q[1] = t.y;
        q[2] = t.z;
        q[3] = t.w;
      } else if (kW == 2) {
        const float2 t = __ldcs(reinterpret_cast<const float2*>(out + col));
        q[0] = t.x;
        q[1] = t.y;
      } else {
        q[0] = __ldcs(out + col);
      }
#pragma unroll
      for (int e = 0; e < kW; ++e) q[e] += acc[kW * j + e];
      store_c<kW>(out + col, q);
    }
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
// consumed at its edges), its entries are k0 .. k1 - 1.  kWarpRow: a warp
// a row (lanes == 32), built apart so that its lane arithmetic folds away.
// kPanel: a column panel (rowptrs its own row pointers, nnz its entries,
// `base` each row's run's first entry less its row pointer); with `add`,
// C += the panel's product, else C = it.
template <typename P, int kW, bool kWarpRow, bool kPanel>
__device__ __forceinline__ void spmm_csr_share(
    const P* __restrict__ rowptrs, const int64_t* __restrict__ edges,
    const int32_t* __restrict__ colinds, const float* __restrict__ values,
    const float* __restrict__ b, int64_t ldb, float* __restrict__ c, int n,
    int lanes_arg, int64_t nrows, int64_t nnz, float* __restrict__ carry,
    int32_t* __restrict__ carry_row, const int32_t* __restrict__ base,
    bool add) {
  const int lanes = kWarpRow ? 32 : lanes_arg;
  __shared__ int32_t ends[kTile];  // row ends, relative to entry k0
  __shared__ int32_t cols[kTile];
  __shared__ float vals[kTile];
  __shared__ float first[kPass];  // a unit's first ended row, by unit
  __shared__ float last[kPass];   // a unit's unended tail, by unit
  __shared__ int32_t first_row[kMaxUnits];  // -1: the unit ended no row
  __shared__ int32_t row_base[kPanel ? kTile + 1 : 1];  // base, rows r0 .. r1
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int per_warp = 32 / lanes;  // units a warp
  const int sub = lane / lanes, l = lane - sub * lanes;
  const int units = kWarps * per_warp, unit = warp * per_warp + sub;
  const int unit_items = kWarpItems / per_warp;
  const int pass = 4 * lanes;  // columns of C a pass

  const int64_t total = nrows + nnz;
  const int64_t s = blockIdx.x;
  const int64_t d0 = s * kTile;
  const int64_t d1 = d0 + kTile < total ? d0 + kTile : total;
  const int64_t r0 = edges[s], r1 = edges[s + 1];
  const int64_t k0 = d0 - r0;
  const int nr = int(r1 - r0);         // rows that end in the share
  const int ne = int(d1 - r1 - k0);    // entries in the share
  for (int i = threadIdx.x; i < nr; i += kThreads)
    ends[i] = int32_t(int64_t(rowptrs[r0 + 1 + i]) - k0);
  // where row r0's run in the share starts (at or before 0): a panel's row
  // with no entry in it is one whose end is where it starts
  int32_t start0 = 0;
  if constexpr (kPanel) {
    start0 = int32_t(int64_t(rowptrs[r0]) - k0);
    for (int i = threadIdx.x; i <= nr && r0 + i < nrows; i += kThreads)
      row_base[i] = base[r0 + i];
    __syncthreads();
    // entry i is of local row j, the first whose end is past i (nr: the
    // tail), and lies at row_base[j] + k0 + i in the matrix
    for (int i = threadIdx.x; i < ne; i += kThreads) {
      int lo = 0, hi = nr;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (ends[mid] <= i) lo = mid + 1;
        else hi = mid;
      }
      const int64_t at = int64_t(row_base[lo]) + k0 + i;
      cols[i] = __ldcs(colinds + at);
      vals[i] = values ? __ldcs(values + at) : 1.f;
    }
  } else {
    for (int i = threadIdx.x; i < ne; i += kThreads) {
      cols[i] = __ldcs(colinds + k0 + i);
      vals[i] = values ? __ldcs(values + k0 + i) : 1.f;
    }
  }
  __syncthreads();

  // the share's tail: entries of row r1 (which a later share ends)
  const bool tail = nr ? ne > ends[nr - 1] : ne > 0;
  if (threadIdx.x == 0) carry_row[s] = tail ? int32_t(r1) : -1;
  const int n_items = nr + ne;
  const int ud0 = unit * unit_items < n_items ? unit * unit_items : n_items;
  const int ud1 = ud0 + unit_items < n_items ? ud0 + unit_items : n_items;
  const int ra = rows_at(ends, nr, ne, ud0), rb = rows_at(ends, nr, ne, ud1);
  float* my_first = first + unit * pass;
  float* my_last = last + unit * pass;

  for (int c0 = 0; c0 < n; c0 += pass) {
    int ri = ra, ki = ud0 - ra, fr = -1;
    const int k_stop = ud1 - rb;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    while (true) {
      const int begin = ki;
      const int stop = ri < rb ? ends[ri] : k_stop;  // row ri's last entry here
      for (; ki + kU <= stop; ki += kU)  // whole batches: no predicates
        accumulate<kW>(b, ldb, c0, n, l, lanes, cols + ki, vals + ki, kU, acc);
      if (ki < stop)
        accumulate<kW>(b, ldb, c0, n, l, lanes, cols + ki, vals + ki, stop - ki,
                       acc);
      ki = stop;
      if (ri >= rb) break;  // the unit's tail: a later unit or share ends it
      if (fr < 0) {         // may have parts in earlier units: resolved below
        fr = ri;
#pragma unroll
        for (int i = 0; i < 4; ++i) my_first[col_of<kW>(l, lanes, i)] = acc[i];
      } else if (!kPanel || !add) {
        store_row<kW>(c, n, r0 + ri, c0, l, lanes, acc);
      } else if (begin < stop) {  // the row started in the unit: all its run
        add_row<kW>(c, n, r0 + ri, c0, l, lanes, acc);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] = 0.f;
      ++ri;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) my_last[col_of<kW>(l, lanes, i)] = acc[i];
    if (l == 0) first_row[unit] = fr;
    __syncthreads();

    // the rows cut between units, in unit order: a unit's tail and the
    // whole of any unit that ends no row belong to the next ended row
    for (int t = threadIdx.x; t < pass; t += kThreads) {
      float run = 0.f;
      for (int u = 0; u < units; ++u) {
        const int j = first_row[u];
        if (j >= 0) {
          if (c0 + t < n) {
            float* out = c + (r0 + j) * n + c0 + t;
            if (!kPanel || !add)
              __stcs(out, run + first[u * pass + t]);
            else if (ends[j] != (j ? ends[j - 1] : start0))
              __stcs(out, __ldcs(out) + (run + first[u * pass + t]));
          }
          run = last[u * pass + t];
        } else {
          run += last[u * pass + t];
        }
      }
      if (tail && c0 + t < n) carry[s * n + c0 + t] = run;
    }
    __syncthreads();  // the next pass reuses first, last and first_row
  }
}

#define SPMM_CSR_PARAMS                                                      \
  const P *__restrict__ rowptrs, const int64_t *__restrict__ edges,          \
      const int32_t *__restrict__ colinds, const float *__restrict__ values, \
      const float *__restrict__ b, int64_t ldb, float *__restrict__ c, int n, \
      int lanes, int64_t nrows, int64_t nnz, float *__restrict__ carry,      \
      int32_t *__restrict__ carry_row
#define SPMM_CSR_ARGS                                                        \
  rowptrs, edges, colinds, values, b, ldb, c, n, lanes, nrows, nnz, carry,   \
      carry_row

template <typename P, int kW, bool kWarpRow>
__global__ void __launch_bounds__(kThreads) spmm_csr_kernel(SPMM_CSR_PARAMS) {
  spmm_csr_share<P, kW, kWarpRow, false>(SPMM_CSR_ARGS, nullptr, false);
}

// A warp a row with 16 B loads: held to four blocks an SM (64 registers),
// where ptxas spilled at 40 with no bound (and a bound on every build cost
// n = 50 its residency).
template <typename P>
__global__ void __launch_bounds__(kThreads, 4) spmm_csr_kernel_row16(SPMM_CSR_PARAMS) {
  spmm_csr_share<P, 4, true, false>(SPMM_CSR_ARGS, nullptr, false);
}

// One column panel (P is int32_t: the panel's own row pointers): the
// kernels above with the panel's staging, adding into C with `add`.
template <typename P, int kW, bool kWarpRow>
__global__ void __launch_bounds__(kThreads) spmm_csr_panel_kernel(
    SPMM_CSR_PARAMS, const int32_t* __restrict__ base, int add) {
  spmm_csr_share<P, kW, kWarpRow, true>(SPMM_CSR_ARGS, base, add != 0);
}

template <typename P>
__global__ void __launch_bounds__(kThreads, 4) spmm_csr_panel_kernel_row16(
    SPMM_CSR_PARAMS, const int32_t* __restrict__ base, int add) {
  spmm_csr_share<P, 4, true, true>(SPMM_CSR_ARGS, base, add != 0);
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

template <typename P, int kW>
int launch(const P* rowptrs, int64_t* edges, int search,
           const int32_t* colinds, const float* values, const float* b,
           int64_t ldb, float* c, int n, int lanes, int64_t nrows, int64_t nnz,
           float* carry, int32_t* carry_row, cudaStream_t stream) {
  const int64_t n_shares = (nrows + nnz + kTile - 1) / kTile;
  if (search) {
    const cudaError_t err = share_edges(rowptrs, nrows, nnz, kTile, edges, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (lanes == 32) {
    if constexpr (kW == 4)
      spmm_csr_kernel_row16<P><<<dim3{static_cast<unsigned>(n_shares)},
                                 kThreads, 0, stream>>>(SPMM_CSR_ARGS);
    else
      spmm_csr_kernel<P, kW, true><<<dim3{static_cast<unsigned>(n_shares)},
                                     kThreads, 0, stream>>>(SPMM_CSR_ARGS);
  } else
    spmm_csr_kernel<P, kW, false><<<dim3{static_cast<unsigned>(n_shares)},
                                    kThreads, 0, stream>>>(
        rowptrs, edges, colinds, values, b, ldb, c, n, lanes, nrows, nnz, carry,
        carry_row);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  spmm_csr_carries<<<dim3{static_cast<unsigned>(n_shares)}, kFixThreads, 0,
                     stream>>>(carry, carry_row, c, n, n_shares);
  return static_cast<int>(cudaGetLastError());
}

// The product panel by panel on `stream`: panel k's row pointers at
// ptrs + k (nrows + 1), its bases at base + k nrows, its share edges after
// the earlier panels' (each ceil((nrows + nnz_k) / kTile) + 1 of them); the
// first panel stores every row of C, each later one with entries adds.
template <int kW>
int launch_panels(const int32_t* ptrs, const int32_t* base,
                  const int64_t* edges, int panels, const int64_t* panel_nnz,
                  const int32_t* colinds, const float* values, const float* b,
                  int64_t ldb, float* c, int n, int lanes, int64_t nrows,
                  float* carry, int32_t* carry_row, cudaStream_t stream) {
  for (int k = 0; k < panels; ++k) {
    const int64_t nnz = panel_nnz[k];
    const int64_t n_shares = (nrows + nnz + kTile - 1) / kTile;
    if (k == 0 || nnz > 0) {
      const int32_t* rowptrs = ptrs + k * (nrows + 1);
      const int32_t* bs = base + k * nrows;
      const int add = k > 0;
      const dim3 grid{static_cast<unsigned>(n_shares)};
      if (lanes == 32) {
        if constexpr (kW == 4)
          spmm_csr_panel_kernel_row16<int32_t><<<grid, kThreads, 0, stream>>>(
              SPMM_CSR_ARGS, bs, add);
        else
          spmm_csr_panel_kernel<int32_t, kW, true><<<grid, kThreads, 0, stream>>>(
              SPMM_CSR_ARGS, bs, add);
      } else {
        spmm_csr_panel_kernel<int32_t, kW, false><<<grid, kThreads, 0, stream>>>(
            SPMM_CSR_ARGS, bs, add);
      }
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
      spmm_csr_carries<<<grid, kFixThreads, 0, stream>>>(carry, carry_row, c, n,
                                                          n_shares);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    edges += n_shares + 1;
  }
  return 0;
}

template <typename P>
int launch_w(int width, const P* rowptrs, int64_t* edges, int search,
             const int32_t* colinds, const float* values, const float* b,
             int64_t ldb, float* c, int n, int lanes, int64_t nrows,
             int64_t nnz, float* carry, int32_t* carry_row,
             cudaStream_t stream) {
  if (width == 4)
    return launch<P, 4>(rowptrs, edges, search, colinds, values, b, ldb, c, n,
                        lanes, nrows, nnz, carry, carry_row, stream);
  if (width == 2)
    return launch<P, 2>(rowptrs, edges, search, colinds, values, b, ldb, c, n,
                        lanes, nrows, nnz, carry, carry_row, stream);
  return launch<P, 1>(rowptrs, edges, search, colinds, values, b, ldb, c, n,
                      lanes, nrows, nnz, carry, carry_row, stream);
}

int launch_panels_w(int width, const int32_t* ptrs, const int32_t* base,
                    const int64_t* edges, int panels, const int64_t* panel_nnz,
                    const int32_t* colinds, const float* values, const float* b,
                    int64_t ldb, float* c, int n, int lanes, int64_t nrows,
                    float* carry, int32_t* carry_row, cudaStream_t stream) {
  if (width == 4)
    return launch_panels<4>(ptrs, base, edges, panels, panel_nnz, colinds,
                            values, b, ldb, c, n, lanes, nrows, carry,
                            carry_row, stream);
  if (width == 2)
    return launch_panels<2>(ptrs, base, edges, panels, panel_nnz, colinds,
                            values, b, ldb, c, n, lanes, nrows, carry,
                            carry_row, stream);
  return launch_panels<1>(ptrs, base, edges, panels, panel_nnz, colinds,
                          values, b, ldb, c, n, lanes, nrows, carry, carry_row,
                          stream);
}

}  // namespace

// C = A @ B for an nrows-row CSR matrix of nnz entries (rowptrs[0] == 0,
// rowptrs[nrows] == nnz) and B of n columns, rows ldb floats apart.  All
// pointers are device pointers, 4 B aligned; values may be null (every
// value 1).  edges holds the rows consumed at the ceil((nrows + nnz) /
// kTile) + 1 share edges (ops/spmv.py:csr_shares), or, with search, room
// for them, which a first launch fills.  width (4, 2 or 1) is the floats a
// lane loads: with 4, n and ldb are multiples of 4 and B and C lie on 16 B
// boundaries; with 2, multiples of 2 on 8 B ones.  lanes (4, 8, 16 or 32)
// walk a row.  carry holds ceil((nrows + nnz) / kTile) rows of n floats and
// carry_row as many int32; C needs no zeroing.
//
// With panels > 1 the product runs in that many column panels
// (ops/spmm.py:Panels): rowptrs holds the panels' int32 row pointers
// (panels x (nrows + 1), ptr64 0), panel_base their int32 bases (panels x
// nrows), edges each panel's share edges one after another (no search),
// panel_nnz, a host array, each panel's entries; carry and carry_row hold
// the largest panel's shares.  panels 0 or 1 is the one launch above.
// Launches the kernels on `stream` and returns the CUDA error (0 on
// success).
extern "C" int csrt_spmm_csr(const void* rowptrs, int ptr64, void* edges,
                             int search, const void* colinds,
                             const void* values, const void* b, int64_t ldb,
                             void* c, int64_t n, int64_t nrows, int64_t nnz,
                             void* carry, void* carry_row, int width, int lanes,
                             int panels, const void* panel_base,
                             const void* panel_nnz, void* stream) {
  if (nrows <= 0 || nnz <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  if (!(lanes == 4 || lanes == 8 || lanes == 16 || lanes == 32) ||
      !(width == 1 || width == 2 || width == 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto e = static_cast<int64_t*>(edges);
  const auto ci = static_cast<const int32_t*>(colinds);
  const auto v = static_cast<const float*>(values);
  const auto bp = static_cast<const float*>(b);
  const auto cp = static_cast<float*>(c);
  const auto cy = static_cast<float*>(carry);
  const auto cr = static_cast<int32_t*>(carry_row);
  const auto s = static_cast<cudaStream_t>(stream);
  if (panels > 1) {
    if (ptr64 || search || !panel_base || !panel_nnz)
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_panels_w(width, static_cast<const int32_t*>(rowptrs),
                           static_cast<const int32_t*>(panel_base), e, panels,
                           static_cast<const int64_t*>(panel_nnz), ci, v, bp,
                           ldb, cp, int(n), lanes, nrows, cy, cr, s);
  }
  if (ptr64)
    return launch_w(width, static_cast<const int64_t*>(rowptrs), e, search, ci, v,
                    bp, ldb, cp, int(n), lanes, nrows, nnz, cy, cr, s);
  return launch_w(width, static_cast<const int32_t*>(rowptrs), e, search, ci, v,
                  bp, ldb, cp, int(n), lanes, nrows, nnz, cy, cr, s);
}
