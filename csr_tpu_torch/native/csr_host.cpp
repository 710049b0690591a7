// Native host-side CSR utilities.
//
// This module plays the role the reference's C shim plays for MKL
// (reference: csr/kernels/mkl/mkl_ops.c): the native component of the
// framework.  Device compute belongs to XLA/Pallas; what remains
// performance-sensitive on the host is *construction* — COO ingestion,
// compaction, row sorting — which runs on numpy buffers before data ships
// to the device.  These are exact ports of the reference algorithms
// (counting sort two-pass COO->CSR, reference: csr/structure.py:12-58;
// count-then-scatter transpose, reference: csr/structure.py:172-237;
// in-place zero compaction, reference: csr/_struct.py:61-79), written as
// cache-friendly single-threaded C++ with optional OpenMP-free threading
// via caller-side row slicing.
//
// Exported C ABI (bound via ctypes, no pybind11 dependency):
//   csrt_from_coo_f{32,64}   COO triple -> CSR triple
//   csrt_from_coo_structure  structure-only variant
//   csrt_transpose_f{32,64}  CSR -> CSC-as-CSR
//   csrt_sort_rows_f{32,64}  in-place per-row column sort
//   csrt_filter_zeros_f{32,64} in-place compaction, returns new nnz
//   csrt_row_ids             rowptr expansion to COO row vector
//
// Build: csr_tpu/native/build.py (g++ -O3 -shared).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

// ---------------------------------------------------------------------------
// COO -> CSR: two-pass counting sort, stable within rows
// (reference: csr/structure.py:12-58)

static void count_rows(int64_t nnz, const int32_t* rows, int64_t nrows,
                       int64_t* rowptrs) {
  std::memset(rowptrs, 0, sizeof(int64_t) * (nrows + 1));
  for (int64_t i = 0; i < nnz; ++i) rowptrs[rows[i] + 1]++;
  for (int64_t r = 0; r < nrows; ++r) rowptrs[r + 1] += rowptrs[r];
}

template <typename T>
static void from_coo_impl(int64_t nnz, const int32_t* rows,
                          const int32_t* cols, const T* vals, int64_t nrows,
                          int64_t* rowptrs, int32_t* out_cols, T* out_vals) {
  count_rows(nnz, rows, nrows, rowptrs);
  std::vector<int64_t> rpos(rowptrs, rowptrs + nrows);
  for (int64_t i = 0; i < nnz; ++i) {
    int64_t p = rpos[rows[i]]++;
    out_cols[p] = cols[i];
    if (vals) out_vals[p] = vals[i];
  }
}

extern "C" void csrt_from_coo_f64(int64_t nnz, const int32_t* rows, const int32_t* cols,
                       const double* vals, int64_t nrows, int64_t* rowptrs,
                       int32_t* out_cols, double* out_vals) {
  from_coo_impl(nnz, rows, cols, vals, nrows, rowptrs, out_cols, out_vals);
}

extern "C" void csrt_from_coo_f32(int64_t nnz, const int32_t* rows, const int32_t* cols,
                       const float* vals, int64_t nrows, int64_t* rowptrs,
                       int32_t* out_cols, float* out_vals) {
  from_coo_impl(nnz, rows, cols, vals, nrows, rowptrs, out_cols, out_vals);
}

extern "C" void csrt_from_coo_structure(int64_t nnz, const int32_t* rows,
                             const int32_t* cols, int64_t nrows,
                             int64_t* rowptrs, int32_t* out_cols) {
  from_coo_impl<double>(nnz, rows, cols, nullptr, nrows, rowptrs, out_cols,
                        nullptr);
}

// ---------------------------------------------------------------------------
// transpose: count-then-scatter (reference: csr/structure.py:172-237)

template <typename T>
static void transpose_impl(int64_t nrows, int64_t ncols,
                           const int64_t* rowptrs, const int32_t* cols,
                           const T* vals, int64_t* t_rowptrs, int32_t* t_cols,
                           T* t_vals) {
  int64_t nnz = rowptrs[nrows];
  std::memset(t_rowptrs, 0, sizeof(int64_t) * (ncols + 1));
  for (int64_t i = 0; i < nnz; ++i) t_rowptrs[cols[i] + 1]++;
  for (int64_t c = 0; c < ncols; ++c) t_rowptrs[c + 1] += t_rowptrs[c];
  std::vector<int64_t> pos(t_rowptrs, t_rowptrs + ncols);
  for (int64_t r = 0; r < nrows; ++r) {
    for (int64_t i = rowptrs[r]; i < rowptrs[r + 1]; ++i) {
      int64_t p = pos[cols[i]]++;
      t_cols[p] = static_cast<int32_t>(r);
      if (vals) t_vals[p] = vals[i];
    }
  }
}

extern "C" void csrt_transpose_f64(int64_t nrows, int64_t ncols, const int64_t* rowptrs,
                        const int32_t* cols, const double* vals,
                        int64_t* t_rowptrs, int32_t* t_cols, double* t_vals) {
  transpose_impl(nrows, ncols, rowptrs, cols, vals, t_rowptrs, t_cols, t_vals);
}

extern "C" void csrt_transpose_f32(int64_t nrows, int64_t ncols, const int64_t* rowptrs,
                        const int32_t* cols, const float* vals,
                        int64_t* t_rowptrs, int32_t* t_cols, float* t_vals) {
  transpose_impl(nrows, ncols, rowptrs, cols, vals, t_rowptrs, t_cols, t_vals);
}

extern "C" void csrt_transpose_structure(int64_t nrows, int64_t ncols,
                              const int64_t* rowptrs, const int32_t* cols,
                              int64_t* t_rowptrs, int32_t* t_cols) {
  transpose_impl<double>(nrows, ncols, rowptrs, cols, nullptr, t_rowptrs,
                         t_cols, nullptr);
}

// ---------------------------------------------------------------------------
// in-place per-row column sort (reference: csr/structure.py:156-169 uses
// bubble sort; here an index sort per row)

template <typename T>
static void sort_rows_impl(int64_t nrows, const int64_t* rowptrs,
                           int32_t* cols, T* vals) {
  std::vector<int32_t> idx;
  std::vector<int32_t> ctmp;
  std::vector<T> vtmp;
  for (int64_t r = 0; r < nrows; ++r) {
    int64_t s = rowptrs[r], e = rowptrs[r + 1];
    int64_t n = e - s;
    if (n <= 1) continue;
    idx.resize(n);
    std::iota(idx.begin(), idx.end(), 0);
    std::stable_sort(idx.begin(), idx.end(), [&](int32_t a, int32_t b) {
      return cols[s + a] < cols[s + b];
    });
    ctmp.assign(cols + s, cols + e);
    for (int64_t i = 0; i < n; ++i) cols[s + i] = ctmp[idx[i]];
    if (vals) {
      vtmp.assign(vals + s, vals + e);
      for (int64_t i = 0; i < n; ++i) vals[s + i] = vtmp[idx[i]];
    }
  }
}

extern "C" void csrt_sort_rows_f64(int64_t nrows, const int64_t* rowptrs, int32_t* cols,
                        double* vals) {
  sort_rows_impl(nrows, rowptrs, cols, vals);
}

extern "C" void csrt_sort_rows_f32(int64_t nrows, const int64_t* rowptrs, int32_t* cols,
                        float* vals) {
  sort_rows_impl(nrows, rowptrs, cols, vals);
}

extern "C" void csrt_sort_rows_structure(int64_t nrows, const int64_t* rowptrs,
                              int32_t* cols) {
  sort_rows_impl<double>(nrows, rowptrs, cols, nullptr);
}

// ---------------------------------------------------------------------------
// in-place zero compaction (reference: csr/_struct.py:61-79)

template <typename T>
static int64_t filter_zeros_impl(int64_t nrows, int64_t* rowptrs,
                                 int32_t* cols, T* vals) {
  int64_t nnz = 0;
  for (int64_t r = 0; r < nrows; ++r) {
    int64_t s = rowptrs[r], e = rowptrs[r + 1];
    rowptrs[r] = nnz;
    for (int64_t i = s; i < e; ++i) {
      if (vals[i] != T(0)) {
        cols[nnz] = cols[i];
        vals[nnz] = vals[i];
        nnz++;
      }
    }
  }
  rowptrs[nrows] = nnz;
  return nnz;
}

extern "C" int64_t csrt_filter_zeros_f64(int64_t nrows, int64_t* rowptrs, int32_t* cols,
                              double* vals) {
  return filter_zeros_impl(nrows, rowptrs, cols, vals);
}

extern "C" int64_t csrt_filter_zeros_f32(int64_t nrows, int64_t* rowptrs, int32_t* cols,
                              float* vals) {
  return filter_zeros_impl(nrows, rowptrs, cols, vals);
}

// ---------------------------------------------------------------------------
// rowptr expansion (reference: csr/_rows.py:122-128)

extern "C" void csrt_row_ids(int64_t nrows, const int64_t* rowptrs, int32_t* out) {
  for (int64_t r = 0; r < nrows; ++r) {
    for (int64_t i = rowptrs[r]; i < rowptrs[r + 1]; ++i) {
      out[i] = static_cast<int32_t>(r);
    }
  }
}


// ---------------------------------------------------------------------------
// Micro-block layout build (the pallas kernel's to_handle preprocessing;
// mirrors csr_tpu/ops/microblock.py:build_microblocks_host exactly).
//
// Entries are reordered to lexicographic (rb, cb, row) order — two stable
// LSD counting-sort passes over the already-row-major CSR entries — then
// packed into micro-rows of up to MB_SLOT_CAP = 127 entries (slot 127 of
// the 128-lane row is always padding: the cap keeps the row-boundary
// prefix count epos in [0, 127] so the SpMV kernel's boundary gather is
// provably lane-bounded; see csr_tpu/ops/microblock.py SLOT_CAP) per
// (rb, cb) group, with each stripe
// (run of one rb) padded to a multiple of pad_mult micro-rows so every
// aligned pad_mult-row accumulation group has a uniform row window.
//
// The column window width is parameterized (cshift = 7 for 128-wide
// windows, 8 for the 256-wide double-window layout; see
// csr_tpu/ops/microblock.py docstring).  meta packs lo | epos << 7 for
// 128-wide and lo | epos << 8 for 256-wide.
//
// Two-call protocol (output size is data-dependent):
//   csrt_mb_plan(...)  -> m  (micro-rows incl. stripe padding), or -1 when
//                         the matrix exceeds the rb/cb packing range
//   csrt_mb_fill(...)  fills caller-allocated vals/meta/rbcb arrays of
//                         m_pad >= m rows; returns m

namespace {

struct MbSorted {
  std::vector<int32_t> rid, col;
  std::vector<float> val;
};

// entries per micro-row (== csr_tpu.ops.microblock.SLOT_CAP)
static constexpr int64_t MB_SLOT_CAP = 127;

static inline int64_t mb_mrs(int64_t size) {
  return (size + MB_SLOT_CAP - 1) / MB_SLOT_CAP;
}

// Sort entries to (rb, cb, row, input-order) using two stable counting
// passes; input CSR order is row-major, which supplies the row/input-order
// tiebreak.
static bool mb_sort(int64_t nnz, int64_t nrows, int64_t ncols,
                    const int64_t* rowptrs, const int32_t* cols,
                    const float* vals, int64_t cshift, MbSorted& out) {
  int64_t window = int64_t(1) << cshift;
  int64_t rb_count = (nrows + 127) >> 7;
  int64_t cb_count = (ncols + window - 1) >> cshift;
  if (rb_count > 32767 || cb_count > 65535) return false;  // rbcb i32 packing

  std::vector<int32_t> rid(nnz);
  for (int64_t r = 0; r < nrows; ++r)
    for (int64_t i = rowptrs[r]; i < rowptrs[r + 1]; ++i) rid[i] = (int32_t)r;

  // pass 1: stable by cb
  std::vector<int64_t> cnt(std::max(rb_count, cb_count) + 1, 0);
  std::vector<int32_t> rid1(nnz), col1(nnz);
  std::vector<float> val1(nnz);
  for (int64_t i = 0; i < nnz; ++i) cnt[(cols[i] >> cshift) + 1]++;
  for (int64_t b = 0; b < cb_count; ++b) cnt[b + 1] += cnt[b];
  for (int64_t i = 0; i < nnz; ++i) {
    int64_t p = cnt[cols[i] >> cshift]++;
    rid1[p] = rid[i];
    col1[p] = cols[i];
    val1[p] = vals ? vals[i] : 1.0f;
  }

  // pass 2: stable by rb
  std::fill(cnt.begin(), cnt.end(), 0);
  out.rid.resize(nnz);
  out.col.resize(nnz);
  out.val.resize(nnz);
  for (int64_t i = 0; i < nnz; ++i) cnt[(rid1[i] >> 7) + 1]++;
  for (int64_t b = 0; b < rb_count; ++b) cnt[b + 1] += cnt[b];
  for (int64_t i = 0; i < nnz; ++i) {
    int64_t p = cnt[rid1[i] >> 7]++;
    out.rid[p] = rid1[i];
    out.col[p] = col1[i];
    out.val[p] = val1[i];
  }
  return true;
}

// Walk (rb, cb) groups in sorted order.  Calls group_fn(start, size, rb)
// for each group and returns total micro-rows incl. per-stripe padding.
// pad_mult is the stripe padding multiple (a power of two): the SpMV
// kernel accumulates pad_mult micro-rows per output read-modify-write, so
// every aligned pad_mult-row group must share one row window.
// pair (a power of two dividing pad_mult) pads every GROUP's micro-row
// count to a multiple of pair, so aligned pair-length micro-row runs share
// one column window: the SpMV build loop then issues one operand address
// per pair instead of one per micro-row (the scalar core is the build
// loop's bottleneck; measured -21%/step at pair=2 on v5e).
template <typename F>
static int64_t mb_walk(int64_t nnz, const MbSorted& s, int64_t cshift,
                       int64_t pad_mult, int64_t pair, F&& group_fn) {
  const int64_t pmask = pad_mult - 1;
  const int64_t gmask = pair - 1;
  int64_t m = 0;
  int64_t i = 0;
  int32_t cur_rb = -1;
  while (i < nnz) {
    int32_t rb = s.rid[i] >> 7, cb = s.col[i] >> cshift;
    if (rb != cur_rb) {
      m = (m + pmask) & ~pmask;  // close previous stripe
      cur_rb = rb;
    }
    int64_t j = i;
    while (j < nnz && (s.rid[j] >> 7) == rb && (s.col[j] >> cshift) == cb) ++j;
    group_fn(i, j - i, m);
    m += (mb_mrs(j - i) + gmask) & ~gmask;
    i = j;
  }
  return (m + pmask) & ~pmask;
}

}  // namespace

extern "C" int64_t csrt_mb_plan(int64_t nnz, int64_t nrows, int64_t ncols,
                                const int64_t* rowptrs, const int32_t* cols,
                                int64_t cshift, int64_t pad_mult,
                                int64_t pair) {
  MbSorted s;
  if (!mb_sort(nnz, nrows, ncols, rowptrs, cols, nullptr, cshift, s)) return -1;
  return mb_walk(nnz, s, cshift, pad_mult, pair,
                 [](int64_t, int64_t, int64_t) {});
}

// Plan for pair = 1, 2 and 4 in one sort+walk (for the layout chooser).
// Writes the three micro-row totals to out3; returns 0, or -1 when the
// matrix exceeds the rbcb packing range.
extern "C" int64_t csrt_mb_plan3(int64_t nnz, int64_t nrows, int64_t ncols,
                                 const int64_t* rowptrs, const int32_t* cols,
                                 int64_t cshift, int64_t pad_mult,
                                 int64_t* out3) {
  MbSorted s;
  if (!mb_sort(nnz, nrows, ncols, rowptrs, cols, nullptr, cshift, s)) return -1;
  const int64_t pmask = pad_mult - 1;
  int64_t m[3] = {0, 0, 0};
  int64_t i = 0;
  int32_t cur_rb = -1;
  while (i < nnz) {
    int32_t rb = s.rid[i] >> 7, cb = s.col[i] >> cshift;
    if (rb != cur_rb) {
      for (int k = 0; k < 3; ++k) m[k] = (m[k] + pmask) & ~pmask;
      cur_rb = rb;
    }
    int64_t j = i;
    while (j < nnz && (s.rid[j] >> 7) == rb && (s.col[j] >> cshift) == cb) ++j;
    int64_t mrs = mb_mrs(j - i);
    m[0] += mrs;
    m[1] += (mrs + 1) & ~int64_t(1);
    m[2] += (mrs + 3) & ~int64_t(3);
    i = j;
  }
  for (int k = 0; k < 3; ++k) out3[k] = (m[k] + pmask) & ~pmask;
  return 0;
}

extern "C" int64_t csrt_mb_fill(int64_t nnz, int64_t nrows, int64_t ncols,
                                const int64_t* rowptrs, const int32_t* cols,
                                const float* vals, int64_t cshift,
                                int64_t pad_mult, int64_t pair,
                                int64_t m_pad, float* out_vals,
                                uint16_t* out_meta, int32_t* out_rbcb) {
  MbSorted s;
  if (!mb_sort(nnz, nrows, ncols, rowptrs, cols, vals, cshift, s)) return -1;
  const int32_t lo_mask = (int32_t(1) << cshift) - 1;
  const int e_shift = (cshift == 7) ? 7 : 8;
  const int64_t gmask = pair - 1;

  // caller supplies zeroed arrays of m_pad micro-rows.  Group-padding
  // micro-rows (up to the pair multiple) carry the group's (rb, cb) so the
  // pair-uniform-cb invariant holds; their values/meta stay zero.
  int64_t m = mb_walk(nnz, s, cshift, pad_mult, pair,
                      [&](int64_t start, int64_t size, int64_t mr0) {
    int32_t rb = s.rid[start] >> 7, cb = s.col[start] >> cshift;
    int64_t mrs = mb_mrs(size);
    int64_t mrs_pad = (mrs + gmask) & ~gmask;
    for (int64_t k = 0; k < mrs_pad; ++k) out_rbcb[mr0 + k] = (rb << 16) | cb;
    for (int64_t k = 0; k < mrs; ++k) {
      int64_t mr = mr0 + k;
      int64_t lim = std::min<int64_t>(MB_SLOT_CAP, size - k * MB_SLOT_CAP);
      int32_t cnt[128] = {0};
      const int64_t base = start + k * MB_SLOT_CAP;
      for (int64_t t = 0; t < lim; ++t) {
        out_vals[mr * 128 + t] = s.val[base + t];
        out_meta[mr * 128 + t] = (uint16_t)(s.col[base + t] & lo_mask);
        cnt[s.rid[base + t] & 127]++;
      }
      int32_t run = 0;
      for (int64_t r = 0; r < 128; ++r) {
        run += cnt[r];
        out_meta[mr * 128 + r] |= (uint16_t)(run << e_shift);
      }
    }
  });

  // stripe-padding micro-rows carry their stripe's rb (value/meta zero,
  // cb zero — safe: stripe pads start pair-aligned because group counts
  // are pair multiples and pad_mult is a multiple of pair); walk again to
  // stamp rbcb on the gaps, then extend the final rb to m_pad
  int64_t cursor = 0;
  int32_t last_rb = 0;
  mb_walk(nnz, s, cshift, pad_mult, pair,
          [&](int64_t start, int64_t size, int64_t mr0) {
    int32_t rb = s.rid[start] >> 7;
    for (; cursor < mr0; ++cursor) out_rbcb[cursor] = last_rb << 16;
    cursor = mr0 + ((mb_mrs(size) + gmask) & ~gmask);
    last_rb = rb;
  });
  for (; cursor < m_pad; ++cursor) out_rbcb[cursor] = last_rb << 16;
  return m;
}
