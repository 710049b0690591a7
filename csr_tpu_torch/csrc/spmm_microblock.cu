// Micro-block SpMM, C += A @ B with dense row-major B and C, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel csr_tpu/ops/spmm.py:_spmm_kernel (and its
// launcher _spmm_call).  It reads the same layout as the SpMV kernel, byte
// for byte (csr_tpu_torch/ops/microblock.py): per micro-row m, vals[m, 128]
// f32, meta[m, 128] u16 = lo | epos << shift, rbcb[m] = rb << 16 | cb.  For
// every stored entry it adds vals[m, s] * B[cb * win + lo[m, s], :] into
// C[rb * 128 + row(s), :], where row r of the micro-row's window holds the
// slots [epos[r-1], epos[r]) and the entry count is epos of slot 127.
//
// What bounds it on this card: reads of B.  Every entry reads one row of
// B, n floats, so the kernel moves nnz * n * 4 B, mostly from L2 (B is
// re-read by entries of many micro-rows); the layout is read once per
// column tile, and C takes one atomic add per row, column and group.  The
// arithmetic is one FMA per 4 B read, so the kernel lives on how many
// loads of B it keeps in flight.  What the design does about it:
//   * B and C stay row-major: the threads of a block own consecutive
//     columns, 1, 2 or 4 each (as n and B's alignment allow, with one
//     4, 8 or 16 B load per row of B), so a warp reads a row of B in one
//     coalesced request.  The TPU kernel held B and C transposed, gathered
//     along lanes and took the row sums as a triangular prefix matmul and
//     a deferred lane-roll difference, because the TPU gathers only along
//     128 lanes; none of that is needed here;
//   * a block owns one aligned group of 32 micro-rows (one rb, which the
//     layout guarantees) and a tile of columns.  It stages the group's
//     metadata in shared memory (coalesced 8 B loads) and builds each
//     micro-row's slot -> row map from epos.  Values are read through L1;
//   * the group's 128 window rows are taken in 4 passes of 32 rows.  Slots
//     are sorted by row, so a pass walks one contiguous slot range of each
//     micro-row.  Each thread walks its columns' entries with 8 loads of B
//     in flight and sums each row's run in registers: direct f32 sums, no
//     prefix difference.  A run ends in a shared tile of the pass's 32
//     rows, in which each thread owns its columns, so the walk needs no
//     barrier.  The tile is a quarter of the 128 rows, so four times as
//     many columns (and loads of B) fit on an SM;
//   * slots outside the pass's ranges are never visited: slots at or past
//     the entry count load nothing, so 0 * inf never forms;
//   * at the end of a pass each thread adds its nonzero tile entries to C
//     with one atomicAdd each.  The order of those adds varies, so results
//     are not bitwise deterministic;
//   * column tiles run along gridDim.y (at most 65535, the rest by a
//     stride loop), so the blocks in flight share one column slab of B.
// `pair` only pads the layout and needs no code here.  TMA, wgmma and a
// deterministic reduction are for later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLane = 128;                 // slots (and window rows) per micro-row
constexpr int kAccGroup = 32;              // micro-rows sharing one rb
constexpr int kSlots = kLane * kAccGroup;  // slots in one group
constexpr int kPassRows = 32;              // window rows accumulated per pass
constexpr int kMaxThreads = 128;
constexpr int kUnroll = 8;                 // loads of B in flight per thread
constexpr int64_t kMaxGridY = 65535;

template <int V> struct Vec;
template <> struct Vec<1> { using T = float; };
template <> struct Vec<2> { using T = float2; };
template <> struct Vec<4> { using T = float4; };

template <int V>
__device__ __forceinline__ void flush(typename Vec<V>::T* dst, float (&acc)[V]) {
  typename Vec<V>::T x = *dst;
  float* xf = reinterpret_cast<float*>(&x);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    xf[i] += acc[i];
    acc[i] = 0.f;
  }
  *dst = x;
}

// V columns per thread: B and the pointer b + col are V * 4 B aligned
template <int V>
__global__ void __launch_bounds__(kMaxThreads)
spmm_microblock_kernel(const float* __restrict__ vals,
                       const uint16_t* __restrict__ meta,
                       const int32_t* __restrict__ rbcb,
                       const float* __restrict__ b, float* __restrict__ c,
                       int shift, int nrows, int64_t n, int64_t n_tiles) {
  using VT = typename Vec<V>::T;
  __shared__ __align__(16) uint16_t smeta[kSlots];
  __shared__ uint8_t srow[kSlots];
  extern __shared__ __align__(16) unsigned char smem[];
  const int tn = blockDim.x;
  const int tid = threadIdx.x;
  VT* mine = reinterpret_cast<VT*>(smem) + tid;  // tile row r: mine[r * tn]
  const int64_t mr0 = int64_t(blockIdx.x) * kAccGroup;
  const float* gvals = vals + mr0 * kLane;
  const int lo_mask = (1 << shift) - 1;

  // stage the group's metadata: 4 slots per thread per step
  const uint2* m4 = reinterpret_cast<const uint2*>(meta + mr0 * kLane);
  for (int i = tid; i < kSlots / 4; i += tn)
    reinterpret_cast<uint2*>(smeta)[i] = m4[i];
  __syncthreads();
  // slot -> row: row r of a micro-row holds slots [epos[r-1], epos[r])
  for (int i = tid; i < kSlots; i += tn) {
    const int r = i & (kLane - 1);
    const int e = (smeta[i] >> shift) & 127;
    const int ep = r ? (smeta[i - 1] >> shift) & 127 : 0;
    uint8_t* row = srow + (i - r);
    for (int s = ep; s < e; ++s) row[s] = static_cast<uint8_t>(r);
  }
  __syncthreads();

  const int row0 = (rbcb[mr0] >> 16) * kLane;
  for (int64_t t = blockIdx.y; t < n_tiles; t += gridDim.y) {
    const int64_t col = (t * tn + tid) * V;
    if (col >= n) break;  // no barrier follows
    const float* bcol = b + col;
    for (int r0 = 0; r0 < kLane; r0 += kPassRows) {
      for (int r = 0; r < kPassRows; ++r) mine[r * tn] = VT{};
      for (int k = 0; k < kAccGroup; ++k) {
        const uint16_t* mk = smeta + k * kLane;
        const int end = (mk[r0 + kPassRows - 1] >> shift) & 127;
        const int begin = r0 ? (mk[r0 - 1] >> shift) & 127 : 0;
        if (begin == end) continue;  // no entry of these rows (or padding)
        const float* bw =
            bcol + (int64_t(rbcb[mr0 + k] & 0xffff) << shift) * n;
        const float* vk = gvals + k * kLane;
        const uint8_t* rk = srow + k * kLane;
        int cur = rk[begin];
        float acc[V] = {};
        for (int s0 = begin; s0 < end; s0 += kUnroll) {
          VT bv[kUnroll];
          float vv[kUnroll];
#pragma unroll
          for (int j = 0; j < kUnroll; ++j) {
            const int s = s0 + j;
            if (s < end) {
              bv[j] = __ldg(reinterpret_cast<const VT*>(
                  bw + int64_t(mk[s] & lo_mask) * n));
              vv[j] = __ldg(vk + s);
            } else {
              bv[j] = VT{};
              vv[j] = 0.f;
            }
          }
#pragma unroll
          for (int j = 0; j < kUnroll; ++j) {
            const int s = s0 + j;
            if (s < end) {
              const int r = rk[s];
              if (r != cur) {
                flush<V>(mine + (cur - r0) * tn, acc);
                cur = r;
              }
              const float* bf = reinterpret_cast<const float*>(&bv[j]);
#pragma unroll
              for (int i = 0; i < V; ++i) acc[i] = fmaf(vv[j], bf[i], acc[i]);
            }
          }
        }
        flush<V>(mine + (cur - r0) * tn, acc);
      }
      for (int r = 0; r < kPassRows; ++r) {
        const int row = row0 + r0 + r;
        if (row >= nrows) break;
        const VT x = mine[r * tn];
        const float* xf = reinterpret_cast<const float*>(&x);
        float* dst = c + int64_t(row) * n + col;
#pragma unroll
        for (int i = 0; i < V; ++i)
          if (xf[i] != 0.f) atomicAdd(dst + i, xf[i]);
      }
    }
  }
}

template <int V>
int launch(const float* vals, const uint16_t* meta, const int32_t* rbcb,
           const float* b, float* c, int64_t n_groups, int shift, int nrows,
           int64_t n, cudaStream_t stream) {
  const int64_t per_thread = n / V;
  const int tn = per_thread < kMaxThreads
                     ? static_cast<int>((per_thread + 31) / 32 * 32)
                     : kMaxThreads;
  const int64_t n_tiles = (per_thread + tn - 1) / tn;
  const size_t tile = sizeof(float) * kPassRows * tn * V;
  // above 48 KB a block must be allowed its dynamic shared memory (on
  // the current device, so set before every launch)
  const cudaError_t err = cudaFuncSetAttribute(
      spmm_microblock_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sizeof(float) * kPassRows * kMaxThreads * V));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(n_groups),
                  static_cast<unsigned>(n_tiles < kMaxGridY ? n_tiles
                                                            : kMaxGridY));
  spmm_microblock_kernel<V><<<grid, tn, tile, stream>>>(
      vals, meta, rbcb, b, c, shift, nrows, n, n_tiles);
  return 0;
}

}  // namespace

// C += A @ B over the first n_groups * 32 micro-rows of the layout, with B
// (ncols, n) and C (nrows, n) row-major and contiguous.  All pointers are
// device pointers: vals 16 B aligned, meta 8 B aligned, C zeroed by the
// caller.  shift is 7 for 128-wide windows, 8 for 256.  Launches on
// `stream` and returns the CUDA error code (0 on success).
extern "C" int csrt_spmm_microblock(const void* vals, const void* meta,
                                    const void* rbcb, const void* b, void* c,
                                    int64_t n_groups, int shift, int nrows,
                                    int64_t n, void* stream) {
  if (n_groups > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  if (n_groups > 0 && n > 0) {
    const auto* v = static_cast<const float*>(vals);
    const auto* m = static_cast<const uint16_t*>(meta);
    const auto* rc = static_cast<const int32_t*>(rbcb);
    const auto* bf = static_cast<const float*>(b);
    auto* cf = static_cast<float*>(c);
    auto* s = static_cast<cudaStream_t>(stream);
    const auto addr = reinterpret_cast<uintptr_t>(b);
    const int rc_launch =
        n % 4 == 0 && addr % 16 == 0
            ? launch<4>(v, m, rc, bf, cf, n_groups, shift, nrows, n, s)
        : n % 2 == 0 && addr % 8 == 0
            ? launch<2>(v, m, rc, bf, cf, n_groups, shift, nrows, n, s)
            : launch<1>(v, m, rc, bf, cf, n_groups, shift, nrows, n, s);
    if (rc_launch != 0) return rc_launch;
  }
  return static_cast<int>(cudaGetLastError());
}
