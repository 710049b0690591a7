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
// What bounds it on this card: the gather of B's rows.  Every entry reads
// one row of B, n floats, so the kernel moves nnz * n * 4 B, nearly all of
// it from L2 (a row of B is read again by entries of other groups, almost
// never by the same block); the layout is 12 B an entry beside it and C
// takes one add per row, column and group.  One FMA goes with every 4 B,
// so the kernel lives on how many loads of B the card keeps in flight and
// on how few instructions go with each.  Which rows of B the blocks in
// flight touch at once matters too: in the packer's order (row window after
// row window) a window of many groups sweeps its groups over all of B's
// rows, so where B passes L2 each window reads most of B again from device
// memory, and those groups add into the same 128 rows of C.  So the blocks
// take the groups in the layout's `order`, sorted by the column window of
// their first micro-row (ops/microblock.py:group_order): the blocks in
// flight come from every row window but share one narrow slab of B's rows,
// which stays in L2, and their adds spread over C.  What the design does
// about the gather:
//   * a block takes one aligned group of 32 micro-rows (one rb: 128 output
//     rows, at most 4064 entries) and regroups it once, in shared memory,
//     into a CSR of the group: a count of entries a window row (summed over
//     the micro-rows from epos), an exclusive prefix, and a scatter of every
//     real slot's (row of B, value) pair, 8 B, into its row's run.  The
//     decode is paid once a block, not once a thread and a column tile.
//     Slots at or past a micro-row's entry count are never scattered, so
//     padding loads no B and 0 * inf never forms;
//   * then a warp owns whole output rows, handed out by a counter in shared
//     memory (rows differ in length).  Its lanes own 4 consecutive columns
//     each, one 16 B load of a row of B; it walks the row's run in one
//     uniform loop with kUnroll loads in flight, one 8 B broadcast read of
//     shared memory per load, and keeps the sums in registers: no shared
//     accumulator, no branch on row changes.  That leaves a block at 41 KB
//     of shared memory whatever its width, so five blocks of eight warps
//     fit an SM;
//   * a row of B narrower than a warp's 512 B is shared out: 16 or 8 lanes
//     take a row, and the warp's 2 or 4 sub-warps take consecutive entries
//     of the same output row and are summed by shuffles at the row's end;
//   * the wrapper hands over a B whose row stride is a multiple of 4 floats
//     and 16 B aligned (a padded copy where it has to), so every load is
//     16 B and there is one lane mapping, not one for each alignment;
//   * C takes one vector atomicAdd (16, 8 or 4 B, as C's stride allows) per
//     row, lane and group; a row without entries in the group adds nothing;
//   * column tiles (lanes * columns a lane wide) are a loop inside the
//     block over the entries it already holds.  gridDim.y splits the tiles
//     into chunks; blocks start chunk by chunk, so those in flight
//     share a few slabs of B's and C's columns, which the wrapper sizes to
//     L2 (a matrix of few groups has several chunks in flight at once).
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py, PERF.md): 48
// registers, no spills, 41,912 B of shared memory, five blocks an SM; the
// gather runs at 7.9 TB/s on a 32768^2 matrix of 327 entries a row times a
// 256-wide B and at 6.3 TB/s on 25M ratings times a 50-wide B, which is
// L2's rate, not device memory's.  A block waits 3% to 13% of the kernel's
// time for its regrouping; staging the next group behind the gathers was
// not built.  The block's group is order[blockIdx.x], one 4 B load a block
// (still 48 registers).  At the Netflix Prize's ratings times a 50-wide B,
// Rt . P (B 96 MB, up to 282 groups a row window) gathers at 3.8 TB/s in
// the packer's order and at 7.2 TB/s in column order, R . Q's rate with
// its B in L2.
// Results are not repeatable bit for bit in general: a row window whose
// entries span several groups (more than 32 micro-rows) takes its groups'
// atomic adds in an order that varies.  Within a group the order of sums is
// fixed, so a matrix whose every row window fits one group repeats exactly.
// `pair` only pads the layout and needs no code here.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLane = 128;                 // slots (and window rows) per micro-row
constexpr int kAccGroup = 32;              // micro-rows sharing one rb
constexpr int kSlots = kLane * kAccGroup;  // slots in one group
constexpr int kMaxEntries = 127 * kAccGroup;  // slot 127 is always padding
constexpr int kThreads = 256;   // a multiple of 128
constexpr int kMinBlocks = 5;   // blocks an SM the register budget allows for
constexpr int kWarps = kThreads / 32;
constexpr int kParts = kThreads / kLane;  // threads per window row in the regrouping
constexpr int kUnroll = 4;  // loads of B in flight per lane
constexpr int kVec = 4;  // columns a lane: one 16 B load of a row of B
constexpr int64_t kMaxGridY = 65535;
static_assert(kThreads % kLane == 0 && kThreads <= 1024, "kThreads");
// the regrouping stages 2 B a slot where the entries will go
static_assert(sizeof(int2) * kMaxEntries >= 2 * kSlots, "staging room");

__device__ __forceinline__ void fma4(float (&acc)[4], float v, const float4& b) {
  acc[0] = fmaf(v, b.x, acc[0]);
  acc[1] = fmaf(v, b.y, acc[1]);
  acc[2] = fmaf(v, b.z, acc[2]);
  acc[3] = fmaf(v, b.w, acc[3]);
}

// the group as a CSR over its 128 window rows
struct Group {
  int2 ent[kMaxEntries];         // (row of B, value bits), row after row
  uint16_t dst[kSlots];          // slot -> position in ent
  int rowoff[kLane + 1];         // row r holds ent[rowoff[r] .. rowoff[r+1])
  int colbase[kAccGroup];        // cb * win of each micro-row
  uint16_t part[kParts][kLane];  // entries of row r in the micro-rows of part h
  uint8_t count[kAccGroup];      // entries of each micro-row
  int warp_sum[kLane / 32];
  int next;                      // the next (tile, row) to hand to a warp
};

// one group's slots regrouped by window row, into shared memory.  Every
// thread loads its share of the group's values and metadata (16 and 8 B a
// step) before anything else and keeps it in registers for the scatter; the
// metadata is staged, for the counts, where the entries will go.
__device__ __forceinline__ void regroup(Group& g, const float* __restrict__ gv,
                                        const uint16_t* __restrict__ gm,
                                        const int32_t* __restrict__ grbcb,
                                        int shift) {
  constexpr int kQuads = kSlots / 4;
  constexpr int kSteps = (kQuads + kThreads - 1) / kThreads;
  const int t = threadIdx.x;
  const int r = t & (kLane - 1), h = t >> 7;
  const int k0 = h * kAccGroup / kParts, k1 = (h + 1) * kAccGroup / kParts;
  const int lo_mask = (1 << shift) - 1;
  uint16_t* smeta = reinterpret_cast<uint16_t*>(g.ent);

  uint2 m4[kSteps];
  float4 v4[kSteps];
#pragma unroll
  for (int i = 0; i < kSteps; ++i) {
    const int q = t + i * kThreads;
    if (kQuads % kThreads == 0 || q < kQuads) {
      m4[i] = __ldg(reinterpret_cast<const uint2*>(gm) + q);
      v4[i] = __ldg(reinterpret_cast<const float4*>(gv) + q);
    }
  }
  if (t < kAccGroup) g.colbase[t] = (grbcb[t] & 0xffff) << shift;
  if (t == 0) g.next = kWarps;
#pragma unroll
  for (int i = 0; i < kSteps; ++i) {
    const int q = t + i * kThreads;
    if (kQuads % kThreads == 0 || q < kQuads)
      reinterpret_cast<uint2*>(smeta)[q] = m4[i];
  }
  __syncthreads();

  // entries of window row r in this part's micro-rows
  int cnt = 0;
  for (int k = k0; k < k1; ++k) {
    const int e = (smeta[k * kLane + r] >> shift) & 127;
    const int ep = r ? (smeta[k * kLane + r - 1] >> shift) & 127 : 0;
    cnt += e - ep;
    if (r == kLane - 1) g.count[k] = static_cast<uint8_t>(e);
  }
  g.part[h][r] = static_cast<uint16_t>(cnt);
  __syncthreads();

  // exclusive prefix over the 128 rows
  int incl = 0;
  if (t < kLane) {
#pragma unroll
    for (int p = 0; p < kParts; ++p) incl += g.part[p][t];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, incl, o);
      if ((t & 31) >= o) incl += up;
    }
    if ((t & 31) == 31) g.warp_sum[t >> 5] = incl;
  }
  __syncthreads();
  if (t < kLane) {
    for (int w = 0; w < (t >> 5); ++w) incl += g.warp_sum[w];
    g.rowoff[t + 1] = incl;
    if (t == 0) g.rowoff[0] = 0;
  }
  __syncthreads();

  // where each real slot goes: row r's run takes its slots micro-row by
  // micro-row, in slot order
  int pos = g.rowoff[r];
  for (int p = 0; p < h; ++p) pos += g.part[p][r];
  for (int k = k0; k < k1; ++k) {
    const int e = (smeta[k * kLane + r] >> shift) & 127;
    const int ep = r ? (smeta[k * kLane + r - 1] >> shift) & 127 : 0;
    for (int s = ep; s < e; ++s) g.dst[k * kLane + s] = static_cast<uint16_t>(pos++);
  }
  __syncthreads();  // the staged metadata is read; the entries take its place

  // scatter from the registers, 4 slots a step
#pragma unroll
  for (int i = 0; i < kSteps; ++i) {
    const int q = t + i * kThreads;
    if (kQuads % kThreads != 0 && q >= kQuads) break;
    const int k = q >> 5, s0 = (q & 31) * 4, nk = g.count[k];
    if (s0 >= nk) continue;
    const uint2 d4 = reinterpret_cast<const uint2*>(g.dst)[q];
    const unsigned m[4] = {m4[i].x & 0xffffu, m4[i].x >> 16, m4[i].y & 0xffffu,
                           m4[i].y >> 16};
    const unsigned d[4] = {d4.x & 0xffffu, d4.x >> 16, d4.y & 0xffffu, d4.y >> 16};
    const float v[4] = {v4[i].x, v4[i].y, v4[i].z, v4[i].w};
    const int base = g.colbase[k];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (s0 + j < nk)
        g.ent[d[j]] = make_int2(base + static_cast<int>(m[j] & lo_mask),
                                __float_as_int(v[j]));
  }
  __syncthreads();
}

// acc (the lane's 4 columns) added into a row of C: vc floats an atomic,
// as C's stride allows; columns at or past n (`left` columns remain) are
// left out, and zero sums add nothing
__device__ __forceinline__ void add_to_c(float* dst, const float (&acc)[kVec],
                                         int vc, int64_t left) {
  if (vc == 4 && left >= 4) {
    if (acc[0] != 0.f || acc[1] != 0.f || acc[2] != 0.f || acc[3] != 0.f)
      atomicAdd(reinterpret_cast<float4*>(dst),
                make_float4(acc[0], acc[1], acc[2], acc[3]));
    return;
  }
#pragma unroll
  for (int i = 0; i < kVec; i += 2) {
    if (vc >= 2 && i + 1 < left) {
      if (acc[i] != 0.f || acc[i + 1] != 0.f)
        atomicAdd(reinterpret_cast<float2*>(dst + i),
                  make_float2(acc[i], acc[i + 1]));
    } else {
      if (i < left && acc[i] != 0.f) atomicAdd(dst + i, acc[i]);
      if (i + 1 < left && acc[i + 1] != 0.f) atomicAdd(dst + i + 1, acc[i + 1]);
    }
  }
}

// LANES lanes on one row of B, 32 / LANES entries of an output row a
// warp-step; B's rows are ldb floats apart, a multiple of 4, 16 B aligned
template <int LANES>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
spmm_microblock_kernel(const float* __restrict__ vals,
                       const uint16_t* __restrict__ meta,
                       const int32_t* __restrict__ rbcb,
                       const int32_t* __restrict__ order,
                       const float* __restrict__ b, float* __restrict__ c,
                       int shift, int nrows, int64_t n, unsigned ldb,
                       int64_t ldc, int vc, int n_tiles, int tiles_per_chunk) {
  constexpr int E = 32 / LANES;  // sub-warps, one entry each a step
  __shared__ Group g;
  const int group = order ? __ldg(order + blockIdx.x) : int(blockIdx.x);
  const int64_t mr0 = int64_t(group) * kAccGroup;
  regroup(g, vals + mr0 * kLane, meta + mr0 * kLane, rbcb + mr0, shift);

  const int lane = threadIdx.x & 31;
  const int sub = lane / LANES, sl = lane % LANES;
  const int64_t row0 = int64_t(rbcb[mr0] >> 16) * kLane;
  const int tile0 = blockIdx.y * tiles_per_chunk;
  const int tiles = min(tiles_per_chunk, n_tiles - tile0);
  const int items = tiles * kLane;  // (tile, row) pairs, rows fastest

  int item = threadIdx.x >> 5;
  while (item < items) {
    int next = 0;
    if (lane == 0) next = atomicAdd(&g.next, 1);
    const int r = item & (kLane - 1);
    const int beg = g.rowoff[r], end = g.rowoff[r + 1];
    if (beg < end) {
      const int64_t col = (int64_t(tile0 + (item >> 7)) * LANES + sl) * kVec;
      const bool active = col < ldb;
      float acc[kVec] = {};
      if (active) {
        const float* bcol = b + col;
        int i = beg + sub;
        for (; i + (kUnroll - 1) * E < end; i += kUnroll * E) {
          int2 e[kUnroll];
          float4 bv[kUnroll];
#pragma unroll
          for (int j = 0; j < kUnroll; ++j) {
            e[j] = g.ent[i + j * E];
            bv[j] = __ldg(reinterpret_cast<const float4*>(
                bcol + uint64_t(unsigned(e[j].x)) * ldb));
          }
#pragma unroll
          for (int j = 0; j < kUnroll; ++j) fma4(acc, __int_as_float(e[j].y), bv[j]);
        }
        if (i < end) {  // the ragged last batch
          int2 e[kUnroll];
          float4 bv[kUnroll];
#pragma unroll
          for (int j = 0; j < kUnroll; ++j) {
            if (i + j * E < end) {
              e[j] = g.ent[i + j * E];
              bv[j] = __ldg(reinterpret_cast<const float4*>(
                  bcol + uint64_t(unsigned(e[j].x)) * ldb));
            } else {
              e[j] = make_int2(0, 0);
              bv[j] = make_float4(0.f, 0.f, 0.f, 0.f);
            }
          }
#pragma unroll
          for (int j = 0; j < kUnroll; ++j) fma4(acc, __int_as_float(e[j].y), bv[j]);
        }
      }
#pragma unroll
      for (int o = LANES; o < 32; o <<= 1)
#pragma unroll
        for (int x = 0; x < kVec; ++x)
          acc[x] += __shfl_xor_sync(0xffffffffu, acc[x], o);
      if (active && sub == 0 && row0 + r < nrows)
        add_to_c(c + (row0 + r) * ldc + col, acc, vc, n - col);
    }
    item = __shfl_sync(0xffffffffu, next, 0);
  }
}

template <int LANES>
int launch(const float* vals, const uint16_t* meta, const int32_t* rbcb,
           const int32_t* order, const float* b, float* c, int64_t n_groups,
           int shift, int nrows, int64_t n, int64_t ldb, int64_t ldc, int vc,
           int64_t per_chunk, cudaStream_t stream) {
  const int64_t tile = int64_t(LANES) * kVec;
  const int64_t n_tiles = (ldb + tile - 1) / tile;
  if (per_chunk < 1 || per_chunk > n_tiles || n_tiles > 0x7fffffff / kLane)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t chunks = (n_tiles + per_chunk - 1) / per_chunk;
  if (chunks > kMaxGridY) return static_cast<int>(cudaErrorInvalidValue);
  // five blocks of 41 KB an SM need most of its 256 KB as shared memory
  const cudaError_t err = cudaFuncSetAttribute(
      spmm_microblock_kernel<LANES>,
      cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(n_groups), static_cast<unsigned>(chunks));
  spmm_microblock_kernel<LANES><<<grid, kThreads, 0, stream>>>(
      vals, meta, rbcb, order, b, c, shift, nrows, n,
      static_cast<unsigned>(ldb), ldc, vc, static_cast<int>(n_tiles),
      static_cast<int>(per_chunk));
  return 0;
}

}  // namespace

// C += A @ B over the first n_groups * 32 micro-rows of the layout, block x
// taking group order[x] where `order` (n_groups int32, a permutation of the
// groups) is given, else group x.  B holds ldb >= n floats a row, a
// multiple of 4, and is 16 B aligned; C holds
// ldc >= n floats a row; both row-major, and only the first n columns of
// either count.  All pointers are device pointers: vals 16 B aligned, meta
// 8 B aligned, C zeroed by the caller.  shift is 7 for 128-wide windows, 8
// for 256.  The launch plan is the caller's
// (csr_tpu_torch/ops/spmm.py:launch_plan): `lanes` lanes on a row of B (32,
// 16 or 8), so a column tile is 4 * lanes wide, and `tiles_per_chunk` tiles
// a block; the tiles' count and the blocks a group follow from these here.
// Launches on `stream` and returns the CUDA error code (0 on success).
extern "C" int csrt_spmm_microblock(const void* vals, const void* meta,
                                    const void* rbcb, const void* order,
                                    const void* b, void* c,
                                    int64_t n_groups, int shift, int nrows,
                                    int64_t n, int64_t ldb, int64_t ldc,
                                    int lanes, int64_t tiles_per_chunk,
                                    void* stream) {
  const auto b_addr = reinterpret_cast<uintptr_t>(b);
  const auto c_addr = reinterpret_cast<uintptr_t>(c);
  if (n_groups > 0x7fffffff || n < 0 || ldb < n || ldc < n ||
      ldb > 0x7fffffff || ldb % kVec != 0 || b_addr % 16 != 0 || c_addr % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_groups > 0 && n > 0) {
    const auto* v = static_cast<const float*>(vals);
    const auto* m = static_cast<const uint16_t*>(meta);
    const auto* rc = static_cast<const int32_t*>(rbcb);
    const auto* od = static_cast<const int32_t*>(order);
    const auto* bf = static_cast<const float*>(b);
    auto* cf = static_cast<float*>(c);
    auto* s = static_cast<cudaStream_t>(stream);
    // floats an atomic into C, as its stride and pointer allow
    const int vc = ldc % 4 == 0 && c_addr % 16 == 0   ? 4
                   : ldc % 2 == 0 && c_addr % 8 == 0 ? 2
                                                     : 1;
    const int rc_launch =
        lanes == 32   ? launch<32>(v, m, rc, od, bf, cf, n_groups, shift, nrows,
                                   n, ldb, ldc, vc, tiles_per_chunk, s)
        : lanes == 16 ? launch<16>(v, m, rc, od, bf, cf, n_groups, shift, nrows,
                                   n, ldb, ldc, vc, tiles_per_chunk, s)
        : lanes == 8  ? launch<8>(v, m, rc, od, bf, cf, n_groups, shift, nrows,
                                  n, ldb, ldc, vc, tiles_per_chunk, s)
                      : static_cast<int>(cudaErrorInvalidValue);
    if (rc_launch != 0) return rc_launch;
  }
  return static_cast<int>(cudaGetLastError());
}
