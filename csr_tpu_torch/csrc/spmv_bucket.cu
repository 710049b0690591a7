// Bucket-selecting micro-block SpMV for Hopper (sm_90a):
//   y[l] += A[l, held[l]] @ x[l]   for every layer l of a stack,
// where A[l, b] is bucket b of layer l in a stack of micro-block layouts
// vals/meta (L, B, M, 128), rbcb (L, B, M), and held (L,) i32 lies in
// device memory.  Per micro-row m: vals[m, 128] f32, meta[m, 128] u16 =
// lo | epos << shift, rbcb[m] = rb << 16 | cb (csr_tpu_torch/ops/
// microblock.py, byte for byte the JAX package's layout).
//
// Replaces the Pallas TPU launcher csr_tpu/ops/spmv.py:_spmv_call_bucket
// (body _spmv_kernel), which the ring schedule
// csr_tpu/parallel/mb_ring.py:spmv_ring_mb runs once per ring step.  On
// the TPU the bucket index rides the scalar-prefetch channel into the
// block index maps, so the pipeline streams only the held bucket's
// blocks.  Here every warp reads held[] from device memory and computes
// its own addresses: the bucket is chosen on the device, with no host
// read of `held` and no copy of the bucket.
//
// What bounds it on this card: bytes, and the chain of latencies of each
// micro-row.  A micro-row is 772 B of layout (512 B of values, 256 B of
// metadata, 4 B of rbcb), read once; x (a column shard, 32-59 KB) is
// gathered through L1; y takes atomic adds.  A ring step reads a few MB
// (one layer, the process form) to a few tens of MB (D layers, the local
// form), a few micro-rows a warp, so the launch must fill the card at
// once, keep bytes in flight, and keep x in L1.  What the design does:
//   * a persistent grid over the real work: one block of kWarps warps an
//     SM (the caller's grid, capped at the stack's layers times its
//     largest group count).  Every warp reads the L counts
//     groups[l, held[l]] into its lanes (so L <= 32); the list of the held
//     buckets' real micro-rows, layer by layer, is dealt out in equal
//     contiguous shares, one a warp.  So the padding groups of a bucket
//     hold no warp, one layer fills the card as well as D do (the process
//     form's launch), no work counter needs resetting between launches,
//     and an SM's warps share one or two layers' x in L1;
//   * each warp streams its share through a ring of kAhead + 1 stages of
//     its own in shared memory by cp.async (16 B a lane: a micro-row's
//     values, metadata and rbcb at once): kAhead micro-rows are in flight
//     while it computes one.  No warp ever waits for another;
//   * the product is exact f32 as in spmv_microblock.cu: a lane takes 4
//     slots of a micro-row (prefix in registers), a warp shuffle scan of
//     the lane totals, whose prefixes take the place of the values in the
//     stage, and row r of the window gets P[epos[r]] - P[epos[r-1]];
//     padding micro-rows and slots read no x.  A lane sums its 4 rows of
//     the window in registers over the consecutive micro-rows of one row
//     window and adds them to y when the window or the layer changes: one
//     16 B atomic add a lane where y's rows allow it, else one per nonzero
//     row (so results are not bitwise repeatable);
//   * y is added to, so the ring's accumulator is y itself across the D
//     steps.  A held index outside [0, B) gives its layer no micro-rows:
//     the wrapper cannot check a device value without a host read.
// kAhead, the warps a block and the blocks an SM were chosen by
// measurement on an H100 (PERF.md, PR 5, with bucket_tune.py), against
// designs that copied only the values of a micro-row's entries once its
// metadata had landed, shared groups among the warps of a team, or staged
// whole groups by bulk copies (cp.async.bulk).

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLane = 128;     // slots per micro-row
constexpr int kAccGroup = 32;  // micro-rows of one group (one rb)
constexpr int kAhead = 1;  // micro-rows between a micro-row's copy and its use
constexpr int kStages = kAhead + 1;  // stages of each warp's ring
constexpr int kWarps = 32;
constexpr int kBlocksPerSm = 1;
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;

// One micro-row: lane j's slots 4j .. 4j+3.  Once a lane has read its
// values, their place takes its four prefixes.
struct Row {
  float4 vals[32];
  uint2 meta[32];
  int32_t rbcb[4];  // [0]; padded to 16 B
};
constexpr uint32_t kMetaAt = offsetof(Row, meta);
constexpr uint32_t kRbcbAt = offsetof(Row, rbcb);
constexpr int kSharedBytes = kWarps * kStages * sizeof(Row);

__device__ __forceinline__ uint32_t smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void copy16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// The work list as one warp holds it, lane l for layer l (at most 32
// layers): the held bucket, its group count (0 when the index is outside
// [0, n_buckets)), and the groups of the layers before.  Two loads a lane
// at the start, then no memory access to find a group's layer.
struct Layers {
  int held = -1;
  int count = 0;
  int before = 0;
  int total = 0;

  __device__ Layers(const int32_t* __restrict__ held_,
                    const int32_t* __restrict__ groups, int n_layers,
                    int n_buckets) {
    const int lane = threadIdx.x & 31;
    if (lane < n_layers) {
      held = __ldg(held_ + lane);
      if (held >= 0 && held < n_buckets)
        count = __ldg(groups + lane * n_buckets + held);
    }
    int incl = count;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += t;
    }
    before = incl - count;
    total = __shfl_sync(kFull, incl, 31);
  }

  // The layer that holds group `item` of the list; every lane of the
  // warp calls it.
  __device__ int layer_of(int item) const {
    return __ffs(__ballot_sync(kFull, item < before + count)) - 1;
  }

  // The place in the stack of micro-row `r` of the list, of layer `layer`.
  __device__ int place(int r, int layer, int n_buckets,
                       int bucket_microrows) const {
    const int bucket = __shfl_sync(kFull, held, layer);
    const int first = __shfl_sync(kFull, before, layer);
    return (layer * n_buckets + bucket) * bucket_microrows + r -
           first * kAccGroup;
  }
};

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
spmv_bucket_kernel(const float4* __restrict__ vals4,
                   const uint4* __restrict__ meta4,
                   const int32_t* __restrict__ rbcb,
                   const int32_t* __restrict__ held,
                   const int32_t* __restrict__ groups, int n_layers,
                   int n_buckets, int bucket_microrows,
                   const float* __restrict__ x, int64_t x_stride,
                   float* __restrict__ y, int64_t y_stride, int shift,
                   int nrows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int lo_mask = (1 << shift) - 1;
  const Layers work(held, groups, n_layers, n_buckets);
  // The list's real micro-rows, in equal contiguous shares a warp: the
  // warps of a block, and of an SM, stay on one layer's x as long as
  // they can.
  const int total = work.total * kAccGroup;
  const int n_warps = gridDim.x * kWarps;
  const int share = (total + n_warps - 1) / n_warps;
  const int begin = (blockIdx.x * kWarps + warp) * share;
  const int end = min(total, begin + share);
  if (begin >= end) return;  // no work for this warp

  Row* ring = reinterpret_cast<Row*>(smem_raw) + warp * kStages;
  const uint32_t ring_at = smem(ring);
  // The copy cursor: the list's micro-row `c_row` is the stack's `c_mr`.
  int c_row = begin, c_mr = 0;
  int s_copy = 0, s_comp = 0;  // the stage each takes next
  auto bump = [](int s) { return s + 1 == kStages ? 0 : s + 1; };
  // Copy the warp's next micro-row into stage s_copy, as one cp.async
  // group (an empty one past the share, so that the wait counts evenly).
  auto copy_next = [&] {
    if (c_row < end) {
      if (c_row == begin || c_row % kAccGroup == 0)  // a group begins
        c_mr = work.place(c_row, work.layer_of(c_row / kAccGroup), n_buckets,
                          bucket_microrows);
      const int mr = c_mr++;
      ++c_row;
      const uint32_t at = ring_at + s_copy * uint32_t(sizeof(Row));
      if (lane < 16)
        copy16(at + kMetaAt + 16 * lane, meta4 + int64_t(mr) * 16 + lane);
      else if (lane == 16)
        copy4(at + kRbcbAt, rbcb + mr);
      copy16(at + 16 * lane, vals4 + int64_t(mr) * 32 + lane);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    s_copy = bump(s_copy);
  };

  for (int q = 0; q < kAhead; ++q) copy_next();

  // lane holds rows 4*lane .. 4*lane+3 of the window `rb` of `layer`;
  // they go to y whenever the window or the layer changes, one atomic add
  // of 16 B a lane where y's rows allow it
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  int layer = -1, rb = -1;
  const float* xl = x;
  auto flush = [&] {
    const int row = rb * kLane + 4 * lane;
    if (rb >= 0 && (a0 != 0.f || a1 != 0.f || a2 != 0.f || a3 != 0.f)) {
      float* dst = y + layer * y_stride + row;
      if (row + 3 < nrows && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
        atomicAdd(reinterpret_cast<float4*>(dst), make_float4(a0, a1, a2, a3));
      } else {
        if (a0 != 0.f && row < nrows) atomicAdd(dst, a0);
        if (a1 != 0.f && row + 1 < nrows) atomicAdd(dst + 1, a1);
        if (a2 != 0.f && row + 2 < nrows) atomicAdd(dst + 2, a2);
        if (a3 != 0.f && row + 3 < nrows) atomicAdd(dst + 3, a3);
      }
    }
    a0 = a1 = a2 = a3 = 0.f;
  };

  for (int r = begin; r < end; ++r) {
    if (r == begin || r % kAccGroup == 0) {  // a group begins
      const int l = work.layer_of(r / kAccGroup);
      if (l != layer) {
        flush();
        layer = l;
        rb = -1;
        xl = x + layer * x_stride;
      }
    }
    // this micro-row has landed (every group but the kAhead - 1 last)
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kAhead - 1) : "memory");
    __syncwarp();
    copy_next();  // into the stage of the micro-row computed last
    Row& st = ring[s_comp];
    s_comp = bump(s_comp);
    const uint2 mt = st.meta[lane];
    const int m0 = mt.x & 0xffff, m1 = mt.x >> 16;
    const int m2 = mt.y & 0xffff, m3 = mt.y >> 16;
    const int e0 = (m0 >> shift) & 127, e1 = (m1 >> shift) & 127;
    const int e2 = (m2 >> shift) & 127, e3 = (m3 >> shift) & 127;
    const int n = __shfl_sync(kFull, e3, 31);  // entries in the micro-row
    if (n > 0) {  // warp-uniform: padding micro-rows load nothing
      const int cell = st.rbcb[0];
      if (cell >> 16 != rb) {
        flush();
        rb = cell >> 16;
      }
      // slots at or past the count are padding: no x read, no 0 * inf
      const float* xw = xl + ((cell & 0xffff) << shift);
      const int s0 = lane * 4;
      float p0 = 0.f, p1 = 0.f, p2 = 0.f, p3 = 0.f;
      if (s0 < n) {
        const float4 v = st.vals[lane];
        p0 = v.x * __ldg(xw + (m0 & lo_mask));
        if (s0 + 1 < n) p1 = v.y * __ldg(xw + (m1 & lo_mask));
        if (s0 + 2 < n) p2 = v.z * __ldg(xw + (m2 & lo_mask));
        if (s0 + 3 < n) p3 = v.w * __ldg(xw + (m3 & lo_mask));
      }
      // P[s] = sum of p over slots < s: lane-local, then across the warp
      const float c0 = p0, c1 = c0 + p1, c2 = c1 + p2, c3 = c2 + p3;
      float inc = c3;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const float t = __shfl_up_sync(kFull, inc, d);
        if (lane >= d) inc += t;
      }
      float excl = __shfl_up_sync(kFull, inc, 1);
      if (lane == 0) excl = 0.f;
      // a lane's prefixes take the place of its own values
      st.vals[lane] = make_float4(excl, excl + c0, excl + c1, excl + c2);
      __syncwarp();
      // row 4*lane+i holds slots [epos[r-1], epos[r]); epos[-1] = 0 and
      // P[0] = 0
      const float* prefix = reinterpret_cast<const float*>(st.vals);
      const float q0 = prefix[e0], q1 = prefix[e1];
      const float q2 = prefix[e2], q3 = prefix[e3];
      int ep = __shfl_up_sync(kFull, e3, 1);
      float qp = __shfl_up_sync(kFull, q3, 1);
      if (lane == 0) ep = 0, qp = 0.f;
      if (e0 != ep) a0 += q0 - qp;
      if (e1 != e0) a1 += q1 - q0;
      if (e2 != e1) a2 += q2 - q1;
      if (e3 != e2) a3 += q3 - q2;
    }
    __syncwarp();  // the stage is free again
  }
  flush();
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// A block may take more than the 48 KB of shared memory a launch gets
// unasked; say so once, before the first launch.
cudaError_t allow_shared_memory() {
  return cudaFuncSetAttribute(spmv_bucket_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kSharedBytes);
}

}  // namespace

// For l in [0, n_layers), n_layers <= 32: y[l * y_stride ..] += A[l, held[l]] @
// x[l * x_stride ..], over the first groups[l, held[l]] groups of 32
// micro-rows of that bucket, on a grid of `grid` blocks (the caller's: one
// an SM, capped at the work there can be).  All pointers are device
// pointers: vals and meta 16 B aligned, rbcb 4 B, bucket_microrows (M) a
// multiple of 32, strides in elements; the stack holds fewer than 2^31
// micro-rows (an 80 GB card holds about 10^8).  shift is 7 for 128-wide
// windows, 8 for 256.  Launches on `stream` and returns the CUDA error (0
// on success).
extern "C" int csrt_spmv_bucket(const void* vals, const void* meta,
                                const void* rbcb, const void* held,
                                const void* groups, int n_layers,
                                int n_buckets, int64_t bucket_microrows,
                                const void* x, int64_t x_stride, void* y,
                                int64_t y_stride, int64_t grid, int shift,
                                int nrows, void* stream) {
  if (int64_t(n_layers) * n_buckets * bucket_microrows >= (int64_t(1) << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (grid > 0 && n_layers > 0) {
    static const cudaError_t prepared = allow_shared_memory();
    if (prepared != cudaSuccess) return static_cast<int>(prepared);
    spmv_bucket_kernel<<<unsigned(grid), kThreads, kSharedBytes,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(vals), static_cast<const uint4*>(meta),
        static_cast<const int32_t*>(rbcb), static_cast<const int32_t*>(held),
        static_cast<const int32_t*>(groups), n_layers, n_buckets,
        int(bucket_microrows), static_cast<const float*>(x), x_stride,
        static_cast<float*>(y), y_stride, shift, nrows);
  }
  return static_cast<int>(cudaGetLastError());
}

// The blocks of the kernel that one SM holds at once, by the CUDA
// runtime's reckoning of its registers, threads and shared memory, into
// *blocks; the threads and the shared memory a block takes, into *threads
// and *shared_bytes.  Returns the CUDA error (0 on success).
extern "C" int csrt_spmv_bucket_occupancy(int* blocks, int* threads,
                                          int* shared_bytes) {
  *threads = kThreads;
  *shared_bytes = kSharedBytes;
  const cudaError_t rc = allow_shared_memory();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, spmv_bucket_kernel, kThreads, kSharedBytes));
}
