// Bucket-selecting micro-block SpMV for Hopper (sm_90a):
//   y[l] += A[l, held[l]] @ x[l]   for every layer l of a stack,
// where A[l, b] is bucket b of layer l in a stack of micro-block layouts
// vals/meta (L, B, M, 128), rbcb (L, B, M), and held (L,) i32 lies in
// device memory.
//
// Replaces the Pallas TPU launcher csr_tpu/ops/spmv.py:_spmv_call_bucket
// (body _spmv_kernel), which the ring schedule
// csr_tpu/parallel/mb_ring.py:spmv_ring_mb runs once per ring step.  On
// the TPU the bucket index rides the scalar-prefetch channel into the
// block index maps, so the pipeline streams only the held bucket's
// blocks.  Here a block computes its own addresses: every block reads
// held[blockIdx.y] from device memory and offsets its micro-row index by
// (l * B + held[l]) * M, in 64 bits.  What is kept is the property: the
// bucket is chosen on the device, with no host read of `held` and no
// copy of the bucket.  The device body is microblock_spmv.cuh, shared
// with spmv_microblock.cu.
//
// What bounds it on this card: bytes, as for spmv_microblock.cu (6 B per
// padded slot of the held buckets, read once).  What the design does:
//   * the second grid dimension runs over the stack's layers, so one
//     launch does a ring step for every row shard that the device holds
//     (all D of them in the single-device form of the mesh, one in the
//     process form): a ring product is D launches, not D * D;
//   * buckets are padded with zero micro-rows to the largest bucket of the
//     stack.  groups (L, B) i32, on the device, holds each bucket's count
//     of 32-micro-row groups up to its last micro-row with an entry; a
//     block past its bucket's count returns after two 4 B loads, before
//     any load of the layout.  On a column-skewed matrix most of a small
//     bucket is such padding;
//   * y is added to, so the ring's accumulator is y itself across the D
//     steps; x is the held column shard, read by indexed loads with no
//     padded copy.
// A held index outside [0, B) adds nothing (the block returns): the
// wrapper cannot check a device value without a host read.

#include "microblock_spmv.cuh"

namespace {

__global__ void __launch_bounds__(kWarps * 32)
spmv_bucket_kernel(const float4* __restrict__ vals4,
                   const uint2* __restrict__ meta4,
                   const int32_t* __restrict__ rbcb,
                   const int32_t* __restrict__ held,
                   const int32_t* __restrict__ groups, int n_buckets,
                   int64_t bucket_microrows, const float* __restrict__ x,
                   int64_t x_stride, float* __restrict__ y, int64_t y_stride,
                   int shift, int nrows) {
  const int64_t l = blockIdx.y;
  const int h = held[l];
  if (h < 0 || h >= n_buckets) return;
  const int64_t bucket = l * n_buckets + h;
  if (int(blockIdx.x) >= groups[bucket]) return;  // padding of the bucket
  microblock_spmv_group(
      vals4, meta4, rbcb, x + l * x_stride, y + l * y_stride,
      bucket * bucket_microrows + int64_t(blockIdx.x) * kAccGroup, shift,
      nrows);
}

}  // namespace

// For l in [0, n_layers): y[l * y_stride ..] += A[l, held[l]] @
// x[l * x_stride ..], over the first groups[l, held[l]] groups of 32
// micro-rows of that bucket; the grid covers n_groups groups a layer (the
// largest count of the stack).  All pointers are device pointers: vals
// 16 B aligned, meta 8 B aligned; bucket_microrows (M) is a multiple of
// 32; strides are in elements.  shift is 7 for 128-wide windows, 8 for
// 256.  Launches on `stream` and returns cudaGetLastError() (0 on
// success).
extern "C" int csrt_spmv_bucket(const void* vals, const void* meta,
                                const void* rbcb, const void* held,
                                const void* groups, int n_layers,
                                int n_buckets, int64_t bucket_microrows,
                                const void* x, int64_t x_stride, void* y,
                                int64_t y_stride, int64_t n_groups, int shift,
                                int nrows, void* stream) {
  if (n_groups > 0 && n_layers > 0) {
    spmv_bucket_kernel<<<dim3(unsigned(n_groups), unsigned(n_layers)),
                         kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(vals), static_cast<const uint2*>(meta),
        static_cast<const int32_t*>(rbcb), static_cast<const int32_t*>(held),
        static_cast<const int32_t*>(groups), n_buckets, bucket_microrows,
        static_cast<const float*>(x), x_stride, static_cast<float*>(y),
        y_stride, shift, nrows);
  }
  return static_cast<int>(cudaGetLastError());
}
