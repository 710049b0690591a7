// The device body of the micro-block SpMV, y += A @ x over one aligned
// group of 32 micro-rows, included by spmv_microblock.cu (one layout).
// spmv_bucket.cu carries a body of its own.
//
// It is the port of the Pallas TPU kernel body
// csr_tpu/ops/spmv.py:_spmv_kernel, on the same layout, byte for byte
// (csr_tpu_torch/ops/microblock.py): per micro-row m, vals[m, 128] f32,
// meta[m, 128] u16 = lo | epos << shift, rbcb[m] = rb << 16 | cb.
// spmv_microblock.cu says what bounds it and what the design does.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLane = 128;      // slots per micro-row
constexpr int kAccGroup = 32;   // micro-rows sharing one rb (ACC_GROUP)
constexpr int kWarps = 4;
constexpr unsigned kFull = 0xffffffffu;

// One block of kWarps * 32 threads adds the products of micro-rows
// mr0 .. mr0 + 31 (one row window rb) into y.  mr0 counts micro-rows from
// the start of vals4/meta4/rbcb in 64 bits, so a stack of layouts past
// 2^31 slots is addressed whole; x points at column 0 of the operand and
// y at row 0 of the result, nrows long.
__device__ __forceinline__ void microblock_spmv_group(
    const float4* __restrict__ vals4, const uint2* __restrict__ meta4,
    const int32_t* __restrict__ rbcb, const float* __restrict__ x,
    float* __restrict__ y, int64_t mr0, int shift, int nrows) {
  __shared__ float4 scan[kWarps][32];  // each warp's exclusive prefix P
  __shared__ float4 part[kWarps][32];  // each warp's row sums
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int lo_mask = (1 << shift) - 1;
  const float* prefix = reinterpret_cast<const float*>(scan[warp]);

  // lane holds window rows 4*lane .. 4*lane+3
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  for (int k = warp; k < kAccGroup; k += kWarps) {
    const int64_t mr = mr0 + k;
    const uint2 mt = meta4[mr * 32 + lane];
    const int m0 = mt.x & 0xffff, m1 = mt.x >> 16;
    const int m2 = mt.y & 0xffff, m3 = mt.y >> 16;
    const int e0 = (m0 >> shift) & 127, e1 = (m1 >> shift) & 127;
    const int e2 = (m2 >> shift) & 127, e3 = (m3 >> shift) & 127;
    const int n = __shfl_sync(kFull, e3, 31);  // entries in the micro-row
    if (n == 0) continue;                      // padding: warp-uniform

    const float* xw = x + (int64_t(rbcb[mr] & 0xffff) << shift);
    const int s0 = lane * 4;
    float p0 = 0.f, p1 = 0.f, p2 = 0.f, p3 = 0.f;
    if (s0 < n) {
      const float4 v = vals4[mr * 32 + lane];
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
    scan[warp][lane] = make_float4(excl, excl + c0, excl + c1, excl + c2);
    __syncwarp();

    // row 4*lane+j holds slots [epos[r-1], epos[r]); epos[-1] = 0
    int ep = __shfl_up_sync(kFull, e3, 1);
    if (lane == 0) ep = 0;
    if (e0 != ep) a0 += prefix[e0] - prefix[ep];
    if (e1 != e0) a1 += prefix[e1] - prefix[e0];
    if (e2 != e1) a2 += prefix[e2] - prefix[e1];
    if (e3 != e2) a3 += prefix[e3] - prefix[e2];
    __syncwarp();  // the next micro-row overwrites this warp's prefix
  }

  part[warp][lane] = make_float4(a0, a1, a2, a3);
  __syncthreads();
  const float* rows = reinterpret_cast<const float*>(part);
  const int t = threadIdx.x;
  const float sum = rows[t] + rows[kLane + t] + rows[2 * kLane + t] +
                    rows[3 * kLane + t];
  const int row = (rbcb[mr0] >> 16) * kLane + t;
  if (sum != 0.f && row < nrows) atomicAdd(y + row, sum);
}

}  // namespace
