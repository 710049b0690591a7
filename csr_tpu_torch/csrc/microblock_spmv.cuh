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

// P[slot] of a warp's prefix, as microblock_spmv_group lays it out
__device__ __forceinline__ double slot_prefix(const double* prefix, int slot) {
  return prefix[(slot & 3) * 32 + (slot >> 2)];
}

// One block of kWarps * 32 threads adds the products of micro-rows
// mr0 .. mr0 + 31 (one row window rb) into y.  mr0 counts micro-rows from
// the start of vals4/meta4/rbcb in 64 bits, so a stack of layouts past
// 2^31 slots is addressed whole; x points at column 0 of the operand and
// y at row 0 of the result, nrows long.
__device__ __forceinline__ void microblock_spmv_group(
    const float4* __restrict__ vals4, const uint2* __restrict__ meta4,
    const int32_t* __restrict__ rbcb, const float* __restrict__ x,
    float* __restrict__ y, int64_t mr0, int shift, int nrows) {
  // each warp's exclusive prefix P in double, slot s at (s & 3) * 32 +
  // (s >> 2), so that the lanes' stores of one position are consecutive
  __shared__ double scan[kWarps][kLane];
  __shared__ float4 part[kWarps][32];  // each warp's row sums
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int lo_mask = (1 << shift) - 1;
  double* const prefix = scan[warp];

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

    // P[s] = sum of the f32 products over slots < s: lane-local, then
    // across the warp, in double.  A row's part is P[epos[r]] -
    // P[epos[r-1]]; in f32 that difference carried the rounding of every
    // earlier row's terms in the micro-row, up to 2e-5 of a short row's
    // magnitudes after heavy ones at MovieLens-25M.  In double it is the
    // row's own terms to within 2^-45 of the micro-row's sum, rounded to
    // f32 once.
    const double c0 = p0, c1 = c0 + p1, c2 = c1 + p2, c3 = c2 + p3;
    double inc = c3;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const double t = __shfl_up_sync(kFull, inc, d);
      if (lane >= d) inc += t;
    }
    double excl = __shfl_up_sync(kFull, inc, 1);
    if (lane == 0) excl = 0.0;
    prefix[lane] = excl;
    prefix[32 + lane] = excl + c0;
    prefix[64 + lane] = excl + c1;
    prefix[96 + lane] = excl + c2;
    __syncwarp();

    // row 4*lane+j holds slots [epos[r-1], epos[r]); epos[-1] = 0
    int ep = __shfl_up_sync(kFull, e3, 1);
    if (lane == 0) ep = 0;
    if (e0 != ep) a0 += float(slot_prefix(prefix, e0) - slot_prefix(prefix, ep));
    if (e1 != e0) a1 += float(slot_prefix(prefix, e1) - slot_prefix(prefix, e0));
    if (e2 != e1) a2 += float(slot_prefix(prefix, e2) - slot_prefix(prefix, e1));
    if (e3 != e2) a3 += float(slot_prefix(prefix, e3) - slot_prefix(prefix, e2));
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
