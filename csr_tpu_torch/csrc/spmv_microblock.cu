// Micro-block SpMV, y += A @ x, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel csr_tpu/ops/spmv.py:_spmv_kernel (and its
// launcher _spmv_call).  It reads the same layout, byte for byte
// (csr_tpu_torch/ops/microblock.py): per micro-row m, vals[m, 128] f32,
// meta[m, 128] u16 = lo | epos << shift, rbcb[m] = rb << 16 | cb.
//
// What bounds it on this card: bytes.  Each micro-row streams 6 B per
// padded slot (4 B value + 2 B meta) plus 4 B of rbcb, read once; x is
// read by direct indexed loads and stays in L2 (128 KB at the 32768^2
// flagship, against 50 MB of L2), and y takes one atomic add per row per
// group of 32 micro-rows.  The arithmetic is a few operations per slot.
// What the design does about it:
//   * every lane of a warp loads 4 consecutive slots with one 16 B load
//     of values and one 8 B load of meta, so a warp reads a micro-row in
//     two fully coalesced requests;
//   * the micro-row's entry count (epos of slot 127) is read first; a
//     padding micro-row (count 0) loads nothing more, and slots at or past
//     the count load neither their value nor x.  So padding never forms
//     0 * x, and an inf in x reaches only the rows whose entries use it;
//   * the 128-slot exclusive prefix is exact f32: a 4-slot serial prefix
//     in registers, then a warp shuffle scan of the 32 lane totals (the
//     TPU kernel needed a two-pass bf16 matmul for this);
//   * row r of the micro-row's window gets P[epos[r]] - P[epos[r-1]],
//     formed at once: nothing on this card makes the difference cheaper to
//     defer, as the TPU kernel did;
//   * the layout pads every stripe to 32 micro-rows, so a block of 4
//     warps takes one aligned group of 32 micro-rows with a single row
//     window rb, sums the warps' rows in shared memory, and adds each row
//     to y with one atomicAdd.  The order of those adds varies, so results
//     are not bitwise deterministic.
// `pair` only pads the layout and needs no code here.  TMA, wgmma and a
// deterministic reduction are for later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLane = 128;      // slots per micro-row
constexpr int kAccGroup = 32;   // micro-rows sharing one rb (ACC_GROUP)
constexpr int kWarps = 4;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kWarps * 32)
spmv_microblock_kernel(const float4* __restrict__ vals4,
                       const uint2* __restrict__ meta4,
                       const int32_t* __restrict__ rbcb,
                       const float* __restrict__ x, float* __restrict__ y,
                       int shift, int nrows) {
  __shared__ float4 scan[kWarps][32];  // each warp's exclusive prefix P
  __shared__ float4 part[kWarps][32];  // each warp's row sums
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t mr0 = int64_t(blockIdx.x) * kAccGroup;
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

// y += A @ x over the first n_groups * 32 micro-rows of the layout.
// All pointers are device pointers: vals 16 B aligned, meta 8 B aligned,
// y zeroed by the caller.  shift is 7 for 128-wide windows, 8 for 256.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int csrt_spmv_microblock(const void* vals, const void* meta,
                                    const void* rbcb, const void* x, void* y,
                                    int64_t n_groups, int shift, int nrows,
                                    void* stream) {
  if (n_groups > 0) {
    spmv_microblock_kernel<<<dim3(unsigned(n_groups)), kWarps * 32, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(vals), static_cast<const uint2*>(meta),
        static_cast<const int32_t*>(rbcb), static_cast<const float*>(x),
        static_cast<float*>(y), shift, nrows);
  }
  return static_cast<int>(cudaGetLastError());
}
