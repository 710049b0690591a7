// Micro-block SpMV, y += A @ x, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel csr_tpu/ops/spmv.py:_spmv_kernel (and its
// launcher _spmv_call); the device body is in microblock_spmv.cuh, which
// spmv_bucket.cu shares.  It reads the same layout, byte for byte
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
//   * the 128-slot exclusive prefix of the f32 products is taken in
//     double: a 4-slot serial prefix in registers, then a warp shuffle
//     scan of the 32 lane totals (the TPU kernel needed a two-pass bf16
//     matmul for this).  In f32, P[epos[r]] - P[epos[r-1]] carried the
//     rounding of the whole micro-row's sum before the row: at
//     MovieLens-25M's converged Lanczos vector it read up to 2.04e-5 of a
//     short row's magnitudes, past the benchmark's limit of 2e-5; in
//     double, 2.3e-7.  A segmented f32 scan (each row's own slots) was
//     as exact and 37% slower, a compensated f32 prefix 29% (PERF.md);
//   * row r of the micro-row's window gets P[epos[r]] - P[epos[r-1]],
//     formed at once and rounded to f32: nothing on this card makes the
//     difference cheaper to defer, as the TPU kernel did;
//   * 16 blocks an SM (at most 32 registers), the most a 128-thread block
//     allows: the kernel waits on its loads and its scan's chain, and the
//     double scan took 18% more time at 12 blocks an SM, 9-12% at 16;
//   * the layout pads every stripe to 32 micro-rows, so a block of 4
//     warps takes one aligned group of 32 micro-rows with a single row
//     window rb, sums the warps' rows in shared memory, and adds each row
//     to y with one atomicAdd.  The order of those adds varies, so results
//     are not bitwise deterministic.
// `pair` only pads the layout and needs no code here.  TMA, wgmma and a
// deterministic reduction are for later work.

#include "microblock_spmv.cuh"

namespace {

__global__ void __launch_bounds__(kWarps * 32, 16)
spmv_microblock_kernel(const float4* __restrict__ vals4,
                       const uint2* __restrict__ meta4,
                       const int32_t* __restrict__ rbcb,
                       const float* __restrict__ x, float* __restrict__ y,
                       int shift, int nrows) {
  microblock_spmv_group(vals4, meta4, rbcb, x, y,
                        int64_t(blockIdx.x) * kAccGroup, shift, nrows);
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
