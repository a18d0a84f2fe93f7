// The top-k kernel (K3) that csrc/topk.cu's K3 replaced, kept verbatim as
// its bit-identity oracle and the baseline of its A/B timings
// (chip_smoke.py, tests/test_torch_cuda.py, tools/topk_breakdown.py); never
// part of the kernel library.  Only its C entry's name differs
// (e2e_topk_reference_f32, was e2e_topk_f32).
//
// Exact top-k over the last axis of a (rows, V) float32 matrix.
//
// Replaces: end2end_tpu/ops/topk_pallas.py::_topk_kernel (launched by
// topk_pallas).  Contract: values sorted descending, equal values by
// ascending index (the order of jax.lax.top_k and of a stable descending
// sort).  Unlike the TPU kernel, exact -inf ties also come out with distinct
// ascending indices.
//
// What bounds it on the H100: at the beam decoder's shape (rows = T*B =
// 32000, V = 1024, k = 24) the input is 131 MB read once from HBM (~40 us at
// 3.35 TB/s); the k rounds re-read each row from L1/L2, so the kernel is
// bound by those k*V/32 loads per lane and the 5-step shuffle reductions,
// not by HBM.
//
// Design: one warp per row, no shared memory and no mutation of the row.
// Round r takes the largest element that comes strictly after round r-1's
// (value, index) in the total order (value desc, index asc): each lane scans
// its strided slice of the row, then a butterfly shuffle reduction picks the
// winner.  This works at any V and needs no scratch.  Rows are independent,
// so 8 warps per block and rows/8 blocks fill the 132 SMs at this shape.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kNoIndex = 0x7fffffff;

// (v, i) comes before (bv, bi) in the output order.
__device__ __forceinline__ bool before(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__global__ void topk_warp_per_row(const float* __restrict__ x,
                                  float* __restrict__ vals,
                                  int* __restrict__ idx, long long rows,
                                  int v, int k) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warp exits together
  const float* xr = x + row * v;
  float prev_v = CUDART_INF_F;
  int prev_i = -1;
  for (int r = 0; r < k; ++r) {
    float bv = -CUDART_INF_F;
    int bi = kNoIndex;
    for (int j = lane; j < v; j += 32) {
      const float xv = __ldg(xr + j);
      // strictly after the previous pick, and better than the lane's best
      if (before(prev_v, prev_i, xv, j) && before(xv, j, bv, bi)) {
        bv = xv;
        bi = j;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (before(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      vals[row * k + r] = bv;
      idx[row * k + r] = bi;
    }
    prev_v = bv;
    prev_i = bi;
  }
}

}  // namespace

extern "C" int e2e_topk_reference_f32(const void* x, void* vals, void* idx,
                            long long rows, int v, int k, void* stream) {
  if (rows > 0) {
    const long long blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
    topk_warp_per_row<<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                        (cudaStream_t)stream>>>(
        (const float*)x, (float*)vals, (int*)idx, rows, v, k);
  }
  return (int)cudaGetLastError();
}
