// Transducer (RNN-T) loss on Hopper: the alpha wavefront (K8) and the beta
// wavefront fused with the node posteriors (K9), float32.
//
// Replaces: end2end_tpu/ops/rnnt_loss_pallas.py::_alpha_kernel (K8, launched
// by alpha_scan_pallas) and ::_post_kernel (K9, launched by
// posteriors_pallas).  Plain version: end2end_tpu_torch/ops/rnnt_loss_plain.py
// (alpha, posteriors), evaluated in the same operation order.
//
// Semantics (the JAX package's): the lattice nodes (t, u) of one sequence,
// t < T, u < Up = U+1, are walked by anti-diagonals d = t+u, D = T+Up-1 of
// them.  Both predecessors of (t, u) lie on d-1 and both successors on d+1,
// so a diagonal is one elementwise step over u plus one max.  Each diagonal
// is renormalised by its max rounded half-to-even to the 0.5 grid (rintf,
// not roundf, whose ties go away from zero), so the running offsets are
// exact and cancel exactly in the posteriors.  Finite log-zero (-1e30).
// The planes are read UNSKEWED from (N, T, Up) at (d-u, u), log-zero outside
// the lattice, so no skewed copy is made.
//
// What bounds it on the H100: each diagonal is a few dependent libm calls per
// lane, a block-wide max (two barriers) and a strided plane read (lane u
// reads row d-u: neighbouring lanes are Up-1 floats apart, one sector each);
// ~T+U diagonals in sequence per block.  Latency, not bandwidth or FLOPs:
// the bench-row planes (B=8, T=400, Up=81) are 1 MB each and stay in L2.
//
// Design: one thread block per sequence, thread i owns the lanes
// u = i + k*blockDim.  The previous diagonal's row lives in shared memory
// with a log-zero pad (lane u reads its neighbour u-1 in K8, u+1 in K9).
// K8 writes the tape of renormalised rows (D, N, Up) and the offsets rcum
// (D, N); K9 walks d downwards carrying beta(d+1) and its offset, emits the
// posteriors of diagonal d straight into the unskewed (N, T, Up) outputs (0
// at t >= il), then steps beta to d; beta never reaches device memory.  One
// block per sequence fills 8 of the 132 SMs at B=8: a first design, not
// tuned.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kLog0 = -1.0e30f;
constexpr float kLog0Threshold = -1.0e29f;
constexpr int kMaxThreads = 1024;

// semiring.logaddexp2
__device__ __forceinline__ float logaddexp2(float a, float b) {
  const float m = fmaxf(a, b);
  const float ms = fmaxf(m, kLog0);
  const float d = fmaxf(-fabsf(a - b), kLog0);
  const float out = ms + log1pf(expf(d));
  return m > kLog0Threshold ? out : kLog0;
}

// rnnt_loss_plain.diag_renorm on a diagonal's max.
__device__ __forceinline__ float renorm_shift(float row_max) {
  const float m = row_max > kLog0Threshold ? row_max : 0.0f;
  return rintf(m * 2.0f) * 0.5f;
}

// Max over the block (blockDim a multiple of 32).  Ends with every thread
// holding the result; `red` may be rewritten only after a later barrier.
__device__ __forceinline__ float block_max(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = red[0];
  const int warps = blockDim.x >> 5;
  for (int w = 1; w < warps; ++w) m = fmaxf(m, red[w]);
  return m;
}

// plane[n, t, u], log-zero outside 0 <= t < T.
__device__ __forceinline__ float plane_at(const float* p, int t, int u,
                                          int t_max, int up) {
  return (t >= 0 && t < t_max) ? __ldg(p + (size_t)t * up + u) : kLog0;
}

// K8.  Grid: one block per sequence.  tape (D, N, Up), rcum (D, N).
__global__ void rnnt_alpha_kernel(const float* __restrict__ b_pl,
                                  const float* __restrict__ l_pl,
                                  float* __restrict__ tape,
                                  float* __restrict__ rcum, int n_seq,
                                  int t_max, int up) {
  extern __shared__ float smem[];
  const int n = blockIdx.x;
  const int d_total = t_max + up - 1;
  float* a = smem;         // [Up + 1]: a[u + 1] = lane u, a[0] log-zero pad
  float* buf = a + up + 1; // [Up]
  float* red = buf + up;   // [32]
  const float* bp = b_pl + (size_t)n * t_max * up;
  const float* lp = l_pl + (size_t)n * t_max * up;
  for (int u = threadIdx.x; u < up + 1; u += blockDim.x) {
    a[u] = u == 1 ? 0.0f : kLog0;
    if (u < up) tape[(size_t)n * up + u] = u == 0 ? 0.0f : kLog0;
  }
  if (threadIdx.x == 0) rcum[n] = 0.0f;
  __syncthreads();
  float r = 0.0f;
  for (int d = 1; d < d_total; ++d) {  // diagonal d from d-1's row and planes
    float lmax = kLog0;
    for (int u = threadIdx.x; u < up; u += blockDim.x) {
      const float skb = plane_at(bp, d - 1 - u, u, t_max, up);
      const float skl = u > 0 ? plane_at(lp, d - u, u - 1, t_max, up) : kLog0;
      const float v = logaddexp2(a[u + 1] + skb, a[u] + skl);
      buf[u] = v;
      lmax = fmaxf(lmax, v);
    }
    const float m = renorm_shift(block_max(lmax, red));  // a[] reads done
    float* row = tape + ((size_t)d * n_seq + n) * up;
    for (int u = threadIdx.x; u < up; u += blockDim.x) {
      const float v = fmaxf(buf[u] - m, kLog0);
      a[u + 1] = v;
      row[u] = v;
    }
    r = r + m;
    if (threadIdx.x == 0) rcum[(size_t)d * n_seq + n] = r;
    __syncthreads();
  }
}

// K9.  Grid: one block per sequence.  Inputs K8's tape/rcum, the lengths
// and the split logZ; outputs gb, gl (N, T, Up), every element written.
__global__ void rnnt_post_kernel(const float* __restrict__ b_pl,
                                 const float* __restrict__ l_pl,
                                 const float* __restrict__ tape,
                                 const float* __restrict__ rcum,
                                 const int* __restrict__ il_arr,
                                 const int* __restrict__ ul_arr,
                                 const float* __restrict__ z_small,
                                 const float* __restrict__ z_off,
                                 float* __restrict__ gb,
                                 float* __restrict__ gl, int n_seq,
                                 int t_max, int up) {
  extern __shared__ float smem[];
  const int n = blockIdx.x;
  const int d_total = t_max + up - 1;
  float* bn = smem;         // [Up + 1]: beta(d+1), bn[Up] log-zero pad
  float* buf = bn + up + 1; // [Up]
  float* red = buf + up;    // [32]
  const size_t base = (size_t)n * t_max * up;
  const float* bp = b_pl + base;
  const float* lp = l_pl + base;
  for (int u = threadIdx.x; u < up + 1; u += blockDim.x) bn[u] = kLog0;
  __syncthreads();
  const int il = il_arr[n];
  const int d_term = il - 1 + ul_arr[n];
  const int u_term = ul_arr[n];
  const float zs = z_small[n];
  const float zo = z_off[n];
  float r_next = 0.0f;  // beta(d+1)'s offset
  for (int d = d_total - 1; d >= 0; --d) {
    const float ar = __ldg(rcum + (size_t)d * n_seq + n);
    const float off = (ar + r_next) - zo;
    const float off_term = ar - zo;
    const float* arow = tape + ((size_t)d * n_seq + n) * up;
    float lmax = kLog0;
    for (int u = threadIdx.x; u < up; u += blockDim.x) {
      const int t = d - u;
      const bool in_lattice = t >= 0 && t < t_max;
      const float skb = plane_at(bp, t, u, t_max, up);
      const float skl = plane_at(lp, t, u, t_max, up);
      const float b_nx = bn[u];
      const float lab_succ = bn[u + 1];
      const bool is_term = d == d_term && u == u_term;
      // posteriors of diagonal d, in rnnt_loss_plain.posteriors' order
      if (in_lattice) {
        const float small = __ldg(arow + u) - zs;
        const float lg_b =
            ((small + skb) + (is_term ? 0.0f : b_nx)) + (is_term ? off_term
                                                                 : off);
        const float lg_l = ((small + skl) + lab_succ) + off;
        const bool live = t < il;
        const size_t o = (size_t)t * up + u;
        gb[base + o] =
            (live && lg_b > kLog0Threshold) ? expf(fminf(lg_b, 0.0f)) : 0.0f;
        gl[base + o] =
            (live && lg_l > kLog0Threshold) ? expf(fminf(lg_l, 0.0f)) : 0.0f;
      }
      // beta on diagonal d, the terminal blank injected on d's scale
      float v = logaddexp2(skb + b_nx, skl + lab_succ);
      v = logaddexp2(v, is_term ? skb - r_next : kLog0);
      buf[u] = v;
      lmax = fmaxf(lmax, v);
    }
    const float m = renorm_shift(block_max(lmax, red));  // bn[] reads done
    for (int u = threadIdx.x; u < up; u += blockDim.x)
      bn[u] = fmaxf(buf[u] - m, kLog0);
    r_next = r_next + m;
    __syncthreads();
  }
}

size_t smem_bytes(int up) { return 4 * (2 * (size_t)up + 1 + 32); }

int threads_for(int up) {
  const int t = (up + 31) / 32 * 32;
  return t < kMaxThreads ? t : kMaxThreads;
}

cudaError_t set_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

extern "C" int e2e_rnnt_alpha_f32(const void* b_pl, const void* l_pl,
                                  void* tape, void* rcum, int n_seq, int t_max,
                                  int up, void* stream) {
  if (n_seq > 0 && t_max > 0) {
    const size_t smem = smem_bytes(up);
    cudaError_t err = set_smem((const void*)rnnt_alpha_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    rnnt_alpha_kernel<<<n_seq, threads_for(up), smem, (cudaStream_t)stream>>>(
        (const float*)b_pl, (const float*)l_pl, (float*)tape, (float*)rcum,
        n_seq, t_max, up);
  }
  return (int)cudaGetLastError();
}

extern "C" int e2e_rnnt_post_f32(const void* b_pl, const void* l_pl,
                                 const void* tape, const void* rcum,
                                 const void* il, const void* ul,
                                 const void* z_small, const void* z_off,
                                 void* gb, void* gl, int n_seq, int t_max,
                                 int up, void* stream) {
  if (n_seq > 0 && t_max > 0) {
    const size_t smem = smem_bytes(up);
    cudaError_t err = set_smem((const void*)rnnt_post_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    rnnt_post_kernel<<<n_seq, threads_for(up), smem, (cudaStream_t)stream>>>(
        (const float*)b_pl, (const float*)l_pl, (const float*)tape,
        (const float*)rcum, (const int*)il, (const int*)ul,
        (const float*)z_small, (const float*)z_off, (float*)gb, (float*)gl,
        n_seq, t_max, up);
  }
  return (int)cudaGetLastError();
}
