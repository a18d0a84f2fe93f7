// The two-barrier alpha kernel (K1) that csrc/ctc_loss.cu's K1 replaced,
// kept verbatim as its bit-identity oracle and the baseline of its A/B
// timings (chip_smoke.py, tests/test_torch_cuda.py,
// tools/ctc_alpha_breakdown.py); never part of the kernel library.
//
// One block per sequence, threads own the states s = tid + k*blockDim; the
// alpha row, the extended labels and the skip flags live in shared memory.
// Each frame gathers its emissions from global memory, writes the unshifted
// row, takes the block max (first barrier), subtracts the shift from the
// row (second barrier).  Same signature as before the redesign:
// e2e_ctc_alpha_f32(lp, targets, il, tl, a_out, n_out, z_hat, norm_end2,
// t_max, n, v, s_max, blank, every, stream).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kLog0 = -1.0e30f;
constexpr float kLog0Threshold = -1.0e29f;
constexpr float kNormClamp = 512.0f;
constexpr int kMaxThreads = 1024;

// log(e^a + e^b + e^c) with the exact max term cancelled: the form of
// semiring.logaddexp3 (and of the JAX package's fastmath.logaddexp3_acc).
__device__ __forceinline__ float logaddexp3(float a, float b, float c) {
  const float m = fmaxf(fmaxf(a, b), c);
  const float ms = fmaxf(m, kLog0);
  const float u = ((expf(a - ms) + expf(b - ms)) + expf(c - ms)) - 1.0f;
  const float out = ms + log1pf(fmaxf(u, 0.0f));
  return m > kLog0Threshold ? out : kLog0;
}

// semiring.logaddexp2
__device__ __forceinline__ float logaddexp2(float a, float b) {
  const float m = fmaxf(a, b);
  const float ms = fmaxf(m, kLog0);
  const float d = fmaxf(-fabsf(a - b), kLog0);
  const float out = ms + log1pf(expf(d));
  return m > kLog0Threshold ? out : kLog0;
}

// Row max on the 0.5 grid (clamped): the renormalisation shift.
__device__ __forceinline__ float renorm_shift(float row_max) {
  return rintf(fminf(fmaxf(row_max, -kNormClamp), kNormClamp) * 2.0f) * 0.5f;
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

// Shared-memory view of one sequence's lattice.
struct Lattice {
  int* ext;    // [L]: vocabulary id of state s
  int* skip;   // [L + 2]: skip[s] = the s-2 -> s transition is allowed
  int L, tl;
};

__device__ void load_lattice(const Lattice& lat, const int* tgt, int blank,
                             int v) {
  for (int s = threadIdx.x; s < lat.L + 2; s += blockDim.x) {
    int e = blank, sk = 0;
    if (s < lat.L && (s & 1)) {
      const int i = (s - 1) >> 1;
      e = min(max(tgt[i], 0), v - 1);
      if (s >= 3) sk = e != min(max(tgt[i - 1], 0), v - 1);
    }
    if (s < lat.L) lat.ext[s] = e;
    lat.skip[s] = sk;
  }
}

// Emission of state s at the frame whose (V,) row is lp_row.
__device__ __forceinline__ float emission(const Lattice& lat,
                                          const float* lp_row, int s) {
  return s < 2 * lat.tl + 1 ? fmaxf(__ldg(lp_row + lat.ext[s]), kLog0)
                            : kLog0;
}

// One renormalised alpha step at frame t < il.  alpha[s + 2] holds state
// s (alpha[0..1] are log-zero pads); buf is [L] scratch.  Shared verbatim by
// K1 and K2's checkpoint recompute.  Ends with a barrier.
__device__ void alpha_step(const Lattice& lat, float* alpha, float* buf,
                           float* red, const float* lp_row, int t,
                           int& norm2) {
  float lmax = kLog0;
  for (int s = threadIdx.x; s < lat.L; s += blockDim.x) {
    const float lp = emission(lat, lp_row, s);
    float anew;
    if (t == 0) {
      anew = (s == 0 || (s == 1 && lat.tl > 0)) ? lp : kLog0;
    } else {
      const float a2 = lat.skip[s] ? alpha[s] : kLog0;
      anew = logaddexp3(alpha[s + 2], alpha[s + 1], a2) + lp;
    }
    anew = fmaxf(anew, kLog0);
    buf[s] = anew;
    lmax = fmaxf(lmax, anew);
  }
  const float m = renorm_shift(block_max(lmax, red));
  for (int s = threadIdx.x; s < lat.L; s += blockDim.x)
    alpha[s + 2] = fmaxf(buf[s] - m, kLog0);
  norm2 += __float2int_rn(m * 2.0f);
  __syncthreads();
}

// K1.  Grid: one block per sequence.  a_out/n_out: the tape (T, N, L) /
// (T, N) when every == 0, else the chunk-start carries (C, N, L) / (C, N).
__global__ void ctc_alpha_kernel(const float* __restrict__ lp,
                                 const int* __restrict__ targets,
                                 const int* __restrict__ il_arr,
                                 const int* __restrict__ tl_arr,
                                 float* __restrict__ a_out,
                                 int* __restrict__ n_out,
                                 float* __restrict__ z_hat,
                                 int* __restrict__ norm_end2, int t_max,
                                 int n_seq, int v, int s_max, int blank,
                                 int every) {
  extern __shared__ float smem[];
  const int n = blockIdx.x;
  const int L = 2 * s_max + 1;
  float* alpha = smem;              // [L + 2]
  float* buf = alpha + L + 2;       // [L]
  float* red = buf + L;             // [32]
  Lattice lat{reinterpret_cast<int*>(red + 32), nullptr, L, tl_arr[n]};
  lat.skip = lat.ext + L;           // [L + 2]
  load_lattice(lat, targets + (size_t)n * s_max, blank, v);
  for (int s = threadIdx.x; s < L + 2; s += blockDim.x) alpha[s] = kLog0;
  __syncthreads();

  const int il = il_arr[n];
  int norm2 = 0;
  for (int t = 0; t < t_max; ++t) {
    if (every > 0 && t % every == 0) {  // the carry entering chunk t/every
      const size_t row = (size_t)(t / every) * n_seq + n;
      for (int s = threadIdx.x; s < L; s += blockDim.x)
        a_out[row * L + s] = alpha[s + 2];
      if (threadIdx.x == 0) n_out[row] = norm2;
    }
    if (t < il)  // block-uniform: frozen rows are not recomputed
      alpha_step(lat, alpha, buf, red, lp + ((size_t)t * n_seq + n) * v, t,
                 norm2);
    if (every == 0) {
      const size_t row = (size_t)t * n_seq + n;
      for (int s = threadIdx.x; s < L; s += blockDim.x)
        a_out[row * L + s] = alpha[s + 2];
      if (threadIdx.x == 0) n_out[row] = norm2;
    }
  }
  if (threadIdx.x == 0) {
    const int tl = lat.tl;
    const float end2 = tl > 0 ? alpha[2 * tl + 1] : kLog0;
    z_hat[n] = logaddexp2(alpha[2 * tl + 2], end2);
    norm_end2[n] = norm2;
  }
}

// Dynamic shared memory of each kernel at L = 2S+1 (ctc_loss_cuda.py
// checks the same sums against the card's limit before launching).
size_t smem_bytes(int s_max, bool beta) {
  const size_t L = 2 * (size_t)s_max + 1;
  const size_t floats = (beta ? 3 * L + 4 : 2 * L + 2) + 32;
  return 4 * (floats + 2 * L + 2);  // + ext[L], skip[L + 2]
}

int threads_for(int L) {
  const int t = (L + 31) / 32 * 32;
  return t < kMaxThreads ? t : kMaxThreads;
}

cudaError_t set_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

extern "C" int e2e_ctc_alpha_f32(const void* lp, const void* targets,
                                 const void* il, const void* tl, void* a_out,
                                 void* n_out, void* z_hat, void* norm_end2,
                                 int t_max, int n_seq, int v, int s_max,
                                 int blank, int every, void* stream) {
  if (n_seq > 0) {
    const size_t smem = smem_bytes(s_max, false);
    cudaError_t err = set_smem((const void*)ctc_alpha_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    ctc_alpha_kernel<<<n_seq, threads_for(2 * s_max + 1), smem,
                       (cudaStream_t)stream>>>(
        (const float*)lp, (const int*)targets, (const int*)il,
        (const int*)tl, (float*)a_out, (int*)n_out, (float*)z_hat,
        (int*)norm_end2, t_max, n_seq, v, s_max, blank, every);
  }
  return (int)cudaGetLastError();
}
