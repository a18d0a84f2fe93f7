// The beta/occupation kernel (K2) that csrc/ctc_loss.cu's K2 replaced,
// kept verbatim as its bit-identity oracle and the baseline of its A/B
// timings (chip_smoke.py, tests/test_torch_cuda.py,
// tools/ctc_beta_breakdown.py); never part of the kernel library.
//
// One block per sequence, threads own the states s = tid + k*blockDim; the
// beta row, the extended labels and the skip flags live in shared memory.
// Each frame computes the unshifted row into shared memory, takes the
// block max (first barrier, then a serial read of the warps' slots), then
// reads each state's alpha tape entry and gathers its emission from global
// memory, stores gamma straight to global memory and writes the shifted
// row plus emission (second barrier).  In checkpoint mode each chunk's
// alpha rows are recomputed into a global scratch by K1's step (kept here
// with the helpers it calls).  Its entry point keeps the signature K2 had
// before the redesign, under its own name:
// e2e_ctc_beta_reference_f32(lp, targets, il, tl, a_in, n_in, z_hat,
// norm_end2, gamma, abuf, nbuf, t_max, n, v, s_max, blank, every, states,
// stream).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kLog0 = -1.0e30f;
constexpr float kLog0Threshold = -1.0e29f;
constexpr float kNormClamp = 512.0f;
constexpr int kMaxThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr long kSmemLimit = 232448;  // a block's shared memory on the H100

// log(e^a + e^b + e^c) with the exact max term cancelled: the form of
// semiring.logaddexp3 (and of the JAX package's fastmath.logaddexp3_acc).
__device__ __forceinline__ float logaddexp3(float a, float b, float c) {
  const float m = fmaxf(fmaxf(a, b), c);
  const float ms = fmaxf(m, kLog0);
  const float u = ((expf(a - ms) + expf(b - ms)) + expf(c - ms)) - 1.0f;
  const float out = ms + log1pf(fmaxf(u, 0.0f));
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
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = red[0];
  const int warps = blockDim.x >> 5;
  for (int w = 1; w < warps; ++w) m = fmaxf(m, red[w]);
  return m;
}

// The max over the warp, exact: floats as order-preserving ints (-0 below
// +0, NaN never arises: every value is fmaxf'ed with log-zero), one redux.
__device__ __forceinline__ float warp_max(float v) {
  const int k = __float_as_int(v);
  const int r = __reduce_max_sync(kFull, k ^ ((k >> 31) & 0x7fffffff));
  return __int_as_float(r ^ ((r >> 31) & 0x7fffffff));
}

// Shared-memory view of one sequence's lattice (K2's).
struct Lattice {
  int* ext;    // [L]: vocabulary id of state s
  int* skip;   // [L + 2]: skip[s] = the s-2 -> s transition is allowed
  int L, tl;
};

__device__ __forceinline__ int label(const int* tgt, int i, int v) {
  return min(max(tgt[i], 0), v - 1);
}

__device__ void load_lattice(const Lattice& lat, const int* tgt, int blank,
                             int v) {
  for (int s = threadIdx.x; s < lat.L + 2; s += blockDim.x) {
    int e = blank, sk = 0;
    if (s < lat.L && (s & 1)) {
      const int i = (s - 1) >> 1;
      e = label(tgt, i, v);
      if (s >= 3) sk = e != label(tgt, i - 1, v);
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

// One thread's R adjacent states s = s0 + j, s0 = R * threadIdx.x.
template <int R>
struct States {
  int col[R];      // vocabulary id of s's emission; -1: log-zero (s >= 2tl+1)
  unsigned skip;   // bit j: the s-2 -> s transition is allowed
  unsigned live;   // bit j: s < L
  unsigned first;  // bit j: s opens a path at t = 0 (s = 0, or 1 if tl > 0)
  float a[R];      // renormalised alpha after the last frame computed
  float p1, p2;    // the same of states s0 - 1 and s0 - 2 (pads: log-zero)
};

template <int R>
__device__ void load_states(States<R>& st, const int* tgt, int L, int tl,
                            int blank, int v) {
  const int s0 = R * threadIdx.x;
  st.skip = st.live = st.first = 0;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int s = s0 + j;
    int e = blank;
    unsigned sk = 0;
    if (s < L && (s & 1)) {
      const int i = (s - 1) >> 1;
      e = label(tgt, i, v);
      if (s >= 3) sk = e != label(tgt, i - 1, v);
    }
    st.col[j] = s < L && s < 2 * tl + 1 ? e : -1;
    st.skip |= sk << j;
    st.live |= (unsigned)(s < L) << j;
    st.first |= (unsigned)(s == 0 || (s == 1 && tl > 0)) << j;
    st.a[j] = kLog0;
  }
  st.p1 = st.p2 = kLog0;
}

// The raw emissions of the thread's states in the frame row `row` (V,),
// loaded at need (K2's recompute); log-zero where the state emits
// nothing.  With R even, s0 is even and
// the even states' column is the blank's (or -1 past 2tl+1, and then for
// every later state too): one load serves them.
template <int R>
__device__ __forceinline__ void load_emissions(const States<R>& st,
                                               const float* row,
                                               float (&e)[R]) {
  if constexpr (R % 2 == 0) {
    const float eb = st.col[0] >= 0 ? __ldg(row + st.col[0]) : kLog0;
#pragma unroll
    for (int j = 0; j < R; ++j)
      e[j] = st.col[j] < 0 ? kLog0 : j % 2 ? __ldg(row + st.col[j]) : eb;
  } else {
#pragma unroll
    for (int j = 0; j < R; ++j)
      e[j] = st.col[j] >= 0 ? __ldg(row + st.col[j]) : kLog0;
  }
}

// One renormalised alpha step at frame t < il over the block's states, on
// the thread's raw emissions e of frame t (kFirst: t == 0).  Shared
// verbatim by K1 and K2's checkpoint recompute.  slots: 2 x 3 *
// (blockDim / 32) floats, ping-pong by frame parity: each warp's max, then
// its two last unshifted values; `warps` (the warps holding states) are
// reduced.  One barrier.
template <int R, bool kFirst>
__device__ __forceinline__ void alpha_step(States<R>& st, const float (&e)[R],
                                           int t, float* slots, int warps,
                                           int& norm2) {
  float anew[R];
  float lmax = kLog0;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const float lp = fmaxf(e[j], kLog0);
    float x;
    if constexpr (kFirst) {
      x = (st.first >> j) & 1 ? lp : kLog0;
    } else {
      const float a1 = j >= 1 ? st.a[j - 1] : st.p1;
      const float a2 = j >= 2 ? st.a[j - 2] : j == 1 ? st.p1 : st.p2;
      x = logaddexp3(st.a[j], a1, (st.skip >> j) & 1 ? a2 : kLog0) + lp;
    }
    x = (st.live >> j) & 1 ? fmaxf(x, kLog0) : kLog0;
    anew[j] = x;
    lmax = fmaxf(lmax, x);
  }
  lmax = warp_max(lmax);
  // the unshifted values of states s0 - 1 and s0 - 2
  float u1, u2;
  if constexpr (R >= 2) {
    u1 = __shfl_up_sync(kFull, anew[R - 1], 1);
    u2 = __shfl_up_sync(kFull, anew[R - 2], 1);
  } else {
    u1 = __shfl_up_sync(kFull, anew[0], 1);
    u2 = __shfl_up_sync(kFull, anew[0], 2);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int all = blockDim.x >> 5;
  float* red = slots + (t & 1) * 3 * all;  // [all] maxima
  float* bnd = red + all;                  // [all][2] last, second last
  if (lane == 0) red[warp] = lmax;
  if (lane == 31) bnd[2 * warp] = anew[R - 1];
  if (lane == (R >= 2 ? 31 : 30)) bnd[2 * warp + 1] = anew[R >= 2 ? R - 2 : 0];
  __syncthreads();
  // the max of the warps' maxima: a slot a lane (warps <= 32), a redux
  const float m = renorm_shift(warp_max(lane < warps ? red[lane] : kLog0));
  norm2 += __float2int_rn(m * 2.0f);
  if (lane == 0) {
    u1 = warp > 0 ? bnd[2 * warp - 2] : kLog0;
    u2 = warp > 0 ? bnd[2 * warp - 1] : kLog0;
  } else if (R == 1 && lane == 1) {
    u2 = warp > 0 ? bnd[2 * warp - 2] : kLog0;
  }
#pragma unroll
  for (int j = 0; j < R; ++j) st.a[j] = fmaxf(anew[j] - m, kLog0);
  st.p1 = fmaxf(u1 - m, kLog0);
  st.p2 = fmaxf(u2 - m, kLog0);
}

// The thread's states of the carry into row `row` of a (rows, L) tape, and
// the norm (thread 0).
template <int R>
__device__ __forceinline__ void store_row(const States<R>& st, float* a_out,
                                          int* n_out, size_t row, int L,
                                          int norm2) {
  const int s0 = R * threadIdx.x;
#pragma unroll
  for (int j = 0; j < R; ++j)
    if ((st.live >> j) & 1) a_out[row * L + s0 + j] = st.a[j];
  if (threadIdx.x == 0) n_out[row] = norm2;
}

// K2's checkpoint recompute of one chunk: the alpha rows of frames [t0, t1)
// from the carry entering t0, by K1's step at R states a thread, into
// arows (t1 - t0, L) and their norms into nrows.  slots: 6 floats a warp
// of the block.  Out of K2's body (noinline), so that the beta loop
// compiles as it did without it.
template <int R>
__device__ void recompute_states(const float* lp_n, const int* tgt,
                                 const float* carry, int norm2, float* arows,
                                 int* nrows, int t0, int t1, int il,
                                 int n_seq, int v, int L, int tl, int blank,
                                 float* slots) {
  States<R> st;
  load_states(st, tgt, L, tl, blank, v);
  const int s0 = R * threadIdx.x;
#pragma unroll
  for (int j = 0; j < R; ++j)
    st.a[j] = (st.live >> j) & 1 ? carry[s0 + j] : kLog0;
  st.p1 = s0 >= 1 && s0 - 1 < L ? carry[s0 - 1] : kLog0;
  st.p2 = s0 >= 2 && s0 - 2 < L ? carry[s0 - 2] : kLog0;
  const int warps = ((L + R - 1) / R + 31) / 32;  // the warps with states
  for (int t = t0; t < t1; ++t) {
    if (t < il) {
      float e[R];
      load_emissions(st, lp_n + (size_t)t * n_seq * v, e);
      if (t == 0)
        alpha_step<R, true>(st, e, t, slots, warps, norm2);
      else
        alpha_step<R, false>(st, e, t, slots, warps, norm2);
    }
    store_row(st, arows, nrows, t - t0, L, norm2);
  }
}

__device__ __noinline__ void recompute_chunk(
    int states, const float* lp_n, const int* tgt, const float* carry,
    int norm2, float* arows, int* nrows, int t0, int t1, int il, int n_seq,
    int v, int L, int tl, int blank, float* slots) {
  auto* run = states == 1   ? recompute_states<1>
              : states == 2 ? recompute_states<2>
              : states == 3 ? recompute_states<3>
              : states == 4 ? recompute_states<4>
              : states == 6 ? recompute_states<6>
              : states == 8 ? recompute_states<8>
                            : recompute_states<16>;
  run(lp_n, tgt, carry, norm2, arows, nrows, t0, t1, il, n_seq, v, L, tl,
      blank, slots);
}

// K2.  Grid: one block per sequence.  a_in/n_in as K1's outputs; with
// every > 0, abuf (N, every, L) and nbuf (N, every) are scratch for the
// recomputed rows of one chunk, which K1's step recomputes with `states`
// a thread (states * blockDim >= L).  gamma: (T, N, L).
__global__ void __launch_bounds__(kMaxThreads)
    ctc_beta_kernel(const float* __restrict__ lp,
                    const int* __restrict__ targets,
                    const int* __restrict__ il_arr,
                    const int* __restrict__ tl_arr,
                    const float* __restrict__ a_in,
                    const int* __restrict__ n_in,
                    const float* __restrict__ z_hat,
                    const int* __restrict__ norm_end2,
                    float* __restrict__ gamma, float* __restrict__ abuf,
                    int* __restrict__ nbuf, int t_max, int n_seq, int v,
                    int s_max, int blank, int every, int states) {
  extern __shared__ float smem[];
  const int n = blockIdx.x;
  const int L = 2 * s_max + 1;
  float* alpha = smem;              // [L + 2]  the recompute's step slots
  float* buf = alpha + L + 2;       // [L]
  float* bs = buf + L;              // [L + 2]  beta~ + emission of t+1
  float* red = bs + L + 2;          // [32]
  Lattice lat{reinterpret_cast<int*>(red + 32), nullptr, L, tl_arr[n]};
  lat.skip = lat.ext + L;
  load_lattice(lat, targets + (size_t)n * s_max, blank, v);
  for (int s = threadIdx.x; s < L + 2; s += blockDim.x) {
    alpha[s] = kLog0;
    // beta~ = log-zero and no emission after the last frame: LOG0 + LOG0,
    // as the plain scan adds them; the two pads read log-zero.
    bs[s] = s < L ? kLog0 + kLog0 : kLog0;
  }
  __syncthreads();

  const int il = il_arr[n];
  const int tl = lat.tl;
  const float zh = z_hat[n];
  const bool finite = zh > kLog0Threshold;
  const float z = finite ? zh : 0.0f;
  const int ne = norm_end2[n];
  const int chunk = every > 0 ? every : t_max;
  const int n_chunks = (t_max + chunk - 1) / chunk;
  int bnorm2 = 0;
  for (int c = n_chunks - 1; c >= 0; --c) {
    const int t0 = c * chunk;
    const int t1 = min(t0 + chunk, t_max);
    float* arows = nullptr;
    int* nrows = nullptr;
    if (every > 0) {  // recompute the chunk's alpha rows from checkpoint c
      arows = abuf + (size_t)n * chunk * L;
      nrows = nbuf + (size_t)n * chunk;
      const size_t row = (size_t)c * n_seq + n;
      recompute_chunk(states, lp + (size_t)n * v, targets + (size_t)n * s_max,
                      a_in + row * L, n_in[row], arows, nrows, t0, t1, il,
                      n_seq, v, L, tl, blank,
                      6 * (int)(blockDim.x >> 5) <= 2 * L + 2 ? alpha : red);
      __syncthreads();  // arows and nrows are read by other threads
    }
    for (int t = t1 - 1; t >= t0; --t) {
      const float* lp_row = lp + ((size_t)t * n_seq + n) * v;
      const float* a_t;
      int an;
      if (every > 0) {
        a_t = arows + (size_t)(t - t0) * L;
        an = nrows[t - t0];
      } else {
        a_t = a_in + ((size_t)t * n_seq + n) * L;
        an = n_in[(size_t)t * n_seq + n];
      }
      float* g_row = gamma + ((size_t)t * n_seq + n) * L;
      if (t >= il) {  // padding frame: beta~ = log-zero, gamma = 0
        bnorm2 = 0;
        for (int s = threadIdx.x; s < L; s += blockDim.x) {
          g_row[s] = 0.0f;
          bs[s] = kLog0 + emission(lat, lp_row, s);
        }
        __syncthreads();
        continue;
      }
      const bool is_init = t == il - 1;
      float m = 0.0f;
      if (!is_init) {
        float lmax = kLog0;
        for (int s = threadIdx.x; s < L; s += blockDim.x) {
          const float b2 = lat.skip[s + 2] ? bs[s + 2] : kLog0;
          const float bnew = fmaxf(logaddexp3(bs[s], bs[s + 1], b2), kLog0);
          buf[s] = bnew;
          lmax = fmaxf(lmax, bnew);
        }
        m = renorm_shift(block_max(lmax, red));  // barrier: bs reads done
        bnorm2 += __float2int_rn(m * 2.0f);
      } else {
        bnorm2 = 0;
      }
      const float shift = (float)(an + bnorm2 - ne) * 0.5f;
      for (int s = threadIdx.x; s < L; s += blockDim.x) {
        float b;
        if (is_init)
          b = (s == 2 * tl || (s == 2 * tl - 1 && tl > 0)) ? 0.0f : kLog0;
        else
          b = fmaxf(buf[s] - m, kLog0);
        const float log_g = a_t[s] + b + (shift - z);
        const float g = expf(fminf(log_g, 0.0f));
        g_row[s] = (finite && s < 2 * tl + 1) ? g : 0.0f;
        bs[s] = b + emission(lat, lp_row, s);
      }
      __syncthreads();
    }
  }
}

// K2's dynamic shared memory at L = 2S+1 (ctc_loss_cuda.py checks the
// same sum against the card's limit before launching).
size_t beta_smem_bytes(int s_max) {
  const size_t L = 2 * (size_t)s_max + 1;
  return 4 * (3 * L + 36 + 2 * L + 2);  // + ext[L], skip[L + 2]
}

int threads_for(int L) {
  const int t = (L + 31) / 32 * 32;
  return t < kMaxThreads ? t : kMaxThreads;
}

bool valid_states(int r) {
  return r == 1 || r == 2 || r == 3 || r == 4 || r == 6 || r == 8 ||
         r == 16;
}

cudaError_t set_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

cudaError_t launch_beta(const void* lp, const void* targets, const void* il,
                        const void* tl, const void* a_in, const void* n_in,
                        const void* z_hat, const void* norm_end2,
                        void* gamma, void* abuf, void* nbuf, int t_max,
                        int n_seq, int v, int s_max, int blank, int every,
                        int states, cudaStream_t stream) {
  const size_t smem = beta_smem_bytes(s_max);
  cudaError_t err = set_smem((const void*)ctc_beta_kernel, smem);
  if (err != cudaSuccess) return err;
  ctc_beta_kernel<<<n_seq, threads_for(2 * s_max + 1), smem, stream>>>(
      (const float*)lp, (const int*)targets, (const int*)il, (const int*)tl,
      (const float*)a_in, (const int*)n_in, (const float*)z_hat,
      (const int*)norm_end2, (float*)gamma, (float*)abuf, (int*)nbuf, t_max,
      n_seq, v, s_max, blank, every, states);
  return cudaGetLastError();
}

}  // namespace

// K2; `states`: K1's plan's, the checkpoint recompute's states a thread.
extern "C" int e2e_ctc_beta_reference_f32(
    const void* lp, const void* targets, const void* il, const void* tl,
    const void* a_in, const void* n_in, const void* z_hat,
    const void* norm_end2, void* gamma, void* abuf, void* nbuf, int t_max,
    int n_seq, int v, int s_max, int blank, int every, int states,
    void* stream) {
  const int L = 2 * s_max + 1;
  if (!valid_states(states) || (long)states * threads_for(L) < L)
    return (int)cudaErrorInvalidConfiguration;
  if (n_seq <= 0) return (int)cudaGetLastError();
  return (int)launch_beta(lp, targets, il, tl, a_in, n_in, z_hat, norm_end2,
                          gamma, abuf, nbuf, t_max, n_seq, v, s_max, blank,
                          every, states, (cudaStream_t)stream);
}
