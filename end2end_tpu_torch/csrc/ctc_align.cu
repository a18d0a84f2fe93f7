// CTC forced alignment on the card: the Viterbi (max-semiring) forward over
// the extended lattice, its predecessor choices on a tape, and the
// backtrace from the best end state, in one launch.
//
// Replaces no Pallas kernel: the JAX package runs it as two lax.scans on
// the device (end2end_tpu/ops/alignment.py::ctc_forced_alignment :37, the
// Viterbi forward :54-70 and the backtrace :88-103), which the port's plain
// version (ops/alignment.py::align_plain) drives from the host as ~2T
// frames of small launches.  It computes exactly what align_plain returns
// for lp (T, N, V) float32, targets (N, S) int32, il and tl (N,) int32:
//   * per frame t < il, for each extended state s (L = 2S + 1; label
//     ext[s] = blank at even s, clamp(targets[(s-1)/2], 0, V-1) at odd s):
//     d1 = delta[s-1] (LOG0 at s = 0), d2 = skip2[s] ? delta[s-2] : LOG0,
//     best = max(delta[s], d1, d2), choice = 2 if d2 >= best, else 1 if
//     d1 >= best, else 0 (the skip wins a tie, then the diagonal), and
//     delta'[s] = max(best + lp_ext[t, s], LOG0), where lp_ext is
//     max(lp[t, n, ext[s]], LOG0) on states s < 2 tl + 1 and LOG0 above;
//   * delta starts at frame 0 on state 0 and, where tl > 0, state 1 (also
//     when il = 0: the score then reads frame 0, as the JAX package's);
//   * the end state e* = 2 tl if delta[2 tl] >= delta[2 tl - 1] (that one
//     LOG0 when tl = 0), else 2 tl - 1; score = max of the two, -inf at or
//     below LOG0_THRESHOLD;
//   * the state at il - 1 is e*, at t >= il -1, and below il - 1 it is
//     s(t+1) - choice(t+1, clamp(s(t+1), 0, L-1)) (an infeasible path may
//     walk below 0, and keeps walking from state 0's choices there);
//   * labels (T, N) int32 = ext[s] where s >= 0, else -1; positions (T, N)
//     int32 = (s-1)/2 at odd s >= 0, else -1.
// The arithmetic is a max and one float add in the plain version's order,
// so labels, positions and scores are bit-equal to align_plain on the card.
//
// What bounds it on the H100: the frame chain, not bytes.  At B=8,
// T'=750, S=150 the kernel needs ~0.7 MB of log-probs and writes ~1.8 MB
// of tape (~0.75 us at 3.35 TB/s), but a sequence's T frames are a chain
// of dependent steps (a global load, a max and an add, a barrier: ~1 us a
// frame), and its backtrace another T dependent tape reads.
//
// Design (a simple first kernel): one block a sequence; the L extended
// states over the block's threads, R a thread (state s = r * threads +
// tid), with their labels, skip flags and validity in registers; delta
// double-buffered in shared memory, one __syncthreads a frame; the
// emissions read through the extended labels from the (T, N, V) log-probs
// (K1's way: no (T, N, L) gather in torch first); the int8 choices into a
// (T, N, L) global tape, frames 1..il-1 only (the walk reads nothing
// else); frames t >= il do nothing, so a block stops at its own length.
// After the last frame one thread walks back from e* and writes labels and
// positions; the block's other threads write the -1 rows past il.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr float kLog0 = -1.0e30f;
constexpr float kLog0Threshold = -1.0e29f;
constexpr int kMaxThreads = 1024;

struct AlignArgs {
  const float* lp;  // (t_max, n, v)
  const int* targets;  // (n, s_max)
  const int* il;
  const int* tl;
  int8_t* tape;  // (t_max, n, L) choices, frames 1..il-1 written
  int* labels;  // (t_max, n)
  int* positions;  // (t_max, n)
  float* scores;  // (n,)
  int t_max, n, v, s_max, blank;
};

__device__ __forceinline__ int ext_label(const AlignArgs& a, int n, int s) {
  if ((s & 1) == 0) return a.blank;
  const int lab = a.targets[(size_t)n * a.s_max + (s - 1) / 2];
  return min(max(lab, 0), a.v - 1);
}

template <int R>
__global__ void __launch_bounds__(kMaxThreads)
    align_kernel(AlignArgs a) {
  extern __shared__ float delta[];  // [2][L]
  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int L = 2 * a.s_max + 1;
  const int il = a.il[n];
  const int tl = a.tl[n];
  int lab[R];
  bool valid[R], skip[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int s = r * nt + tid;
    lab[r] = s < L ? ext_label(a, n, s) : 0;
    valid[r] = s < 2 * tl + 1;  // and s < L, since tl <= S
    skip[r] = s < L && (s & 1) && s >= 3 && lab[r] != ext_label(a, n, s - 2);
  }
  const size_t row = (size_t)a.v;
  const float* lp_n = a.lp + (size_t)n * row;  // frame t at t * n * v
  const size_t frame = (size_t)a.n * row;
  // frame 0: state 0, and state 1 where tl > 0
  float* cur = delta;
  float* nxt = delta + L;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int s = r * nt + tid;
    if (s < L) {
      const float x = valid[r] ? fmaxf(lp_n[lab[r]], kLog0) : kLog0;
      cur[s] = (s == 0 || (s == 1 && tl > 0)) ? x : kLog0;
    }
  }
  __syncthreads();
  for (int t = 1; t < il; ++t) {
    const float* lp_t = lp_n + (size_t)t * frame;
    float x[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int s = r * nt + tid;
      x[r] = (s < L && valid[r]) ? fmaxf(__ldg(lp_t + lab[r]), kLog0) : kLog0;
    }
    int8_t* tape_t = a.tape + ((size_t)t * a.n + n) * L;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int s = r * nt + tid;
      if (s < L) {
        const float d = cur[s];
        const float d1 = s >= 1 ? cur[s - 1] : kLog0;
        const float d2 = skip[r] ? cur[s - 2] : kLog0;
        const float best = fmaxf(fmaxf(d, d1), d2);
        tape_t[s] = (int8_t)(d2 >= best ? 2 : (d1 >= best ? 1 : 0));
        nxt[s] = fmaxf(best + x[r], kLog0);
      }
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  // the rows past the length
  for (int t = max(il, 0) + tid; t < a.t_max; t += nt) {
    a.labels[(size_t)t * a.n + n] = -1;
    a.positions[(size_t)t * a.n + n] = -1;
  }
  if (tid != 0) return;
  const float end1 = cur[2 * tl];
  const float end2 = tl > 0 ? cur[2 * tl - 1] : kLog0;
  const float score = fmaxf(end1, end2);
  a.scores[n] = score > kLog0Threshold ? score : -CUDART_INF_F;
  int s = end1 >= end2 ? 2 * tl : max(2 * tl - 1, 0);
  for (int t = il - 1; t >= 0; --t) {
    if (t < il - 1) {
      const int idx = min(max(s, 0), L - 1);
      s -= a.tape[((size_t)(t + 1) * a.n + n) * L + idx];
    }
    const size_t o = (size_t)t * a.n + n;
    a.labels[o] = s >= 0 ? ext_label(a, n, s) : -1;
    a.positions[o] = (s >= 0 && (s & 1)) ? (s - 1) / 2 : -1;
  }
}

template <int R>
int launch(const AlignArgs& a, int threads, cudaStream_t stream) {
  const int L = 2 * a.s_max + 1;
  const size_t smem = 2 * (size_t)L * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        align_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  align_kernel<R><<<(unsigned)a.n, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// lp (t_max, n, v) f32, targets (n, s_max) int32, il, tl (n,) int32 with
// 0 <= il <= t_max and 0 <= tl <= s_max (the wrapper checks them); tape
// (t_max, n, 2 s_max + 1) int8 scratch; writes labels and positions
// (t_max, n) int32 and scores (n,) f32.  states (R, 1/2/4/8) and threads
// (a multiple of 32, <= 1024, threads * R >= 2 s_max + 1) come from
// ops/alignment.py::align_plan.
extern "C" int e2e_ctc_align_f32(const void* lp, const void* targets,
                                 const void* il, const void* tl, void* tape,
                                 void* labels, void* positions, void* scores,
                                 int t_max, int n, int v, int s_max,
                                 int blank, int states, int threads,
                                 void* stream) {
  const long long L = 2LL * s_max + 1;
  if (t_max < 1 || n < 0 || v < 1 || s_max < 0 || blank < 0 || blank >= v ||
      threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      (long long)threads * states < L)
    return (int)cudaErrorInvalidValue;
  AlignArgs a{};
  a.lp = (const float*)lp;
  a.targets = (const int*)targets;
  a.il = (const int*)il;
  a.tl = (const int*)tl;
  a.tape = (int8_t*)tape;
  a.labels = (int*)labels;
  a.positions = (int*)positions;
  a.scores = (float*)scores;
  a.t_max = t_max;
  a.n = n;
  a.v = v;
  a.s_max = s_max;
  a.blank = blank;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  switch (states) {
    case 1: return launch<1>(a, threads, st);
    case 2: return launch<2>(a, threads, st);
    case 4: return launch<4>(a, threads, st);
    case 8: return launch<8>(a, threads, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
