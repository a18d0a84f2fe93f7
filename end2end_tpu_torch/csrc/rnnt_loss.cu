// Transducer (RNN-T) loss on Hopper: the alpha wavefront (K8) and the beta
// wavefront with the node posteriors (K9), float32.
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
// The planes are (N, T, Up), log-zero outside the lattice.
//
// What bounds it on the H100: a chain of T+U-1 diagonals a sequence, each
// a dependent libm logaddexp2 a lane (expf + log1pf), the row's max and
// the shift; B sequences fill B of the 132 SMs.  The block-per-sequence
// kernels this design replaced (kept as tools/rnnt_loss_reference.cu) spent
// ~1,300 (K8) and ~1,900 (K9) cycles a diagonal at the training slice's
// lattice (B=8, T'=750, Up=151): a third of K8's in two dependent strided
// plane loads a lane on the chain (lane u reads row d-u: a sector a lane),
// a third of K9's in the posteriors, whose alpha-tape load was on the
// chain too (tools/rnnt_wavefront_breakdown.py).
//
// Design.  A skew pass on every SM first copies both planes into rows of
// diagonals, sk[p, n, d, u] = plane_p[n, d-u, u] (log-zero outside the
// lattice), so a diagonal's entries are one coalesced row.  K8 and K9's
// beta wavefront then run one block a sequence, R lanes u = R i + j a
// thread in registers over whole warps (one lane a thread up to 1024
// lanes, then 2, 4, 8): the neighbour u-1 (K8) or u+1 (beta) is the
// thread's own register or the next thread's by one shuffle, and the row
// max is one redux.sync on the floats' order-preserving integers, then
// K1's one-barrier exchange: each warp's max and its edge lane's unshifted
// value go to a ping-pong slot row, one barrier, and every thread reduces
// the slots and shifts its edge neighbour itself (one warp: no barrier).
// Each thread copies its lanes' entries of diagonal d + ring - 1 by
// cp.async into its own slots of a ring kRing diagonals deep (2 at 8
// lanes) and reads diagonal d+1's into registers before d's row max, so no
// diagonal waits for a load.  A barrier waits until the stores its threads
// have issued have landed, so a row and its offset are stored right after
// the next diagonal's barrier.  The beta wavefront skips the terminal
// blank's second logaddexp2 off the terminal node (with a log-zero term it
// returns its first argument to the bit, which is never -0) and writes a
// beta tape like K8's; K9's posteriors then take one thread a node on every
// SM, in rnnt_loss_plain.posteriors' order, out of the alpha and beta tapes
// and the skewed planes.  The skewed planes (and K9's beta tape) live in a
// workspace the caller passes: 2 N D Up floats for K8, (3 Up + 1) N D for
// K9.  The skew and posterior passes walk a 1-D grid with a block stride,
// so no batch or length meets a grid limit.  Past 8192 lanes the rows live
// in shared memory, a thread a lane per block stride, two barriers a
// diagonal, the posteriors inside the beta walk (the replaced kernels'
// scheme, no workspace).  The launch plan (lanes, warps, ring, shared
// bytes) is a function of Up alone, rnnt_loss_cuda.wavefront_plan's; the C
// entries check that it holds.  The maxima are exact and every sum keeps
// the replaced kernels' order, so the outputs are bit-equal to theirs.
// Tried and measured slower (the breakdown builds them by text patches):
// one warp a sequence at up to 8 lanes a thread, 2 to 5 lanes a thread,
// rings of 2 and 8, lanes interleaved across a warp, the rows copied by a
// thread's TMA bulk copies, rows staged in shared memory between stores,
// and warp slots polled in place of the barrier.
//
// K8 writes the tape of renormalised rows (D, N, Up) and the offsets rcum
// (D, N); K9 writes the node posteriors into the (N, T, Up) outputs (0 at
// t >= il).

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kLog0 = -1.0e30f;
constexpr float kLog0Threshold = -1.0e29f;
constexpr int kMaxThreads = 1024;
constexpr int kMaxLanes = 8;  // a thread's lanes in registers
constexpr int kRing = 4;      // diagonals copied ahead (2 at kMaxLanes)
constexpr unsigned kFull = 0xffffffffu;
constexpr long kSmemLimit = 232448;  // a block's shared memory on the H100

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

// The max over the warp, exact: floats as order-preserving ints (-0 below
// +0, as fmaxf orders them; no NaN arises), one redux.
__device__ __forceinline__ float warp_max(float v) {
  const int k = __float_as_int(v);
  const int r = __reduce_max_sync(kFull, k ^ ((k >> 31) & 0x7fffffff));
  return __int_as_float(r ^ ((r >> 31) & 0x7fffffff));
}

// cp.async of one float to the shared address `dst`.
__device__ __forceinline__ void cp_async4(unsigned dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float ld_shared(unsigned addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// The lane index u of the thread's lane j.
template <int R>
__device__ __forceinline__ int lane_u(int j) {
  return R * threadIdx.x + j;
}

// xn[j] = x at lane u-1 (lane_u(0) - 1 of the warp's first thread: edge).
template <int R>
__device__ __forceinline__ void lower_neighbours(const float (&x)[R],
                                                 float (&xn)[R], float edge) {
  const float up1 = __shfl_up_sync(kFull, x[R - 1], 1);
  xn[0] = (threadIdx.x & 31) == 0 ? edge : up1;
#pragma unroll
  for (int j = 1; j < R; ++j) xn[j] = x[j - 1];
}

// xn[j] = x at lane u+1 (the warp's last thread's last lane + 1: edge).
template <int R>
__device__ __forceinline__ void upper_neighbours(const float (&x)[R],
                                                 float (&xn)[R], float edge) {
  const float dn1 = __shfl_down_sync(kFull, x[0], 1);
#pragma unroll
  for (int j = 0; j < R - 1; ++j) xn[j] = x[j + 1];
  xn[R - 1] = (threadIdx.x & 31) == 31 ? edge : dn1;
}

// The max over the block's lanes of x's local max, and the unshifted edge
// neighbour of the warp (K8: the previous warp's last lane, K9: the next
// warp's first; log-zero past the block): one warp, a redux; several, a
// redux, the slot row of this diagonal's parity (K1's step: each warp's max
// and its edge lane, one barrier).
template <int R, bool kOneWarp, bool kLower>
__device__ __forceinline__ float row_max(float lmax, const float (&x)[R],
                                         float* slots, int d, float& edge) {
  lmax = warp_max(lmax);
  edge = kLog0;
  if constexpr (!kOneWarp) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int warps = blockDim.x >> 5;
    float* red = slots + (d & 1) * 2 * warps;  // [warps] maxima, then edges
    if (lane == 0) red[warp] = lmax;
    if (kLower && lane == 31) red[warps + warp] = x[R - 1];
    if (!kLower && lane == 0) red[warps + warp] = x[0];
    __syncthreads();
    lmax = warp_max(lane < warps ? red[lane] : kLog0);
    if (kLower && warp > 0) edge = red[warps + warp - 1];
    if (!kLower && warp + 1 < warps) edge = red[warps + warp + 1];
  }
  return lmax;
}

// Both planes skewed: sk (2, N, D, Up), sk[p, n, d, u] = plane_p[n, d-u,
// u], log-zero outside 0 <= d-u < T.
// Tiles (z, y, x) of (2N, ceil(D/32), ceil(Up/32)), x fastest, a block
// stride apart over a 1-D grid; block (32, 8): a 32 x 32 output tile from
// the 63 plane rows it touches, read and written a row at a time
// (tile[r][x]'s row stride of 32 floats makes the skewed reads
// r = i - x + 31 conflict-free).
__global__ void __launch_bounds__(256)
    rnnt_skew_kernel(const float* __restrict__ b_pl,
                     const float* __restrict__ l_pl, float* __restrict__ sk,
                     int n_seq, int t_max, int up) {
  __shared__ float tile[63][32];
  const int d_total = t_max + up - 1;
  const int xs = (up + 31) / 32, ys = (d_total + 31) / 32;
  const long tiles = 2L * n_seq * ys * xs;
  const int tx = threadIdx.x;
  for (long b = blockIdx.x; b < tiles; b += gridDim.x) {
    const int bx = (int)(b % xs), by = (int)(b / xs % ys);
    const int z = (int)(b / xs / ys), n = z % n_seq;
    const float* x = (z < n_seq ? b_pl : l_pl) + (size_t)n * t_max * up;
    float* out = sk + (size_t)z * d_total * up;
    const int d0 = by * 32, u = bx * 32 + tx;
    const int t0 = d0 - bx * 32 - 31;  // the tile's first plane row
    for (int r = threadIdx.y; r < 63; r += 8) {
      const int t = t0 + r;
      tile[r][tx] =
          t >= 0 && t < t_max && u < up ? x[(size_t)t * up + u] : kLog0;
    }
    __syncthreads();
    for (int i = threadIdx.y; i < 32; i += 8) {
      const int d = d0 + i;
      if (d < d_total && u < up)
        out[(size_t)d * up + u] = tile[i - tx + 31][tx];
    }
    __syncthreads();  // the tile's reads done before the next tile's writes
  }
}

// The thread's ring of D stages of its lanes' entries (2R floats a stage,
// [2R][blockDim] a stage, the thread's own slots): stage s, entry e at
// slot + s * stage + e * entry bytes.  The slot row [2][2 warps] precedes
// the ring.
struct Slots {
  unsigned slot, stage, entry;
  float* red;
};

template <int R>
__device__ __forceinline__ Slots slot_layout(float* smem) {
  const int threads = blockDim.x;
  Slots s;
  s.red = smem;
  s.slot = smem_addr(smem + 8 * (threads >> 5) + threadIdx.x);
  s.entry = 4 * threads;
  s.stage = 2 * R * s.entry;
  return s;
}

// Diagonal d's renormalised row v (the thread's lanes) and its offset off
// into rows (D, N, Up) and offs (D, N).  A barrier waits until the stores
// its threads have issued have landed: K8 stores a row as soon as it has
// it, the beta wavefront right after the next diagonal's barrier (each
// measured the faster for its kernel, tools/rnnt_wavefront_breakdown.py).
template <int R>
__device__ __forceinline__ void store_row(float* rows, float* offs,
                                          const float (&v)[R], float off,
                                          int d, int n_seq, int n, int up) {
  const size_t row = (size_t)d * n_seq + n;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int u = lane_u<R>(j);
    if (u < up) rows[row * up + u] = v[j];
  }
  if (threadIdx.x == 0) offs[row] = off;
}

// K8.  Grid: one block per sequence of blockDim = 32 warps threads, R
// lanes a thread, a ring of D diagonals.  Inputs the skewed planes
// (rnnt_skew_kernel's sk); tape (D, N, Up), rcum (D, N).
template <int R, int D, bool kOneWarp>
__global__ void __launch_bounds__(kOneWarp ? 32 : kMaxThreads)
    rnnt_alpha_kernel(const float* __restrict__ sk, float* __restrict__ tape,
                      float* __restrict__ rcum, int n_seq, int t_max,
                      int up) {
  extern __shared__ __align__(16) float smem[];
  const int n = blockIdx.x;
  const int d_total = t_max + up - 1;
  const Slots sl = slot_layout<R>(smem);
  const float* skb = sk + (size_t)n * d_total * up;
  const float* skl = skb + (size_t)n_seq * d_total * up;
  int ib[R], il[R];  // the lanes' (clamped) indices into the rows
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int u = lane_u<R>(j);
    ib[j] = min(u, up - 1);
    il[j] = min(max(u - 1, 0), up - 1);
  }
  // diagonal dd's entries into ring stage s: b[dd-1-u, u] = skb[dd-1, u],
  // l[dd-u, u-1] = skl[dd-1, u-1]
  auto copy = [&](int dd, int s) {
    const unsigned st = sl.slot + s * sl.stage;
    const size_t row = (size_t)max(dd - 1, 0) * up;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      cp_async4(st + j * sl.entry, skb + row + ib[j]);
      cp_async4(st + (R + j) * sl.entry, skl + row + il[j]);
    }
  };
#pragma unroll
  for (int s = 0; s < D - 1; ++s) {
    copy(min(1 + s, d_total - 1), s);
    cp_async_commit();
  }
  float a[R], p[R];  // alpha at the lanes and at u-1, renormalised
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int u = lane_u<R>(j);
    a[j] = u == 0 ? 0.0f : kLog0;
    p[j] = u == 1 ? 0.0f : kLog0;
    if (u < up) tape[(size_t)n * up + u] = a[j];
  }
  if (threadIdx.x == 0) rcum[n] = 0.0f;
  // the entries of diagonal d (d = 1 first), read a diagonal ahead: the
  // copies of d + 1 were started D - 2 diagonals before d
  float eb[R], el[R];
  auto read = [&](int s) {
    cp_async_wait<D - 2>();
#pragma unroll
    for (int j = 0; j < R; ++j) {
      eb[j] = ld_shared(sl.slot + s * sl.stage + j * sl.entry);
      el[j] = ld_shared(sl.slot + s * sl.stage + (R + j) * sl.entry);
    }
  };
  read(0);
  float r = 0.0f;
  for (int d = 1; d < d_total; ++d) {  // diagonal d from d-1's row and planes
    copy(min(d + D - 1, d_total - 1), (d + D - 2) % D);
    cp_async_commit();
    float x[R];
    float lmax = kLog0;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int u = lane_u<R>(j);
      const float v = logaddexp2(a[j] + eb[j],
                                 p[j] + (u >= 1 ? el[j] : kLog0));
      x[j] = u < up ? v : kLog0;
      lmax = fmaxf(lmax, x[j]);
    }
    read(d % D);
    float xn[R], edge;
    lmax = row_max<R, kOneWarp, true>(lmax, x, sl.red, d, edge);
    lower_neighbours(x, xn, edge);
    const float m = renorm_shift(lmax);
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int u = lane_u<R>(j);
      a[j] = fmaxf(x[j] - m, kLog0);
      p[j] = u == 0 ? kLog0 : fmaxf(xn[j] - m, kLog0);
    }
    r = r + m;
    store_row(tape, rcum, a, r, d, n_seq, n, up);
  }
  cp_async_wait<0>();
}

// K9's beta wavefront, K8's mirror: d walks downwards from beta(D) = log
// zero, the terminal blank injected at (il-1, ul) on d's scale.  Writes the
// beta tape btape (D, N, Up) (row d: beta on diagonal d, renormalised) and
// its offsets brcum (D, N); grid, ring and shared memory as K8's.
template <int R, int D, bool kOneWarp>
__global__ void __launch_bounds__(kOneWarp ? 32 : kMaxThreads)
    rnnt_beta_kernel(const float* __restrict__ sk,
                     const int* __restrict__ il_arr,
                     const int* __restrict__ ul_arr,
                     float* __restrict__ btape, float* __restrict__ brcum,
                     int n_seq, int t_max, int up) {
  extern __shared__ __align__(16) float smem[];
  const int n = blockIdx.x;
  const int d_total = t_max + up - 1;
  const Slots sl = slot_layout<R>(smem);
  const float* skb = sk + (size_t)n * d_total * up;
  const float* skl = skb + (size_t)n_seq * d_total * up;
  int ix[R];  // the lanes' (clamped) indices into the rows
#pragma unroll
  for (int j = 0; j < R; ++j) ix[j] = min(lane_u<R>(j), up - 1);
  // diagonal dd's entries into ring stage s: b[dd-u, u], l[dd-u, u]
  auto copy = [&](int dd, int s) {
    const unsigned st = sl.slot + s * sl.stage;
    const size_t row = (size_t)dd * up;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      cp_async4(st + j * sl.entry, skb + row + ix[j]);
      cp_async4(st + (R + j) * sl.entry, skl + row + ix[j]);
    }
  };
#pragma unroll
  for (int s = 0; s < D - 1; ++s) {
    copy(max(d_total - 1 - s, 0), s);
    cp_async_commit();
  }
  const int d_term = il_arr[n] - 1 + ul_arr[n];
  const int u_term = ul_arr[n];
  float bn[R], bs[R];  // beta(d+1) at the lanes and at u+1, renormalised
#pragma unroll
  for (int j = 0; j < R; ++j) bn[j] = bs[j] = kLog0;
  // the entries of the k-th diagonal d = D-1-k, read a diagonal ahead
  float eb[R], el[R];
  auto read = [&](int s) {
    cp_async_wait<D - 2>();
#pragma unroll
    for (int j = 0; j < R; ++j) {
      eb[j] = ld_shared(sl.slot + s * sl.stage + j * sl.entry);
      el[j] = ld_shared(sl.slot + s * sl.stage + (R + j) * sl.entry);
    }
  };
  read(0);
  float r_next = 0.0f;  // beta(d+1)'s offset
  for (int d = d_total - 1, k = 0; d >= 0; --d, ++k) {
    copy(max(d - D + 1, 0), (k + D - 1) % D);
    cp_async_commit();
    float x[R];
    float lmax = kLog0;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int u = lane_u<R>(j);
      float v = logaddexp2(eb[j] + bn[j], el[j] + bs[j]);
      // logaddexp2(v, log zero) is v to the bit (v is never -0): only the
      // terminal node takes the second one
      if (d == d_term && u == u_term) v = logaddexp2(v, eb[j] - r_next);
      x[j] = u < up ? v : kLog0;
      lmax = fmaxf(lmax, x[j]);
    }
    read((k + 1) % D);
    float xn[R], edge;
    lmax = row_max<R, kOneWarp, false>(lmax, x, sl.red, d, edge);
    if (k > 0) store_row(btape, brcum, bn, r_next, d + 1, n_seq, n, up);
    upper_neighbours(x, xn, edge);
    const float m = renorm_shift(lmax);
#pragma unroll
    for (int j = 0; j < R; ++j) {
      bn[j] = fmaxf(x[j] - m, kLog0);
      bs[j] = fmaxf(xn[j] - m, kLog0);
    }
    r_next = r_next + m;
  }
  store_row(btape, brcum, bn, r_next, 0, n_seq, n, up);
  cp_async_wait<0>();
}

// K9's posteriors, every node at once: a thread a (n, d, u) of the skewed
// lattice (u fastest, so the tapes and the skewed planes are read
// coalesced), in rnnt_loss_plain.posteriors' order, written to the
// unskewed (N, T, Up) outputs at t = d - u (0 at t >= il).  Blocks (n, d)
// of 128 threads a block stride apart over a 1-D grid of x, and ceil(Up /
// 128) of y.
__global__ void __launch_bounds__(128)
    rnnt_post_kernel(const float* __restrict__ sk,
                     const float* __restrict__ tape,
                     const float* __restrict__ rcum,
                     const float* __restrict__ btape,
                     const float* __restrict__ brcum,
                     const int* __restrict__ il_arr,
                     const int* __restrict__ ul_arr,
                     const float* __restrict__ z_small,
                     const float* __restrict__ z_off, float* __restrict__ gb,
                     float* __restrict__ gl, int n_seq, int t_max, int up) {
  const int d_total = t_max + up - 1;
  const int u = blockIdx.y * blockDim.x + threadIdx.x;
  for (long b = blockIdx.x; b < (long)n_seq * d_total; b += gridDim.x) {
    const int d = (int)(b % d_total), n = (int)(b / d_total);
    const int t = d - u;
    if (u >= up || t < 0 || t >= t_max) continue;
    const size_t o = ((size_t)n * t_max + t) * up + u;
    const int il = il_arr[n];
    if (t >= il) {
      gb[o] = gl[o] = 0.0f;
      continue;
    }
    const bool last = d + 1 == d_total;
    const size_t nx = ((size_t)(d + 1) * n_seq + n) * up + u;
    const float b_nx = last ? kLog0 : btape[nx];
    const float lab_succ = last || u + 1 == up ? kLog0 : btape[nx + 1];
    const float r_next = last ? 0.0f : brcum[(size_t)(d + 1) * n_seq + n];
    const float ar = rcum[(size_t)d * n_seq + n];
    const float zo = z_off[n];
    const float off = (ar + r_next) - zo;
    const float off_term = ar - zo;
    const bool is_term = d == il - 1 + ul_arr[n] && u == ul_arr[n];
    const float small = tape[((size_t)d * n_seq + n) * up + u] - z_small[n];
    const size_t e = ((size_t)n * d_total + d) * up + u;
    const float skb = sk[e];
    const float skl = sk[e + (size_t)n_seq * d_total * up];
    const float lg_b = ((small + skb) + (is_term ? 0.0f : b_nx)) +
                       (is_term ? off_term : off);
    const float lg_l = ((small + skl) + lab_succ) + off;
    gb[o] = lg_b > kLog0Threshold ? expf(fminf(lg_b, 0.0f)) : 0.0f;
    gl[o] = lg_l > kLog0Threshold ? expf(fminf(lg_l, 0.0f)) : 0.0f;
  }
}

// Past the register plan's lanes: the rows in shared memory, thread i owns
// the lanes u = i + k blockDim; a block max of two barriers a diagonal.

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

// plane[n, t, u], log-zero outside 0 <= t < T.
__device__ __forceinline__ float plane_at(const float* p, int t, int u,
                                          int t_max, int up) {
  return (t >= 0 && t < t_max) ? __ldg(p + (size_t)t * up + u) : kLog0;
}

// K8 with the rows in shared memory: a[Up + 1] (a[u + 1] = lane u, a[0] a
// log-zero pad), buf[Up], red[32].
__global__ void rnnt_alpha_rows_kernel(const float* __restrict__ b_pl,
                                       const float* __restrict__ l_pl,
                                       float* __restrict__ tape,
                                       float* __restrict__ rcum, int n_seq,
                                       int t_max, int up) {
  extern __shared__ __align__(16) float smem[];
  const int n = blockIdx.x;
  const int d_total = t_max + up - 1;
  float* a = smem;
  float* buf = a + up + 1;
  float* red = buf + up;
  const float* bp = b_pl + (size_t)n * t_max * up;
  const float* lp = l_pl + (size_t)n * t_max * up;
  for (int u = threadIdx.x; u < up + 1; u += blockDim.x) {
    a[u] = u == 1 ? 0.0f : kLog0;
    if (u < up) tape[(size_t)n * up + u] = u == 0 ? 0.0f : kLog0;
  }
  if (threadIdx.x == 0) rcum[n] = 0.0f;
  __syncthreads();
  float r = 0.0f;
  for (int d = 1; d < d_total; ++d) {
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

// K9 with the rows in shared memory: bn[Up + 1] (beta(d+1), bn[Up] a
// log-zero pad), buf[Up], red[32].
__global__ void rnnt_post_rows_kernel(
    const float* __restrict__ b_pl, const float* __restrict__ l_pl,
    const float* __restrict__ tape, const float* __restrict__ rcum,
    const int* __restrict__ il_arr, const int* __restrict__ ul_arr,
    const float* __restrict__ z_small, const float* __restrict__ z_off,
    float* __restrict__ gb, float* __restrict__ gl, int n_seq, int t_max,
    int up) {
  extern __shared__ __align__(16) float smem[];
  const int n = blockIdx.x;
  const int d_total = t_max + up - 1;
  float* bn = smem;
  float* buf = bn + up + 1;
  float* red = buf + up;
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
  float r_next = 0.0f;
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

// The launch plan of rnnt_loss_cuda.wavefront_plan at Up lanes: R lanes a
// thread, the fewest of 1, 2, 4, 8 that fit 1024 threads, over whole warps
// (ceil(ceil(Up / R) / 32)), a ring of kRing diagonals (2 at 8 lanes) and
// shared bytes 4 (8 warps + ring 2R 32 warps): the slot row and the ring.
// Past 8192 lanes the rows in shared memory: lanes 0, 32 warps, ring 0,
// 4 (2 Up + 33) bytes.
bool plan_holds(int up, int lanes, int warps, int ring, int smem) {
  long bytes = 4 * (2 * (long)up + 33);
  int r = 0, w = 32, d = 0;
  if (up <= kMaxThreads * kMaxLanes) {
    r = 1;
    while ((up + r - 1) / r > kMaxThreads) r *= 2;
    w = ((up + r - 1) / r + 31) / 32;
    d = r < kMaxLanes ? kRing : 2;
    bytes = 4 * (8L * w + (long)d * 2 * r * 32 * w);
  }
  return up >= 1 && lanes == r && warps == w && ring == d && smem == bytes &&
         bytes <= kSmemLimit;
}

cudaError_t set_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

struct Launch {
  int n_seq, t_max, up, threads, smem;
  cudaStream_t stream;
};

// One block a sequence of l.threads threads and l.smem bytes.
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, const Launch& l, Args... args) {
  cudaError_t err = set_smem((const void*)kernel, l.smem);
  if (err != cudaSuccess) return err;
  kernel<<<l.n_seq, l.threads, l.smem, l.stream>>>(args..., l.n_seq, l.t_max,
                                                   l.up);
  return cudaGetLastError();
}

// A 1-D grid of `blocks` blocks, at most INT_MAX (the kernel strides).
unsigned grid_1d(long blocks) {
  return (unsigned)(blocks < INT_MAX ? blocks : INT_MAX);
}

cudaError_t skew(const float* b_pl, const float* l_pl, float* sk,
                 const Launch& l) {
  const long tiles =
      2L * l.n_seq * ((l.t_max + l.up + 30) / 32) * ((l.up + 31) / 32);
  rnnt_skew_kernel<<<grid_1d(tiles), dim3(32, 8), 0, l.stream>>>(
      b_pl, l_pl, sk, l.n_seq, l.t_max, l.up);
  return cudaGetLastError();
}

// The register kernels' instantiation for the plan's lanes (one warp: 1).
template <template <int, int, bool> class K>
auto pick(int lanes, bool one_warp) {
  if (one_warp) return K<1, kRing, true>::fn();
  switch (lanes) {
    case 1: return K<1, kRing, false>::fn();
    case 2: return K<2, kRing, false>::fn();
    case 4: return K<4, kRing, false>::fn();
    default: return K<kMaxLanes, 2, false>::fn();
  }
}

template <int R, int D, bool W>
struct Alpha {
  static auto fn() { return &rnnt_alpha_kernel<R, D, W>; }
};

template <int R, int D, bool W>
struct Beta {
  static auto fn() { return &rnnt_beta_kernel<R, D, W>; }
};

}  // namespace

// K8 with the plan (lanes a thread, warps, ring depth, shared bytes) of
// rnnt_loss_cuda.wavefront_plan; cudaErrorInvalidConfiguration if the plan
// does not hold.  work: the skewed planes, 2 N D Up floats (none with the
// rows in shared memory).
extern "C" int e2e_rnnt_alpha_f32(const void* b_pl, const void* l_pl,
                                  void* work, void* tape, void* rcum,
                                  int n_seq, int t_max, int up, int lanes,
                                  int warps, int ring, int smem,
                                  void* stream) {
  if (!plan_holds(up, lanes, warps, ring, smem))
    return (int)cudaErrorInvalidConfiguration;
  if (n_seq <= 0 || t_max <= 0) return (int)cudaGetLastError();
  const Launch l{n_seq, t_max, up, 32 * warps, smem, (cudaStream_t)stream};
  const auto b = (const float*)b_pl, lp = (const float*)l_pl;
  const auto sk = (float*)work, tp = (float*)tape, rc = (float*)rcum;
  if (lanes == 0) return (int)launch(rnnt_alpha_rows_kernel, l, b, lp, tp, rc);
  cudaError_t err = skew(b, lp, sk, l);
  if (err != cudaSuccess) return (int)err;
  return (int)launch(pick<Alpha>(lanes, warps == 1), l,
                     (const float*)sk, tp, rc);
}

// K9 with the plan of K8's launch.  work: the beta tape (D N Up), its
// offsets (D N), then the skewed planes: 3 N D Up + D N floats
// (none with the rows in shared memory).
extern "C" int e2e_rnnt_post_f32(const void* b_pl, const void* l_pl,
                                 const void* tape, const void* rcum,
                                 const void* il, const void* ul,
                                 const void* z_small, const void* z_off,
                                 void* gb, void* gl, void* work, int n_seq,
                                 int t_max, int up, int lanes, int warps,
                                 int ring, int smem, void* stream) {
  if (!plan_holds(up, lanes, warps, ring, smem))
    return (int)cudaErrorInvalidConfiguration;
  if (n_seq <= 0 || t_max <= 0) return (int)cudaGetLastError();
  const Launch l{n_seq, t_max, up, 32 * warps, smem, (cudaStream_t)stream};
  const auto b = (const float*)b_pl, lp = (const float*)l_pl;
  const auto ilp = (const int*)il, ulp = (const int*)ul;
  const auto zs = (const float*)z_small, zo = (const float*)z_off;
  const auto tp = (const float*)tape, rc = (const float*)rcum;
  if (lanes == 0)
    return (int)launch(rnnt_post_rows_kernel, l, b, lp, tp, rc, ilp, ulp, zs,
                       zo, (float*)gb, (float*)gl);
  const size_t cells = (size_t)n_seq * (t_max + up - 1) * up;
  float* btape = (float*)work;
  float* brcum = btape + cells;
  const auto sk = brcum + cells / up;
  cudaError_t err = skew(b, lp, sk, l);
  if (err == cudaSuccess)
    err = launch(pick<Beta>(lanes, warps == 1), l, (const float*)sk, ilp,
                 ulp, btape, brcum);
  if (err != cudaSuccess) return (int)err;
  const dim3 blocks(grid_1d((long)n_seq * (t_max + up - 1)), (up + 127) / 128);
  rnnt_post_kernel<<<blocks, 128, 0, l.stream>>>(
      sk, tp, rc, btape, brcum, ilp, ulp, zs, zo, (float*)gb, (float*)gl,
      n_seq, t_max, up);
  return (int)cudaGetLastError();
}
