// The online-softmax fused transducer joint on Hopper: the forward (K10),
// the activation gradient dh (K11) and the output-projection gradients dW,
// db (K12), bf16 tensor-core products with float32 sums; and their
// vocabulary-sharded modes K10tp, K11tp, K12tp.
//
// Replaces: end2end_tpu/ops/rnnt_joint_pallas.py::_fwd_kernel (K10, launched
// at :223), ::_dh_kernel (K11, :257), ::_dw_kernel (K12, :271), and
// ::_fwd_kernel_tp (K10tp, :513), ::_dh_kernel_tp (K11tp, :563),
// ::_dw_kernel_tp (K12tp, :577).  Plain versions:
// end2end_tpu_torch/ops/rnnt_joint_plain.py (joint_fwd, joint_dh, joint_dw
// and their _tp twins).
//
// The TP modes are the same kernels on one shard's (J, V/D) slice of W: the
// blank and label ids are shard-relative, -1 where another shard owns the
// column (the run-time compares `col == id` then match nothing), and K10
// with `raw` set stores the raw blank and label logits (0 when unowned) and
// the shard's local m and log s instead of the planes; the caller combines
// them across shards.  K11 and K12 take the global (m, log s) unchanged and
// give the shard's partial dh and its own dW, db columns.  K12tp keeps one
// block per 128-column tile of the shard: at the bench row's V/D = 8192
// that is 64 blocks on the 132 SMs, and the card is half idle.
//
// Semantics (the JAX package's): rows of the activation h (R, J) are
// independent.  Per row, logits x = h W + b over V columns; K10 keeps an
// online max m and sum-exp s and picks the blank column and the row's label
// column y, emitting b_pl = (x_blank - m) - log s, l_pl = (x_y - m) - log s,
// m and log s: 4 floats a row instead of V.  K11 and K12 recompute the
// logits and form the gradient of (b_pl, l_pl) weighted by their
// cotangents, d = gb 1[blank] + gl 1[y] - p (gb + gl), p = exp(x - m -
// log s); K11 sums dh = bf16(d) W^T, K12 dW = bf16(h)^T bf16(d) and
// db = sum of the float32 d.  h and W enter the products as bf16 (the
// wrapper rounds them once per call); the (R, V) logits never reach device
// memory.
//
// What bounds it on the H100, at the JAX bench row (B=8, T=400, U=80,
// V=32768, J=128: R = 259,200 rows): K10 does 2 R J V = 2.17e12 bf16
// tensor-core operations and R V = 8.5e9 exps; K11 and K12 each do 4.35e12
// operations and 8.5e9 exps.  They move only h (66 MB bf16), W (8 MB), the
// row statistics and their outputs, 0.1-0.3 GB.  So they are bound by the
// tensor cores (2.2 ms for K10, 4.4 ms for K11 and K12 at 989 TFLOP/s) and
// the exp unit (~2 ms at 16 exps per SM per clock), not by bytes.
//
// Design: 256 threads (8 warps), 64 rows x 128 columns per step.  The
// products run on the tensor cores through nvcuda::wmma (bf16 16x16x16
// fragments, float32 accumulators): a warp owns a 16-row slab and four of
// the eight 16-column slabs of the logits tile.  The accumulators go to a
// float32 tile in shared memory, where the epilogue reads them with the
// layout thread -> (row tid/4, columns tid%4 + 4i), conflict-free.  K10
// keeps each thread's own online (max, sum-exp) over its 32 columns of
// every tile, so a tile needs no cross-thread reduction; the four threads
// of a row combine once at the end.  K11 writes d as a bf16 tile and
// multiplies it by the W tile read back col_major (W^T for free); K12 reads
// the h tile col_major (h^T).  J is padded with zeros to 16, 32, 64 or 128
// in shared memory only (a template on the number of 16-wide slabs).  J >
// 128 walks J in slabs of 128 rows through the same shared tiles (WIDE):
// K10 streams h and W slab by slab into one set of logits fragments; K11
// and K12, whose (64, J) and (J, 128) float32 accumulators would not fit in
// registers, get a second grid dimension over the slabs, each block
// recomputing the logits over the whole J and accumulating only its own
// slab (J/128 times the logits work).  The TPU's sequential K12 grid (V
// tile outer, row block inner, sums carried in scratch) becomes one block
// per V tile that loops over every row block itself: deterministic, no
// atomics.  W streams tile by tile from L2 (8 MB of bf16 at the bench row).
// Shared memory: h tile 17 KB, W tile 34 KB, logits 33 KB, d tile 17 KB,
// two blocks per SM.  __expf (ex2.approx) for the exps: its ~1e-6 relative
// error is noise against the bf16 rounding of h and W.  A first design:
// no cp.async/TMA pipelining and no wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kRows = 64;             // rows of h per step
constexpr int kTile = 128;            // vocabulary columns per tile
constexpr int kThreads = 256;         // 8 warps
constexpr int kPad = 8;               // bf16 row pad: 16 bytes
constexpr int kWld = kTile + kPad;    // W tile / d tile row stride (bf16)
constexpr int kXld = kTile + 4;       // logits tile row stride (float)
constexpr int kPerThread = kTile / 4; // columns of a tile per thread
constexpr int kSlab = 128;            // J rows per slab when J > 128
constexpr float kNeg = -3.0e38f;      // the running max's identity

template <int NJ>
struct Layout {
  static constexpr int JP = 16 * NJ;        // padded J
  static constexpr int HLD = JP + kPad;     // h tile row stride (bf16)
  static constexpr size_t h_bytes = (size_t)kRows * HLD * 2;
  static constexpr size_t w_bytes = (size_t)JP * kWld * 2;
  static constexpr size_t x_bytes = (size_t)kRows * kXld * 4;
  static constexpr size_t d_bytes = (size_t)kRows * kWld * 2;
  static constexpr size_t b_bytes = (size_t)kTile * 4;
  // every region starts 32-byte aligned, as wmma needs
  static constexpr size_t fwd = h_bytes + w_bytes + x_bytes + b_bytes;
  static constexpr size_t bwd = fwd + d_bytes;
};

struct Smem {
  bf16* h;
  bf16* w;
  float* x;
  float* bias;
  bf16* d;
};

template <int NJ>
__device__ __forceinline__ Smem carve(unsigned char* base) {
  using L = Layout<NJ>;
  Smem s;
  s.h = reinterpret_cast<bf16*>(base);
  s.w = reinterpret_cast<bf16*>(base + L::h_bytes);
  s.x = reinterpret_cast<float*>(base + L::h_bytes + L::w_bytes);
  s.bias = reinterpret_cast<float*>(base + L::h_bytes + L::w_bytes +
                                    L::x_bytes);
  s.d = reinterpret_cast<bf16*>(base + L::fwd);
  return s;
}

// Zero the pad columns J..JP-1 of the h tile and the pad rows J..JP-1 of
// the W tile; the loads below never write them.
template <int NJ>
__device__ void zero_pads(const Smem& s, int J) {
  using L = Layout<NJ>;
  const bf16 z = __float2bfloat16(0.0f);
  const int hp = L::JP - J;
  for (int i = threadIdx.x; i < kRows * hp; i += kThreads)
    s.h[(i / hp) * L::HLD + J + i % hp] = z;
  for (int i = threadIdx.x; i < hp * kWld; i += kThreads)
    s.w[J * kWld + i] = z;
}

// Columns j0..j0+jn-1 of rows r0..r0+63 of the bf16 h (R, J) into columns
// 0..jn-1 of the h tile; rows >= R as zeros.
template <int NJ>
__device__ void load_h(const bf16* __restrict__ h, const Smem& s, long r0,
                       long R, int J, int j0, int jn) {
  using L = Layout<NJ>;
  if (J % 8 == 0) {  // 16-byte vectors (j0 and jn are multiples of 8 too)
    const int per_row = jn / 8;
    for (int i = threadIdx.x; i < kRows * per_row; i += kThreads) {
      const int r = i / per_row, q = i % per_row;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r0 + r < R)
        v = *reinterpret_cast<const uint4*>(h + (r0 + r) * J + j0 + q * 8);
      *reinterpret_cast<uint4*>(s.h + r * L::HLD + q * 8) = v;
    }
  } else {
    for (int i = threadIdx.x; i < kRows * jn; i += kThreads) {
      const int r = i / jn, j = i % jn;
      s.h[r * L::HLD + j] =
          r0 + r < R ? h[(r0 + r) * J + j0 + j] : __float2bfloat16(0.0f);
    }
  }
}

// Rows j0..j0+jn-1 of the bf16 W (J, Vp) (zero past V), columns c0..c0+127,
// into rows 0..jn-1 of the W tile.
__device__ void load_w(const bf16* __restrict__ w, const Smem& s, int c0,
                       int j0, int jn, int Vp) {
  for (int i = threadIdx.x; i < jn * (kTile / 8); i += kThreads) {
    const int j = i / (kTile / 8), q = i % (kTile / 8);
    *reinterpret_cast<uint4*>(s.w + j * kWld + q * 8) =
        *reinterpret_cast<const uint4*>(w + (size_t)(j0 + j) * Vp + c0 +
                                        q * 8);
  }
}

// The bias of columns c0..c0+127 (0 past V).
__device__ void load_bias(const float* __restrict__ b, const Smem& s, int c0,
                          int V) {
  for (int c = threadIdx.x; c < kTile; c += kThreads)
    s.bias[c] = c0 + c < V ? b[c0 + c] : 0.0f;
}

using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// acc += the h tile's NJ 16-wide slabs times the W tile's.  Warp w owns
// rows 16 (w % 4).. and column slabs w / 4 + 2i, i < 4, of the 64 x 128
// logits tile.
template <int NJ>
__device__ __forceinline__ void logits_mma(const Smem& s, Acc (&acc)[4]) {
  using L = Layout<NJ>;
  const int warp = threadIdx.x / 32;
  const int rm = warp % 4;
#pragma unroll
  for (int k = 0; k < NJ; ++k) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::load_matrix_sync(a, s.h + rm * 16 * L::HLD + k * 16, L::HLD);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bw;
      wmma::load_matrix_sync(bw, s.w + k * 16 * kWld + (warp / 4 + 2 * i) * 16,
                             kWld);
      wmma::mma_sync(acc[i], a, bw, acc[i]);
    }
  }
}

__device__ __forceinline__ void store_logits(const Smem& s, Acc (&acc)[4]) {
  const int warp = threadIdx.x / 32;
  const int rm = warp % 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    wmma::store_matrix_sync(s.x + rm * 16 * kXld + (warp / 4 + 2 * i) * 16,
                            acc[i], kXld, wmma::mem_row_major);
}

// The 64 x 128 logits tile h W (without the bias) into s.x, from the h and
// W tiles in shared memory (J <= 128).
template <int NJ>
__device__ void logits_tile(const Smem& s) {
  Acc acc[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) wmma::fill_fragment(acc[i], 0.0f);
  logits_mma<NJ>(s, acc);
  store_logits(s, acc);
}

// The same for J > 128, and the bias of the tile: rows r0.. of h and
// columns c0.. of W stream through the h and W tiles one 128-row J slab at
// a time, in slab order, the products accumulating in one set of fragments.
// Begins with a barrier (the previous tile's reads of every shared region
// are done); the caller's next barrier publishes s.x.  Afterwards the h
// and W tiles hold the last slab.
__device__ void logits_tile_wide(const bf16* __restrict__ h,
                                 const bf16* __restrict__ w,
                                 const float* __restrict__ b, const Smem& s,
                                 long r0, long R, int J, int c0, int V,
                                 int Vp) {
  Acc acc[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) wmma::fill_fragment(acc[i], 0.0f);
  for (int j0 = 0; j0 < J; j0 += kSlab) {
    const int jn = min(kSlab, J - j0);
    __syncthreads();
    if (j0 == 0) load_bias(b, s, c0, V);
    load_h<8>(h, s, r0, R, J, j0, jn);
    load_w(w, s, c0, j0, jn, Vp);
    if (jn < kSlab) zero_pads<8>(s, jn);  // the previous slab's rows
    __syncthreads();
    logits_mma<8>(s, acc);
  }
  store_logits(s, acc);
}

// The per-row inputs of the backward kernels.
struct RowStats {
  bool live;
  int y;
  float m, logs, gb, gl;
};

__device__ __forceinline__ RowStats row_stats(long row, long R,
                                              const int* __restrict__ y,
                                              const float* __restrict__ m,
                                              const float* __restrict__ logs,
                                              const float* __restrict__ gb,
                                              const float* __restrict__ gl) {
  RowStats st{row < R, -1, 0.0f, 0.0f, 0.0f, 0.0f};
  if (st.live) {
    st.y = y[row];
    st.m = m[row];
    st.logs = logs[row];
    st.gb = gb[row];
    st.gl = gl[row];
  }
  return st;
}

// d of this thread's row at tile column c (0 for dead rows and columns past
// V), in rnnt_joint_plain's order: -p (gb + gl), + gb at blank, + gl at y.
__device__ __forceinline__ float d_value(const Smem& s, const RowStats& st,
                                         int row, int c, int c0, int V,
                                         int blank) {
  const int col = c0 + c;
  if (!st.live || col >= V) return 0.0f;
  const float x = s.x[row * kXld + c] + s.bias[c];
  float d = -__expf((x - st.m) - st.logs) * (st.gb + st.gl);
  if (col == blank) d += st.gb;
  if (col == st.y) d += st.gl;
  return d;
}

// K10 (K10tp with `raw`).  Grid: one block per 64 rows.  Outputs b_pl,
// l_pl, m, logs (R,); with `raw`, the raw blank and label logits in place
// of the planes and the shard's local m, logs.
template <int NJ, bool WIDE>
__global__ void __launch_bounds__(kThreads, 2)
    rnnt_joint_fwd_kernel(const bf16* __restrict__ h,
                          const bf16* __restrict__ w,
                          const float* __restrict__ b,
                          const int* __restrict__ y, float* __restrict__ b_pl,
                          float* __restrict__ l_pl, float* __restrict__ m_out,
                          float* __restrict__ logs_out, long R, int J, int V,
                          int Vp, int blank, int raw) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem s = carve<NJ>(smem);
  const long r0 = (long)blockIdx.x * kRows;
  const int row = threadIdx.x / 4, seg = threadIdx.x % 4;
  const long grow = r0 + row;
  int yr = grow < R ? y[grow] : -1;
  if (yr >= V) yr = -1;  // a label past V matches no column
  if constexpr (!WIDE) {
    zero_pads<NJ>(s, J);
    load_h<NJ>(h, s, r0, R, J, 0, J);
  }
  float m = kNeg, sum = 0.0f, xb = 0.0f, xy = 0.0f;
  for (int c0 = 0; c0 < Vp; c0 += kTile) {
    if constexpr (WIDE) {
      logits_tile_wide(h, w, b, s, r0, R, J, c0, V, Vp);
    } else {
      __syncthreads();  // the previous tile's reads of s.w, s.x are done
      load_w(w, s, c0, 0, J, Vp);
      load_bias(b, s, c0, V);
      __syncthreads();
      logits_tile<NJ>(s);
    }
    __syncthreads();
    float vals[kPerThread];
    float tmax = kNeg;
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int c = seg + 4 * i;
      const float x = c0 + c < V ? s.x[row * kXld + c] + s.bias[c] : kNeg;
      vals[i] = x;
      tmax = fmaxf(tmax, x);
      if (c0 + c == blank) xb = x;
      if (c0 + c == yr) xy = x;
    }
    const float m_new = fmaxf(m, tmax);
    float part = 0.0f;
#pragma unroll
    for (int i = 0; i < kPerThread; ++i)
      if (c0 + seg + 4 * i < V) part += __expf(vals[i] - m_new);
    sum = sum * __expf(m - m_new) + part;
    m = m_new;
  }
  // the four threads of a row (neighbouring lanes) combine their stats
  float mr = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
  mr = fmaxf(mr, __shfl_xor_sync(0xffffffffu, mr, 2));
  float sr = sum * __expf(m - mr);
  sr += __shfl_xor_sync(0xffffffffu, sr, 1);
  sr += __shfl_xor_sync(0xffffffffu, sr, 2);
  xb += __shfl_xor_sync(0xffffffffu, xb, 1);  // one owner, the others 0
  xb += __shfl_xor_sync(0xffffffffu, xb, 2);
  xy += __shfl_xor_sync(0xffffffffu, xy, 1);
  xy += __shfl_xor_sync(0xffffffffu, xy, 2);
  if (seg == 0 && grow < R) {
    const float logs = logf(sr);
    b_pl[grow] = raw ? xb : (xb - mr) - logs;
    l_pl[grow] = raw ? xy : (xy - mr) - logs;
    m_out[grow] = mr;
    logs_out[grow] = logs;
  }
}

// K11.  Grid: one block per 64 rows (x) and, when WIDE, per 128-row J slab
// (y).  Output dh (Rp, ldo) float32, Rp the row count rounded up to 64, ldo
// the padded J (the wrapper slices [:R, :J]).
template <int NJ, bool WIDE>
__global__ void __launch_bounds__(kThreads, 2)
    rnnt_joint_dh_kernel(const bf16* __restrict__ h,
                         const bf16* __restrict__ w,
                         const float* __restrict__ b,
                         const int* __restrict__ y,
                         const float* __restrict__ m,
                         const float* __restrict__ logs,
                         const float* __restrict__ gb,
                         const float* __restrict__ gl, float* __restrict__ dh,
                         long R, int J, int V, int Vp, int blank) {
  using L = Layout<NJ>;
  constexpr int kFrags = (4 * NJ + 7) / 8;  // dh slabs per warp
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem s = carve<NJ>(smem);
  const long r0 = (long)blockIdx.x * kRows;
  const int row = threadIdx.x / 4, seg = threadIdx.x % 4;
  const int warp = threadIdx.x / 32, rm = warp % 4;
  const int js = WIDE ? blockIdx.y : 0, last = (J - 1) / kSlab;
  const int ldo = WIDE ? (last + 1) * kSlab : L::JP;
  const RowStats st = row_stats(r0 + row, R, y, m, logs, gb, gl);
  if constexpr (!WIDE) {
    zero_pads<NJ>(s, J);
    load_h<NJ>(h, s, r0, R, J, 0, J);
  }
  Acc acc[kFrags];
#pragma unroll
  for (int i = 0; i < kFrags; ++i) wmma::fill_fragment(acc[i], 0.0f);
  for (int c0 = 0; c0 < Vp; c0 += kTile) {
    if constexpr (WIDE) {
      logits_tile_wide(h, w, b, s, r0, R, J, c0, V, Vp);
      __syncthreads();
      // the W tile holds the last slab; this block's product needs its own
      if (js != last) load_w(w, s, c0, js * kSlab, kSlab, Vp);
    } else {
      __syncthreads();
      load_w(w, s, c0, 0, J, Vp);
      load_bias(b, s, c0, V);
      __syncthreads();
      logits_tile<NJ>(s);
      __syncthreads();
    }
#pragma unroll 8
    for (int i = 0; i < kPerThread; ++i) {
      const int c = seg + 4 * i;
      s.d[row * kWld + c] =
          __float2bfloat16(d_value(s, st, row, c, c0, V, blank));
    }
    __syncthreads();
    // dh[rm slab, slab nj] += d (64 x 128) W_tile^T (128 x JP)
#pragma unroll
    for (int k = 0; k < kTile / 16; ++k) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, s.d + rm * 16 * kWld + k * 16, kWld);
#pragma unroll
      for (int i = 0; i < kFrags; ++i) {
        const int nj = warp / 4 + 2 * i;
        if (nj < NJ) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> wt;
          wmma::load_matrix_sync(wt, s.w + nj * 16 * kWld + k * 16, kWld);
          wmma::mma_sync(acc[i], a, wt, acc[i]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kFrags; ++i) {
    const int nj = warp / 4 + 2 * i;
    if (nj < NJ)
      wmma::store_matrix_sync(dh + (r0 + rm * 16) * ldo + js * kSlab + nj * 16,
                              acc[i], ldo, wmma::mem_row_major);
  }
}

// K12.  Grid: one block per 128-column V tile (x) and, when WIDE, per
// 128-row J slab (y); the block walks every row block.  Outputs dw (JPad,
// Vp) and db (Vp,) float32, JPad the padded J (the wrapper slices); the
// blocks of slab 0 write db.
template <int NJ, bool WIDE>
__global__ void __launch_bounds__(kThreads, 2)
    rnnt_joint_dw_kernel(const bf16* __restrict__ h,
                         const bf16* __restrict__ w,
                         const float* __restrict__ b,
                         const int* __restrict__ y,
                         const float* __restrict__ m,
                         const float* __restrict__ logs,
                         const float* __restrict__ gb,
                         const float* __restrict__ gl, float* __restrict__ dw,
                         float* __restrict__ db, long R, int J, int V, int Vp,
                         int blank) {
  using L = Layout<NJ>;
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem s = carve<NJ>(smem);
  const int c0 = blockIdx.x * kTile;
  const int row = threadIdx.x / 4, seg = threadIdx.x % 4;
  const int warp = threadIdx.x / 32;  // owns dW column slab `warp`
  const int js = WIDE ? blockIdx.y : 0, last = (J - 1) / kSlab;
  if constexpr (!WIDE) {
    zero_pads<NJ>(s, J);
    load_w(w, s, c0, 0, J, Vp);
    load_bias(b, s, c0, V);
  }
  Acc acc[NJ];
#pragma unroll
  for (int i = 0; i < NJ; ++i) wmma::fill_fragment(acc[i], 0.0f);
  float db_acc = 0.0f;  // column threadIdx.x of the tile (threads < 128)
  for (long r0 = 0; r0 < R; r0 += kRows) {
    const RowStats st = row_stats(r0 + row, R, y, m, logs, gb, gl);
    if constexpr (WIDE) {
      logits_tile_wide(h, w, b, s, r0, R, J, c0, V, Vp);
      __syncthreads();
      // the h tile holds the last slab; this block's product needs its own
      if (js != last) load_h<8>(h, s, r0, R, J, js * kSlab, kSlab);
    } else {
      __syncthreads();  // the previous row block's reads are done
      load_h<NJ>(h, s, r0, R, J, 0, J);
      __syncthreads();
      logits_tile<NJ>(s);
      __syncthreads();
    }
    // d, as float32 over the logits (for db) and as bf16 (for dW)
#pragma unroll 8
    for (int i = 0; i < kPerThread; ++i) {
      const int c = seg + 4 * i;
      const float d = d_value(s, st, row, c, c0, V, blank);
      s.x[row * kXld + c] = d;
      s.d[row * kWld + c] = __float2bfloat16(d);
    }
    __syncthreads();
    if (threadIdx.x < kTile)
      for (int r = 0; r < kRows; ++r) db_acc += s.x[r * kXld + threadIdx.x];
    // dW[slab jm, slab warp] += h^T (JP x 64) d (64 x 128)
#pragma unroll
    for (int k = 0; k < kRows / 16; ++k) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> dfr;
      wmma::load_matrix_sync(dfr, s.d + k * 16 * kWld + warp * 16, kWld);
#pragma unroll
      for (int jm = 0; jm < NJ; ++jm) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> ht;
        wmma::load_matrix_sync(ht, s.h + k * 16 * L::HLD + jm * 16, L::HLD);
        wmma::mma_sync(acc[jm], ht, dfr, acc[jm]);
      }
    }
  }
#pragma unroll
  for (int jm = 0; jm < NJ; ++jm)
    wmma::store_matrix_sync(
        dw + (size_t)(js * kSlab + jm * 16) * Vp + c0 + warp * 16, acc[jm],
        Vp, wmma::mem_row_major);
  if (js == 0 && threadIdx.x < kTile) db[c0 + threadIdx.x] = db_acc;
}

// The number of 16-wide J slabs the kernels are built for: 1, 2, 4 or 8
// (J <= 128; wider J runs the WIDE kernels with 8).
int slabs_for(int J) {
  int nj = 1;
  while (16 * nj < J) nj *= 2;
  return nj;
}

// 128-row J slabs of the WIDE kernels' second grid dimension.
unsigned wide_slabs(int J) { return (unsigned)((J + kSlab - 1) / kSlab); }

cudaError_t set_smem(const void* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int NJ, bool WIDE>
cudaError_t fwd(const void* h, const void* w, const void* b, const void* y,
                void* b_pl, void* l_pl, void* m, void* logs, long R, int J,
                int V, int Vp, int blank, int raw, cudaStream_t stream) {
  const size_t smem = Layout<NJ>::fwd;
  cudaError_t err =
      set_smem((const void*)rnnt_joint_fwd_kernel<NJ, WIDE>, smem);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)((R + kRows - 1) / kRows);
  rnnt_joint_fwd_kernel<NJ, WIDE><<<blocks, kThreads, smem, stream>>>(
      (const bf16*)h, (const bf16*)w, (const float*)b, (const int*)y,
      (float*)b_pl, (float*)l_pl, (float*)m, (float*)logs, R, J, V, Vp,
      blank, raw);
  return cudaGetLastError();
}

template <int NJ, bool WIDE>
cudaError_t dh(const void* h, const void* w, const void* b, const void* y,
               const void* m, const void* logs, const void* gb,
               const void* gl, void* out, long R, int J, int V, int Vp,
               int blank, cudaStream_t stream) {
  const size_t smem = Layout<NJ>::bwd;
  cudaError_t err = set_smem((const void*)rnnt_joint_dh_kernel<NJ, WIDE>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((R + kRows - 1) / kRows),
                  WIDE ? wide_slabs(J) : 1u);
  rnnt_joint_dh_kernel<NJ, WIDE><<<grid, kThreads, smem, stream>>>(
      (const bf16*)h, (const bf16*)w, (const float*)b, (const int*)y,
      (const float*)m, (const float*)logs, (const float*)gb,
      (const float*)gl, (float*)out, R, J, V, Vp, blank);
  return cudaGetLastError();
}

template <int NJ, bool WIDE>
cudaError_t dw(const void* h, const void* w, const void* b, const void* y,
               const void* m, const void* logs, const void* gb,
               const void* gl, void* dw_out, void* db_out, long R, int J,
               int V, int Vp, int blank, cudaStream_t stream) {
  const size_t smem = Layout<NJ>::bwd;
  cudaError_t err = set_smem((const void*)rnnt_joint_dw_kernel<NJ, WIDE>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(Vp / kTile), WIDE ? wide_slabs(J) : 1u);
  rnnt_joint_dw_kernel<NJ, WIDE><<<grid, kThreads, smem, stream>>>(
      (const bf16*)h, (const bf16*)w, (const float*)b, (const int*)y,
      (const float*)m, (const float*)logs, (const float*)gb,
      (const float*)gl, (float*)dw_out, (float*)db_out, R, J, V, Vp, blank);
  return cudaGetLastError();
}

}  // namespace

// h (R, J) bf16, w (J, Vp) bf16 zero past V, b (V,) f32, y (R,) i32;
// Vp a multiple of 128, J >= 1, -1 <= blank < V (-1, and labels outside
// [0, V), match no column).  raw = 0: b_pl, l_pl are the planes; raw = 1
// (K10tp): the raw blank and label logits.
extern "C" int e2e_rnnt_joint_fwd(const void* h, const void* w, const void* b,
                                  const void* y, void* b_pl, void* l_pl,
                                  void* m, void* logs, long long R, int J,
                                  int V, int Vp, int blank, int raw,
                                  void* stream) {
  if (R <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  if (J > kSlab)
    return (int)fwd<8, true>(h, w, b, y, b_pl, l_pl, m, logs, R, J, V, Vp, blank, raw, st);
  switch (slabs_for(J)) {
    case 1: return (int)fwd<1, false>(h, w, b, y, b_pl, l_pl, m, logs, R, J, V, Vp, blank, raw, st);
    case 2: return (int)fwd<2, false>(h, w, b, y, b_pl, l_pl, m, logs, R, J, V, Vp, blank, raw, st);
    case 4: return (int)fwd<4, false>(h, w, b, y, b_pl, l_pl, m, logs, R, J, V, Vp, blank, raw, st);
    case 8: return (int)fwd<8, false>(h, w, b, y, b_pl, l_pl, m, logs, R, J, V, Vp, blank, raw, st);
  }
  return (int)cudaErrorInvalidValue;
}

// As e2e_rnnt_joint_fwd, plus m, logs, gb, gl (R,) f32; dh (Rp, JPad) f32,
// JPad = 16, 32, 64, 128 or J rounded up to a multiple of 128.
extern "C" int e2e_rnnt_joint_dh(const void* h, const void* w, const void* b,
                                 const void* y, const void* m,
                                 const void* logs, const void* gb,
                                 const void* gl, void* out, long long R, int J,
                                 int V, int Vp, int blank, void* stream) {
  if (R <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  if (J > kSlab)
    return (int)dh<8, true>(h, w, b, y, m, logs, gb, gl, out, R, J, V, Vp, blank, st);
  switch (slabs_for(J)) {
    case 1: return (int)dh<1, false>(h, w, b, y, m, logs, gb, gl, out, R, J, V, Vp, blank, st);
    case 2: return (int)dh<2, false>(h, w, b, y, m, logs, gb, gl, out, R, J, V, Vp, blank, st);
    case 4: return (int)dh<4, false>(h, w, b, y, m, logs, gb, gl, out, R, J, V, Vp, blank, st);
    case 8: return (int)dh<8, false>(h, w, b, y, m, logs, gb, gl, out, R, J, V, Vp, blank, st);
  }
  return (int)cudaErrorInvalidValue;
}

// As e2e_rnnt_joint_dh; dw (JPad, Vp) and db (Vp,) f32, every element
// written.
extern "C" int e2e_rnnt_joint_dw(const void* h, const void* w, const void* b,
                                 const void* y, const void* m,
                                 const void* logs, const void* gb,
                                 const void* gl, void* dw_out, void* db_out,
                                 long long R, int J, int V, int Vp, int blank,
                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (J > kSlab)
    return (int)dw<8, true>(h, w, b, y, m, logs, gb, gl, dw_out, db_out, R, J, V, Vp, blank, st);
  switch (slabs_for(J)) {
    case 1: return (int)dw<1, false>(h, w, b, y, m, logs, gb, gl, dw_out, db_out, R, J, V, Vp, blank, st);
    case 2: return (int)dw<2, false>(h, w, b, y, m, logs, gb, gl, dw_out, db_out, R, J, V, Vp, blank, st);
    case 4: return (int)dw<4, false>(h, w, b, y, m, logs, gb, gl, dw_out, db_out, R, J, V, Vp, blank, st);
    case 8: return (int)dw<8, false>(h, w, b, y, m, logs, gb, gl, dw_out, db_out, R, J, V, Vp, blank, st);
  }
  return (int)cudaErrorInvalidValue;
}
