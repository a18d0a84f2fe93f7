// The wmma forward kernel of the fused transducer joint (K10, K10tp with
// `raw`) that csrc/rnnt_joint.cu's wgmma K10 replaced, kept verbatim as the
// baseline of its A/B timings (chip_smoke.py phases 20 and 25,
// tools/joint_fwd_breakdown.py); never part of the kernel library.  One
// addition beside the verbatim kernel: e2e_rnnt_joint_fwd_plan, its
// resources for the timings' launch line.
//
// 256 threads (8 warps), 64 rows x 128 columns per step: the logits tile
// by nvcuda::wmma (bf16 16x16x16 fragments) into a float32 tile in shared
// memory, read back by the epilogue (thread -> row tid/4, columns tid%4 +
// 4i), each thread's online (max, sum-exp) over its 32 columns of a tile,
// the row's four threads combined at the end; W and the bias copied by all
// threads between barriers, three a tile; two blocks per SM.  J > 128
// walks J in 128-row slabs through the same tiles.  Signature:
// e2e_rnnt_joint_fwd(h, w, b, y, b_pl, l_pl, m, logs, R, J, V, Vp, blank,
// raw, stream), h (R, J) bf16, w (J, Vp) bf16 zero past V, b (V,) float32.

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
constexpr int kWld = kTile + kPad;    // W tile row stride (bf16)
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
  static constexpr size_t b_bytes = (size_t)kTile * 4;
  // every region starts 32-byte aligned, as wmma needs
  static constexpr size_t fwd = h_bytes + w_bytes + x_bytes + b_bytes;
};

struct Smem {
  bf16* h;
  bf16* w;
  float* x;
  float* bias;
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

// The number of 16-wide J slabs the kernels are built for: 1, 2, 4 or 8
// (J <= 128; wider J runs the WIDE kernels with 8).
int slabs_for(int J) {
  int nj = 1;
  while (16 * nj < J) nj *= 2;
  return nj;
}

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

// The kernel's resources at this J: info[0] resident blocks per SM, [1]
// registers per thread, [2] dynamic shared memory bytes, [3] local
// (spilled) bytes per thread, [4] stages (0: no ring), [5] 0 (h never
// streams).
template <int NJ, bool WIDE>
cudaError_t fwd_plan(int* info) {
  const size_t smem = Layout<NJ>::fwd;
  const void* kernel = (const void*)rnnt_joint_fwd_kernel<NJ, WIDE>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[0], kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  info[1] = attr.numRegs;
  info[2] = (int)smem;
  info[3] = (int)attr.localSizeBytes;
  info[4] = 0;
  info[5] = 0;
  return err;
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

extern "C" int e2e_rnnt_joint_fwd_plan(int J, int* info) {
  if (J > kSlab) return (int)fwd_plan<8, true>(info);
  switch (slabs_for(J)) {
    case 1: return (int)fwd_plan<1, false>(info);
    case 2: return (int)fwd_plan<2, false>(info);
    case 4: return (int)fwd_plan<4, false>(info);
    case 8: return (int)fwd_plan<8, false>(info);
  }
  return (int)cudaErrorInvalidValue;
}
