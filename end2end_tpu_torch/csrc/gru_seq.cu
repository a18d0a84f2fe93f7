// The transducer predictor's GRU over a whole target sequence on the card:
// the U-step forward recurrence in one persistent launch, and its backward
// recurrence in another, float32.
//
// Replaces no Pallas kernel: the JAX package runs the predictor's U steps
// as a lax.scan of gru_step (end2end_tpu/models/transducer.py::
// ConformerTransducer._pred_states :101-112), which XLA compiles into one
// device loop.  The port's plain path drives the same loop from the host, ~4,900
// small launches and ~1,344 autograd nodes a training step at the
// benchmark's batches.  ops/gru_cuda.py launches these kernels; its plain
// twins are ops/neural_lm.py::gru_seq_forward_plain and
// ::gru_seq_backward_plain, which state the arithmetic below in torch.
//
// The cell (ops/neural_lm.py::gru_step; the reset gate scales h BEFORE the
// candidate's product):
//   z = sigmoid(gx_z + h Wz),  r = sigmoid(gx_r + h Wr),  q = r h,
//   c = tanh(gx_c + q Wh),     h' = (1 - z) h + z c,
// with gx (N, U, 3H) the x-side terms and biases of every step, one matmul
// before the loop, and Wz, Wr, Wh the (H, H) hidden-side rows of the
// (E+H, H) weights (row k an input unit, column j an output unit).
//
// Forward: writes the states (N, U+1, H), h_0 broadcast on every row, and a
// tape (N, U, 4H) of z, r, c and q.  Backward, from the states' cotangent
// dS (N, U+1, H) and a carry g, the gradient of h_{t+1}, starting at
// dS[:, U]; for t = U-1 .. 0:
//   dac = g z (1 - c^2),   daz = g (c - h) z (1 - z),
//   dq = dac Wh^T,         dar = dq h r (1 - r),
//   g <- g (1 - z) + dq r + daz Wz^T + dar Wr^T + dS[:, t];
// writes the pre-activation gradients (daz, dar, dac) into dgx (N, U, 3H)
// and the last carry, the gradient of h_0, into dh (N, H).  The weight,
// bias and embedding gradients are matmuls over all N U rows afterwards.
//
// What bounds it on the H100: 2U grid-wide barriers a direction (the step
// chain: each step needs all of h_t, then all of r h_t, in the forward;
// all of dac, then all of daz and dar, in the backward) and the float32
// FMAs of 3 N H^2 a step on CUDA cores (67 TFLOP/s; no TF32, no tensor
// cores: the configuration is float32).  At the benchmark's batches (N U
// ~1,800 rows, H = 640) the FMAs are ~4.4 GFLOP a direction, ~66 us at the
// peak, and the barriers ~1-2 us each, ~0.5 ms at U = 158.
//
// Design.  One cooperative launch of `slices x groups` blocks, all
// resident at once (one a SM).  A block owns a slice of US output units
// and a group of rows, and keeps its slice of the three hidden-side
// weights in shared memory for the whole loop: the forward the US columns
// of each (transposed, a unit's column contiguous), the backward the US
// rows (so it computes its units' share of the transposed products).  A
// phase stages the rows it reads (h_t, q, dac, or daz | dar side by side)
// from L2 into a shared tile (ld.global.cg: other SMs wrote them, so L1 is
// bypassed), then each warp takes two rows at a time, its lanes split the
// reduction (lane l sums k = l, l+32, ...; one weight load feeds both
// rows), a butterfly of shuffles gives every lane the sums, and lanes
// 0..2US-1 finish one (row, unit) each; they load their own operands
// (x-side terms, gates, carry) before the dots, so those loads wait under
// them.  A grid barrier is a flag a block in device memory, zeroed before
// the launch: a block's thread 0 stores the barrier's number into its own
// flag after a fence, and its warp 0 polls every flag (acquire loads) until
// all hold it, trapping after ~2^35 cycles rather than hang.  The plan
// (gru_cuda.gru_plan) splits the rows into two groups of blocks with twice
// the units wherever they fit, which halves the rows each block stages from
// L2 a phase.
// Every row runs all U steps, padded tokens included.  Sums run in another
// order than cuBLAS's, so the results agree with the loop to float32
// rounding, not to the bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxUnits = 16;  // 2 US <= 32 finishing lanes
constexpr long long kSpinCycles = 1LL << 35;

struct FwdArgs {
  const float* gx;  // (n, u, 3h)
  const float* wz;  // (h, h), hidden-side rows of wz
  const float* wr;
  const float* wh;
  const float* h0;  // (h,)
  float* states;    // (n, u + 1, h)
  float* tape;      // (n, u, 4h): z, r, c, q
  unsigned int* bar;  // a flag a block
  int n, u, h, slices, groups, rows_tile, vec4;
};

struct BwdArgs {
  const float* states;   // (n, u + 1, h)
  const float* tape;     // (n, u, 4h)
  const float* dstates;  // (n, u + 1, h)
  const float* wz;
  const float* wr;
  const float* wh;
  float* dgx;  // (n, u, 3h): daz, dar, dac
  float* dh;   // (n, h): the carry, at the end the gradient of h_0
  unsigned int* bar;
  int n, u, h, slices, groups, rows_tile, vec4;
};

__device__ __forceinline__ unsigned int ld_acquire(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.global.acquire.gpu.b32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Every block stores `epoch` into its own flag, then warp 0 waits until
// every block's flag holds it (flags zeroed before the launch; no two
// blocks write one address, so no atomic queues at one L2 slice).
__device__ __forceinline__ void grid_barrier(unsigned int* flags,
                                             unsigned int epoch) {
  __syncthreads();
  if (threadIdx.x < 32) {
    if (threadIdx.x == 0) {
      __threadfence();
      *reinterpret_cast<volatile unsigned int*>(flags + blockIdx.x) = epoch;
    }
    const long long t0 = clock64();
    bool done;
    do {
      done = true;
      for (unsigned int b = threadIdx.x; b < gridDim.x; b += 32)
        done &= ld_acquire(flags + b) >= epoch;
      if (clock64() - t0 > kSpinCycles) __trap();
    } while (!__all_sync(0xffffffffu, done));
  }
  __syncthreads();
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// store(i, load(i)) for i < total over the block, kBatch loads a thread in
// flight before the first store: a store to shared memory could alias a
// later load through a generic pointer, so a plain loop waits out each
// load's latency in turn.
template <typename T, typename Load, typename Store>
__device__ __forceinline__ void batched(int total, Load load, Store store) {
  constexpr int kBatch = 8;
  for (int base = threadIdx.x; base < total; base += kBatch * blockDim.x) {
    T v[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int i = base + q * blockDim.x;
      if (i < total) v[q] = load(i);
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int i = base + q * blockDim.x;
      if (i < total) store(i, v[q]);
    }
  }
}

// tile[r K + k] = src[(r0 + r) stride + k], r < rows, k < K, through L2.
__device__ __forceinline__ void stage(float* tile, const float* src,
                                      size_t stride, int r0, int rows, int K,
                                      int vec4) {
  if (vec4) {
    const int k4 = K >> 2;
    float4* t4 = reinterpret_cast<float4*>(tile);
    batched<float4>(
        rows * k4,
        [&](int i) {
          const int r = i / k4;
          return __ldcg(reinterpret_cast<const float4*>(
                            src + (size_t)(r0 + r) * stride) + (i - r * k4));
        },
        [&](int i, float4 v) { t4[i] = v; });
  } else {
    batched<float>(
        rows * K,
        [&](int i) {
          const int r = i / K;
          return __ldcg(src + (size_t)(r0 + r) * stride + (i - r * K));
        },
        [&](int i, float v) { tile[i] = v; });
  }
}

// acc[r][c] = sum_k row_r[k] w[c K + k] for two rows, summed over the warp
// (lane l takes k = l, l + 32, ...); every lane ends with every sum.
template <int CW>
__device__ __forceinline__ void warp_dots(const float* ra, const float* rb,
                                          const float* w, int K,
                                          float (&acc)[2][CW]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int c = 0; c < CW; ++c) acc[0][c] = acc[1][c] = 0.0f;
#pragma unroll 4
  for (int k = lane; k < K; k += 32) {
    const float a = ra[k], b = rb[k];
#pragma unroll
    for (int c = 0; c < CW; ++c) {
      const float wv = w[c * K + k];
      acc[0][c] = fmaf(a, wv, acc[0][c]);
      acc[1][c] = fmaf(b, wv, acc[1][c]);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int c = 0; c < CW; ++c) {
      acc[0][c] += __shfl_xor_sync(0xffffffffu, acc[0][c], off);
      acc[1][c] += __shfl_xor_sync(0xffffffffu, acc[1][c], off);
    }
  }
}

// acc[r][c] without a dynamic register index.
template <int CW>
__device__ __forceinline__ float pick(const float (&acc)[2][CW], int r,
                                      int c) {
  float v = 0.0f;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
#pragma unroll
    for (int cc = 0; cc < CW; ++cc) {
      if (rr == r && cc == c) v = acc[rr][cc];
    }
  }
  return v;
}

// The block's units [j0, j0 + uv) and rows [r0, r1).
struct Owned {
  int j0, uv, r0, r1;
};

template <int US>
__device__ __forceinline__ Owned owned(int n, int h, int slices, int groups) {
  const int slice = blockIdx.x % slices, group = blockIdx.x / slices;
  const int rpg = (n + groups - 1) / groups;
  Owned o;
  o.j0 = slice * US;
  o.uv = min(US, h - o.j0);
  o.r0 = min(n, group * rpg);
  o.r1 = min(n, o.r0 + rpg);
  return o;
}

template <int US>
__global__ void __launch_bounds__(256, 1) gru_seq_fwd(FwdArgs a) {
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);  // 3 US rows of h
  const int n = a.n, u = a.u, h = a.h;
  float* tile = w_s + 3 * US * h;  // rows_tile rows of h
  const Owned o = owned<US>(n, h, a.slices, a.groups);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  // w_s[(g US + c) h + k] = W_g[k, j0 + c] (g: z, r, candidate); 0 past h
  batched<float>(
      3 * US * h,
      [&](int i) {
        const int c = i % US, k = (i / US) % h, g = i / (US * h);
        const float* w = g == 0 ? a.wz : g == 1 ? a.wr : a.wh;
        return c < o.uv ? w[(size_t)k * h + o.j0 + c] : 0.0f;
      },
      [&](int i, float v) {
        const int c = i % US, k = (i / US) % h, g = i / (US * h);
        w_s[(g * US + c) * h + k] = v;
      });
  for (int i = threadIdx.x; i < (o.r1 - o.r0) * o.uv; i += blockDim.x) {
    const int row = o.r0 + i / o.uv, j = o.j0 + i % o.uv;
    a.states[(size_t)row * (u + 1) * h + j] = a.h0[j];
  }
  __syncthreads();
  const size_t srow = (size_t)(u + 1) * h, trow = (size_t)u * 4 * h;
  // finishing lanes: row ia or ib of the pair, unit c of the slice
  const int fr = lane / US, fc = lane - fr * US;
  const bool finisher = lane < 2 * US && fc < o.uv;
  unsigned int epoch = 0;
  for (int t = 0; t < u; ++t) {
    const float* hsrc = t == 0 ? a.h0 : a.states + (size_t)t * h;
    const size_t hstride = t == 0 ? 0 : srow;
    // (a) z and r of the block's units from all of h_t; q = r h_t
    for (int tr0 = o.r0; tr0 < o.r1; tr0 += a.rows_tile) {
      const int rows = min(a.rows_tile, o.r1 - tr0);
      stage(tile, hsrc, hstride, tr0, rows, h, a.vec4);
      __syncthreads();
      for (int p = warp; 2 * p < rows; p += nwarps) {
        const int ia = 2 * p, ib = min(2 * p + 1, rows - 1);
        const int it = 2 * p + fr, row = tr0 + it, j = o.j0 + fc;
        const bool mine = finisher && it < rows;
        const size_t g = ((size_t)row * u + t) * 3 * h;
        const float gz = mine ? a.gx[g + j] : 0.0f;  // loads under the dots
        const float gr = mine ? a.gx[g + h + j] : 0.0f;
        float acc[2][2 * US];
        warp_dots<2 * US>(tile + ia * h, tile + ib * h, w_s, h, acc);
        if (mine) {
          const size_t tp = ((size_t)row * u + t) * 4 * h;
          const float z = sigmoid(pick(acc, fr, fc) + gz);
          const float r = sigmoid(pick(acc, fr, US + fc) + gr);
          a.tape[tp + j] = z;
          a.tape[tp + h + j] = r;
          a.tape[tp + 3 * h + j] = r * tile[it * h + j];
        }
      }
      __syncthreads();
    }
    grid_barrier(a.bar, ++epoch);
    // (b) the candidate from all of q, then h_{t+1} of the block's units
    const float* qsrc = a.tape + (size_t)t * 4 * h + 3 * h;
    for (int tr0 = o.r0; tr0 < o.r1; tr0 += a.rows_tile) {
      const int rows = min(a.rows_tile, o.r1 - tr0);
      stage(tile, qsrc, trow, tr0, rows, h, a.vec4);
      __syncthreads();
      for (int p = warp; 2 * p < rows; p += nwarps) {
        const int ia = 2 * p, ib = min(2 * p + 1, rows - 1);
        const int it = 2 * p + fr, row = tr0 + it, j = o.j0 + fc;
        const bool mine = finisher && it < rows;
        const size_t tp = ((size_t)row * u + t) * 4 * h;
        float gc = 0.0f, z = 0.0f, hv = 0.0f;
        if (mine) {  // loads under the dots
          gc = a.gx[((size_t)row * u + t) * 3 * h + 2 * h + j];
          z = __ldcg(a.tape + tp + j);
          hv = __ldcg(hsrc + row * hstride + j);
        }
        float acc[2][US];
        warp_dots<US>(tile + ia * h, tile + ib * h, w_s + 2 * US * h, h,
                      acc);
        if (mine) {
          const float c = tanhf(pick(acc, fr, fc) + gc);
          a.tape[tp + 2 * h + j] = c;
          a.states[(size_t)row * srow + (size_t)(t + 1) * h + j] =
              (1.0f - z) * hv + z * c;
        }
      }
      __syncthreads();
    }
    if (t + 1 < u) grid_barrier(a.bar, ++epoch);
  }
}

template <int US>
__global__ void __launch_bounds__(256, 1) gru_seq_bwd(BwdArgs a) {
  extern __shared__ float4 smem4[];
  // US rows of [Wz row | Wr row] (2h), then US rows of Wh (h)
  float* w_s = reinterpret_cast<float*>(smem4);
  const int n = a.n, u = a.u, h = a.h;
  float* wh_s = w_s + 2 * US * h;
  float* tile = w_s + 3 * US * h;  // rows_tile rows of up to 2h
  const Owned o = owned<US>(n, h, a.slices, a.groups);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  batched<float>(
      3 * US * h,
      [&](int i) {
        const int c = i / (2 * h), k = i - c * 2 * h;  // rows of [Wz | Wr]
        const int ch = (i - 2 * US * h) / h, kh = i - 2 * US * h - ch * h;
        if (i >= 2 * US * h)  // then the rows of Wh
          return ch < o.uv ? a.wh[(size_t)(o.j0 + ch) * h + kh] : 0.0f;
        const size_t at = (size_t)(o.j0 + c) * h;
        return c >= o.uv ? 0.0f : k < h ? a.wz[at + k] : a.wr[at + k - h];
      },
      [&](int i, float v) { w_s[i] = v; });
  const size_t srow = (size_t)(u + 1) * h, grow = (size_t)u * 3 * h;
  const int own = (o.r1 - o.r0) * o.uv;
  for (int i = threadIdx.x; i < own; i += blockDim.x) {
    const int row = o.r0 + i / o.uv, j = o.j0 + i % o.uv;
    a.dh[(size_t)row * h + j] = a.dstates[row * srow + (size_t)u * h + j];
  }
  __syncthreads();
  const int fr = lane / US, fc = lane - fr * US;
  const bool finisher = lane < 2 * US && fc < o.uv;
  unsigned int epoch = 0;
  for (int t = u - 1; t >= 0; --t) {
    // (a) the block's units: dac, daz, and the carry's direct part
    for (int i = threadIdx.x; i < own; i += blockDim.x) {
      const int row = o.r0 + i / o.uv, j = o.j0 + i % o.uv;
      const size_t tp = ((size_t)row * u + t) * 4 * h;
      const size_t g3 = ((size_t)row * u + t) * 3 * h;
      const float g = __ldcg(a.dh + (size_t)row * h + j);
      const float z = a.tape[tp + j], c = a.tape[tp + 2 * h + j];
      const float hv = a.states[row * srow + (size_t)t * h + j];
      a.dgx[g3 + 2 * h + j] = g * z * (1.0f - c * c);
      a.dgx[g3 + j] = g * (c - hv) * z * (1.0f - z);
      a.dh[(size_t)row * h + j] = g * (1.0f - z);
    }
    grid_barrier(a.bar, ++epoch);
    // (b) dq = dac Wh^T for the block's units from all of dac; dar
    const float* csrc = a.dgx + (size_t)t * 3 * h + 2 * h;
    for (int tr0 = o.r0; tr0 < o.r1; tr0 += a.rows_tile) {
      const int rows = min(a.rows_tile, o.r1 - tr0);
      stage(tile, csrc, grow, tr0, rows, h, a.vec4);
      __syncthreads();
      for (int p = warp; 2 * p < rows; p += nwarps) {
        const int ia = 2 * p, ib = min(2 * p + 1, rows - 1);
        const int it = 2 * p + fr, row = tr0 + it, j = o.j0 + fc;
        const bool mine = finisher && it < rows;
        float* dh = a.dh + (size_t)row * h + j;
        float r = 0.0f, hv = 0.0f, g = 0.0f;
        if (mine) {  // loads under the dots
          r = a.tape[((size_t)row * u + t) * 4 * h + h + j];
          hv = a.states[row * srow + (size_t)t * h + j];
          g = __ldcg(dh);
        }
        float acc[2][US];
        warp_dots<US>(tile + ia * h, tile + ib * h, wh_s, h, acc);
        if (mine) {
          const float dq = pick(acc, fr, fc);
          a.dgx[((size_t)row * u + t) * 3 * h + h + j] =
              dq * hv * r * (1.0f - r);
          *dh = g + dq * r;
        }
      }
      __syncthreads();
    }
    grid_barrier(a.bar, ++epoch);
    // (c) daz Wz^T + dar Wr^T for the block's units from all of daz | dar,
    // and the states' own cotangent
    const float* zsrc = a.dgx + (size_t)t * 3 * h;
    for (int tr0 = o.r0; tr0 < o.r1; tr0 += a.rows_tile) {
      const int rows = min(a.rows_tile, o.r1 - tr0);
      stage(tile, zsrc, grow, tr0, rows, 2 * h, a.vec4);
      __syncthreads();
      for (int p = warp; 2 * p < rows; p += nwarps) {
        const int ia = 2 * p, ib = min(2 * p + 1, rows - 1);
        const int it = 2 * p + fr, row = tr0 + it, j = o.j0 + fc;
        const bool mine = finisher && it < rows;
        float* dh = a.dh + (size_t)row * h + j;
        float g = 0.0f;
        if (mine)  // loads under the dots
          g = __ldcg(dh) + a.dstates[row * srow + (size_t)t * h + j];
        float acc[2][US];
        warp_dots<US>(tile + ia * 2 * h, tile + ib * 2 * h, w_s, 2 * h, acc);
        if (mine) *dh = g + pick(acc, fr, fc);
      }
      __syncthreads();
    }
  }
}

bool aligned(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <typename Args>
int valid_plan(const Args& a, int units, int threads) {
  if (a.n < 1 || a.u < 1 || a.h < 1 || units < 1 || units > kMaxUnits ||
      a.slices != (a.h + units - 1) / units || a.groups < 1 ||
      a.rows_tile < 2 || threads != 256)
    return 0;
  return 1;
}

template <typename Kernel, typename Args>
int launch(Kernel kernel, Args a, int threads, int smem, cudaStream_t st) {
  cudaError_t err = cudaMemsetAsync(
      a.bar, 0, sizeof(unsigned int) * a.slices * a.groups, st);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)kernel,
                                    dim3(a.slices * a.groups), dim3(threads),
                                    params, (size_t)smem, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

#define E2E_GRU_UNITS(X) X(1) X(2) X(4) X(5) X(8) X(10) X(16)

}  // namespace

extern "C" int e2e_gru_seq_fwd(const void* gx, const void* wz, const void* wr,
                               const void* wh, const void* h0, void* states,
                               void* tape, void* bar, int n, int u, int h,
                               int units, int slices, int groups,
                               int rows_tile, int threads, int smem,
                               void* stream) {
  FwdArgs a{(const float*)gx, (const float*)wz, (const float*)wr,
            (const float*)wh, (const float*)h0, (float*)states, (float*)tape,
            (unsigned int*)bar, n, u, h, slices, groups, rows_tile, 0};
  if (!valid_plan(a, units, threads) ||
      (size_t)smem < (size_t)(3 * units + rows_tile) * h * sizeof(float))
    return (int)cudaErrorInvalidValue;
  a.vec4 = h % 4 == 0 && aligned(h0) && aligned(states) && aligned(tape);
  cudaStream_t st = (cudaStream_t)stream;
  switch (units) {
#define E2E_GRU_FWD(US) \
  case US: return launch(gru_seq_fwd<US>, a, threads, smem, st);
    E2E_GRU_UNITS(E2E_GRU_FWD)
#undef E2E_GRU_FWD
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int e2e_gru_seq_bwd(const void* states, const void* tape,
                               const void* dstates, const void* wz,
                               const void* wr, const void* wh, void* dgx,
                               void* dh, void* bar, int n, int u, int h,
                               int units, int slices, int groups,
                               int rows_tile, int threads, int smem,
                               void* stream) {
  BwdArgs a{(const float*)states, (const float*)tape,
            (const float*)dstates, (const float*)wz, (const float*)wr,
            (const float*)wh, (float*)dgx, (float*)dh, (unsigned int*)bar,
            n, u, h, slices, groups, rows_tile, 0};
  if (!valid_plan(a, units, threads) ||
      (size_t)smem < (size_t)(3 * units + 2 * rows_tile) * h * sizeof(float))
    return (int)cudaErrorInvalidValue;
  a.vec4 = h % 4 == 0 && aligned(dgx);
  cudaStream_t st = (cudaStream_t)stream;
  switch (units) {
#define E2E_GRU_BWD(US) \
  case US: return launch(gru_seq_bwd<US>, a, threads, smem, st);
    E2E_GRU_UNITS(E2E_GRU_BWD)
#undef E2E_GRU_BWD
    default: return (int)cudaErrorInvalidValue;
  }
}
