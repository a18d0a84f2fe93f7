// Exact top-k over the last axis of a (rows, V) float32 matrix.
//
// Replaces: end2end_tpu/ops/topk_pallas.py::_topk_kernel (launched by
// topk_pallas).  Contract: values sorted descending, equal values by
// ascending index (the order of jax.lax.top_k and of a stable descending
// sort); -0.0 and +0.0 are equal, and unlike the TPU kernel exact +-inf
// ties also come out with distinct ascending indices.  Values and indices
// are bit-equal to the K3 this one replaced (tools/topk_reference.cu: k
// rounds, each a rescan of the row and a warp reduction) on every input
// without NaN.
//
// What bounds it on the H100: the bytes are small (the row read once, k
// pairs written: 0.6 us at the serving slice's T'=750, B=8, V=32, k=24;
// 41 us at the decoder's reference shape B=32, T=1000, V=1024), so what
// counts is the length of a warp's dependent chain of shuffles and the
// instructions it issues.  The replaced kernel ran k rounds of a rescan
// and a 5-step butterfly, k x ~10 dependent shuffles a row.
//
// Design: each value becomes one 64-bit composite, an order-preserving
// key of the value (-0.0 mapped to +0.0's key) above the complement of its
// index, so a larger composite comes first in the output order and no two
// are equal; the value written is re-read from the row, so -0.0 stays
// -0.0.  Each row is read once.  The launch's plan comes from the wrapper
// (ops/topk_cuda.py::topk_plan), which the C entry checks:
//   * sort (V <= 32): a row is a segment of P >= V lanes (a power of two),
//     32 / P rows a warp, one value a lane, one bitonic sort of the
//     segment: log2(P) (log2(P) + 1) / 2 shuffle steps (15 at P = 32);
//   * select (V > 32, k <= 256; the "WarpSelect" shape of Johnson, Douze
//     and Jegou, Billion-scale similarity search with GPUs, 2017): a warp
//     a row, a sorted list of the best L = 32 M >= k composites in M
//     registers a lane (entry r * 32 + lane), streamed in chunks of 128
//     values (a float4 a lane where the row is 16-byte aligned, else four
//     coalesced scalar loads); a ballot admits the values above the list's
//     k-th into a buffer in shared memory, and each 32 buffered values are
//     sorted (15 steps) and merged into the list (one reversing shuffle,
//     log2(M) register steps, 5 shuffle steps); for k <= 32 the first
//     chunk admits only the values at or above the k-th of its lanes'
//     maxima (one more sort);
//   * rounds (k > 256): the replaced kernel's k rounds.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;             // warps a block (sort, select)
constexpr int kQueue = 4;             // values a lane loads a chunk
constexpr int kChunk = 32 * kQueue;   // values a chunk
constexpr int kBuffer = 31 + kChunk;  // < 32 left over + one chunk
constexpr int kMaxList = 256;
constexpr int kRoundsWarps = 8;  // warps a block (rounds)
constexpr int kNoIndex = 0x7fffffff;

// Order-preserving key: a larger value has a larger key; -0.0 and +0.0
// have one key.
__device__ __forceinline__ uint32_t order_key(float x) {
  const uint32_t u = __float_as_uint(x == 0.f ? 0.f : x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// (value, index) as one composite: larger first, equal values by smaller
// index; 0 is below every composite of a value.
__device__ __forceinline__ uint64_t composite(float x, int i) {
  return ((uint64_t)order_key(x) << 32) | (uint32_t)~i;
}

__device__ __forceinline__ int index_of(uint64_t c) {
  return (int)~(uint32_t)c;
}

__device__ __forceinline__ uint64_t shfl64(uint64_t x, int src) {
  return __shfl_sync(kFull, (unsigned long long)x, src);
}

__device__ __forceinline__ uint64_t shfl_xor64(uint64_t x, int m) {
  return __shfl_xor_sync(kFull, (unsigned long long)x, m);
}

// Each segment of P lanes sorted, largest in its first lane: a bitonic
// network, one exchange by shuffle a step (the last stage merges every
// segment descending).
template <int P>
__device__ __forceinline__ uint64_t segment_sort_desc(uint64_t x, int lane) {
#pragma unroll
  for (int k = 2; k <= P; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const uint64_t o = shfl_xor64(x, j);
      const bool keep_max = ((lane & j) == 0) == ((lane & k & (P - 1)) == 0);
      x = keep_max == (x > o) ? x : o;
    }
  }
  return x;
}

template <int P>
__global__ void __launch_bounds__(kWarps * 32)
    topk_sort_kernel(const float* __restrict__ x, float* __restrict__ vals,
                     int* __restrict__ idx, long long rows, int v, int k) {
  constexpr int kRows = 32 / P;  // rows a warp
  const int lane = threadIdx.x & 31;
  const long long first =
      ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * kRows;
  if (first >= rows) return;  // the whole warp
  const int g = lane / P, e = lane % P;
  const long long row = first + g;
  const bool live = row < rows && e < v;
  const float xv = live ? __ldg(x + row * v + e) : 0.f;
  const uint64_t c = segment_sort_desc<P>(live ? composite(xv, e) : 0, lane);
  const int i = index_of(c);  // a value's index wherever e < k <= v
  const float out = __shfl_sync(kFull, xv, g * P + (i & (P - 1)));
  if (row < rows && e < k) {
    vals[row * k + e] = out;
    idx[row * k + e] = i;
  }
}

// The list (entry r * 32 + lane, descending) and 32 sorted composites g:
// the list's best L of both.  max(list, g reversed and padded with 0 at
// the front) keeps them as a bitonic sequence (only the last register row
// can change), which the merge network sorts.
template <int M>
__device__ __forceinline__ void merge_sorted(uint64_t (&list)[M], uint64_t g,
                                             int lane) {
  const uint64_t rev = shfl64(g, 31 - lane);
  list[M - 1] = list[M - 1] > rev ? list[M - 1] : rev;
#pragma unroll
  for (int jr = M >> 1; jr > 0; jr >>= 1) {
#pragma unroll
    for (int r = 0; r < M; ++r) {
      if ((r & jr) == 0) {
        const uint64_t a = list[r], b = list[r | jr];
        list[r] = a > b ? a : b;
        list[r | jr] = a > b ? b : a;
      }
    }
  }
#pragma unroll
  for (int j = 16; j > 0; j >>= 1) {
    const bool keep_max = (lane & j) == 0;
#pragma unroll
    for (int r = 0; r < M; ++r) {
      const uint64_t o = shfl_xor64(list[r], j);
      list[r] = keep_max == (list[r] > o) ? list[r] : o;
    }
  }
}

// The list's entry k - 1 (0 while fewer than k values were merged).
template <int M>
__device__ __forceinline__ uint64_t kth(const uint64_t (&list)[M], int k) {
  const int kr = (k - 1) >> 5;
  uint64_t t = list[0];
#pragma unroll
  for (int r = 1; r < M; ++r) t = r == kr ? list[r] : t;
  return shfl64(t, (k - 1) & 31);
}

template <int M>
__global__ void __launch_bounds__(kWarps * 32)
    topk_select_kernel(const float* __restrict__ x, float* __restrict__ vals,
                       int* __restrict__ idx, long long rows, int v, int k) {
  __shared__ uint64_t s_buf[kWarps][kBuffer];
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp
  uint64_t* buf = s_buf[threadIdx.x >> 5];
  const float* xr = x + row * v;
  const bool aligned = (reinterpret_cast<uintptr_t>(xr) & 15) == 0;
  const unsigned below = (1u << lane) - 1u;  // the lanes before this one
  uint64_t list[M];
#pragma unroll
  for (int r = 0; r < M; ++r) list[r] = 0;
  uint64_t thr = 0;  // the list's k-th: a value must beat it to enter
  int held = 0;      // composites in buf
  for (int c0 = 0; c0 < v; c0 += kChunk) {
    float xq[kQueue];
    int iq[kQueue];
    if (aligned && c0 + kChunk <= v) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(xr + c0) + lane);
      xq[0] = q.x;
      xq[1] = q.y;
      xq[2] = q.z;
      xq[3] = q.w;
#pragma unroll
      for (int j = 0; j < kQueue; ++j) iq[j] = c0 + kQueue * lane + j;
    } else {
#pragma unroll
      for (int j = 0; j < kQueue; ++j) {
        iq[j] = c0 + 32 * j + lane;
        xq[j] = iq[j] < v ? __ldg(xr + iq[j]) : 0.f;
      }
    }
    uint64_t cq[kQueue];
#pragma unroll
    for (int j = 0; j < kQueue; ++j) cq[j] = composite(xq[j], iq[j]);
    if (c0 == 0 && k <= 32 && v >= kChunk) {
      // the first chunk's bound: k of its values are at least the k-th of
      // the lanes' maxima, so only those enter (~k + 14 at k = 24 on
      // random rows, in place of all 128 and four merges)
      uint64_t m = cq[0];
#pragma unroll
      for (int j = 1; j < kQueue; ++j) m = m > cq[j] ? m : cq[j];
      thr = shfl64(segment_sort_desc<32>(m, lane), k - 1) - 1;
    }
    __syncwarp();  // every lane has read what the last merge took
#pragma unroll
    for (int j = 0; j < kQueue; ++j) {
      const uint64_t cj = cq[j];
      const bool hit = iq[j] < v && cj > thr;
      const unsigned b = __ballot_sync(kFull, hit);
      if (hit) buf[held + __popc(b & below)] = cj;
      held += __popc(b);
    }
    __syncwarp();  // the buffer's entries are visible to every lane
    while (held >= 32) {
      held -= 32;
      merge_sorted<M>(list, segment_sort_desc<32>(buf[held + lane], lane),
                      lane);
      thr = kth<M>(list, k);
    }
  }
  if (held > 0)
    merge_sorted<M>(
        list, segment_sort_desc<32>(lane < held ? buf[lane] : 0, lane), lane);
#pragma unroll
  for (int r = 0; r < M; ++r) {
    const int e = r * 32 + lane;
    if (e < k) {
      const int i = index_of(list[r]);
      vals[row * k + e] = __ldg(xr + i);
      idx[row * k + e] = i;
    }
  }
}

// (v, i) comes before (bv, bi) in the output order.
__device__ __forceinline__ bool before(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// k > 256: the replaced kernel, k rounds of a rescan and a reduction.
__global__ void topk_rounds_kernel(const float* __restrict__ x,
                                   float* __restrict__ vals,
                                   int* __restrict__ idx, long long rows,
                                   int v, int k) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * kRoundsWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warp exits together
  const float* xr = x + row * v;
  float prev_v = CUDART_INF_F;
  int prev_i = -1;
  for (int r = 0; r < k; ++r) {
    float bv = -CUDART_INF_F;
    int bi = kNoIndex;
    for (int j = lane; j < v; j += 32) {
      const float xv = __ldg(xr + j);
      if (before(prev_v, prev_i, xv, j) && before(xv, j, bv, bi)) {
        bv = xv;
        bi = j;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(kFull, bv, off);
      const int oi = __shfl_xor_sync(kFull, bi, off);
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

using Kernel = void (*)(const float*, float*, int*, long long, int, int);

Kernel sort_kernel(int segment) {
  switch (segment) {
    case 1: return topk_sort_kernel<1>;
    case 2: return topk_sort_kernel<2>;
    case 4: return topk_sort_kernel<4>;
    case 8: return topk_sort_kernel<8>;
    case 16: return topk_sort_kernel<16>;
    case 32: return topk_sort_kernel<32>;
  }
  return nullptr;
}

Kernel select_kernel(int list) {
  switch (list) {
    case 32: return topk_select_kernel<1>;
    case 64: return topk_select_kernel<2>;
    case 128: return topk_select_kernel<4>;
    case 256: return topk_select_kernel<8>;
  }
  return nullptr;
}

}  // namespace

// The plan (ops/topk_cuda.py::topk_plan): segment > 0 runs the sort path
// with segments of that many lanes (a power of two, V <= segment <= 32);
// else list > 0 the select path with a list of that many composites (32,
// 64, 128 or 256, k <= list); both 0 the rounds.
extern "C" int e2e_topk_f32(const void* x, void* vals, void* idx,
                            long long rows, int v, int k, int segment,
                            int list, void* stream) {
  if (v < 1 || k < 1 || k > v || rows < 0) return (int)cudaErrorInvalidValue;
  Kernel kernel = nullptr;
  long long blocks = 0;
  int threads = kWarps * 32;
  if (segment > 0) {
    kernel = segment >= v && list == 0 ? sort_kernel(segment) : nullptr;
    const long long warps = (rows + 32 / segment - 1) / (32 / segment);
    blocks = (warps + kWarps - 1) / kWarps;
  } else if (list > 0) {
    kernel = k <= list && list <= kMaxList ? select_kernel(list) : nullptr;
    blocks = (rows + kWarps - 1) / kWarps;
  } else {
    kernel = topk_rounds_kernel;
    threads = kRoundsWarps * 32;
    blocks = (rows + kRoundsWarps - 1) / kRoundsWarps;
  }
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  if (rows > 0)
    kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)x, (float*)vals, (int*)idx, rows, v, k);
  return (int)cudaGetLastError();
}
