// The beam backtrace on the card: the lane walk over the backpointer codes
// (for every final beam of every sequence, the lane it occupied after each
// frame, walking from the last frame to the first), with the ids its path
// emitted frame by frame (the chunked LM decode's boundary) or compacted
// into token and time rows ranked by score (the backtrace).
//
// Replaces end2end_tpu/ops/beam_search_pallas.py::_backtrace (:442: an
// associative scan of lane maps through `_compose` :426, then XLA's
// gathers, cumsum, scatters and top_k on the TPU; a loop of ~2T small
// launches from the host, then ~20 torch ops, in the port before this
// kernel).  Two entry points:
//   * e2e_lane_walk computes exactly what
//     ops/beam_search_cuda.py::lane_walk_plain returns for bp (T, W, N)
//     int32 codes and ck (T, N, ks) int32 ids: lane0 (N, W) int64, the
//     lane final beam w descends from before frame 0; toks (N, W, T)
//     int64, the id its path emitted at each frame (-1 where it emitted
//     nothing); n_emit (N, W) int64, how many it emitted; with
//     parent(c) = c < W ? c : (c - W) / K and slot(c) = (c - W) % K
//     (the chunked LM decode's boundary; it replaces the JAX chunked
//     decode's end2end_tpu/ops/beam_chunked.py::_chunk_emissions :70, the
//     same scan over one chunk);
//   * e2e_backtrace computes exactly what backtrace_plain returns: tokens
//     and times (N, W, s_cap) int32 (-1 past each length), lengths (N, W)
//     int32 and scores (N, W) f32 (-inf for a dead beam), best beam first.
// Codes lie in [0, W + W K) (csrc/beam_step.cu writes nothing else), so
// C's truncating division is Python's floor.  Dead beams and frozen frames
// write ordinary codes: no special case.
//
// What bounds it on the H100: a dependent chain of T steps per sequence
// (each step's lane picks the next step's entry), not bytes: at B=128,
// T=1000, W=8 the walk reads 4 MB of codes (~1.2 us at 3.35 TB/s) but
// walks 1,000 steps, ~41 cycles each if a step is one shuffle (~21 us at
// 1,980 MHz).
//
// Design: a sequence is a segment of W lanes of a warp (32 / W sequences a
// warp).  Lane w holds the current lane of final beam w as an absolute
// lane number.  Each frame it takes its new lane by one __shfl_sync from
// the lane that owns the current entry, which offers its parent as an
// absolute lane and the entry's slot + 1 (0 for a stay): the shuffle is
// the only dependent step of a frame.  The codes do not depend on the
// chain: a lane loads kFrames frames of its column into registers one
// block ahead of the walk, so the loads are in flight while the previous
// block's shuffles run (no barrier or __syncwarp in the walk, so nothing
// waits for them but their first use), and a block's offers are computed
// before its chain (a warp issues in order: work placed between two
// shuffles of the chain waits for the first one, and the second for it),
// the division by K as a multiply-high.  The lane walk keeps each frame's
// slot + 1 in a frame-major scratch (T, N, W), one coalesced store a
// frame; the backtrace keeps the emissions of each path in a scratch row
// (N, W, T) as the walk finds them, last first.  Then the walking warp's
// block, kFillWarps warps, gathers the ids and writes the rows (the
// gathers need many loads in flight: one warp alone took ~0.1 ms at
// T'=750, N=8 on an H100, the block ~0.03 ms).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kFillWarps = 8;  // warps a block: one walks, all write
constexpr int kFrames = 32;  // frames of codes a lane loads ahead
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxK = 128;  // the beam step's prune_k cap
constexpr float kLog0Threshold = -1.0e29f;  // at or below: log-zero

// Frames t_hi, t_hi - 1, ..., t_hi - kFrames + 1 of this lane's column
// (frames below 0, and idle lanes, read the stay code `w`).
__device__ __forceinline__ void load_block(int (&c)[kFrames],
                                           const int* __restrict__ col,
                                           long long stride, int t_hi,
                                           bool act, int w) {
#pragma unroll
  for (int f = 0; f < kFrames; ++f) {
    const int t = t_hi - f;
    c[f] = (act && t >= 0) ? __ldg(col + t * stride) : w;
  }
}

struct Args {
  const int* bp;  // (t_max, W, n) codes
  const int* ck;  // (t_max, n, ks) top-k ids
  // the lane walk: took (t_max, n, W) scratch; toks (n, W, t_max), lane0
  // and n_emit (n, W)
  int* took;
  long long* toks;
  long long* lane0;
  long long* n_emit;
  // the backtrace: scores (W, n); rev (n, W, t_max) scratch; tokens,
  // times (n, W, s_cap), lens, sc (n, W)
  const float* scores;
  int* rev;
  int* tokens;
  int* times;
  int* lens;
  float* sc;
  int t_max, n, W, K, ks, s_cap;
};

// One warp's walk over its sequences (32 / W of them from `first`):
// lane w of a segment walks final beam w.  The shuffle brings the entry
// the beam takes: its parent's lane and its slot + 1 (0 for a stay).
// kAligned = true (the lane walk): every frame's slot + 1 at its frame in
// `took`.  kAligned = false (the backtrace): a lane whose path emitted
// records (t, slot) at its next place in `rev`, its emissions from the
// last.  Returns how many its path emitted; `lane0` takes the lane it
// descends from before frame 0.
template <bool kAligned>
__device__ __forceinline__ int walk(const Args& a, long long first,
                                    int lane, int& lane0) {
  const int W = a.W, n = a.n, t_max = a.t_max;
  const int seqs = 32 / W;
  const int s = lane / W;
  const int w = lane - s * W;
  const int base = s * W;  // the segment's first lane
  const long long seq = first + s;
  const bool act = s < seqs && seq < n;
  const long long stride = (long long)W * n;  // bp's and took's frames
  const int* col = a.bp + (long long)w * n + seq;  // bp[t, w, seq]
  const long long at = seq * W + w;                // took[t, seq, w]
  // (c - W) / K as a multiply-high: exact for c - W < 32 K, K <= 128
  const uint64_t inv_k = ((1ull << 32) + a.K - 1) / a.K;
  int* rev = a.rev + at * t_max;  // this beam's emissions, last first
  int emitted = 0;
  int cur = base + w;  // final beam w's lane after the frame being walked
  int next[kFrames];
  load_block(next, col, stride, t_max - 1, act, w);
  for (int t_hi = t_max - 1; t_hi >= 0; t_hi -= kFrames) {
    int codes[kFrames], offer[kFrames];
#pragma unroll
    for (int f = 0; f < kFrames; ++f) codes[f] = next[f];
    load_block(next, col, stride, t_hi - kFrames, act, w);
    // what each code offers, off the chain: its parent as an absolute lane
    // and its slot + 1 above it (0 for a stay)
#pragma unroll
    for (int f = 0; f < kFrames; ++f) {
      const int c = codes[f];
      const int q = (int)(((uint64_t)(uint32_t)(c - W) * inv_k) >> 32);
      offer[f] = base + (c < W ? c : q);
      if (c >= W) offer[f] |= (c - W - q * a.K + 1) << 5;
    }
    // the chain: one shuffle a frame; the frame's store beside it
#pragma unroll
    for (int f = 0; f < kFrames; ++f) {
      const int t = t_hi - f;
      if (t < 0) break;  // uniform: the last block is short
      const int got = __shfl_sync(kFull, offer[f], cur);
      cur = got & 31;
      if (kAligned) {
        emitted += got >= 32;
        if (act) a.took[t * stride + at] = got >> 5;
      } else if (act && got >= 32) {
        rev[emitted++] = t * 128 + (got >> 5) - 1;
      }
    }
  }
  lane0 = cur - base;
  return emitted;
}

// The lane walk: a block's first warp walks its sequences, writing lane0,
// n_emit and each frame's slot + 1 into `took`; then the block's
// kFillWarps warps write the rows toks[seq, w, t], the id ck[t, seq] holds
// at the slot taken (-1 for a stay), every element's loads issued without
// a branch.
__global__ void __launch_bounds__(kFillWarps * 32)
    lane_walk_kernel(const Args a) {
  const int W = a.W, n = a.n, t_max = a.t_max;
  const int seqs = 32 / W;
  const long long first = (long long)blockIdx.x * seqs;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int lane0;
    const int emitted = walk<true>(a, first, lane, lane0);
    const int s = lane / W;
    const long long at = (first + s) * W + lane - s * W;
    if (s < seqs && first + s < n) {
      a.lane0[at] = lane0;
      a.n_emit[at] = emitted;
    }
  }
  __syncthreads();  // the walk's stores are the block's
  // row j: final beam j % W of sequence first + j / W
  const int rows = (int)min((long long)seqs, n - first) * W;
  const long long row0 = first * W;
  for (int i = threadIdx.x; i < rows * t_max; i += kFillWarps * 32) {
    const int j = i / t_max, t = i - j * t_max;
    const int took = a.took[(long long)t * n * W + row0 + j];
    const int tok = __ldg(a.ck + ((long long)t * n + first + j / W) * a.ks +
                          max(took - 1, 0));
    a.toks[(row0 + j) * t_max + t] = took ? tok : -1;
  }
}

// The whole backtrace: a block's first warp walks its sequences; then
// each beam takes its rank among its sequence's beams (score descending,
// equal scores by lane, log-zero as -inf), and the block's kFillWarps
// warps write the rows at their ranks, tokens and times in frame order
// (-1 past the length; emissions past s_cap on its last slot, the last
// one there, as the plain version's sequential scatter leaves it), every
// element's loads issued without a branch.
__global__ void __launch_bounds__(kFillWarps * 32)
    backtrace_kernel(const Args a) {
  __shared__ int s_emitted[32], s_rank[32];  // by the walking lane
  const int W = a.W, n = a.n;
  const int seqs = 32 / W;
  const long long first = (long long)blockIdx.x * seqs;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int lane0;  // not an output of the backtrace
    const int emitted = walk<false>(a, first, lane, lane0);
    const int s = lane / W, w = lane - s * W;
    const long long seq = first + s;
    const bool act = s < seqs && seq < n;
    float mine = act ? __ldg(a.scores + (long long)w * n + seq) : 0.f;
    mine = mine > kLog0Threshold ? mine : -CUDART_INF_F;
    int rank = 0;
    for (int j = 0; j < W; ++j) {
      const float o = __shfl_sync(kFull, mine, s * W + j);
      rank += o > mine || (o == mine && j < w);
    }
    if (act) {
      a.lens[seq * W + rank] = min(emitted, a.s_cap);
      a.sc[seq * W + rank] = mine;
    }
    s_emitted[lane] = emitted;
    s_rank[lane] = rank;
  }
  __syncthreads();  // the emissions and the rows' counts are the block's
  // row j is walking lane j's beam
  const int rows = (int)min((long long)seqs, n - first) * W;
#pragma unroll 4
  for (int i = threadIdx.x; i < rows * a.s_cap; i += kFillWarps * 32) {
    const int j = i / a.s_cap, p = i - j * a.s_cap;
    const int sj = j / W;
    const long long seqj = first + sj;
    const int ej = s_emitted[j];
    const bool in = p < min(ej, a.s_cap);
    const int e =
        in ? a.rev[(seqj * W + j - sj * W) * a.t_max +
                   (p == a.s_cap - 1 ? 0 : ej - 1 - p)]
           : 0;
    const int tok =
        __ldg(a.ck + ((long long)(e >> 7) * n + seqj) * a.ks + (e & 127));
    const long long out = (seqj * W + s_rank[j]) * a.s_cap + p;
    a.tokens[out] = in ? tok : -1;
    a.times[out] = in ? e >> 7 : -1;
  }
}

}  // namespace

// The lane walk: bp (t_max, W, n) int32 codes, ck (t_max, n, ks) int32
// ids, took (t_max, n, W) int32 scratch; writes toks (n, W, t_max), lane0
// and n_emit (n, W), all int64.
extern "C" int e2e_lane_walk(const void* bp, const void* ck, void* took,
                             void* toks, void* lane0, void* n_emit,
                             int t_max, int n, int W, int K, int ks,
                             void* stream) {
  if (W < 1 || W > 32 || K < 1 || K > kMaxK || ks < K || t_max < 0 ||
      t_max >= (1 << 24) || n < 0)
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.bp = (const int*)bp;
  a.ck = (const int*)ck;
  a.took = (int*)took;
  a.toks = (long long*)toks;
  a.lane0 = (long long*)lane0;
  a.n_emit = (long long*)n_emit;
  a.t_max = t_max;
  a.n = n;
  a.W = W;
  a.K = K;
  a.ks = ks;
  if (n > 0)
    lane_walk_kernel<<<(unsigned)((n + 32 / W - 1) / (32 / W)),
                       kFillWarps * 32, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// The whole backtrace: bp (t_max, W, n) int32 codes, ck (t_max, n, ks)
// int32 ids, scores (W, n) f32, rev (n, W, t_max) int32 scratch; writes
// tokens and times (n, W, s_cap) int32, lens (n, W) int32 and sc (n, W)
// f32, best beam first.
extern "C" int e2e_backtrace(const void* bp, const void* ck,
                             const void* scores, void* rev, void* tokens,
                             void* times, void* lens, void* sc, int t_max,
                             int n, int W, int K, int ks, int s_cap,
                             void* stream) {
  if (W < 1 || W > 32 || K < 1 || K > kMaxK || ks < K || t_max < 1 ||
      t_max >= (1 << 24) || n < 0 || s_cap < 1 || s_cap >= (1 << 24))
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.bp = (const int*)bp;
  a.ck = (const int*)ck;
  a.scores = (const float*)scores;
  a.rev = (int*)rev;
  a.tokens = (int*)tokens;
  a.times = (int*)times;
  a.lens = (int*)lens;
  a.sc = (float*)sc;
  a.t_max = t_max;
  a.n = n;
  a.W = W;
  a.K = K;
  a.ks = ks;
  a.s_cap = s_cap;
  if (n > 0)
    backtrace_kernel<<<(unsigned)((n + 32 / W - 1) / (32 / W)),
                       kFillWarps * 32, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
