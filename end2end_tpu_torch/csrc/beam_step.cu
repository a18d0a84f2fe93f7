// CTC prefix beam search over all frames of a batch: one beam step per
// frame, emitting backpointer codes, with the LM modes of the TPU kernel.
//
// Replaces end2end_tpu/ops/beam_search_pallas.py::_beam_kernel (launched
// there by _run_beam_kernel :597) in all four of its forms:
//   * K4, no LM (n_ctx = 0, use_cls = False, resume = False);
//   * K5, in-kernel dense-bigram fusion (n_ctx > 0; :202-224, :264-267,
//     :334-345, :409): each extension gets the increment
//     inc[ctx, token] = alpha * log p_LM(token | ctx) + beta, where ctx is
//     the beam's last symbol (row C-1 for the empty prefix);
//   * K6, class-keyed guide (use_cls; :101-105, :203-205, :328-333,
//     :374-376): ctx is the class of the last symbol, carried per beam in
//     `lcls` and read from cls_map (V,) on each extension;
//   * K7, resume (:129-141, :225-228, :411-423): the 10-field beam state is
//     read from state_in instead of the empty prefix and written out at the
//     end, for the chunked LM decode.
// Same semantics, candidate order and tie-breaks as the TPU kernel:
//   * stay candidate of beam w (code w): blank + repeat-last; the repeat's
//     frame probability is looked up in the whole ks-slot top-k window;
//   * extension of beam w by its k-th candidate (code W + w*K + k), k < K;
//   * an extension that recreates an existing beam's prefix is merged into
//     that beam with logaddexp (found through the beam's parent-prefix hash)
//     and removed from the extension pool; merges are acoustic only;
//   * each beam carries an accumulated LM bonus `lm`; candidates rank by
//     acoustic + bonus (stay: the beam's own bonus; extension: its parent's
//     plus the increment, or the parent's alone without an increment
//     table), W rounds of argmax, equal scores by smallest code, a pick
//     leaving the pool as log-zero; a pick's acoustic mass is its unranked
//     value, its bonus the ranked one's;
//   * a pick at log-zero carries no state (dead slot: slot-unique hashes,
//     bonus 0, class -1);
//   * frames t >= il[n] leave the state as it is and emit code w;
//   * the final score is logaddexp(pb, pnb) + lm.
// Prefix hashes are two 32-bit rolling hashes with wraparound (uint32 here,
// int32 on the TPU: the same bits).  Log-zero is the finite -1e30 of
// ops/semiring.py, never -inf.  The ranking sums are additions only (the
// increments arrive precomputed), so no multiply-add contraction can make
// the kernel rank or break ties differently from its plain twin
// (ops/beam_search_cuda.py::beam_step_plain).  Its outputs are bit-equal
// to those of the warp-per-sequence kernel it replaced
// (tools/beam_step_reference.cu).
//
// What bounds it on the H100: nothing in bytes (per frame a sequence reads
// ks*8 + 4 bytes and W*K increments, and writes 4*W) and little in
// arithmetic (about W*(W*K) compares per frame); the frame loop is a chain
// of dependent steps, so it is bound by latency (a shared-memory load, a
// shuffle or a redux costs 41-46 cycles in a dependent chain on the H100,
// a laddexp2 157: tools/beam_step_breakdown.py).
//
// Design: one warp per sequence; lane w owns beam w's state in registers
// (W <= 32) and writes a copy to shared memory once a frame for the other
// lanes.  Off the chain:
//   * the frame inputs (ks ids and log-probs, the blank log-prob) arrive by
//     cp.async kRing - 1 frames ahead into a ring of shared stages;
//   * a (C, V) increment table of at most 4096 entries (every K5 table of
//     the decoder's envelope) is copied to shared memory once; a larger
//     one's increments for the frame's extensions, whose contexts are the
//     beams' last symbols (or classes), are gathered by cp.async when the
//     frame starts and land while the stays, the extensions and the merge
//     are formed, K6's classes of the K slot tokens with them;
//   * a beam's laddexp2(pb, pnb) is carried, not recomputed: a stay's is
//     the one that ranks it, an extension's is x + 0.
// The stay term: each slot's lane hands its log-prob to the beams whose
// last token it holds (a frame's tokens are unique: the top-k), W
// independent compares in place of a ks-long search.  The merge: each
// beam compares its parent hash with all W beams' hashes, four a load.
// Top-W: each candidate is one 64-bit composite, an order-preserving key
// of its rank score above the complement of its code, so a larger
// composite ranks first and no two are equal (-0.0 and +0.0 share a key:
// the plain twin's argmax treats them as equal).  Lane l owns the stay of
// beam l and the extensions e = (l - W) mod 32 + 32 j in slot-major order
// (P a lane in registers; rescanned in shared memory above 16).  The
// lanes' heads are sorted across the warp (a bitonic network of 15
// shuffle steps); tau, the W-th, bounds the picks from below.  When W
// heads are live and no lane holds two candidates >= tau, the sorted
// heads are the picks; else, when at most 32 candidates are >= tau, they
// are sorted the same way.  Otherwise W rounds of two `redux.sync` (the
// largest key, then the smallest code at it) and the winner's rescan; and
// once no candidate above log-zero is left, the sequential argmax would
// pick one code over and over: the smallest code among those at log-zero,
// counting the picks (which left the pool at log-zero), found by one
// more pair of reductions over the composites with their keys clamped
// to log-zero's.  Each lane then reads its pick's state, both kinds of
// pick at once.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr float kLog0 = -1.0e30f;
constexpr float kLog0Threshold = -1.0e29f;
constexpr int kMaxW = 32;
constexpr int kMaxK = 128;
constexpr int kMaxKs = kMaxK + 8;
constexpr int kMaxCtx = 64;
constexpr int kRing = 4;  // stages of frame inputs: kRing - 1 in flight
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kM1 = 2654435761u;
constexpr uint32_t kM2 = 0x85EBCA6Bu;
constexpr uint32_t kSeed1 = 1u;
constexpr uint32_t kSeed2 = 7u;
constexpr uint32_t kDeadBase = 0x7EAD0000u;
constexpr uint32_t kNoParent = 0x5EED0000u;  // matches no prefix hash
// rank_key(kLog0) and rank_key(kLog0Threshold)
constexpr uint32_t kKeyLog0 = 0x0EB60D35u;
constexpr uint32_t kKeyDead = 0x105E70F7u;

__device__ __forceinline__ float laddexp2(float a, float b) {
  const float m = fmaxf(a, b);
  const float m_safe = fmaxf(m, kLog0);
  const float d = fmaxf(-fabsf(a - b), kLog0);
  const float out = m_safe + log1pf(expf(d));
  return m > kLog0Threshold ? out : kLog0;
}

// Order-preserving key of a rank score: a larger score has a larger key;
// -0.0 and +0.0 have one key.
__device__ __forceinline__ uint32_t rank_key(float x) {
  const uint32_t u = __float_as_uint(x == 0.f ? 0.f : x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The candidate's composite: a larger one ranks first (larger score,
// equal scores by smaller code); 0 is below every candidate.
__device__ __forceinline__ uint64_t composite(float rank, int code) {
  return ((uint64_t)rank_key(rank) << 32) | (uint32_t)~code;
}

// Its key clamped to log-zero's: the rank it has once it left the pool.
__device__ __forceinline__ uint64_t at_most_log0(uint64_t c) {
  return (uint32_t)(c >> 32) > kKeyLog0
             ? ((uint64_t)kKeyLog0 << 32) | (uint32_t)c
             : c;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
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

__device__ __forceinline__ uint64_t max64(uint64_t a, uint64_t b) {
  return a > b ? a : b;
}

// The warp's 32 composites sorted, largest in lane 0: a bitonic network,
// one exchange by shuffle a step, 15 steps.
__device__ __forceinline__ uint64_t warp_sort_desc(uint64_t x, int lane) {
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const uint64_t o = __shfl_xor_sync(kFull, (unsigned long long)x, j);
      const bool keep_max = ((lane & j) == 0) == ((lane & k) == 0);
      x = keep_max == (x > o) ? x : o;
    }
  }
  return x;
}

// kInc: extensions add inc[ctx, token] to their bonus (K5, K6);
// kCls: ctx is the class of the last symbol (K6), else the symbol (K5);
// kTable: the (C, V) increment table sits in shared memory (C*V <= 4096),
// else each frame gathers its extensions' increments;
// P: extension slots a lane holds in registers, in sorted groups of four
// (P >= ceil(W*K / 32)), or 0 to rescan them in shared memory.
template <bool kInc, bool kCls, bool kTable, int P>
__global__ void __launch_bounds__(32)
    beam_step_kernel(const float* __restrict__ lpk, const int* __restrict__ ck,
                     const float* __restrict__ lpb, const int* __restrict__ il,
                     const float* __restrict__ inc,
                     const int* __restrict__ cls_map,
                     const int* __restrict__ state_in, int* __restrict__ bp,
                     float* __restrict__ score, int* __restrict__ state_out,
                     int t_max, int n, int ks, int W, int K, int s_cap,
                     int blank, int n_ctx, int v) {
  __shared__ int s_ck[kRing][kMaxKs];
  __shared__ float s_lpk[kRing][kMaxKs];
  __shared__ float s_lpb[kRing];
  __shared__ float s_ext[kMaxW * kMaxK];
  // the increment table (kTable), or the gathered increments and then
  // the extensions' bonuses
  __shared__ float s_lmt[kInc ? kMaxW * kMaxK : 1];
  __shared__ int s_ccls[kCls ? kMaxK : 1];  // classes of the K slot tokens
  __shared__ float s_pb[kMaxW], s_tot[kMaxW], s_lm[kMaxW];
  // read four at a time
  __shared__ __align__(16) uint32_t s_h1[kMaxW];
  __shared__ __align__(16) uint32_t s_h2[kMaxW];
  __shared__ __align__(16) int s_last[kMaxW];
  __shared__ __align__(16) int s_len[kMaxW];
  __shared__ uint32_t s_hp1[kMaxW], s_hp2[kMaxW];
  __shared__ int s_lcls[kMaxW];
  // a frame's stays (pb, pnb, laddexp2 of both), the repeat's log-prob
  // and slot of each beam's last token, and round r's code
  __shared__ float s_pbs[kMaxW], s_pnbs[kMaxW], s_stot[kMaxW];
  __shared__ float s_rep[kMaxW];
  __shared__ int s_krep[kMaxW];
  __shared__ uint64_t s_surv[32];  // the candidates >= tau

  const int seq = blockIdx.x;
  const int lane = threadIdx.x;
  const bool act = lane < W;
  const int n_ext = W * K;
  const int n_run = max(min(il[seq], t_max), 0);
  const long long field = (long long)W * n;  // stride of a state field
  const long long at = (long long)lane * n + seq;
  // This lane's extension slots e = e0 + 32 j, j < m, in slot-major order
  // e = k*W + w (extension (w, k) has code W + w*K + k).  e0 = lane - W
  // (mod 32) puts each beam's best extensions, slot 0, 1, ..., on lanes of
  // their own, away from the stays' lanes 0..W-1: a frame's best
  // candidates then tend to sit on different lanes.
  const int e0 = (lane + 32 - W) & 31;
  const int m = e0 < n_ext ? (n_ext - 1 - e0) / 32 + 1 : 0;
  const int w0 = e0 % W, k0 = e0 / W, dw = 32 % W, dk = 32 / W;
  auto next_slot = [&](int& w, int& k) {  // (w, k) of e + 32
    w += dw;
    k += dk;
    if (w >= W) {
      w -= W;
      ++k;
    }
  };
  constexpr int kP = P > 0 ? P : 1;
  int sw[kP], sk[kP];
  if (P > 0) {
#pragma unroll
    for (int j = 0, w = w0, k = k0; j < kP; ++j) {
      sw[j] = w;
      sk[j] = k;
      next_slot(w, k);
    }
  }

  // beam state of lane w; beam 0 is the live empty prefix
  float pb = lane == 0 ? 0.f : kLog0;
  float pnb = kLog0, lm = 0.f;
  uint32_t h1 = lane == 0 ? kSeed1 : kDeadBase + lane;
  uint32_t h2 = lane == 0 ? kSeed2 : kDeadBase + lane;
  uint32_t hp1 = kNoParent + lane, hp2 = kNoParent + lane;
  int last = -1, len = 0, lcls = -1;
  if (state_in != nullptr && act) {  // resume from a carried state
    pb = __int_as_float(state_in[at]);
    pnb = __int_as_float(state_in[field + at]);
    h1 = (uint32_t)state_in[2 * field + at];
    h2 = (uint32_t)state_in[3 * field + at];
    hp1 = (uint32_t)state_in[4 * field + at];
    hp2 = (uint32_t)state_in[5 * field + at];
    last = state_in[6 * field + at];
    len = state_in[7 * field + at];
    lm = __int_as_float(state_in[8 * field + at]);
    lcls = state_in[9 * field + at];
  }
  // laddexp2(pb, pnb), carried from frame to frame: a pick's total is its
  // stay's (computed to rank it) or an extension's x + 0 (below)
  float tot = laddexp2(pb, pnb);

  if (kTable) {
    for (int i = lane; i < n_ctx * v; i += 32) s_lmt[i] = inc[i];
  }
  // frame f's inputs into its stage (nothing past the sequence's frames)
  const long long frame = (long long)n * ks;  // a frame's candidates
  const int* ck_seq = ck + (long long)seq * ks;
  const float* lpk_seq = lpk + (long long)seq * ks;
  auto issue = [&](int f) {
    if (f < n_run) {
      const int sg = f % kRing;
      const int* cs = ck_seq + f * frame;
      const float* ls = lpk_seq + f * frame;
#pragma unroll 1  // unrolled, this loop's code cost ~2% of a frame
      for (int j = lane; j < ks; j += 32) {
        cp_async4(&s_ck[sg][j], cs + j);
        cp_async4(&s_lpk[sg][j], ls + j);
      }
      if (lane == 0) cp_async4(&s_lpb[sg], lpb + (long long)f * n + seq);
    }
  };
  // Two groups a frame in one order: the frame's increments (empty
  // without a gather), then the inputs of the frame kRing - 1 ahead.
  for (int f = 0; f < kRing - 1; ++f) {
    cp_async_commit();
    issue(f);
    cp_async_commit();
  }
  auto publish = [&]() {  // the state copy the other lanes read
    if (act) {
      s_pb[lane] = pb;
      s_tot[lane] = tot;
      s_last[lane] = last;
      s_len[lane] = len;
      s_h1[lane] = h1;
      s_h2[lane] = h2;
      s_hp1[lane] = hp1;
      s_hp2[lane] = hp2;
      s_lm[lane] = lm;
      s_lcls[lane] = lcls;
      s_rep[lane] = kLog0;  // no slot holds the last token yet
      s_krep[lane] = -1;
    }
  };
  publish();
  // the increment table's row for beam w's extensions (kInc)
  auto ctx_of = [&](int w) {
    const int lw = s_last[w];
    return lw >= 0 ? (kCls ? s_lcls[w] : lw) : n_ctx - 1;
  };

  uint64_t comp[kP];
  for (int t = 0; t < n_run; ++t) {
    cp_async_wait<2 * (kRing - 2)>();  // frame t's inputs have landed
    __syncwarp();
    const int sg = t % kRing;
    const int* f_ck = s_ck[sg];
    const float* f_lpk = s_lpk[sg];
    const float lpb_t = s_lpb[sg];

    // --- the increments (and K6's classes) of this frame's extensions ----
    if (kInc && !kTable) {
      for (int j = 0, w = w0, k = k0; j < (P > 0 ? P : m); ++j) {
        if (P > 0) {
          w = sw[j];
          k = sk[j];
        }
        if (j < m) {
          const int col = min(max(f_ck[k], 0), v - 1);
          cp_async4(&s_lmt[e0 + 32 * j],
                    inc + (long long)ctx_of(w) * v + col);
        }
        if (P == 0) {
          next_slot(w, k);
        }
      }
      if (kCls) {
        for (int k = lane; k < K; k += 32)
          cp_async4(&s_ccls[k], cls_map + min(max(f_ck[k], 0), v - 1));
      }
    }
    cp_async_commit();
    issue(t + kRing - 1);  // into the stage frame t - 1 left
    cp_async_commit();

    // --- stay: each slot's lane hands its log-prob to the beams whose
    // last token it holds (tokens are unique in a frame: the top-k) ------
    for (int j = lane; j < ks; j += 32) {
      const int tok = f_ck[j];
      const float lp = f_lpk[j];
#pragma unroll 8
      for (int w = 0; w < W; w += 4) {
        const int4 l4 = *reinterpret_cast<const int4*>(s_last + w);
        if (l4.x == tok) {
          s_rep[w] = lp;
          s_krep[w] = j;
        }
        if (l4.y == tok && w + 1 < W) {
          s_rep[w + 1] = lp;
          s_krep[w + 1] = j;
        }
        if (l4.z == tok && w + 2 < W) {
          s_rep[w + 2] = lp;
          s_krep[w + 2] = j;
        }
        if (l4.w == tok && w + 3 < W) {
          s_rep[w + 3] = lp;
          s_krep[w + 3] = j;
        }
      }
    }

    // --- extension candidates from the first K slots (with P > 0 every
    // slot's loads are issued at once: slots past m write unused entries,
    // their (w, k) kept in range)
    for (int j = 0, w = w0, k = k0; j < (P > 0 ? P : m); ++j) {
      if (P > 0) {
        w = sw[j];
        k = min(sk[j], K - 1);
      }
      const int tok = f_ck[k];
      const float lp = f_lpk[k], pb_w = s_pb[w], tot_w = s_tot[w];
      const bool ok = (tok >= 0) & (tok != blank) & (s_len[w] < s_cap);
      s_ext[e0 + 32 * j] = ok ? (tok == s_last[w] ? pb_w : tot_w) + lp : kLog0;
      if (P == 0) {
        next_slot(w, k);
      }
    }

    // --- merge: beam w absorbs its parent's extension by last[w] ---------
    uint32_t hits = 0;  // the beams whose prefix is beam w's parent prefix
    if (act) {
#pragma unroll 8
      for (int p = 0; p < W; p += 4) {
        const uint4 a = *reinterpret_cast<const uint4*>(s_h1 + p);
        const uint4 b = *reinterpret_cast<const uint4*>(s_h2 + p);
        const int4 l = *reinterpret_cast<const int4*>(s_len + p);
        hits |= (uint32_t)(a.x == hp1 && b.x == hp2 && l.x < s_cap) << p;
        hits |= (uint32_t)(a.y == hp1 && b.y == hp2 && l.y < s_cap)
                << (p + 1);
        hits |= (uint32_t)(a.z == hp1 && b.z == hp2 && l.z < s_cap)
                << (p + 2);
        hits |= (uint32_t)(a.w == hp1 && b.w == hp2 && l.w < s_cap)
                << (p + 3);
      }
      hits &= W < 32 ? (1u << W) - 1 : kFull;
    }
    __syncwarp();  // s_ext, s_rep and s_krep are complete
    const float rep = act ? s_rep[lane] : kLog0;
    const int krep = s_krep[lane];
    float val = 0.f;
    for (uint32_t h = hits; h != 0; h &= h - 1) {
      const int p = __ffs(h) - 1;
      val += s_last[p] == last ? s_pb[p] : s_tot[p];
      if (krep >= 0 && krep < K && last >= 0 && last != blank)
        s_ext[krep * W + p] = kLog0;  // the merged extension leaves
    }
    const float pb_stay = tot + lpb_t;
    float pnb_stay = last >= 0 ? pnb + rep : kLog0;
    const float add = hits != 0 && rep > kLog0Threshold &&
                              val > kLog0Threshold
                          ? val + rep
                          : kLog0;
    // laddexp2(x, log-zero) is x + 0 above the threshold: no exp, no log
    pnb_stay = add != kLog0 ? laddexp2(pnb_stay, add)
               : pnb_stay > kLog0Threshold ? pnb_stay + 0.f
                                           : kLog0;
    const float stay_tot = laddexp2(pb_stay, pnb_stay);
    const float stay = stay_tot + lm;  // ranked with the bonus
    if (act) {
      s_pbs[lane] = pb_stay;
      s_pnbs[lane] = pnb_stay;
      s_stot[lane] = stay_tot;
    }
    if (kInc && !kTable) {  // the increments have landed: the bonuses
      cp_async_wait<1>();
      for (int j = 0, w = w0; j < (P > 0 ? P : m); ++j) {
        if (P > 0) w = sw[j];
        if (j < m) s_lmt[e0 + 32 * j] = s_lm[w] + s_lmt[e0 + 32 * j];
        if (P == 0) w = (e0 + 32 * (j + 1)) % W;
      }
    }
    __syncwarp();  // the merges' removals and the bonuses are in place

    // --- top-W --------------------------------------------------------
    auto slot = [&](int j, int w, int k) {  // extension slot j's composite
      const int e = e0 + 32 * j;
      float bonus = s_lm[w];
      if (kInc)
        bonus = kTable ? bonus + s_lmt[ctx_of(w) * v +
                                       min(max(f_ck[k], 0), v - 1)]
                       : s_lmt[e];
      return composite(s_ext[e] + bonus, W + w * K + k);
    };
    const uint64_t c_stay = act ? composite(stay, lane) : 0;
    // this lane's best composite below `below` (any with all)
    auto best = [&](uint64_t below, bool all) {
      uint64_t b = all || c_stay < below ? c_stay : 0;
      if (P > 0) {
#pragma unroll
        for (int j = 0; j < kP; ++j) {
          const uint64_t c = comp[j];
          if ((all || c < below) && c > b) b = c;
        }
      } else {
        for (int j = 0, w = w0, k = k0; j < m; ++j) {
          const uint64_t c = slot(j, w, k);
          if ((all || c < below) && c > b) b = c;
          next_slot(w, k);
        }
      }
      return b;
    };
    if (P > 0) {
#pragma unroll
      for (int j = 0; j < kP; ++j)
        comp[j] = j < m ? slot(j, sw[j], sk[j]) : 0;
    }
    uint64_t head = best(0, true);
    int my_code = lane;
    uint32_t my_key = 0;
    bool picked = false;
    if (P > 0) {
      // The lanes' heads sorted across the warp; tau, the W-th of them,
      // bounds the picks from below.  If W of them are live and no lane
      // holds two candidates >= tau, the sorted heads are the picks; if
      // the candidates >= tau are at most 32, sorting them gives them.
      const uint64_t heads = warp_sort_desc(head, lane);
      const uint64_t tau =
          __shfl_sync(kFull, (unsigned long long)heads, W - 1);
      if ((uint32_t)(tau >> 32) > kKeyLog0) {
        int cnt = c_stay >= tau;
#pragma unroll
        for (int j = 0; j < kP; ++j) cnt += comp[j] >= tau;
        uint64_t pick = heads;
        picked = __ballot_sync(kFull, cnt > 1) == 0;
        if (!picked) {  // the candidates >= tau, one a lane, sorted
          int below = cnt;  // an inclusive scan of the counts
#pragma unroll
          for (int d = 1; d < 32; d <<= 1) {
            const int y = __shfl_up_sync(kFull, below, d);
            below += lane >= d ? y : 0;
          }
          const int total = __shfl_sync(kFull, below, 31);
          if (total <= 32) {
            int at_ = below - cnt;
            if (c_stay >= tau) s_surv[at_++] = c_stay;
#pragma unroll
            for (int j = 0; j < kP; ++j)
              if (comp[j] >= tau) s_surv[at_++] = comp[j];
            __syncwarp();
            pick = warp_sort_desc(lane < total ? s_surv[lane] : 0, lane);
            picked = true;
          }
        }
        if (picked && act) {
          my_code = (int)~(uint32_t)pick;
          my_key = (uint32_t)(pick >> 32);
        }
      }
    }
    if (!picked) {  // W rounds of two reductions
      int r = 0;
      for (; r < W; ++r) {
        const uint32_t hk = (uint32_t)(head >> 32);
        const uint32_t mk = __reduce_max_sync(kFull, hk);
        if (mk <= kKeyLog0) break;  // nothing above log-zero is left
        if (lane == r) my_key = mk;
        const uint32_t lo = hk == mk ? (uint32_t)head : 0u;
        const uint32_t mc = __reduce_max_sync(kFull, lo);
        if (lane == r) my_code = (int)~mc;
        if (lo == mc) head = best(head, false);  // the winner's next best
      }
      if (r < W) {  // every later round picks the same code, at log-zero:
        // the best of all candidates with their keys clamped to log-zero's
        uint64_t d = at_most_log0(c_stay);
        if (P > 0) {
#pragma unroll
          for (int j = 0; j < kP; ++j) d = max64(d, at_most_log0(comp[j]));
        } else {
          for (int j = 0, w = w0, k = k0; j < m; ++j) {
            d = max64(d, at_most_log0(slot(j, w, k)));
            next_slot(w, k);
          }
        }
        const uint32_t dk_ = (uint32_t)(d >> 32);
        const uint32_t mk = __reduce_max_sync(kFull, dk_);
        const uint32_t mc =
            __reduce_max_sync(kFull, dk_ == mk ? (uint32_t)d : 0u);
        if (lane >= r) {
          my_code = (int)~mc;
          my_key = mk;
        }
      }
    }

    // --- the picks' state, each lane its own ------------------------------
    float n_pb = kLog0, n_pnb = kLog0, n_lm = 0.f, n_tot = kLog0;
    uint32_t n_h1 = kDeadBase + lane, n_h2 = kDeadBase + lane;
    uint32_t n_hp1 = kNoParent + lane, n_hp2 = kNoParent + lane;
    int n_last = -1, n_len = 0, n_lcls = kCls ? -1 : lcls;
    {  // every field of both kinds of pick read at once, then chosen
      const bool is_stay = my_code < W;
      const int parent = min(is_stay ? my_code : (my_code - W) / K, W - 1);
      const int k = is_stay ? 0 : my_code - W - parent * K;
      const int c = k * W + parent;  // its slot-major index
      const int tok = f_ck[k];
      const float e_pnb = s_ext[c], s_pb_ = s_pbs[parent];
      const float s_pnb_ = s_pnbs[parent], s_tot_ = s_stot[parent];
      const float lm_p = s_lm[parent];
      const int last_p = s_last[parent], len_p = s_len[parent];
      const uint32_t h1_p = s_h1[parent], h2_p = s_h2[parent];
      const uint32_t hp1_p = s_hp1[parent], hp2_p = s_hp2[parent];
      float e_lm = lm_p;
      if (kInc)
        e_lm = kTable ? lm_p + s_lmt[ctx_of(parent) * v +
                                     min(max(tok, 0), v - 1)]
                      : s_lmt[c];
      if (act && my_key > kKeyDead) {  // else a dead pick: no mass, no state
        n_pb = is_stay ? s_pb_ : kLog0;
        n_pnb = is_stay ? s_pnb_ : e_pnb;
        // an extension's laddexp2(log-zero, x): x + 0 above the threshold
        n_tot = is_stay ? s_tot_
                : e_pnb > kLog0Threshold ? e_pnb + 0.f
                                         : kLog0;
        n_lm = is_stay ? lm_p : e_lm;
        n_last = is_stay ? last_p : tok;
        n_len = is_stay ? len_p : len_p + 1;
        n_h1 = is_stay ? h1_p : h1_p * kM1 + (uint32_t)(tok + 1);
        n_h2 = is_stay ? h2_p : h2_p * kM2 + (uint32_t)(tok + 1);
        n_hp1 = is_stay ? hp1_p : h1_p;
        n_hp2 = is_stay ? hp2_p : h2_p;
        if (kCls) n_lcls = is_stay ? s_lcls[parent] : s_ccls[k];
      }
    }
    if (act) bp[((long long)t * W + lane) * n + seq] = my_code;
    __syncwarp();  // every lane is done with this frame's shared state
    if (act) {
      pb = n_pb;
      pnb = n_pnb;
      tot = n_tot;
      lm = n_lm;
      h1 = n_h1;
      h2 = n_h2;
      hp1 = n_hp1;
      hp2 = n_hp2;
      last = n_last;
      len = n_len;
      lcls = n_lcls;
    }
    publish();
  }
  // frozen frames: the state stays, every beam "stays"
  if (act) {
    for (int t = n_run; t < t_max; ++t)
      bp[((long long)t * W + lane) * n + seq] = lane;
  }
  cp_async_wait<0>();
  if (act) {
    score[at] = tot + lm;
    state_out[at] = __float_as_int(pb);
    state_out[field + at] = __float_as_int(pnb);
    state_out[2 * field + at] = (int)h1;
    state_out[3 * field + at] = (int)h2;
    state_out[4 * field + at] = (int)hp1;
    state_out[5 * field + at] = (int)hp2;
    state_out[6 * field + at] = last;
    state_out[7 * field + at] = len;
    state_out[8 * field + at] = __float_as_int(lm);
    state_out[9 * field + at] = lcls;
  }
}

template <bool kInc, bool kCls, bool kTable>
void launch(int slots, dim3 grid, cudaStream_t stream, const float* lpk,
            const int* ck, const float* lpb, const int* il, const float* inc,
            const int* cls_map, const int* state_in, int* bp, float* score,
            int* state_out, int t_max, int n, int ks, int W, int K,
            int s_cap, int blank, int n_ctx, int v) {
  auto kernel = slots <= 4    ? beam_step_kernel<kInc, kCls, kTable, 4>
                : slots <= 16 ? beam_step_kernel<kInc, kCls, kTable, 16>
                              : beam_step_kernel<kInc, kCls, kTable, 0>;
  kernel<<<grid, 32, 0, stream>>>(lpk, ck, lpb, il, inc, cls_map, state_in,
                                  bp, score, state_out, t_max, n, ks, W, K,
                                  s_cap, blank, n_ctx, v);
}

}  // namespace

// inc (n_ctx, v) f32 or null (no increments); cls_map (v,) i32 or null
// (symbol-keyed contexts); state_in (10, W, n) i32 (floats as bits) or null
// (the empty prefix).  Writes bp (t_max, W, n), score (W, n) and
// state_out (10, W, n).
extern "C" int e2e_beam_step_f32(const void* lpk, const void* ck,
                                 const void* lpb, const void* il,
                                 const void* inc, const void* cls_map,
                                 const void* state_in, void* bp, void* score,
                                 void* state_out, int t_max, int n, int ks,
                                 int W, int K, int s_cap, int blank,
                                 int n_ctx, int v, void* stream) {
  if (W < 1 || W > kMaxW || K < 1 || K > kMaxK || ks < K || ks > kMaxKs)
    return (int)cudaErrorInvalidValue;
  if (inc != nullptr && (n_ctx < 1 || n_ctx > kMaxCtx || v < 1))
    return (int)cudaErrorInvalidValue;
  if (cls_map != nullptr && inc == nullptr)
    return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const int slots = (W * K + 31) / 32;  // extension slots of lane 0
    auto go = inc == nullptr                   ? launch<false, false, false>
              : cls_map != nullptr             ? launch<true, true, false>
              : n_ctx * v <= kMaxW * kMaxK ? launch<true, false, true>
                                               : launch<true, false, false>;
    go(slots, dim3(n), (cudaStream_t)stream, (const float*)lpk,
       (const int*)ck, (const float*)lpb, (const int*)il, (const float*)inc,
       (const int*)cls_map, (const int*)state_in, (int*)bp, (float*)score,
       (int*)state_out, t_max, n, ks, W, K, s_cap, blank, n_ctx, v);
  }
  return (int)cudaGetLastError();
}
