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
//     table), W rounds of argmax, equal scores by smallest code; a pick's
//     acoustic mass is its unranked value, its bonus the ranked one's;
//   * a pick at log-zero carries no state (dead slot: slot-unique hashes,
//     bonus 0, class -1);
//   * frames t >= il[n] leave the state as it is and emit code w;
//   * the final score is logaddexp(pb, pnb) + lm.
// Prefix hashes are two 32-bit rolling hashes with wraparound (uint32 here,
// int32 on the TPU: the same bits).  Log-zero is the finite -1e30 of
// ops/semiring.py, never -inf.  The ranking sums are additions only (the
// increments arrive precomputed), so no multiply-add contraction can make
// the kernel rank or break ties differently from its plain twin
// (ops/beam_search_cuda.py::beam_step_plain).
//
// What bounds it on the H100: nothing in bytes (per frame a sequence reads
// ks*8 + 4 bytes, W*K increments out of the L2-resident (C, V) table, and
// writes 4*W) and little in arithmetic (about W*(W*K) compares per frame);
// the frame loop is a chain of dependent warp reductions, so it is bound by
// latency: a few microseconds per frame.
//
// Design: one warp per sequence; lane w owns beam w's state in registers
// (W <= 32), and shared memory holds the frame's candidates, a copy of the
// beam state for cross-lane reads, the W*K extension scores and (with an
// increment table) their W*K bonuses.  The TPU streams a (T, C, K, N)
// increment tensor built outside the kernel; here each extension reads
// inc[ctx * V + token] itself from the (C, V) table in global memory (at
// most 64 x V floats, L2-resident).  Each top-W round is a strided scan
// plus a 5-step shuffle reduction; there is no __syncthreads, only
// __syncwarp.  With one block per sequence, B = 8..32 sequences fill 8..32
// of the 132 SMs: a low-occupancy first design, kept simple on purpose.

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
constexpr int kBigCode = 1 << 30;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kM1 = 2654435761u;
constexpr uint32_t kM2 = 0x85EBCA6Bu;
constexpr uint32_t kSeed1 = 1u;
constexpr uint32_t kSeed2 = 7u;
constexpr uint32_t kDeadBase = 0x7EAD0000u;
constexpr uint32_t kNoParent = 0x5EED0000u;  // matches no prefix hash

__device__ __forceinline__ float laddexp2(float a, float b) {
  const float m = fmaxf(a, b);
  const float m_safe = fmaxf(m, kLog0);
  const float d = fmaxf(-fabsf(a - b), kLog0);
  const float out = m_safe + log1pf(expf(d));
  return m > kLog0Threshold ? out : kLog0;
}

// (v, c) ranks before (bv, bc): larger score, equal score by smaller code.
__device__ __forceinline__ bool before(float v, int c, float bv, int bc) {
  return v > bv || (v == bv && c < bc);
}

// kInc: extensions add inc[ctx, token] to their bonus (K5, K6);
// kCls: ctx is the class of the last symbol (K6), else the symbol (K5).
template <bool kInc, bool kCls>
__global__ void __launch_bounds__(32)
    beam_step_warp_per_seq(const float* __restrict__ lpk,
                           const int* __restrict__ ck,
                           const float* __restrict__ lpb,
                           const int* __restrict__ il,
                           const float* __restrict__ inc,
                           const int* __restrict__ cls_map,
                           const int* __restrict__ state_in,
                           int* __restrict__ bp, float* __restrict__ score,
                           int* __restrict__ state_out, int t_max, int n,
                           int ks, int W, int K, int s_cap, int blank,
                           int n_ctx, int v) {
  __shared__ float s_lpk[kMaxKs];
  __shared__ int s_ck[kMaxKs];
  __shared__ float s_ext[kMaxW * kMaxK];
  __shared__ float s_lmt[kInc ? kMaxW * kMaxK : 1];
  __shared__ float s_pb[kMaxW], s_tot[kMaxW], s_pbs[kMaxW], s_pnbs[kMaxW];
  __shared__ float s_lm[kMaxW];
  __shared__ uint32_t s_h1[kMaxW], s_h2[kMaxW], s_hp1[kMaxW], s_hp2[kMaxW];
  __shared__ int s_last[kMaxW], s_len[kMaxW], s_lcls[kMaxW];

  const int seq = blockIdx.x;
  const int lane = threadIdx.x;
  const bool act = lane < W;
  const int n_ext = W * K;
  const int my_il = il[seq];
  const long long field = (long long)W * n;  // stride of a state field
  const long long at = (long long)lane * n + seq;
  // (w, k) of this lane's first extension slot c = lane, and the step of
  // (w, k) as c advances by 32: no division inside the frame loop
  const int w0 = lane / K, k0 = lane % K, dw = 32 / K, dk = 32 % K;

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

  for (int t = 0; t < t_max; ++t) {
    int* bp_t = bp + (long long)t * W * n + seq;  // bp[t, w, seq] at w * n
    if (t >= my_il) {  // frozen: state unchanged, every beam "stays"
      if (act) bp_t[lane * n] = lane;
      continue;
    }
    const long long row = (long long)t * n + seq;
    for (int j = lane; j < ks; j += 32) {
      s_lpk[j] = lpk[row * ks + j];
      s_ck[j] = ck[row * ks + j];
    }
    const float lpb_t = lpb[row];
    const float total = laddexp2(pb, pnb);
    if (act) {
      s_pb[lane] = pb;
      s_tot[lane] = total;
      s_last[lane] = last;
      s_len[lane] = len;
      s_h1[lane] = h1;
      s_h2[lane] = h2;
      s_hp1[lane] = hp1;
      s_hp2[lane] = hp2;
      s_lm[lane] = lm;
      s_lcls[lane] = lcls;
    }
    __syncwarp();

    // --- stay candidate: repeat-last read over the whole ks window -------
    float rep = -CUDART_INF_F;
    for (int j = 0; j < ks; ++j)
      rep = fmaxf(rep, s_ck[j] == last ? s_lpk[j] : kLog0);
    const float pb_stay = total + lpb_t;
    float pnb_stay = last >= 0 ? pnb + rep : kLog0;

    // --- extension candidates from the first K slots, and their bonus ----
    for (int c = lane, w = w0, k = k0; c < n_ext; c += 32) {
      const int tok = s_ck[k];
      const bool ok = tok >= 0 && tok != blank && s_len[w] < s_cap;
      s_ext[c] = ok ? (tok == s_last[w] ? s_pb[w] : s_tot[w]) + s_lpk[k]
                    : kLog0;
      if (kInc) {
        const int lw = s_last[w];
        const int ctx = lw >= 0 ? (kCls ? s_lcls[w] : lw) : n_ctx - 1;
        const int col = min(max(tok, 0), v - 1);
        s_lmt[c] = s_lm[w] + __ldg(inc + (long long)ctx * v + col);
      }
      w += dw;
      k += dk;
      if (k >= K) {
        k -= K;
        ++w;
      }
    }

    // --- merge: beam w absorbs its parent's extension by last[w] ---------
    float val = 0.f;
    bool hit = false;
    int par = 0;
    if (act) {
      for (int p = 0; p < W; ++p) {
        if (s_h1[p] == hp1 && s_h2[p] == hp2 && s_len[p] < s_cap) {
          val += s_last[p] == last ? s_pb[p] : s_tot[p];
          hit = true;
          par = p;
        }
      }
    }
    __syncwarp();  // s_ext is complete before the merged entry is removed
    if (hit) {
      for (int k = 0; k < K; ++k) {
        const int tok = s_ck[k];
        if (tok == last && tok >= 0 && tok != blank)
          s_ext[par * K + k] = kLog0;
      }
    }
    const float add = hit && rep > kLog0Threshold && val > kLog0Threshold
                          ? val + rep
                          : kLog0;
    pnb_stay = laddexp2(pnb_stay, add);
    float stay = laddexp2(pb_stay, pnb_stay) + lm;  // ranked with the bonus
    if (act) {
      s_pbs[lane] = pb_stay;
      s_pnbs[lane] = pnb_stay;
    }
    __syncwarp();

    // --- top-W by W rounds of argmax over acoustic + bonus -----------------
    float n_pb = kLog0, n_pnb = kLog0, n_lm = 0.f;
    uint32_t n_h1 = 0, n_h2 = 0, n_hp1 = 0, n_hp2 = 0;
    int n_last = -1, n_len = 0, n_lcls = lcls, my_code = 0;
    for (int r = 0; r < W; ++r) {
      float bv = -CUDART_INF_F;
      int bc = kBigCode;
      if (act) {
        bv = stay;
        bc = lane;
      }
      for (int c = lane, w = w0, k = k0; c < n_ext; c += 32) {
        const float rank = s_ext[c] + (kInc ? s_lmt[c] : s_lm[w]);
        if (before(rank, W + c, bv, bc)) {
          bv = rank;
          bc = W + c;
        }
        w += dw;
        k += dk;
        if (k >= K) {
          k -= K;
          ++w;
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(kFull, bv, off);
        const int oc = __shfl_xor_sync(kFull, bc, off);
        if (before(ov, oc, bv, bc)) {
          bv = ov;
          bc = oc;
        }
      }
      const float mx = bv;
      const int code = bc;
      const bool is_stay = code < W;
      // an extension pick's acoustic mass and bonus, read before it leaves
      // the pool
      float pick_ac = 0.f, pick_lm = 0.f;
      if (!is_stay) {
        pick_ac = s_ext[code - W];
        pick_lm = kInc ? s_lmt[code - W] : s_lm[(code - W) / K];
      }
      __syncwarp();
      // remove the pick from the pool (its owner lane writes it)
      if (is_stay) {
        if (lane == code) stay = kLog0;
      } else if (lane == (code - W) % 32) {
        s_ext[code - W] = kLog0;
      }
      if (lane == r) {
        my_code = code;
        const int parent = is_stay ? code : (code - W) / K;
        if (mx <= kLog0Threshold) {  // dead pick: no mass, unique hashes
          n_pb = kLog0;
          n_pnb = kLog0;
          n_lm = 0.f;
          n_last = -1;
          n_len = 0;
          n_h1 = n_h2 = kDeadBase + r;
          n_hp1 = n_hp2 = kNoParent + r;
          if (kCls) n_lcls = -1;
        } else if (is_stay) {
          n_pb = s_pbs[parent];
          n_pnb = s_pnbs[parent];
          n_lm = s_lm[parent];
          n_last = s_last[parent];
          n_len = s_len[parent];
          n_h1 = s_h1[parent];
          n_h2 = s_h2[parent];
          n_hp1 = s_hp1[parent];
          n_hp2 = s_hp2[parent];
          if (kCls) n_lcls = s_lcls[parent];
        } else {
          const int tok = s_ck[(code - W) % K];
          n_pb = kLog0;
          n_pnb = pick_ac;
          n_lm = pick_lm;
          n_last = tok;
          n_len = s_len[parent] + 1;
          n_h1 = s_h1[parent] * kM1 + (uint32_t)(tok + 1);
          n_h2 = s_h2[parent] * kM2 + (uint32_t)(tok + 1);
          n_hp1 = s_h1[parent];
          n_hp2 = s_h2[parent];
          if (kCls) n_lcls = __ldg(cls_map + min(max(tok, 0), v - 1));
        }
      }
      __syncwarp();
    }
    if (act) {
      bp_t[lane * n] = my_code;
      pb = n_pb;
      pnb = n_pnb;
      lm = n_lm;
      h1 = n_h1;
      h2 = n_h2;
      hp1 = n_hp1;
      hp2 = n_hp2;
      last = n_last;
      len = n_len;
      lcls = n_lcls;
    }
    __syncwarp();  // every lane is done with this frame's shared memory
  }
  if (act) {
    score[at] = laddexp2(pb, pnb) + lm;
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
    auto kernel = inc == nullptr       ? beam_step_warp_per_seq<false, false>
                  : cls_map == nullptr ? beam_step_warp_per_seq<true, false>
                                       : beam_step_warp_per_seq<true, true>;
    kernel<<<n, 32, 0, (cudaStream_t)stream>>>(
        (const float*)lpk, (const int*)ck, (const float*)lpb, (const int*)il,
        (const float*)inc, (const int*)cls_map, (const int*)state_in,
        (int*)bp, (float*)score, (int*)state_out, t_max, n, ks, W, K, s_cap,
        blank, n_ctx, v);
  }
  return (int)cudaGetLastError();
}
