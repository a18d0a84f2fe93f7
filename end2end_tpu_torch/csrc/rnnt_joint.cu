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
// give the shard's partial dh and its own dW, db columns; K12 splits the
// rows over as many blocks as fill the card, so a shard's fewer V tiles do
// not leave SMs idle.
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
// tensor cores (2.03 ms for K10, 4.06 ms for K11 and K12 at 4096 operations
// a clock per SM at the card's max SM clock, 1,980 MHz) and the exp unit
// (2.03 ms at 16 exps a clock per SM), not by bytes.
//
// Design of K10 (forward).  The TPU kernels (_fwd_kernel, :78, and
// _fwd_kernel_tp, :376) keep all of W in VMEM and walk 512-row blocks over
// 512-lane V tiles.  On the card K10 takes K11's skeleton: W and its log2
// bias through a ring of TMA bulk copies in the stages' order (w_tiles,
// dh_bias), the logits S = h W_tile by wgmma into registers, h resident in
// shared memory up to J = 640 and streamed with W above.  At J = 128 its
// products and its exps bound it alike: 2 R J V = 2.17e12 bf16 operations
// and R V = 8.5e9 exps take 2.03 ms each at 1,980 MHz, so a design that
// runs a tile's products and then its exps cannot go below ~4.1 ms.  So
// the online softmax runs on the accumulators (one FMA into log2 units,
// an exp2 an element against the running max of the earlier tiles, so
// that the exps need not wait for the tile's max; the running max and sum
// of a row in registers), and the warpgroups that share a W tile never
// wait for each other (a stage is refilled by the last warp done with it,
// not behind a barrier): one's softmax runs under another's products.  Up
// to J = 128 a block has four warpgroups, 256 rows a W tile (a quarter of
// the W traffic from L2 of the 64 rows before), so each scheduler has
// four warps to hide the softmax's latencies; one set of 64 accumulators
// a thread, 124 registers, one block per SM.  Above J = 128 two
// warpgroups (128 rows), as K11.  The card holds it at its 700 W limit.
//
// Design of K11 (dh).  The TPU kernel keeps all of W in VMEM and walks
// 512-row blocks; 8 MB of W does not fit in 227 KB of shared memory, so
// on the card W streams from L2 and each W tile is shared by as many rows
// as the registers allow: 128 rows a block, two warpgroups of 64, which
// halves the W traffic from L2 against 64 rows (16.6 GB at the bench row).
// The block's h tile (128 x J, 32 KB at J = 128) is loaded once; W tiles
// of 128 columns, with their bias in log2 units, stream through a ring of
// up to 4 stages, each filled by TMA bulk copies (one thread, an mbarrier
// a stage) three tiles ahead of the products.  The wrapper lays W out
// tile by tile in the stage's core-matrix order, so a stage is one
// contiguous copy (W rows read at their 64 KB stride cost 40% of the
// kernel).  Per tile a warpgroup computes its 64 x 128 logits with wgmma
// (m64n128k16, both operands from shared memory) into registers, forms d
// there (an FMA and an exp2 per element, the rows' statistics held in
// registers for the whole kernel), and multiplies bf16(d), repacked as
// the register A operand, by the same W tile read K-major (m64nJk16): the
// logits and d never reach shared memory, and a tile costs one barrier.
// 154 registers a thread, one block per SM.  J > 128: a second grid
// dimension over 128-column slabs of dh (the (64, J) accumulator would
// not fit in registers); each slab block recomputes the logits over every
// J slab (one ring item per slab, its own last) and accumulates its own
// slab: J/128 times the logits work.  Up to J = 640 the whole h tile
// stays in shared memory; above, h streams slab by slab with W, laid out
// by the wrapper as the stages hold it.
//
// Design of K12 (dW, db).  The TPU's sequential grid (V tile outer, row
// block inner, sums carried in scratch) becomes a grid of 256-column V
// tiles x row splits (x 128-row J slabs above J = 128): S contiguous runs
// of whole 64-row blocks per tile, S chosen on the host (plan_splits in
// ops/rnnt_joint_cuda.py) so that the grid fills the card; each split's
// partial dW, db go to a workspace that a second kernel adds up in split
// order: deterministic, no atomics.  512 threads, four warpgroups of 64
// columns.  Per 64-row block a warpgroup computes the transposed logits
// S^T = W_tile^T h^T with wgmma (m64n64k16, both operands read from
// shared memory by the tensor cores), forms d in the accumulator
// registers (one fused multiply-add and an exp2 per element, the row
// statistics staged in shared memory), sums db in registers, and rounds d
// to bf16 into the register A operand of dW^T += d^T h (m64nJk16, B the
// same h tile read N-major): the logits and d never reach shared memory,
// and a row block costs one barrier.  h and the row statistics stream
// through a 3-stage cp.async ring, a row block ahead of the products; the
// block's W tile is loaded once.  256 columns rather than 128 halve the h
// traffic from L2 (17 GB at the bench row with 128); one block of 16
// warps per SM, 128 registers a thread, 118 KB of shared memory.  On an
// H100 its largest parts are the dW product and the h loads, and some
// cards hold it at their 700 W limit, ~1,860 of 1,980 MHz (PERF.md).  J >
// 128: each J slab's block recomputes the logits over the whole J, W
// streaming slab by slab through a 2-stage ring with h.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;             // K12: rows of h per row block
constexpr int kTile = 128;            // vocabulary columns per tile
constexpr int kSlab = 128;            // J rows per slab when J > 128
constexpr float kNeg = -3.0e38f;      // the running max's identity
constexpr int kDwTile = 256;          // K12: vocabulary columns per block
constexpr int kDwThreads = 512;       // K12: a warp per 16 columns

// A wgmma shared-memory descriptor without swizzle: the operand is made of
// 8 x 8 core matrices of 128 contiguous bytes (8 rows of 16 bytes), `sbo`
// bytes apart along M or N and `lbo` bytes apart along K.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of wgmma accumulators
// across the asynchronous product's issue and wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// This thread's completed cp.async writes, visible to wgmma's reads.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Operand majors of wgmma's immediate transpose flags: a shared-memory
// operand is K-major (0) or M-/N-major (1).
constexpr int kKMajor = 0, kMNMajor = 1;

// D (64 x N) (+)= A (64 x 16) B (16 x N), both from shared memory
// descriptors, each K-major or M-/N-major as TA and TB say; scale_d = 0
// overwrites D.  N is 64 or 128.
template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  static_assert(N == 64 || N == 128, "wgmma_ss: N is 64 or 128");
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
          "%0, %1, %2, %3, %4, %5, %6, %7, "
          "%8, %9, %10, %11, %12, %13, %14, %15, "
          "%16, %17, %18, %19, %20, %21, %22, %23, "
          "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
          "%0, %1, %2, %3, %4, %5, %6, %7, "
          "%8, %9, %10, %11, %12, %13, %14, %15, "
          "%16, %17, %18, %19, %20, %21, %22, %23, "
          "%24, %25, %26, %27, %28, %29, %30, %31, "
          "%32, %33, %34, %35, %36, %37, %38, %39, "
          "%40, %41, %42, %43, %44, %45, %46, %47, "
          "%48, %49, %50, %51, %52, %53, %54, %55, "
          "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  }
}

// D (64 x N) += A (64 x 16, registers) B (16 x N, a shared memory
// descriptor, N-major by default, K-major with TB = kKMajor).  N is 16,
// 32, 64 or 128.
template <int N, int TB = kMNMajor>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  static_assert(N == 16 || N == 32 || N == 64 || N == 128,
                "wgmma_rs: N is 16, 32, 64 or 128");
  if constexpr (N == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{"
          "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
          "n"(TB));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{"
          "%0, %1, %2, %3, %4, %5, %6, %7, "
          "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
          "n"(TB));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
          "%0, %1, %2, %3, %4, %5, %6, %7, "
          "%8, %9, %10, %11, %12, %13, %14, %15, "
          "%16, %17, %18, %19, %20, %21, %22, %23, "
          "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
          "n"(TB));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
          "%0, %1, %2, %3, %4, %5, %6, %7, "
          "%8, %9, %10, %11, %12, %13, %14, %15, "
          "%16, %17, %18, %19, %20, %21, %22, %23, "
          "%24, %25, %26, %27, %28, %29, %30, %31, "
          "%32, %33, %34, %35, %36, %37, %38, %39, "
          "%40, %41, %42, %43, %44, %45, %46, %47, "
          "%48, %49, %50, %51, %52, %53, %54, %55, "
          "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
          "n"(TB));
  }
}

// 16 bytes (8 bf16) from global memory, or zeros when `live` is false.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                          bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(live ? 16 : 0));
}

// 4 bytes, or zeros when `live` is false.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                         bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(live ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kInf = __builtin_huge_valf();

// 2^x (ex2.approx: ~2 ulp; 2^-inf = 0).
__device__ __forceinline__ float ex2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// K12's shared memory: a ring of stages, each an h tile (64 rows x JP
// columns, one 128-row J slab when WIDE) and the 64 rows' statistics (a
// float4 of m, log s, gb, gl a row, then y); when WIDE each stage also
// holds the slab's W rows, else the block's W tile (JP x 128) sits
// outside the ring, loaded once.  The h and W
// tiles are laid out in core matrices (see smem_desc): h's of rows 8a..
// and columns 8b.. at (8 b + a) * 128 bytes, W's of rows 8a.. and columns
// 8b.. at (16 a + b) * 128 bytes; within one, row i at 16 i bytes.
template <int NJ, bool WIDE>
struct DwLayout {
  static constexpr int JP = 16 * NJ;
  static constexpr int kStages = WIDE ? 2 : 3;
  static constexpr size_t h_bytes = (size_t)kRows * JP * 2;
  static constexpr size_t w_bytes = (size_t)JP * kDwTile * 2;
  static constexpr size_t st_bytes = (size_t)5 * kRows * 4;
  static constexpr size_t stage = h_bytes + st_bytes + (WIDE ? w_bytes : 0);
  static constexpr size_t bytes = kStages * stage + (WIDE ? 0 : w_bytes);
};

// The core-matrix strides of the h and W tiles.
constexpr uint32_t kHRows8 = 128;          // h: 8 rows further
constexpr uint32_t kHCols8 = 8 * 128;      // h: 8 columns (J) further
constexpr uint32_t kWCols8 = 128;                // W: 8 columns (V) further
constexpr uint32_t kWRows8 = kDwTile / 8 * 128;  // W: 8 rows (J) further

// Columns j0..j0+JP-1 of rows r0..r0+63 of h (R, J) into an h tile, and,
// when `w` is given, rows j0..j0+JP-1 of W's columns c0..c0+127 into a W
// tile; zeros past R and J.  Eight neighbouring threads copy the 16-byte
// rows of one core matrix: 128 contiguous bytes of shared memory, and
// 16-byte pieces of 8 rows of global memory, 64 contiguous bytes a row for
// a warp.
template <int JP>
__device__ __forceinline__ void issue_h(const bf16* __restrict__ h,
                                        uint32_t hs, long r0, long R, int J,
                                        int j0) {
  for (int i = threadIdx.x; i < kRows * (JP / 8); i += kDwThreads) {
    const int ri = i % 8, b = (i / 8) % (JP / 8), a = i / JP;
    const long r = r0 + 8 * a + ri;
    const int j = j0 + 8 * b;
    const bool live = r < R && j < J;
    cp_async16(hs + b * kHCols8 + a * kHRows8 + ri * 16,
               live ? h + r * J + j : h, live);
  }
}

template <int JP>
__device__ __forceinline__ void issue_w(const bf16* __restrict__ w,
                                        uint32_t ws, int c0, int J, int j0,
                                        int Vp) {
  for (int i = threadIdx.x; i < JP * (kDwTile / 8); i += kDwThreads) {
    const int ji = i % 8, b = (i / 8) % (kDwTile / 8), a = i / kDwTile;
    const int j = j0 + 8 * a + ji;
    const bool live = j < J && c0 + 8 * b < Vp;
    cp_async16(ws + a * kWRows8 + b * kWCols8 + ji * 16,
               live ? w + (size_t)j * Vp + c0 + 8 * b : w, live);
  }
}

// K12 (K12tp on a shard).  Grid: x the 256-column V tiles (fastest, so the
// blocks in flight share rows and h is read from L2; a last tile past Vp
// computes on zeros and stores nothing), y the 128-row J slabs (WIDE), z
// the `splits` row splits, each a contiguous range of whole 64-row
// blocks.  Each block writes dW (ldj, Vp) and db (Vp,) of its rows,
// one after the other at dst + split * (ldj + 1) * Vp; with one split that
// is the output, else the workspace that rnnt_joint_dw_sum_kernel adds up
// in split order.  J is a multiple of 8 (the wrapper pads h and W).
//
// Warpgroup g owns vocabulary columns 64g..64g+63 of the tile and, per row
// block, computes the transposed logits S^T = W_tile^T h^T (64 x 64) with
// wgmma from shared memory into registers (warp w of the block: columns
// 16w..16w+15), forms d from them in registers, adds its float32 d to the
// two db sums of its columns, rounds d to bf16 and repacks the
// accumulators as the register A operand of dW^T += d^T h (64 x JP), whose
// B operand is the same h tile read N-major.
template <int NJ, bool WIDE>
__global__ void __launch_bounds__(kDwThreads, 1)
    rnnt_joint_dw_kernel(const bf16* __restrict__ h,
                         const bf16* __restrict__ w,
                         const float* __restrict__ b,
                         const int* __restrict__ y,
                         const float* __restrict__ m,
                         const float* __restrict__ logs,
                         const float* __restrict__ gb,
                         const float* __restrict__ gl, float* __restrict__ dst,
                         long R, int J, int V, int Vp, int blank, int splits) {
  using L = DwLayout<NJ, WIDE>;
  constexpr int S = L::kStages, JP = L::JP;
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int c0 = blockIdx.x * kDwTile;
  const int nslab = WIDE ? (int)gridDim.y : 1, js = WIDE ? blockIdx.y : 0;
  const long nrb = (R + kRows - 1) / kRows;
  const long rb0 = blockIdx.z * nrb / splits;
  const long n_items = ((blockIdx.z + 1) * nrb / splits - rb0) * nslab;
  const uint32_t ring = smem_addr(smem);
  const uint32_t wtile = ring + S * L::stage;  // !WIDE: the block's W tile

  // Item `it` (row block rb0 + it / nslab, J slab (js + 1 + it % nslab) %
  // nslab: the block's own slab last) into stage `st`.
  auto issue = [&](long it, int st) {
    const uint32_t base = ring + st * L::stage;
    const long r0 = (rb0 + it / nslab) * kRows;
    const int q = (int)(it % nslab);
    const int j0 = WIDE ? ((js + 1 + q) % nslab) * kSlab : 0;
    issue_h<JP>(h, base, r0, R, J, j0);
    if constexpr (WIDE)
      issue_w<JP>(w, base + L::h_bytes + L::st_bytes, c0, J, j0, Vp);
    if (q == nslab - 1) {  // the row statistics, for d (zeros past R)
      for (int i = threadIdx.x; i < 5 * kRows; i += kDwThreads) {
        const int k = i / kRows, r = i % kRows;
        const bool live = r0 + r < R;
        const long row = live ? r0 + r : 0;
        const void* src = k == 0   ? (const void*)(m + row)
                          : k == 1 ? (const void*)(logs + row)
                          : k == 2 ? (const void*)(gb + row)
                          : k == 3 ? (const void*)(gl + row)
                                   : (const void*)(y + row);
        cp_async4(base + L::h_bytes + (k < 4 ? 16 * r + 4 * k : 4 * i), src,
                  live);
      }
    }
  };

  if constexpr (!WIDE) issue_w<JP>(w, wtile, c0, J, 0, Vp);  // group 0
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < n_items) issue(s, s);
    cp_async_commit();
  }

  // this thread's two vocabulary columns: accumulator rows g and g + 8
  const int ca = c0 + warp * 16 + g, cb = ca + 8;
  // the bias in log2 units; -inf past V, where p = 0
  const float ba = ca < V ? b[ca] * kLog2e : -kInf;
  const float bb = cb < V ? b[cb] * kLog2e : -kInf;
  const bool va = ca < V, vb = cb < V;
  const bool blank_a = ca == blank, blank_b = cb == blank;
  const uint32_t wg_cols = (warp / 4) * 8 * kWCols8;  // this warpgroup's
  float sacc[32];      // S^T: 64 columns x 64 rows, 8 n-fragments of 4
  float dacc[JP / 2];  // dW^T: 64 columns x JP
  float dba = 0.0f, dbb = 0.0f;
#pragma unroll
  for (int i = 0; i < 32; ++i) sacc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < JP / 2; ++i) dacc[i] = 0.0f;

  for (long it = 0; it < n_items; ++it) {
    cp_async_wait<S - 2>();
    fence_async_shared();
    __syncthreads();  // item `it` landed; stage (it - 1) % S is free
    if (it + S - 1 < n_items) issue(it + S - 1, (int)((it + S - 1) % S));
    cp_async_commit();
    const int q = (int)(it % nslab);
    const uint32_t hs = ring + (it % S) * L::stage;
    const uint32_t ws =
        (WIDE ? hs + L::h_bytes + L::st_bytes : wtile) + wg_cols;
    // S^T (+)= W_tile^T (64 x JP) h^T (JP x 64), 16 of J at a time
    fence_regs(sacc);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < NJ; ++k)
      wgmma_ss<64, kMNMajor, kKMajor>(
          sacc, smem_desc(ws + 2 * k * kWRows8, kWRows8, kWCols8),
          smem_desc(hs + 2 * k * kHCols8, kHCols8, kHRows8), k > 0 || q > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sacc);
    if (q != nslab - 1) continue;  // more J slabs of these rows

    // d in place of the logits, in rnnt_joint_plain's order: -p (gb + gl),
    // + gb at blank, + gl at y; p = 2^(x log2 e - (m + log s) log2 e).
    // Rows past R have gb = gl = 0 and an infinite m + log s (p = 0).
    const long r0 = (rb0 + it / nslab) * kRows;
    const unsigned char* stats = smem + (it % S) * L::stage + L::h_bytes;
    const float4* st = reinterpret_cast<const float4*>(stats);
    const int2* sy = reinterpret_cast<const int2*>(stats + 16 * kRows);
#pragma unroll
    for (int nf = 0; nf < 8; ++nf) {
      const int2 y2 = sy[nf * 4 + t];  // rows nf 8 + 2t, + 1
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = nf * 8 + 2 * t + e;
        const float4 q4 = st[r];  // m, log s, gb, gl
        const int yr = e ? y2.y : y2.x;
        const float mr = r0 + r < R ? (q4.x + q4.y) * kLog2e : kInf;
        const float nc = -(q4.z + q4.w);
        float da = ex2(fmaf(sacc[4 * nf + e], kLog2e, ba - mr)) * nc;
        float dv = ex2(fmaf(sacc[4 * nf + 2 + e], kLog2e, bb - mr)) * nc;
        if (blank_a) da += q4.z;
        if (blank_b) dv += q4.z;
        if (va && ca == yr) da += q4.w;
        if (vb && cb == yr) dv += q4.w;
        sacc[4 * nf + e] = da;
        sacc[4 * nf + 2 + e] = dv;
        dba += da;
        dbb += dv;
      }
    }
    // dW^T += bf16(d)^T (64 x 64) h (64 x JP), 16 rows at a time: the
    // accumulators of row fragments 2kk and 2kk + 1 are the A fragment of
    // rows 16kk..16kk+15
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[kk][i] = pack_bf16(sacc[8 * kk + 2 * i], sacc[8 * kk + 2 * i + 1]);
    fence_regs(dacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<JP>(dacc, a[kk],
                   smem_desc(hs + 2 * kk * kHRows8, kHRows8, kHCols8));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dacc);
  }
  cp_async_wait<0>();  // no copy outlives the block

  if (ca >= Vp) return;  // the half of a last tile past Vp
  const int ldj = nslab * JP;
  float* dw = dst + (size_t)blockIdx.z * (ldj + 1) * Vp;
  float* db = dw + (size_t)ldj * Vp;
#pragma unroll
  for (int i = 0; i < JP / 8; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const size_t j = js * JP + i * 8 + 2 * t + e;
      dw[j * Vp + ca] = dacc[4 * i + e];
      dw[j * Vp + cb] = dacc[4 * i + 2 + e];
    }
  // the quad's four partial sums of a column, in a fixed order
  dba += __shfl_xor_sync(0xffffffffu, dba, 1);
  dba += __shfl_xor_sync(0xffffffffu, dba, 2);
  dbb += __shfl_xor_sync(0xffffffffu, dbb, 1);
  dbb += __shfl_xor_sync(0xffffffffu, dbb, 2);
  if (js == 0 && t == 0) {
    db[ca] = dba;
    db[cb] = dbb;
  }
}

// K12's second pass: out[i] = the sum over s of ws[s n + i], s in order;
// n a multiple of 4.
__global__ void rnnt_joint_dw_sum_kernel(const float4* __restrict__ ws,
                                         float4* __restrict__ out, long n4,
                                         int splits) {
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (long)gridDim.x * blockDim.x) {
    float4 acc = ws[i];
    for (int s = 1; s < splits; ++s) {
      const float4 v = ws[s * n4 + i];
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
    out[i] = acc;
  }
}

// K11's shapes: 128 rows a block, two warpgroups of 64, sharing each W
// tile; the block's h tile (128 x J) stays in shared memory up to
// kDhResidentJ, where it and two W stages still fit; at most kDhStages
// stages.
constexpr int kDhRows = 128;
constexpr int kDhThreads = 256;
constexpr int kDhResidentJ = 640;
constexpr int kDhStages = 4;
constexpr size_t kSmemMax = 232448;  // a block's shared memory on Hopper
constexpr uint32_t kDhSlabBytes = kDhRows * kSlab * 2;  // 128 x 128 of h

// K11's shared memory: a ring of stages, each a W tile (16 NJ rows of J,
// one 128-row slab when WIDE, x 128 vocabulary columns), when h streams
// (J > kDhResidentJ) the block's h slab of the same J rows, and the tile's
// bias in log2 units; then, unless h streams, the block's h tile (128 rows
// x ldh columns: 16 NJ, or every slab when WIDE), loaded once; and one
// mbarrier a stage.  The tiles are made of core matrices (see
// smem_desc): W's of J rows 8a.. and columns 8b.. at (16 a + b) * 128
// bytes, h's of rows 8a.. and J columns 8b.. at (16 b + a) * 128 bytes;
// within one, row i at 16 i bytes.  So one W tile is the N-major B operand
// of the logits (K = J) and the K-major B operand of the dh product (K =
// vocabulary column), with the strides swapped.  As many stages as fit,
// up to kDhStages (2 at J = 640).
template <int NJ, bool WIDE>
struct DhLayout {
  static constexpr int JP = 16 * NJ;
  static constexpr uint32_t w_bytes = JP * kTile * 2;
  static bool stream(int J) { return WIDE && J > kDhResidentJ; }
  static uint32_t stage(int J) {
    return w_bytes + (stream(J) ? kDhSlabBytes : 0) + kTile * 4;
  }
  static size_t h_bytes(int J) {
    return stream(J) ? 0
                     : (size_t)kDhRows *
                           (WIDE ? (J + kSlab - 1) / kSlab * kSlab : JP) * 2;
  }
  static int stages(int J) {
    return (int)std::min<size_t>(kDhStages,
                                 (kSmemMax - h_bytes(J)) / (stage(J) + 8));
  }
  static size_t bytes(int J) {
    return stages(J) * (stage(J) + 8) + h_bytes(J);
  }
};

constexpr uint32_t kDhStep8 = 128;   // h: 8 rows, W: 8 columns further
constexpr uint32_t kDhJ8 = 16 * 128;  // h, W: 8 of J further

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

// One arrival that also expects `bytes` of asynchronous copies.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// A TMA bulk copy of `bytes` contiguous bytes (a multiple of 16), global to
// shared, completing on the mbarrier `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Wait for the phase of `bar` with this parity to complete; a wait that
// never ends (a copy that never lands) traps rather than hangs the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  for (int tries = 0;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (tries > (1 << 22)) asm volatile("trap;");
  }
}

// Rows r0..r0+127 of h (R, J) into K11's h tile of ldh columns; zeros past
// R and J.
__device__ __forceinline__ void dh_issue_h(const bf16* __restrict__ h,
                                           uint32_t hs, long r0, long R,
                                           int J, int ldh) {
  for (int i = threadIdx.x; i < kDhRows * (ldh / 8); i += kDhThreads) {
    const int ri = i % 8, b = (i / 8) % (ldh / 8), a = i / ldh;
    const long r = r0 + 8 * a + ri;
    const bool live = r < R && 8 * b < J;
    cp_async16(hs + b * kDhJ8 + a * kDhStep8 + ri * 16,
               live ? h + r * J + 8 * b : h, live);
  }
}

// acc[4 nf + e0 + e] += v where tile column c is 8 nf + 2 t + e, the
// accumulator layout's column of this thread's (t) element; nothing unless
// the thread holds c (0 <= c < 128).  e0: 0 for the thread's first row, 2
// for its second.
__device__ __forceinline__ void add_at_column(float (&acc)[64], int c, int t,
                                              int e0, float v) {
  if ((unsigned)c >= (unsigned)kTile || ((c >> 1) & 3) != t) return;
#pragma unroll
  for (int nf = 0; nf < kTile / 8; ++nf)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (8 * nf + 2 * t + e == c) acc[4 * nf + e0 + e] += v;
}

// K11 (K11tp on a shard).  Grid: x the 128-row blocks, y the 128-column J
// slabs of dh (WIDE).  Takes W in its W tiles' layout (w_tiles in
// ops/rnnt_joint_cuda.py: for each 128-column tile, JW = 16 NJ or, when
// WIDE, every slab's rows, zeros past J, in core matrices as a W stage
// holds them) and the bias in log2 units, b2 (Vp,), -inf past V, so a
// stage is two contiguous copies.  Above kDhResidentJ (`stream`) h
// streams with W: the wrapper lays it out as 128-row blocks of 128-column
// slabs, each in the core-matrix order of a stage's h slab (h_tiles in
// ops/rnnt_joint_cuda.py), and each stage takes the item's h slab too.
// Writes dh (R, J) float32, rows < R only; J is a multiple of 8 (the
// wrapper pads h).
//
// Warpgroup g owns rows 64g..64g+63 of the block, and each thread its two
// rows of wgmma's accumulator layout (warp w, lane l: 16 w + l / 4 and
// that + 8), whose statistics it keeps in registers for the whole kernel.
// Per W tile the warpgroup computes the logits S = h W_tile (64 x 128)
// with wgmma into registers (h K-major, W N-major, both from shared
// memory), forms d in place, and rounds it to bf16 into the register A
// operand of dh += d W_tile^T (64 x JP), whose B operand is the same W
// tile read K-major: the logits and d never reach shared memory.  Items:
// the V tiles in order and, when WIDE, one item per J slab of each, the
// block's own slab (whose W rows the dh product needs) last; S sums over
// the slabs.  Thread 0 copies item it + S - 1 into the ring while the
// block works on item it.
//
// Per item: one barrier (every thread is done with the previous item,
// whose stage thread 0 refills), a wait for the item's copies, the
// logits; after a tile's last item, d and the dh product.  The two
// warpgroups may drift apart within an item, so that one's exps overlap
// the other's products.  The products are issued unconditionally (a wgmma
// issued under a run-time condition makes ptxas serialize them).  The sum
// over V stays in the block's registers, in tile order: dh is the same
// bits run to run.
template <int NJ, bool WIDE>
__global__ void __launch_bounds__(kDhThreads, 1)
    rnnt_joint_dh_kernel(const bf16* __restrict__ h,
                         const bf16* __restrict__ w,
                         const float* __restrict__ b2,
                         const int* __restrict__ y,
                         const float* __restrict__ m,
                         const float* __restrict__ logs,
                         const float* __restrict__ gb,
                         const float* __restrict__ gl, float* __restrict__ dh,
                         long R, int J, int V, int Vp, int blank,
                         int stages, int stream) {
  using L = DhLayout<NJ, WIDE>;
  constexpr int JP = L::JP;
  const int S = stages;
  const bool hs_streams = WIDE && stream;
  const uint32_t stage = L::w_bytes + (hs_streams ? kDhSlabBytes : 0) +
                         kTile * 4;
  const uint32_t bias_at = stage - kTile * 4;  // in a stage
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4, wg = warp / 4;
  const int nslab = WIDE ? (int)gridDim.y : 1, js = WIDE ? blockIdx.y : 0;
  const long r0 = (long)blockIdx.x * kDhRows;
  const int n_items = Vp / kTile * nslab;
  const uint32_t ring = smem_addr(smem);
  const uint32_t hs = ring + S * stage;  // unless h streams
  const uint32_t bars = hs + (hs_streams ? 0 : kDhRows * nslab * JP * 2);

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (!hs_streams) dh_issue_h(h, hs, r0, R, J, nslab * JP);
  cp_async_commit();
  __syncthreads();  // the mbarriers are initialised

  // Item `it`'s W rows (and h slab) and its tile's bias into stage it % S
  // (thread 0)
  auto issue = [&](int it) {
    if (threadIdx.x != 0 || it >= n_items) return;
    const int st = it % S, c0 = it / nslab * kTile;
    const int jq = WIDE ? (js + 1 + it % nslab) % nslab : 0;
    const uint32_t dst = ring + st * stage, bar = bars + 8 * st;
    mbar_expect_tx(bar, stage);
    bulk_copy(dst, w + ((size_t)c0 * nslab + jq * kTile) * JP, L::w_bytes,
              bar);
    if (hs_streams)
      bulk_copy(dst + L::w_bytes,
                h + ((size_t)blockIdx.x * nslab + jq) * kDhRows * kSlab,
                kDhSlabBytes, bar);
    bulk_copy(dst + bias_at, b2 + c0, kTile * 4, bar);
  };
  for (int it = 0; it < S - 1; ++it) issue(it);

  // this thread's two rows: M = (m + log s) log2 e (inf past R, where p =
  // 0), the cotangents, nc = -(gb + gl) and the label (-1 outside [0, V))
  const long ra = r0 + wg * 64 + (warp % 4) * 16 + g, rb = ra + 8;
  float Ma = kInf, Mb = kInf, gba = 0.0f, gbb = 0.0f, gla = 0.0f, glb = 0.0f;
  int ya = -1, yb = -1;
  if (ra < R) {
    Ma = (m[ra] + logs[ra]) * kLog2e;
    gba = gb[ra];
    gla = gl[ra];
    ya = (unsigned)y[ra] < (unsigned)V ? y[ra] : -1;
  }
  if (rb < R) {
    Mb = (m[rb] + logs[rb]) * kLog2e;
    gbb = gb[rb];
    glb = gl[rb];
    yb = (unsigned)y[rb] < (unsigned)V ? y[rb] : -1;
  }
  const float nca = -(gba + gla), ncb = -(gbb + glb);
  const uint32_t h_wg = hs + wg * 8 * kDhStep8;  // this warpgroup's rows
  cp_async_wait<0>();  // this thread's part of the h tile
  fence_async_shared();

  float sacc[64];         // S, then d: 64 rows x 128 columns
  float dacc[JP / 2];     // dh: 64 rows x JP
  uint32_t a[kTile / 16][4];  // bf16(d), the dh product's A operand
#pragma unroll
  for (int i = 0; i < 64; ++i) sacc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < JP / 2; ++i) dacc[i] = 0.0f;

  // d of item `it` (a tile's last) from its logits in sacc, in
  // rnnt_joint_plain's order: -p (gb + gl), + gb at blank, + gl at y;
  // p = 2^(x log2 e + b log2 e - M); rounded to bf16 into `a`: the
  // accumulators of column fragments 2kk and 2kk + 1 are the A fragment
  // of columns 16kk..16kk+15.
  auto form_d = [&](int it) {
    const int c0 = it / nslab * kTile;
    const float2* bias = reinterpret_cast<const float2*>(
        smem + it % S * stage + bias_at);
#pragma unroll
    for (int nf = 0; nf < kTile / 8; ++nf) {
      const float2 bc = bias[4 * nf + t];  // columns 8 nf + 2 t, + 1
      sacc[4 * nf] = ex2(fmaf(sacc[4 * nf], kLog2e, bc.x - Ma)) * nca;
      sacc[4 * nf + 1] = ex2(fmaf(sacc[4 * nf + 1], kLog2e, bc.y - Ma)) * nca;
      sacc[4 * nf + 2] = ex2(fmaf(sacc[4 * nf + 2], kLog2e, bc.x - Mb)) * ncb;
      sacc[4 * nf + 3] = ex2(fmaf(sacc[4 * nf + 3], kLog2e, bc.y - Mb)) * ncb;
    }
    add_at_column(sacc, blank - c0, t, 0, gba);
    add_at_column(sacc, blank - c0, t, 2, gbb);
    add_at_column(sacc, ya - c0, t, 0, gla);
    add_at_column(sacc, yb - c0, t, 2, glb);
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[kk][i] = pack_bf16(sacc[8 * kk + 2 * i], sacc[8 * kk + 2 * i + 1]);
  };

  // One step of the ring: every thread is done with item it - 1, whose
  // stage takes item it + S - 1, and item `it` has landed.
  auto step = [&](int it) {
    __syncthreads();
    issue(it + S - 1);
    mbar_wait(bars + 8 * (it % S), (it / S) & 1);
  };
  auto group_begin = [&]() {
    fence_regs(sacc);
    fence_regs(dacc);
    wgmma_fence();
  };
  auto group_end = [&]() {
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sacc);
    fence_regs(dacc);
  };

  for (int c = 0; c < n_items / nslab; ++c) {
    for (int q = 0; q < nslab; ++q) {
      // S (+)= h[:, slab jq] (64 x JP) W_it (JP x 128), 16 of J at a time
      const int it = c * nslab + q;
      const int jq = WIDE ? (js + 1 + q) % nslab : 0;
      const uint32_t ws = ring + it % S * stage;
      // this warpgroup's rows of h's slab jq: resident, or in the stage
      const uint32_t ha = hs_streams
                              ? ws + L::w_bytes + wg * 8 * kDhStep8
                              : h_wg + jq * NJ * 2 * kDhJ8;
      step(it);
      group_begin();
#pragma unroll
      for (int k = 0; k < NJ; ++k)
        wgmma_ss<128, kKMajor, kMNMajor>(
            sacc, smem_desc(ha + k * 2 * kDhJ8, kDhJ8, kDhStep8),
            smem_desc(ws + 2 * k * kDhJ8, kDhJ8, kDhStep8), k > 0 || q > 0);
      group_end();
    }
    // dh += bf16(d) (64 x 128) W_last^T (128 x JP), W_last the tile's last
    // item, the block's own J slab
    const int last = (c + 1) * nslab - 1;
    form_d(last);
    const uint32_t ws = ring + last % S * stage;
    group_begin();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
      wgmma_rs<JP, kKMajor>(
          dacc, a[kk], smem_desc(ws + 2 * kk * kDhStep8, kDhStep8, kDhJ8));
    group_end();
  }

#pragma unroll
  for (int nf = 0; nf < JP / 8; ++nf) {
    const int j = js * JP + 8 * nf + 2 * t;
    if (j >= J) continue;  // J is a multiple of 8: so is j + 1 < J
    if (ra < R)
      *reinterpret_cast<float2*>(dh + ra * J + j) =
          make_float2(dacc[4 * nf], dacc[4 * nf + 1]);
    if (rb < R)
      *reinterpret_cast<float2*>(dh + rb * J + j) =
          make_float2(dacc[4 * nf + 2], dacc[4 * nf + 3]);
  }
}

// K10's shapes: a block of G warpgroups of 64 rows shares each W tile, G = 4
// up to J = 128 and 2 above (where the h tile of more rows would not fit
// beside the ring); at most kFwdStages stages in the ring.
template <bool WIDE>
struct FwdShape {
  static constexpr int groups = WIDE ? 2 : 4;
  static constexpr int rows = 64 * groups;
  static constexpr int threads = 128 * groups;
  static constexpr int warps = threads / 32;
  static constexpr uint32_t j8 = rows / 8 * 128;  // h tile: 8 of J further
};
constexpr int kFwdStages = 4;
constexpr float kLn2 = 0.6931471805599453f;

// K10's shared memory: K11's ring of stages (DhLayout: a W tile, when h
// streams the block's h slab, and the tile's log2 bias), then, unless h
// streams, the block's h tile (FwdShape rows x every slab's columns), then
// a full mbarrier and a release counter a stage.  As many stages as fit,
// up to kFwdStages.
template <int NJ, bool WIDE>
struct FwdLayout {
  using D = DhLayout<NJ, WIDE>;
  static size_t h_bytes(int J) {
    return D::stream(J) ? 0
                        : (size_t)FwdShape<WIDE>::rows *
                              (WIDE ? (J + kSlab - 1) / kSlab * kSlab
                                    : D::JP) * 2;
  }
  static int stages(int J) {
    return (int)std::min<size_t>(
        kFwdStages, (kSmemMax - h_bytes(J)) / (D::stage(J) + 12));
  }
  static size_t bytes(int J) {
    return stages(J) * (D::stage(J) + 12) + h_bytes(J);
  }
};

// atomicAdd on a shared counter, ordered after this thread's earlier
// accesses and before its later ones (acquire-release); returns the old
// value.
__device__ __forceinline__ uint32_t atom_add_acq_rel(uint32_t addr,
                                                     uint32_t v) {
  uint32_t old;
  asm volatile("atom.acq_rel.cta.shared::cta.add.u32 %0, [%1], %2;\n"
               : "=r"(old)
               : "r"(addr), "r"(v)
               : "memory");
  return old;
}

// Rows r0.. of h (R, J) into K10's resident h tile of ldh columns, in
// core matrices (see smem_desc) of rows 8a.. and J columns 8b.. at
// (rows / 8 b + a) * 128 bytes; zeros past R and J.
template <bool WIDE>
__device__ __forceinline__ void fwd_issue_h(const bf16* __restrict__ h,
                                            uint32_t hs, long r0, long R,
                                            int J, int ldh) {
  using F = FwdShape<WIDE>;
  for (int i = threadIdx.x; i < F::rows * (ldh / 8); i += F::threads) {
    const int ri = i % 8, b = (i / 8) % (ldh / 8), a = i / ldh;
    const long r = r0 + 8 * a + ri;
    const bool live = r < R && 8 * b < J;
    cp_async16(hs + b * F::j8 + a * kDhStep8 + ri * 16,
               live ? h + r * J + 8 * b : h, live);
  }
}

// This lane's share (J columns t, t + 4, ...) of the logit h[row] .
// W[:, col], bf16 products summed in float32: h (R, J) as given, or in
// h_tiles' layout (jw columns) when `tiled`; W in w_tiles' layout (jw rows
// a tile).  0 when col < 0 or row >= R.
__device__ __forceinline__ float row_dot(const bf16* __restrict__ h,
                                         const bf16* __restrict__ w,
                                         long row, int col, long R, int J,
                                         int jw, bool tiled, int t) {
  if (col < 0 || row >= R) return 0.0f;
  const bf16* wc = w + (size_t)(col / kTile) * jw * kTile +
                   (col % kTile) / 8 * 64 + col % 8;
  const bf16* hr =
      tiled ? h + (row / kDhRows) * (size_t)jw * kDhRows +
                  (row % kDhRows) / 8 * 64 + (row % 8) * 8
            : h + row * J;
  float s = 0.0f;
#pragma unroll 8
  for (int j = t; j < J; j += 4) {
    const size_t hj = tiled ? (size_t)(j / kSlab) * kSlab * kDhRows +
                                  (j % kSlab) / 8 * 16 * 64 + j % 8
                            : (size_t)j;
    s = fmaf(__bfloat162float(hr[hj]),
             __bfloat162float(wc[(j / 8) * 16 * 64 + (j % 8) * 8]), s);
  }
  return s;
}

// K10 (K10tp with `raw`).  Grid: the FwdShape<WIDE>::rows-row blocks.
// Takes W and b2 as K11 does (w_tiles, dh_bias: a stage is two contiguous
// copies, three when h streams above kDhResidentJ in h_tiles' layout), and
// b (V,) in natural units for the blank and label logits.  Writes b_pl,
// l_pl, m, logs (R,), rows < R only; with `raw`, the raw blank and label
// logits (0 where the id is no column) in place of the planes, and the
// shard's local m and log s.  J is a multiple of 8 (the wrapper pads h and
// W).
//
// Warpgroup g owns rows 64g..64g+63 of the block, each thread its two rows
// of wgmma's accumulator layout (warp w, lane l: 16 w + l / 4 and that +
// 8), and for each of them a running max M and sum S over its columns
// (8 nf + 2 t + e of every tile, t = l % 4) in log2 units, in registers
// for the whole kernel.  Per item (a W tile, or one 128-row J slab of it
// above J = 128) the warpgroup computes the logits S (+)= h W_item (64 x
// 128) with wgmma into registers (h K-major, W N-major, both from shared
// memory: K11's product); after a tile's last item its softmax turns each
// element into v = x log2 e + b2[c] by one FMA and adds exp2(v - M) to S,
// M the running max of the earlier tiles, so that the exps need not wait
// for the tile's max; then M takes the tile's max and S is rescaled by one
// exp2 a row.  A row whose tile max exceeds M by more than 64 (every row
// on its first tile) redoes the tile's exps against the new max, so no
// term exceeds 2^64.  The logits never reach shared or device memory.  The
// four threads of a row combine (M, S) once at the end by shuffles; m and
// log s leave in natural units.  The blank and label logits are separate
// dot products of the row of h with W's column (each thread a quarter of
// J), computed while the first copies land, + b[c].
//
// The products and the exps take the same time at J = 128, and the exps
// are too few a warp for two warps a scheduler to keep the exp unit busy.
// So the warpgroups, four up to J = 128, never wait for each other: each
// stage has a full mbarrier (the copies landed) and a counter that every
// warp adds one to when it is done with the stage; the last of the block's
// warps to do so refills it.  A warpgroup runs ahead of the others as far
// as the ring allows, and the others' softmax runs under its products.
// Every product is issued unconditionally (a wgmma under a run-time
// condition makes ptxas serialise them).
template <int NJ, bool WIDE>
__global__ void __launch_bounds__(FwdShape<WIDE>::threads, 1)
    rnnt_joint_fwd_kernel(const bf16* __restrict__ h,
                          const bf16* __restrict__ w,
                          const float* __restrict__ b,
                          const float* __restrict__ b2,
                          const int* __restrict__ y, float* __restrict__ b_pl,
                          float* __restrict__ l_pl, float* __restrict__ m_out,
                          float* __restrict__ logs_out, long R, int J, int V,
                          int Vp, int blank, int raw, int stages,
                          int stream) {
  using L = DhLayout<NJ, WIDE>;
  using F = FwdShape<WIDE>;
  constexpr int JP = L::JP;
  const int S = stages;
  const bool hs_streams = WIDE && stream;
  const uint32_t stage = L::w_bytes + (hs_streams ? kDhSlabBytes : 0) +
                         kTile * 4;
  const uint32_t bias_at = stage - kTile * 4;  // in a stage
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4, wg = warp / 4;
  const int nslab = WIDE ? (J + kSlab - 1) / kSlab : 1;
  const long r0 = (long)blockIdx.x * F::rows;
  const int n_items = Vp / kTile * nslab;
  const uint32_t ring = smem_addr(smem);
  const uint32_t hs = ring + S * stage;  // unless h streams
  const uint32_t bars = hs + (hs_streams ? 0 : F::rows * nslab * JP * 2);
  const uint32_t counters = bars + 8 * S;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(bars + 8 * s, 1);
      asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(counters + 4 * s),
                   "r"(0u)
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (!hs_streams) fwd_issue_h<WIDE>(h, hs, r0, R, J, nslab * JP);
  cp_async_commit();

  // Item `it`'s W rows (and h slab) and its tile's bias into stage it % S
  auto issue = [&](int it) {
    if (it >= n_items) return;
    const int st = it % S, c0 = it / nslab * kTile;
    const int jq = WIDE ? it % nslab : 0;
    const uint32_t dst = ring + st * stage, bar = bars + 8 * st;
    const bf16* wsrc = w + ((size_t)c0 * nslab + jq * kTile) * JP;
    mbar_expect_tx(bar, stage);  // W, h when it streams, the bias
    bulk_copy(dst, wsrc, L::w_bytes, bar);
    if (hs_streams)
      bulk_copy(dst + L::w_bytes,
                h + ((size_t)blockIdx.x * nslab + jq) * kDhRows * kSlab,
                kDhSlabBytes, bar);
    bulk_copy(dst + bias_at, b2 + c0, kTile * 4, bar);
  };
  // This warp is done with item `it`'s stage; the block's last warp to be
  // done with it refills it with item it + S.
  auto release = [&](int it) {
    __syncwarp();
    if (lane == 0 &&
        atom_add_acq_rel(counters + 4 * (it % S), 1) % F::warps ==
            F::warps - 1)
      issue(it + S);
  };
  cp_async_wait<0>();  // this thread's part of the h tile
  fence_async_shared();
  __syncthreads();  // the h tile and the mbarriers
  if (threadIdx.x == 0)
    for (int it = 0; it < S; ++it) issue(it);

  // this thread's two rows: the label (-1 outside [0, V)) and this lane's
  // shares of the blank and label logits, while the first copies land
  const long ra = r0 + wg * 64 + (warp % 4) * 16 + g, rb = ra + 8;
  int ya = -1, yb = -1;
  if (ra < R && (unsigned)y[ra] < (unsigned)V) ya = y[ra];
  if (rb < R && (unsigned)y[rb] < (unsigned)V) yb = y[rb];
  const int jw = nslab * JP;
  const float xba = row_dot(h, w, ra, blank, R, J, jw, hs_streams, t);
  const float xbb = row_dot(h, w, rb, blank, R, J, jw, hs_streams, t);
  const float xya = row_dot(h, w, ra, ya, R, J, jw, hs_streams, t);
  const float xyb = row_dot(h, w, rb, yb, R, J, jw, hs_streams, t);
  // this warpgroup's rows of the resident h tile
  const uint32_t h_wg = hs + wg * 8 * kDhStep8;
  float Ma = kNeg, Mb = kNeg, Sa = 0.0f, Sb = 0.0f;  // log2 units
  float acc[64];  // the logits: 64 rows x 128 columns
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;

  for (int c = 0; c < n_items / nslab; ++c) {
    for (int q = 0; q < nslab; ++q) {
      // acc (+)= h[:, slab q] (64 x JP) W_it (JP x 128), 16 of J at a time
      const int it = c * nslab + q;
      const uint32_t ws = ring + it % S * stage;
      const uint32_t ha = hs_streams ? ws + L::w_bytes + wg * 8 * kDhStep8
                                     : h_wg + q * NJ * 2 * F::j8;
      const uint32_t hj8 = hs_streams ? kDhJ8 : F::j8;
      mbar_wait(bars + 8 * (it % S), (it / S) & 1);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < NJ; ++k)
        wgmma_ss<128, kKMajor, kMNMajor>(
            acc, smem_desc(ha + k * 2 * hj8, hj8, kDhStep8),
            smem_desc(ws + 2 * k * kDhJ8, kDhJ8, kDhStep8), k > 0 || q > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      if (q < nslab - 1) {  // more J slabs of the tile
        release(it);
        continue;
      }

      // the tile's softmax; the bias is in the last item's stage
      const float2* bias =
          reinterpret_cast<const float2*>(smem + it % S * stage + bias_at);
      float ta = kNeg, tb = kNeg;
      float sa0 = 0.0f, sa1 = 0.0f, sb0 = 0.0f, sb1 = 0.0f;
#pragma unroll
      for (int nf = 0; nf < kTile / 8; ++nf) {
        const float2 bc = bias[4 * nf + t];  // columns 8 nf + 2 t, + 1
        acc[4 * nf] = fmaf(acc[4 * nf], kLog2e, bc.x);
        acc[4 * nf + 1] = fmaf(acc[4 * nf + 1], kLog2e, bc.y);
        acc[4 * nf + 2] = fmaf(acc[4 * nf + 2], kLog2e, bc.x);
        acc[4 * nf + 3] = fmaf(acc[4 * nf + 3], kLog2e, bc.y);
        ta = fmaxf(ta, fmaxf(acc[4 * nf], acc[4 * nf + 1]));
        tb = fmaxf(tb, fmaxf(acc[4 * nf + 2], acc[4 * nf + 3]));
        sa0 += ex2(acc[4 * nf] - Ma);
        sa1 += ex2(acc[4 * nf + 1] - Ma);
        sb0 += ex2(acc[4 * nf + 2] - Mb);
        sb1 += ex2(acc[4 * nf + 3] - Mb);
      }
      const float na = fmaxf(Ma, ta), nb = fmaxf(Mb, tb);
      if (ta > Ma + 64.0f) {
        sa0 = sa1 = 0.0f;
#pragma unroll
        for (int nf = 0; nf < kTile / 8; ++nf) {
          sa0 += ex2(acc[4 * nf] - na);
          sa1 += ex2(acc[4 * nf + 1] - na);
        }
        Sa = fmaf(Sa, ex2(Ma - na), sa0 + sa1);
      } else {
        Sa = (Sa + (sa0 + sa1)) * ex2(Ma - na);
      }
      if (tb > Mb + 64.0f) {
        sb0 = sb1 = 0.0f;
#pragma unroll
        for (int nf = 0; nf < kTile / 8; ++nf) {
          sb0 += ex2(acc[4 * nf + 2] - nb);
          sb1 += ex2(acc[4 * nf + 3] - nb);
        }
        Sb = fmaf(Sb, ex2(Mb - nb), sb0 + sb1);
      } else {
        Sb = (Sb + (sb0 + sb1)) * ex2(Mb - nb);
      }
      Ma = na;
      Mb = nb;
      release(it);
    }
  }

  // the four threads of a row (neighbouring lanes) combine their (M, S)
  // and their shares of the blank and label logits
  auto finish = [&](float M, float s, float xb, float xy, int yr, long row) {
    float mr = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, 1));
    mr = fmaxf(mr, __shfl_xor_sync(0xffffffffu, mr, 2));
    float sr = s * ex2(M - mr);
    sr += __shfl_xor_sync(0xffffffffu, sr, 1);
    sr += __shfl_xor_sync(0xffffffffu, sr, 2);
    xb += __shfl_xor_sync(0xffffffffu, xb, 1);
    xb += __shfl_xor_sync(0xffffffffu, xb, 2);
    xy += __shfl_xor_sync(0xffffffffu, xy, 1);
    xy += __shfl_xor_sync(0xffffffffu, xy, 2);
    if (t == 0 && row < R) {
      const float m = mr * kLn2, logs = logf(sr);
      xb = blank >= 0 ? xb + b[blank] : 0.0f;
      xy = yr >= 0 ? xy + b[yr] : 0.0f;
      b_pl[row] = raw ? xb : (xb - m) - logs;
      l_pl[row] = raw ? xy : (xy - m) - logs;
      m_out[row] = m;
      logs_out[row] = logs;
    }
  };
  finish(Ma, Sa, xba, xya, ya, ra);
  finish(Mb, Sb, xbb, xyb, yb, rb);
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
cudaError_t fwd_smem(int J, size_t* bytes) {
  *bytes = FwdLayout<NJ, WIDE>::bytes(J);
  return set_smem((const void*)rnnt_joint_fwd_kernel<NJ, WIDE>, *bytes);
}

// K10's resources at this J: info[0..5] as dh_plan's.
template <int NJ, bool WIDE>
cudaError_t fwd_plan(int J, int* info) {
  size_t smem;
  cudaError_t err = fwd_smem<NJ, WIDE>(J, &smem);
  if (err != cudaSuccess) return err;
  const void* kernel = (const void*)rnnt_joint_fwd_kernel<NJ, WIDE>;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &info[0], kernel, FwdShape<WIDE>::threads, smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  info[1] = attr.numRegs;
  info[2] = (int)smem;
  info[3] = (int)attr.localSizeBytes;
  info[4] = FwdLayout<NJ, WIDE>::stages(J);
  info[5] = (int)DhLayout<NJ, WIDE>::stream(J);
  return err;
}

template <int NJ, bool WIDE>
cudaError_t fwd(const void* h, const void* w, const void* b, const void* b2,
                const void* y, void* b_pl, void* l_pl, void* m, void* logs,
                long R, int J, int V, int Vp, int blank, int raw,
                cudaStream_t stream) {
  size_t smem;
  cudaError_t err = fwd_smem<NJ, WIDE>(J, &smem);
  if (err != cudaSuccess) return err;
  using F = FwdShape<WIDE>;
  const unsigned blocks = (unsigned)((R + F::rows - 1) / F::rows);
  rnnt_joint_fwd_kernel<NJ, WIDE><<<blocks, F::threads, smem, stream>>>(
      (const bf16*)h, (const bf16*)w, (const float*)b, (const float*)b2,
      (const int*)y, (float*)b_pl, (float*)l_pl, (float*)m, (float*)logs, R,
      J, V, Vp, blank, raw, FwdLayout<NJ, WIDE>::stages(J),
      (int)DhLayout<NJ, WIDE>::stream(J));
  return cudaGetLastError();
}

template <int NJ, bool WIDE>
cudaError_t dh_smem(int J, size_t* bytes) {
  *bytes = DhLayout<NJ, WIDE>::bytes(J);
  return set_smem((const void*)rnnt_joint_dh_kernel<NJ, WIDE>, *bytes);
}

// K11's resources at this J: info[0..4] as dw_plan's, [5] 1 when h
// streams with W (the wrapper then lays it out with h_tiles), else 0.
template <int NJ, bool WIDE>
cudaError_t dh_plan(int J, int* info) {
  size_t smem;
  cudaError_t err = dh_smem<NJ, WIDE>(J, &smem);
  if (err != cudaSuccess) return err;
  const void* kernel = (const void*)rnnt_joint_dh_kernel<NJ, WIDE>;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[0], kernel,
                                                      kDhThreads, smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  info[1] = attr.numRegs;
  info[2] = (int)smem;
  info[3] = (int)attr.localSizeBytes;
  info[4] = DhLayout<NJ, WIDE>::stages(J);
  info[5] = (int)DhLayout<NJ, WIDE>::stream(J);
  return err;
}

template <int NJ, bool WIDE>
cudaError_t dh(const void* h, const void* w, const void* b, const void* y,
               const void* m, const void* logs, const void* gb,
               const void* gl, void* out, long R, int J, int V, int Vp,
               int blank, cudaStream_t stream) {
  size_t smem;
  cudaError_t err = dh_smem<NJ, WIDE>(J, &smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((R + kDhRows - 1) / kDhRows),
                  WIDE ? wide_slabs(J) : 1u);
  rnnt_joint_dh_kernel<NJ, WIDE><<<grid, kDhThreads, smem, stream>>>(
      (const bf16*)h, (const bf16*)w, (const float*)b, (const int*)y,
      (const float*)m, (const float*)logs, (const float*)gb,
      (const float*)gl, (float*)out, R, J, V, Vp, blank,
      DhLayout<NJ, WIDE>::stages(J), (int)DhLayout<NJ, WIDE>::stream(J));
  return cudaGetLastError();
}

template <int NJ, bool WIDE>
cudaError_t dw_smem(size_t* bytes) {
  *bytes = DwLayout<NJ, WIDE>::bytes;
  return set_smem((const void*)rnnt_joint_dw_kernel<NJ, WIDE>, *bytes);
}

// K12's resources: info[0] resident blocks per SM, [1] registers per
// thread, [2] dynamic shared memory bytes, [3] local (spilled) bytes per
// thread, [4] stages of the ring.
template <int NJ, bool WIDE>
cudaError_t dw_plan(int* info) {
  size_t smem;
  cudaError_t err = dw_smem<NJ, WIDE>(&smem);
  if (err != cudaSuccess) return err;
  const void* kernel = (const void*)rnnt_joint_dw_kernel<NJ, WIDE>;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[0], kernel,
                                                      kDwThreads, smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  info[1] = attr.numRegs;
  info[2] = (int)smem;
  info[3] = (int)attr.localSizeBytes;
  info[4] = DwLayout<NJ, WIDE>::kStages;
  return err;
}

template <int NJ, bool WIDE>
cudaError_t dw(const void* h, const void* w, const void* b, const void* y,
               const void* m, const void* logs, const void* gb,
               const void* gl, void* out, void* ws, long R, int J, int V,
               int Vp, int blank, int splits, cudaStream_t stream) {
  size_t smem;
  cudaError_t err = dw_smem<NJ, WIDE>(&smem);
  if (err != cudaSuccess) return err;
  const unsigned slabs = WIDE ? wide_slabs(J) : 1u;
  const dim3 grid((unsigned)((Vp + kDwTile - 1) / kDwTile), slabs,
                  (unsigned)splits);
  rnnt_joint_dw_kernel<NJ, WIDE><<<grid, kDwThreads, smem, stream>>>(
      (const bf16*)h, (const bf16*)w, (const float*)b, (const int*)y,
      (const float*)m, (const float*)logs, (const float*)gb,
      (const float*)gl, (float*)(splits > 1 ? ws : out), R, J, V, Vp, blank,
      splits);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long n4 = ((long)slabs * 16 * NJ + 1) * Vp / 4;
  const unsigned blocks = (unsigned)std::min<long>((n4 + 255) / 256, 4096);
  rnnt_joint_dw_sum_kernel<<<blocks, 256, 0, stream>>>(
      (const float4*)ws, (float4*)out, n4, splits);
  return cudaGetLastError();
}

}  // namespace

// h (R, J) bf16, J a multiple of 8, w in K11's W tiles' layout (see
// rnnt_joint_dh_kernel), b (V,) f32, b2 the (Vp,) bias in log2 units, -inf
// past V, y (R,) i32, and, where e2e_rnnt_joint_fwd_plan reports that h
// streams (above kDhResidentJ), h in K11's h tiles' layout; Vp a multiple
// of 128, -1 <= blank < V (-1, and labels outside [0, V), match no
// column).  raw = 0: b_pl, l_pl are the planes; raw = 1 (K10tp): the raw
// blank and label logits.
extern "C" int e2e_rnnt_joint_fwd(const void* h, const void* w, const void* b,
                                  const void* b2, const void* y, void* b_pl,
                                  void* l_pl, void* m, void* logs,
                                  long long R, int J, int V, int Vp,
                                  int blank, int raw, void* stream) {
  if (J % 8 != 0) return (int)cudaErrorInvalidValue;
  if (R <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  if (J > kSlab)
    return (int)fwd<8, true>(h, w, b, b2, y, b_pl, l_pl, m, logs, R, J, V, Vp, blank, raw, st);
  switch (slabs_for(J)) {
    case 1: return (int)fwd<1, false>(h, w, b, b2, y, b_pl, l_pl, m, logs, R, J, V, Vp, blank, raw, st);
    case 2: return (int)fwd<2, false>(h, w, b, b2, y, b_pl, l_pl, m, logs, R, J, V, Vp, blank, raw, st);
    case 4: return (int)fwd<4, false>(h, w, b, b2, y, b_pl, l_pl, m, logs, R, J, V, Vp, blank, raw, st);
    case 8: return (int)fwd<8, false>(h, w, b, b2, y, b_pl, l_pl, m, logs, R, J, V, Vp, blank, raw, st);
  }
  return (int)cudaErrorInvalidValue;
}

// K10's resources at this J (a multiple of 8) on the current device
// (info as e2e_rnnt_joint_dh_plan's).
extern "C" int e2e_rnnt_joint_fwd_plan(int J, int* info) {
  if (J % 8 != 0) return (int)cudaErrorInvalidValue;
  if (J > kSlab) return (int)fwd_plan<8, true>(J, info);
  switch (slabs_for(J)) {
    case 1: return (int)fwd_plan<1, false>(J, info);
    case 2: return (int)fwd_plan<2, false>(J, info);
    case 4: return (int)fwd_plan<4, false>(J, info);
    case 8: return (int)fwd_plan<8, false>(J, info);
  }
  return (int)cudaErrorInvalidValue;
}

// As e2e_rnnt_joint_fwd, plus m, logs, gb, gl (R,) f32, with J a multiple
// of 8, w in K11's W tiles' layout, b the (Vp,) bias in log2 units, -inf
// past V, and, where e2e_rnnt_joint_dh_plan reports that h streams (above
// kDhResidentJ), h in K11's h tiles' layout (see rnnt_joint_dh_kernel);
// dh (R, J) f32.
extern "C" int e2e_rnnt_joint_dh(const void* h, const void* w, const void* b,
                                 const void* y, const void* m,
                                 const void* logs, const void* gb,
                                 const void* gl, void* out, long long R, int J,
                                 int V, int Vp, int blank, void* stream) {
  if (J % 8 != 0) return (int)cudaErrorInvalidValue;
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

// K11's resources at this J (a multiple of 8) on the current device
// (info[0..4] as dw_plan, info[5] whether h streams: see dh_plan).
extern "C" int e2e_rnnt_joint_dh_plan(int J, int* info) {
  if (J % 8 != 0) return (int)cudaErrorInvalidValue;
  if (J > kSlab) return (int)dh_plan<8, true>(J, info);
  switch (slabs_for(J)) {
    case 1: return (int)dh_plan<1, false>(J, info);
    case 2: return (int)dh_plan<2, false>(J, info);
    case 4: return (int)dh_plan<4, false>(J, info);
    case 8: return (int)dh_plan<8, false>(J, info);
  }
  return (int)cudaErrorInvalidValue;
}

// As e2e_rnnt_joint_dh, with any J a multiple of 8; out holds dW (JPad,
// Vp), JPad = 16, 32, 64, 128 or J rounded up to a multiple of 128, and
// then db (Vp,), f32, every element written.  With splits > 1 the rows
// are split over that many blocks per V tile (1 <= splits <= the 64-row
// blocks, or 1 when R = 0) whose partial sums go to ws, splits x the size
// of out, and a second kernel adds them up in split order.
extern "C" int e2e_rnnt_joint_dw(const void* h, const void* w, const void* b,
                                 const void* y, const void* m,
                                 const void* logs, const void* gb,
                                 const void* gl, void* out, void* ws,
                                 long long R, int J, int V, int Vp, int blank,
                                 int splits, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (J % 8 != 0 || splits < 1 || (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  if (J > kSlab)
    return (int)dw<8, true>(h, w, b, y, m, logs, gb, gl, out, ws, R, J, V, Vp, blank, splits, st);
  switch (slabs_for(J)) {
    case 1: return (int)dw<1, false>(h, w, b, y, m, logs, gb, gl, out, ws, R, J, V, Vp, blank, splits, st);
    case 2: return (int)dw<2, false>(h, w, b, y, m, logs, gb, gl, out, ws, R, J, V, Vp, blank, splits, st);
    case 4: return (int)dw<4, false>(h, w, b, y, m, logs, gb, gl, out, ws, R, J, V, Vp, blank, splits, st);
    case 8: return (int)dw<8, false>(h, w, b, y, m, logs, gb, gl, out, ws, R, J, V, Vp, blank, splits, st);
  }
  return (int)cudaErrorInvalidValue;
}

// K12's resources at this J on the current device (info as dw_plan).
extern "C" int e2e_rnnt_joint_dw_plan(int J, int* info) {
  if (J > kSlab) return (int)dw_plan<8, true>(info);
  switch (slabs_for(J)) {
    case 1: return (int)dw_plan<1, false>(info);
    case 2: return (int)dw_plan<2, false>(info);
    case 4: return (int)dw_plan<4, false>(info);
    case 8: return (int)dw_plan<8, false>(info);
  }
  return (int)cudaErrorInvalidValue;
}
