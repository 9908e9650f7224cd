// Flash attention backward on the Hopper tensor cores (sm_90a): bf16 q, k,
// v, hand-written CUDA C++ with wgmma, TMA and mbarriers.
//
// The gradient of `flash_attention` for the tensor-core route's inputs:
// q [B, Tq, H, d], k [B, Tk, KV, d], v [B, Tk, KV, dv], all bf16, (d, dv) ∈
// {(64, 64), (112, 112), (128, 128), (256, 256), (192, 128)} — the pairs
// flash_attention_tc.cu takes.  The TPU kernel
// `repro.kernels.flash_attention.flash_attention` has no VJP: the JAX
// package trains through `repro.kernels.ref.make_flash`, a jax.custom_vjp
// whose bwd (src/repro/kernels/ref.py:201) this computes, as
// flash_attention_bwd.cu does on the CUDA cores for every other input.
// From the forward's f32 output o [B, Tq, H, dv], its row statistics m, l
// [B, H, Tq] and the output's gradient do (bf16):
//
//     D_i  = Σ_c do_ic · o_ic
//     s_ij = (q_i · k_j)·scale, or NEG_INF = −1e30 where the mask drops it
//     p_ij = exp(s_ij − m_i) / max(l_i, 1e-20)
//     ds_ij = p_ij · (do_i · v_j − D_i) · scale
//     dq_i = Σ_j ds_ij k_j,   dk_j = Σ_i ds_ij q_i,   dv_j = Σ_i p_ij do_i
//
// with dk and dv summed over the H / KV query heads of each KV head.  As in
// the reference, a masked score is NEG_INF and not −inf: a row that a
// window leaves without keys has m = NEG_INF, so each of its keys gets
// p = 1 / l and its ds is not masked.  Rows past Tq and keys past Tk get
// p = ds = 0.  The plain version is `flash_attention_backward_reference`
// in flash_attention.py.
//
// What bounds it.  At Gemma-2B's training shape [8, 1,024, 8 on 1, 256]
// the causal half of the five products is 86 GFLOP (0.087 ms at the 989
// TFLOP/s bf16 peak) against 185 MB of traffic (0.055 ms at 3.35 TB/s):
// operations.  This kernel does more than that: the two passes recompute s
// and do·vᵀ, and p and ds enter their products in three bf16 parts (see
// "Precision"), ~225 GFLOP of tensor-core work at that shape.
//
// Design: three launches (four where the dK/dV pass splits the query
// heads), no float atomics, so the gradients are the same bits from run to
// run.
//   * prep_kernel: one warp per (b, head, row) of Tq rounded up to 64: D,
//     m·log2(e) and 1 / max(l, 1e-20) into a record of 3 × 64 floats per
//     (b, head, 64-row tile), so a pass loads a tile's row constants with
//     one bulk copy.  Rows past Tq get D = 0, m = 0, 1/l = 0: their p is 0.
//   * dkdv_kernel: one block per (64-key tile, KV head, b, share of the
//     head's query heads).  K and V are loaded once by TMA and stay in
//     shared memory.  A producer thread streams, through a ring of
//     mbarrier'd stages, the Q tile, the dO tile and the row record of
//     each (query head of the share, Q tile the mask keeps).  Two consumer
//     warpgroups split the work, each running the same instructions on
//     other operands (no wgmma in a branch that differs between them,
//     which ptxas would serialise):
//       - warpgroup 0: Sᵀ = K·Qᵀ, then Pᵀ = exp2(Sᵀ·scale·log2 e − m₂)·(1/l)
//         with the masks on the fragments, Pᵀ in f32 to shared memory, and
//         dV += Pᵀ·dO;
//       - warpgroup 1: dPᵀ = V·dOᵀ, then (after a named barrier) dSᵀ = Pᵀ ⊙
//         (dPᵀ − D)·scale, and dK += dSᵀ·Q.
//     Sᵀ and dPᵀ are wgmma m64n64k16 with both operands from shared memory
//     (K-major); the accumulating products take Pᵀ or dSᵀ as the register A
//     operand (the accumulator layout of a 64 × 64 product is the A layout)
//     and dO or Q from shared memory, MN-major, as the forward's V.  One
//     accumulator of 64 × max(d, dv) f32 per warpgroup (128 registers a
//     thread at d = 256).  Where d ≠ dv the shorter operand's missing boxes
//     are zeros in shared memory, so both warpgroups run max(d, dv).
//   * Head shares (`head_split`): Gemma-2B's MQA gives 128 dK/dV blocks
//     whose causal work runs from 8 to 128 (head, Q tile) pairs, so the
//     heaviest would set the pass's time.  Where the blocks would not fill
//     the card twice over, each KV head's query heads are split into
//     shares (2 there) whose f32 partial sums dkdv_sum_kernel adds in a
//     fixed order (H100, scripts/flash_variants.py: 0.97 → 0.77 ms a call
//     at that shape).
//   * dq_kernel: one block per (Q tile, head, b), the forward's layout: two
//     consumer warpgroups of 64 rows (two heads of one KV head when the
//     GQA group is even, else 128 rows of one head; one warpgroup at
//     d = 256, for shared memory) and a producer streaming K / V tiles
//     through a ring.  S = Q·Kᵀ and dP = dO·Vᵀ (shared-memory operands),
//     dS on the fragments, dQ += dS·K (K MN-major).
//   * Masks: evaluated only on tiles that some row does not keep whole (a
//     condition uniform over the block).  A (Q tile, K tile) pair is
//     skipped only when no row of the Q tile keeps a key of the K tile and
//     no row of the Q tile keeps no key at all (then every p of the pair is
//     exactly 0), as flash_attention_bwd.cu does.
//   * Grid order: with fewer (b, head) groups than SMs the tile is the
//     slowest grid index and the heavy tiles (the most kept pairs under a
//     causal mask) start first; with more, the fastest, for L2 locality.
//   * Registers: setmaxnreg lowers the producer warpgroup to 24 and raises
//     two consumer warpgroups to 240; a block with one consumer warpgroup
//     keeps the 255 a thread its 256 threads allow.
//
// Precision.  The gate on the card holds each bf16 gradient within 5e-3 of
// its largest magnitude of the plain version's bf16 gradient, so one bf16
// ulp of difference in an element of the top binade (2⁻⁸ to 2⁻⁷ of the
// largest) nearly spends it: the f32 values before the output rounding
// must differ by much less than the f32 plain version's own rounding
// noise.  Two things decide that here.
//   * p and ds are not bf16.  One bf16 rounding moves the gradients by ~2e-3
//     of their largest magnitude (tests/test_torch_flash_bwd_tc.py restates
//     the kernel's roundings on the CPU: the bf16 outputs then break the
//     gate).  Each enters as bf16 parts, each the rounding of what the
//     earlier leave: three parts (TERMS) carry ~24 bits, three wgmmas into
//     one accumulator.  (Two parts, 16 bits, left 0.25–0.33 % of the bf16
//     gradients' elements one ulp off the plain version's on the H100:
//     `parts2` in scripts/flash_variants.py.)
//   * The tensor cores' f32 accumulation is not round-to-nearest: the
//     differences grow with the number of wgmmas summed into one
//     accumulator (dK, dV of Gemma-2B's MQA summed there over 4 heads × 16
//     Q tiles: 0.39 % of the elements one ulp off and dV at 4.67e-3 of its
//     max, `tc_sum` in scripts/flash_variants.py).  So every accumulating
//     product of one Q or K tile lands in a temporary that is added to the
//     f32 accumulator on the CUDA cores: 0.075–0.15 % off, as the CUDA-core
//     kernel's 0.02–0.14 %.

#include <cuda.h>            // CUtensorMap and its enums; no driver library linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

struct FlashBwdTcArgs {
  int B, Tq, Tk, H, KV, d, dv, causal, window, q_offset;
  float scale;
};

namespace {

constexpr int ROWS = 64;                // query rows per tile
constexpr int BK = 64;                  // keys per tile
constexpr int BOX = 64;                 // bf16 per 128-byte swizzled row
constexpr int BOX_BYTES = 64 * 128;     // one box of 64 rows
constexpr int REC = 3 * ROWS;           // floats of a tile's row record
constexpr int REC_BYTES = REC * 4;
constexpr int SMEM_MAX = 232448;        // what a block may use (227 KB)
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float NEG_L2 = NEG_INF * LOG2E;   // a masked score in log2 units
constexpr int TERMS = 3;                // bf16 parts of p and ds (Precision)

template <int D_, int DV_>
struct Cfg {
  static constexpr int D = D_, DV = DV_;
  static constexpr int NBQ = (D + BOX - 1) / BOX;    // boxes across d
  static constexpr int NBV = (DV + BOX - 1) / BOX;   // boxes across dv
  static constexpr int NB = NBQ > NBV ? NBQ : NBV;
  static constexpr int W = D > DV ? D : DV;
  static constexpr int LAST = W - BOX * (NB - 1);    // the last box: 64 or 48
  static constexpr int LASTQ = D - BOX * (NBQ - 1);
  // dK/dV pass: K, V resident (NB boxes each; V's past dv are zeros), a
  // ring of Q, dO (NB boxes each; dO's past dv zeros) and row records,
  // Pᵀ's f32 exchange (64 × 64)
  static constexpr int KV_FIXED = 1024 + 2 * NB * BOX_BYTES + 64 * 64 * 4;
  static constexpr int KV_STAGE = 2 * NB * BOX_BYTES + REC_BYTES;
  static constexpr int KV_STAGES =
      KV_FIXED + 3 * KV_STAGE + 8 * 7 <= SMEM_MAX ? 3 : 2;
  static constexpr int KV_SMEM = KV_FIXED + KV_STAGES * KV_STAGE +
                                 8 * (2 * KV_STAGES + 1);
  // dQ pass: CW consumer warpgroups with their Q and dO tiles and row
  // records, a ring of K / V tiles
  static constexpr int CW = D > 192 ? 1 : 2;
  static constexpr int Q_FIXED =
      1024 + CW * (NBQ + NBV) * BOX_BYTES + CW * REC_BYTES;
  static constexpr int Q_STAGE = (NBQ + NBV) * BOX_BYTES;
  static constexpr int Q_STAGES =
      Q_FIXED + 3 * Q_STAGE + 8 * 7 <= SMEM_MAX ? 3 : 2;
  static constexpr int Q_SMEM = Q_FIXED + Q_STAGES * Q_STAGE +
                                8 * (2 * Q_STAGES + 1);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes) : "memory");
}

// spin until the phase of parity `parity` has completed; a wait that lasts
// 4 s (a fault in the pipeline) traps rather than holding the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred done, late;\n.reg .u64 t0, t1;\n"
      "mov.u64 t0, %%globaltimer;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@done bra.uni DONE;\n"
      "mov.u64 t1, %%globaltimer;\n"
      "sub.u64 t1, t1, t0;\n"
      "setp.gt.u64 late, t1, 4000000000;\n"
      "@late trap;\n"
      "bra.uni WAIT;\n"
      "DONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// arrive on `bar` where `pred` holds (a predicated instruction, no branch)
__device__ __forceinline__ void mbar_arrive_if(uint32_t bar, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(bar),
      "r"(int(pred))
      : "memory");
}

// named barriers between the two consumer warpgroups (256 threads)
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// one box of a 4-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3) : "memory");
}

// `bytes` (a multiple of 16) contiguous bytes into shared memory
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// wgmma descriptor of a 1024-byte-aligned run of 128-byte swizzled rows
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void fence_regs(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}
template <int R>
__device__ __forceinline__ void fence_all(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) fence_regs(r[i]);
}
template <int T, int K>
__device__ __forceinline__ void fence_all(uint32_t (&p)[T][K][4]) {
#pragma unroll
  for (int t = 0; t < T; ++t)
#pragma unroll
    for (int kk = 0; kk < K; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) fence_regs(p[t][kk][i]);
}

// D[64×64] (+)= A·B, A and B from shared memory (K-major, 128-byte
// swizzle); accumulate = 0 overwrites D
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
          "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
          "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64×64] (+)= A·B, A (bf16 pairs) from registers, B from shared memory
// (MN-major, 128-byte swizzle: the transpose flag set); accumulate = 0
// overwrites D
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
          "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
          "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// D[64×48] (+)= A·B, A from registers, B from shared memory (MN-major)
__device__ __forceinline__ void wgmma_rs_n48(float* d, const uint32_t* a,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
          "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// 2^x by the SFU (ex2.approx, ~2 ulp; subnormal results flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// a 64 × 64 f32 fragment as wgmma's register A operand in TERMS bf16
// parts, each the bf16 rounding of what the earlier ones leave (exact
// differences in f32): the fragment's layout for columns 16·kk … 16·kk +
// 15 is the A fragment of k-step kk
__device__ __forceinline__ void pack_split(uint32_t (&f)[TERMS][BK / 16][4],
                                           const float (&x)[BK / 2]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float a = x[8 * kk + 2 * i], b = x[8 * kk + 2 * i + 1];
#pragma unroll
      for (int t = 0; t < TERMS; ++t) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
        f[t][kk][i] = *reinterpret_cast<const uint32_t*>(&h);
        a -= __low2float(h);
        b -= __high2float(h);
      }
    }
}

__device__ __forceinline__ bool keep(const FlashBwdTcArgs& a, int qp,
                                     int kp) {
  return (!a.causal || kp <= qp) && (!a.window || kp > qp - a.window);
}

// [lo, hi) of the K tiles holding a kept key for some of `rows` query rows
// from position q_offset + pos0; every tile if one of those rows keeps no
// key at all (the mask is monotone in the position: only the first row can
// lose every key to causality, only the last to the window); none if
// rows <= 0
__device__ __forceinline__ void kv_range(const FlashBwdTcArgs& a, int pos0,
                                         int rows, int& lo, int& hi) {
  if (rows <= 0) {
    lo = hi = 0;
    return;
  }
  const int qlo = a.q_offset + pos0, qhi = qlo + rows - 1;
  const bool empty_row = (a.causal && qlo < 0) ||
                         (a.window && qhi - a.window + 1 > a.Tk - 1);
  if (empty_row) {
    lo = 0;
    hi = (a.Tk + BK - 1) / BK;
  } else {
    lo = (a.window ? max(0, qlo - a.window + 1) : 0) / BK;
    hi = (a.causal ? min(a.Tk - 1, qhi) : a.Tk - 1) / BK + 1;
  }
}

// whether the pair (Q tile t, K tile from key k0) can hold a nonzero p
__device__ __forceinline__ bool pair_live(const FlashBwdTcArgs& a, int t,
                                          int k0) {
  int lo, hi;
  kv_range(a, t * ROWS, min(ROWS, a.Tq - t * ROWS), lo, hi);
  return k0 / BK >= lo && k0 / BK < hi;
}

// whether every (query of the rows [qlo, qhi], key of the tile from k0)
// pair is kept and every key is below Tk: the tile needs no mask
__device__ __forceinline__ bool whole(const FlashBwdTcArgs& a, int qlo,
                                      int qhi, int k0) {
  return k0 + BK <= a.Tk && (!a.causal || k0 + BK - 1 <= qlo) &&
         (!a.window || k0 > qhi - a.window);
}

// X = A·Bᵀ over `ksteps` k16 steps, both from shared memory (K-major
// boxes of 64), issued (not committed)
template <int KSTEPS>
__device__ __forceinline__ void issue_ss(float (&x)[BK / 2], uint32_t sA,
                                         uint32_t sB) {
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const uint32_t off = (kk >> 2) * BOX_BYTES + (kk & 3) * 32;
    wgmma_ss_n64(x, sw128_desc(sA + off), sw128_desc(sB + off), kk > 0);
  }
}

// ACC += (Σ parts)·B over the NB boxes of B's N (MN-major, 64 k-rows a
// box; the last box LAST wide), box by box: each box's product (4 k-steps
// × TERMS parts, the largest part first) on the tensor cores into the
// temporary t, then added to ACC in f32 on the CUDA cores (see
// "Precision")
template <int NB, int LAST>
__device__ __forceinline__ void accumulate_rs(
    float (&acc)[NB][32], float (&t)[BK / 2],
    const uint32_t (&f)[TERMS][BK / 16][4], uint32_t sB) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    const bool full = nb < NB - 1 || LAST == 64;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t db = sw128_desc(sB + nb * BOX_BYTES + kk * 16 * 128);
#pragma unroll
      for (int p = 0; p < TERMS; ++p)
        if (full)
          wgmma_rs_n64(t, f[p][kk], db, kk + p > 0);
        else
          wgmma_rs_n48(t, f[p][kk], db, kk + p > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_all(t);
#pragma unroll
    for (int i = 0; i < BK / 2; ++i)
      if (full || i < 24) acc[nb][i] += t[i];
  }
}

// ----------------------------------------------------------------- prep
__global__ void __launch_bounds__(256)
    prep_kernel(const FlashBwdTcArgs a, const __nv_bfloat16* __restrict__ dout,
                const float* __restrict__ o, const float* __restrict__ m,
                const float* __restrict__ l, float* __restrict__ rec) {
  const int ntq = (a.Tq + ROWS - 1) / ROWS;
  const size_t row = size_t(blockIdx.x) * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= size_t(a.B) * a.H * ntq * ROWS) return;
  const int i = int(row % (size_t(ntq) * ROWS));
  const size_t bh = row / (size_t(ntq) * ROWS);           // b·H + h
  const int h = int(bh % a.H), b = int(bh / a.H);
  float dsum = 0.f, m2 = 0.f, il = 0.f;
  if (i < a.Tq) {
    const size_t base = ((size_t(b) * a.Tq + i) * a.H + h) * a.dv;
    for (int c = lane * 8; c < a.dv; c += 256) {
      const uint4 u = *reinterpret_cast<const uint4*>(dout + base + c);
      const float4 o0 = *reinterpret_cast<const float4*>(o + base + c);
      const float4 o1 = *reinterpret_cast<const float4*>(o + base + c + 4);
      const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&u);
      const float2 x0 = __bfloat1622float2(d2[0]),
                   x1 = __bfloat1622float2(d2[1]),
                   x2 = __bfloat1622float2(d2[2]),
                   x3 = __bfloat1622float2(d2[3]);
      dsum = fmaf(x0.x, o0.x, dsum);
      dsum = fmaf(x0.y, o0.y, dsum);
      dsum = fmaf(x1.x, o0.z, dsum);
      dsum = fmaf(x1.y, o0.w, dsum);
      dsum = fmaf(x2.x, o1.x, dsum);
      dsum = fmaf(x2.y, o1.y, dsum);
      dsum = fmaf(x3.x, o1.z, dsum);
      dsum = fmaf(x3.y, o1.w, dsum);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      dsum += __shfl_xor_sync(0xffffffffu, dsum, off);
    const size_t r = bh * a.Tq + i;
    const float mm = m[r];
    m2 = mm == NEG_INF ? NEG_L2 : mm * LOG2E;
    il = 1.f / fmaxf(l[r], 1e-20f);
  }
  if (lane == 0) {
    float* t = rec + (bh * ntq + i / ROWS) * REC + i % ROWS;
    t[0] = m2;
    t[ROWS] = il;
    t[2 * ROWS] = dsum;
  }
}

// (tile, head, batch) of this block; tile_major: the tile is the slowest
// grid index (see grid)
__device__ __forceinline__ void coords(bool tile_major, int& tile, int& head,
                                       int& b) {
  tile = tile_major ? blockIdx.z : blockIdx.x;
  b = tile_major ? blockIdx.x : blockIdx.z;
  head = blockIdx.y;
}

// ----------------------------------------------------------------- dK/dV
template <class C>
__global__ void __launch_bounds__(384, 1)
    dkdv_kernel(const __grid_constant__ CUtensorMap tmq,
                const __grid_constant__ CUtensorMap tmk,
                const __grid_constant__ CUtensorMap tmv,
                const __grid_constant__ CUtensorMap tmo,
                const FlashBwdTcArgs a, bool tile_major, int split,
                const float* __restrict__ rec, __nv_bfloat16* __restrict__ dk,
                __nv_bfloat16* __restrict__ dv, float* __restrict__ part) {
  constexpr int NB = C::NB, NBQ = C::NBQ, NBV = C::NBV, S = C::KV_STAGES;
  static_assert(NBQ == NB, "d >= dv: K and Q fill every box");
  constexpr int TILE = NB * BOX_BYTES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sK = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sV = sK + TILE;
  const uint32_t sQ = sV + TILE;                 // S stages of Q
  const uint32_t sO = sQ + S * TILE;             // S stages of dO
  const uint32_t sX = sO + S * TILE;             // Pᵀ, f32 [32][128]
  const uint32_t sR = sX + 64 * 64 * 4;          // S row records
  const uint32_t bars = sR + S * REC_BYTES;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (S + s); };
  const uint32_t kvbar = bars + 8u * (2 * S);
  uint8_t* const base = smem_raw + (sK - smem_u32(smem_raw));
  float* const xP = reinterpret_cast<float*>(base + (sX - sK));
  const float* const recs = reinterpret_cast<const float*>(base + (sR - sK));

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int kt, hs, b;
  coords(tile_major, kt, hs, b);
  // this block's share of the KV head's query heads: gs of them from h0
  const int kvh = hs / split, share = hs % split;
  const int k0 = kt * BK, gs = a.H / a.KV / split, ntq = (a.Tq + ROWS - 1) / ROWS;
  const int h0 = (kvh * split + share) * gs;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);            // one arrival per consumer warp
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the boxes past dv of V and of every dO stage are zeros that no load
  // overwrites: the shorter product runs as long as the longer one
  if (NBV < NB) {
    for (int s = 0; s <= S; ++s) {
      uint4* z = reinterpret_cast<uint4*>(
          base + ((s == S ? sV : sO + s * TILE) - sK) + NBV * BOX_BYTES);
      for (int i = tid; i < (NB - NBV) * BOX_BYTES / 16; i += 384)
        z[i] = make_uint4(0, 0, 0, 0);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (warp == 8 && lane == 0) {
      mbar_expect_tx(kvbar, (NBQ + NBV) * BOX_BYTES);
      for (int nb = 0; nb < NBQ; ++nb)
        tma_load(sK + nb * BOX_BYTES, &tmk, kvbar, nb * BOX, kvh, k0, b);
      for (int nb = 0; nb < NBV; ++nb)
        tma_load(sV + nb * BOX_BYTES, &tmv, kvbar, nb * BOX, kvh, k0, b);
      int stage = 0, phase = 0;
      for (int hh = 0; hh < gs; ++hh) {
        const int h = h0 + hh;
        for (int t = 0; t < ntq; ++t) {
          if (!pair_live(a, t, k0)) continue;
          mbar_wait(empty(stage), phase ^ 1);
          mbar_expect_tx(full(stage), (NBQ + NBV) * BOX_BYTES + REC_BYTES);
          for (int nb = 0; nb < NBQ; ++nb)
            tma_load(sQ + stage * TILE + nb * BOX_BYTES, &tmq, full(stage),
                     nb * BOX, h, t * ROWS, b);
          for (int nb = 0; nb < NBV; ++nb)
            tma_load(sO + stage * TILE + nb * BOX_BYTES, &tmo, full(stage),
                     nb * BOX, h, t * ROWS, b);
          bulk_load(sR + stage * REC_BYTES,
                    rec + ((size_t(b) * a.H + h) * ntq + t) * REC, REC_BYTES,
                    full(stage));
          if (++stage == S) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // ------------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  // warpgroup 0: Sᵀ = K·Qᵀ → Pᵀ → dV += Pᵀ·dO;
  // warpgroup 1: dPᵀ = V·dOᵀ → dSᵀ = Pᵀ(dPᵀ − D)·scale → dK += dSᵀ·Q
  const int w = warp >> 2, wt = tid & 127;
  const int r0 = (warp & 3) * 16 + (lane >> 2);     // key rows r0, r0 + 8
  const float sl2 = a.scale * LOG2E;
  const uint32_t sA = w == 0 ? sK : sV;

  float acc[NB][32], x[BK / 2], tmp[BK / 2];
  uint32_t frag[TERMS][BK / 16][4];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[nb][i] = 0.f;

  int n_live = 0;
  for (int t = 0; t < ntq; ++t) n_live += pair_live(a, t, k0);
  n_live *= gs;

  mbar_wait(kvbar, 0);
  int stage = 0, phase = 0, it = 0;
  for (int hh = 0; hh < gs; ++hh) {
    for (int t = 0; t < ntq; ++t) {
      if (!pair_live(a, t, k0)) continue;
      mbar_wait(full(stage), phase);
      const uint32_t qs = sQ + stage * TILE, os = sO + stage * TILE;
      wgmma_fence();
      issue_ss<C::W / 16>(x, sA, w == 0 ? qs : os);
      wgmma_commit();
      wgmma_wait<0>();
      fence_all(x);
      const float* rs = recs + stage * REC;     // m₂, 1/l, D of the tile
      const int q0 = t * ROWS, qlo = a.q_offset + q0;
      if (w == 0) {
        const bool mask = !whole(a, qlo, qlo + ROWS - 1, k0);
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * j + 2 * (lane & 3) + e;
            const float m2 = rs[col], il = rs[ROWS + col];
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              float& v = x[4 * j + 2 * hr + e];
              const int kp = k0 + r0 + 8 * hr;
              float s2 = v * sl2;
              if (mask && !keep(a, qlo + col, kp)) s2 = NEG_L2;
              v = (mask && kp >= a.Tk) ? 0.f : ex2(s2 - m2) * il;
            }
          }
        if (it > 0) bar_sync(2);          // warpgroup 1 has read the last Pᵀ
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) xP[i * 128 + wt] = x[i];
        __threadfence_block();
        bar_arrive(1);
      } else {
        bar_sync(1);                      // warpgroup 0's Pᵀ is written
        float p[BK / 2];
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) p[i] = xP[i * 128 + wt];
        if (it + 1 < n_live) {
          __threadfence_block();
          bar_arrive(2);
        }
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * j + 2 * (lane & 3) + e;
            const float dd = rs[2 * ROWS + col];
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              float& v = x[4 * j + 2 * hr + e];
              v = p[4 * j + 2 * hr + e] * (v - dd) * a.scale;
            }
          }
      }
      pack_split(frag, x);
      accumulate_rs<NB, C::LAST>(acc, tmp, frag, w == 0 ? os : qs);
      fence_all(frag);
      mbar_arrive_if(empty(stage), lane == 0);
      if (++stage == S) {
        stage = 0;
        phase ^= 1;
      }
      ++it;
    }
  }

  // dV (warpgroup 0, dv columns) or dK (warpgroup 1, d columns): bf16, or
  // this share's f32 partial sums [split, B, Tk, KV, width] (dK's, then
  // dV's) for dkdv_sum_kernel
  const int width = w == 0 ? a.dv : a.d;
  const size_t nk = size_t(a.B) * a.Tk * a.KV * a.d;
  __nv_bfloat16* const out = w == 0 ? dv : dk;
  float* const pout = part + (w == 0 ? split * nk : 0) +
                      size_t(share) * a.B * a.Tk * a.KV * width;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int key = k0 + r0 + 8 * hr;
    if (key >= a.Tk) continue;
    const size_t row = ((size_t(b) * a.Tk + key) * a.KV + kvh) * width;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = nb * BOX + 8 * j + 2 * (lane & 3);
        if (col >= width) continue;
        const float lo = acc[nb][4 * j + 2 * hr], hi = acc[nb][4 * j + 2 * hr + 1];
        if (split == 1)
          *reinterpret_cast<__nv_bfloat162*>(out + row + col) =
              __floats2bfloat162_rn(lo, hi);
        else
          *reinterpret_cast<float2*>(pout + row + col) = make_float2(lo, hi);
      }
  }
}

// dK and dV from the dK/dV pass's `split` partial sums, added in order of
// the share (so two launches give the same bits)
__global__ void __launch_bounds__(256)
    dkdv_sum_kernel(const FlashBwdTcArgs a, int split,
                  const float* __restrict__ part,
                  __nv_bfloat16* __restrict__ dk,
                  __nv_bfloat16* __restrict__ dv) {
  const size_t nk = size_t(a.B) * a.Tk * a.KV * a.d,
               nv = size_t(a.B) * a.Tk * a.KV * a.dv;
  for (size_t i = size_t(blockIdx.x) * 256 + threadIdx.x; i < nk + nv;
       i += size_t(gridDim.x) * 256) {
    const bool is_k = i < nk;
    const size_t j = is_k ? i : i - nk, n = is_k ? nk : nv;
    const float* src = part + (is_k ? 0 : split * nk) + j;
    float sum = src[0];
    for (int p = 1; p < split; ++p) sum += src[p * n];
    (is_k ? dk : dv)[j] = __float2bfloat16_rn(sum);
  }
}

// ----------------------------------------------------------------- dQ
template <class C>
__global__ void __launch_bounds__((C::CW + 1) * 128, 1)
    dq_kernel(const __grid_constant__ CUtensorMap tmq,
              const __grid_constant__ CUtensorMap tmk,
              const __grid_constant__ CUtensorMap tmv,
              const __grid_constant__ CUtensorMap tmo,
              const FlashBwdTcArgs a, bool tile_major,
              const float* __restrict__ rec, __nv_bfloat16* __restrict__ dq) {
  constexpr int NBQ = C::NBQ, NBV = C::NBV, CW = C::CW, S = C::Q_STAGES;
  constexpr int QT = NBQ * BOX_BYTES, VT = NBV * BOX_BYTES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;  // CW Q tiles
  const uint32_t sO = sQ + CW * QT;                           // CW dO tiles
  const uint32_t sK = sO + CW * VT;                           // S K tiles
  const uint32_t sV = sK + S * QT;                            // S V tiles
  const uint32_t sR = sV + S * VT;                            // CW records
  const uint32_t bars = sR + CW * REC_BYTES;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (S + s); };
  const uint32_t qbar = bars + 8u * (2 * S);
  const float* const recs = reinterpret_cast<const float*>(
      smem_raw + (sR - smem_u32(smem_raw)));

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = a.H / a.KV, ntq = (a.Tq + ROWS - 1) / ROWS;
  // CW heads × 64 rows when the GQA group holds CW heads, else CW × 64
  // rows of one head; the last tiles (the most kept pairs) first when the
  // tile is the slowest index
  const bool heads = g % CW == 0;
  int tile, hb, b;
  coords(tile_major, tile, hb, b);
  const int tiles = heads ? ntq : (ntq + CW - 1) / CW;
  if (tile_major) tile = tiles - 1 - tile;
  int pos0[CW], head[CW], rows[CW];
  int blo = 1 << 30, bhi = 0, qlo = 1 << 30, qhi = -(1 << 30);
#pragma unroll
  for (int w = 0; w < CW; ++w) {
    pos0[w] = heads ? tile * ROWS : (tile * CW + w) * ROWS;
    head[w] = heads ? hb * CW + w : hb;
    rows[w] = min(ROWS, a.Tq - pos0[w]);
    int lo, hi;
    kv_range(a, pos0[w], rows[w], lo, hi);
    if (rows[w] > 0) {
      blo = min(blo, lo);
      bhi = max(bhi, hi);
      qlo = min(qlo, a.q_offset + pos0[w]);
      qhi = max(qhi, a.q_offset + pos0[w] + ROWS - 1);
    }
  }
  const int kvh = head[0] / g;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * CW);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * CW) {
    // ------------------------------------------------------------ producer
    if (CW > 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (warp == 4 * CW && lane == 0) {
      int bytes = 0;
      for (int w = 0; w < CW; ++w)
        if (rows[w] > 0) bytes += QT + VT + REC_BYTES;
      mbar_expect_tx(qbar, bytes);
      for (int w = 0; w < CW; ++w) {
        if (rows[w] <= 0) continue;
        for (int nb = 0; nb < NBQ; ++nb)
          tma_load(sQ + w * QT + nb * BOX_BYTES, &tmq, qbar, nb * BOX,
                   head[w], pos0[w], b);
        for (int nb = 0; nb < NBV; ++nb)
          tma_load(sO + w * VT + nb * BOX_BYTES, &tmo, qbar, nb * BOX,
                   head[w], pos0[w], b);
        bulk_load(sR + w * REC_BYTES,
                  rec + ((size_t(b) * a.H + head[w]) * ntq + pos0[w] / ROWS) *
                            REC,
                  REC_BYTES, qbar);
      }
      int stage = 0, phase = 0;
      for (int kb = blo; kb < bhi; ++kb) {
        mbar_wait(empty(stage), phase ^ 1);
        mbar_expect_tx(full(stage), QT + VT);
        for (int nb = 0; nb < NBQ; ++nb)
          tma_load(sK + stage * QT + nb * BOX_BYTES, &tmk, full(stage),
                   nb * BOX, kvh, kb * BK, b);
        for (int nb = 0; nb < NBV; ++nb)
          tma_load(sV + stage * VT + nb * BOX_BYTES, &tmv, full(stage),
                   nb * BOX, kvh, kb * BK, b);
        if (++stage == S) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ------------------------------------------------------------- consumers
  if (CW > 1) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int w = warp >> 2;
  const int r0 = (warp & 3) * 16 + (lane >> 2);     // rows r0 and r0 + 8
  const float sl2 = a.scale * LOG2E;
  const uint32_t sQw = sQ + w * QT, sOw = sO + w * VT;

  float acc[NBQ][32], s[BK / 2], dp[BK / 2], tmp[BK / 2];
  uint32_t frag[TERMS][BK / 16][4];
#pragma unroll
  for (int nb = 0; nb < NBQ; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[nb][i] = 0.f;

  // A warpgroup whose rows lie past Tq computes on tiles that were not
  // loaded and stores nothing; a K tile outside its own rows' range gives
  // p = 0 there (masked scores against a finite m), as the forward does
  mbar_wait(qbar, 0);
  const float* rw = recs + w * REC;
  float m2[2], il[2], dd[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    m2[hr] = rows[w] > 0 ? rw[r0 + 8 * hr] : 0.f;
    il[hr] = rows[w] > 0 ? rw[ROWS + r0 + 8 * hr] : 0.f;
    dd[hr] = rows[w] > 0 ? rw[2 * ROWS + r0 + 8 * hr] : 0.f;
  }
  const int qp0 = a.q_offset + pos0[w] + r0;
  int stage = 0, phase = 0;
  for (int kb = blo; kb < bhi; ++kb) {
    mbar_wait(full(stage), phase);
    const uint32_t ks = sK + stage * QT, vs = sV + stage * VT;
    wgmma_fence();
    issue_ss<C::D / 16>(s, sQw, ks);
    issue_ss<C::DV / 16>(dp, sOw, vs);
    wgmma_commit();
    wgmma_wait<0>();
    fence_all(s);
    fence_all(dp);
    const int k0 = kb * BK;
    const bool mask = !whole(a, qlo, qhi, k0);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kp = k0 + 8 * j + 2 * (lane & 3) + e;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int i = 4 * j + 2 * hr + e;
          float s2 = s[i] * sl2;
          if (mask && !keep(a, qp0 + 8 * hr, kp)) s2 = NEG_L2;
          const float p = (mask && kp >= a.Tk) ? 0.f
                                                : ex2(s2 - m2[hr]) * il[hr];
          s[i] = p * (dp[i] - dd[hr]) * a.scale;
        }
      }
    pack_split(frag, s);
    accumulate_rs<NBQ, C::LASTQ>(acc, tmp, frag, ks);
    fence_all(frag);
    mbar_arrive_if(empty(stage), lane == 0);
    if (++stage == S) {
      stage = 0;
      phase ^= 1;
    }
  }

  if (rows[w] <= 0) return;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int pos = pos0[w] + r0 + 8 * hr;
    if (pos >= a.Tq) continue;
    __nv_bfloat16* row = dq + ((size_t(b) * a.Tq + pos) * a.H + head[w]) * C::D;
#pragma unroll
    for (int nb = 0; nb < NBQ; ++nb)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = nb * BOX + 8 * j + 2 * (lane & 3);
        if (col < C::D)
          *reinterpret_cast<__nv_bfloat162*>(row + col) =
              __floats2bfloat162_rn(acc[nb][4 * j + 2 * hr],
                                    acc[nb][4 * j + 2 * hr + 1]);
      }
  }
}

// cuTensorMapEncodeTiled from the driver the runtime already loaded
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// [B, T, heads, d] bf16, d innermost, in boxes of 64 rows × 64 of d
bool tensor_map(CUtensorMap* map, const void* ptr, int B, int T, int heads,
                int d) {
  const EncodeTiled enc = encode_tiled();
  if (!enc) return false;
  const cuuint64_t dims[4] = {cuuint64_t(d), cuuint64_t(heads), cuuint64_t(T),
                              cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(d) * 2, cuuint64_t(heads) * d * 2,
                                 cuuint64_t(T) * heads * d * 2};
  const cuuint32_t box[4] = {BOX, 1, 64, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int sm_count() {
  static int n = 0;
  if (!n) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 1;
  }
  return n;
}

// A pass's grid: tiles × groups (batch × heads).  With fewer groups than
// SMs a wave of blocks spans few groups, and under a causal mask their
// heavy tiles would start late: the tile is then the slowest index.  With
// more, the fastest, so a wave keeps a few groups' tiles in L2.
dim3 grid(int tiles, int heads, int B, bool& tile_major) {
  tile_major = size_t(B) * heads < size_t(sm_count());
  return tile_major ? dim3(B, heads, tiles) : dim3(tiles, heads, B);
}

// Into how many shares the dK/dV pass splits each KV head's query heads:
// 1, unless its blocks (key tiles × KV heads × batch) would not fill the
// card twice over — Gemma-2B's MQA has 128 blocks whose causal work runs
// from 8 to 128 (head, Q tile) pairs, so the heaviest sets the pass's
// time.  Split in powers of two while the blocks stay within twice the
// SMs; the shares' f32 partial sums go through dkdv_sum_kernel.
int head_split(const FlashBwdTcArgs& a) {
  const int g = a.H / a.KV;
  const size_t blocks = size_t(a.B) * a.KV * ((a.Tk + BK - 1) / BK);
  int s = 1;
  while (g % (2 * s) == 0 && blocks * 2 * s <= 2 * size_t(sm_count())) s *= 2;
  return s;
}

size_t rec_floats(const FlashBwdTcArgs& a) {
  return size_t(a.B) * a.H * ((a.Tq + ROWS - 1) / ROWS) * REC;
}

size_t part_floats(const FlashBwdTcArgs& a) {
  const int s = head_split(a);
  return s == 1 ? 0
                : size_t(s) * a.B * a.Tk * a.KV * (size_t(a.d) + a.dv);
}

template <class C>
int launch(const FlashBwdTcArgs& a, const void* q, const void* k,
           const void* v, const float* o, const float* m, const float* l,
           const void* dout, float* rec, void* dq, void* dk, void* dv,
           cudaStream_t st) {
  CUtensorMap mq, mk, mv, mo;
  if (!tensor_map(&mq, q, a.B, a.Tq, a.H, a.d) ||
      !tensor_map(&mk, k, a.B, a.Tk, a.KV, a.d) ||
      !tensor_map(&mv, v, a.B, a.Tk, a.KV, a.dv) ||
      !tensor_map(&mo, dout, a.B, a.Tq, a.H, a.dv))
    return int(cudaErrorNotSupported);
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::KV_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dq_kernel<C>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::Q_SMEM);
  if (err != cudaSuccess) return int(err);
  const int ntq = (a.Tq + ROWS - 1) / ROWS;
  const size_t rows = size_t(a.B) * a.H * ntq * ROWS;
  prep_kernel<<<unsigned((rows + 7) / 8), 256, 0, st>>>(
      a, static_cast<const __nv_bfloat16*>(dout), o, m, l, rec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  bool tm;
  const int split = head_split(a);
  float* const part = rec + rec_floats(a);
  const dim3 gk = grid((a.Tk + BK - 1) / BK, a.KV * split, a.B, tm);
  dkdv_kernel<C><<<gk, 384, C::KV_SMEM, st>>>(
      mq, mk, mv, mo, a, tm, split, rec, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  if (split > 1) {
    dkdv_sum_kernel<<<4 * sm_count(), 256, 0, st>>>(
        a, split, part, static_cast<__nv_bfloat16*>(dk),
        static_cast<__nv_bfloat16*>(dv));
    err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
  }
  const bool heads = (a.H / a.KV) % C::CW == 0;
  const dim3 gq = grid(heads ? ntq : (ntq + C::CW - 1) / C::CW,
                       heads ? a.H / C::CW : a.H, a.B, tm);
  dq_kernel<C><<<gq, (C::CW + 1) * 128, C::Q_SMEM, st>>>(
      mq, mk, mv, mo, a, tm, rec, static_cast<__nv_bfloat16*>(dq));
  return int(cudaGetLastError());
}

}  // namespace

// Floats of the scratch `rec` for these arguments: the row records, then
// the dK/dV pass's partial sums where it splits the query heads.
extern "C" long long flash_attention_bwd_tc_scratch_floats(
    const FlashBwdTcArgs* a) {
  return (long long)(rec_floats(*a) + part_floats(*a));
}

// q, k, v, do, dq, dk, dv bf16, contiguous in the layouts above, 16-byte
// aligned (do and dq [B, Tq, H, d(v)], dk and dv as k and v); o [B, Tq, H,
// dv], m, l [B, H, Tq] f32; rec f32 scratch of
// flash_attention_bwd_tc_scratch_floats.  Returns a cudaError_t:
// cudaErrorInvalidValue for arguments it does not take,
// cudaErrorNotSupported if a tensor map cannot be encoded.
extern "C" int flash_attention_bwd_tc_launch(
    const FlashBwdTcArgs* a, const void* q, const void* k, const void* v,
    const float* o, const float* m, const float* l, const void* dout,
    float* rec, void* dq, void* dk, void* dv, void* stream) {
  if (a->B < 1 || a->Tq < 1 || a->Tk < 1 || a->H < 1 || a->KV < 1 ||
      a->H % a->KV || a->window < 0 || a->B > 65535 || a->H > 65535 ||
      (a->Tk + BK - 1) / BK > 65535 || (a->Tq + ROWS - 1) / ROWS > 65535 ||
      !((a->d == a->dv && (a->d == 64 || a->d == 112 || a->d == 128 ||
                           a->d == 256)) ||
        (a->d == 192 && a->dv == 128)) ||
      ((uintptr_t(q) | uintptr_t(k) | uintptr_t(v) | uintptr_t(o) |
        uintptr_t(dout) | uintptr_t(rec)) & 15))
    return int(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (a->d) {
    case 64:
      return launch<Cfg<64, 64>>(*a, q, k, v, o, m, l, dout, rec, dq, dk, dv,
                                 st);
    case 112:
      return launch<Cfg<112, 112>>(*a, q, k, v, o, m, l, dout, rec, dq, dk,
                                   dv, st);
    case 128:
      return launch<Cfg<128, 128>>(*a, q, k, v, o, m, l, dout, rec, dq, dk,
                                   dv, st);
    case 192:
      return launch<Cfg<192, 128>>(*a, q, k, v, o, m, l, dout, rec, dq, dk,
                                   dv, st);
    default:
      return launch<Cfg<256, 256>>(*a, q, k, v, o, m, l, dout, rec, dq, dk,
                                   dv, st);
  }
}
