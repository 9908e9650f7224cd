// Flash attention forward on the Hopper tensor cores (sm_90a): bf16 q, k, v,
// hand-written CUDA C++ with wgmma, TMA and mbarriers.
//
// Replaces the TPU kernel `repro.kernels.flash_attention.flash_attention`
// (Pallas body `_kernel`, src/repro/kernels/flash_attention.py) for the
// serving path's inputs: q [B, Tq, H, d], k and v [B, Tk, KV, d], all bf16,
// d ∈ {64, 112, 128, 256} (every head dim in configs/).  Same function as
// flash_attention.cu, which keeps every other input (f32, mixed types,
// other head dims); the wrapper routes by dtype and shape alone
// (`flash_route` in flash_attention.py).  The plain version is
// `flash_attention_reference` there.
//
//     s[i, j] = (q_i · k_j)·scale, or NEG_INF = −1e30 where the causal /
//               sliding-window mask drops (j, i) (positions i + q_offset, j)
//     out_i   = Σ_j softmax_j(s[i, ·]) v_j, normalised by max(l, 1e-20)
//
// What bounds it.  Each input byte read once and the output written once:
// at Zamba2-7B's prefill [8, 1,024, 32, 112] about 235 MB, 0.070 ms at
// 3.35 TB/s; the causal half of the two products is ~61 GFLOP, 0.061 ms at
// the 989 TFLOP/s bf16 tensor-core peak.  Gemma-2B's [8, 1,024, 8 on 1,
// 256] is bound by its 34.5 GFLOP (0.035 ms).  The CUDA-core kernel spent
// ~1 ms of f32 FMAs at best on Zamba2's work; the tensor cores are the way
// to the bound.
//
// Design.
//   * Block: two consumer warpgroups, each owning a Q tile of 64 rows, and
//     a producer warpgroup of which one thread issues every load (384
//     threads; the producer's three idle warps are there so that
//     setmaxnreg, which trades registers between the block's warpgroups,
//     has registers to hand over).  When the GQA group H / KV is even
//     the two tiles are the same 64 positions of two query heads of one KV
//     head (Gemma's 8-on-1 MQA), so one K/V tile feeds both; otherwise
//     they are 128 consecutive positions of one head (Zamba2's MHA).
//     Q tiles run in reverse so the long causal rows start first.  Both
//     warpgroups walk the block's whole range of K/V tiles, one tile at a
//     time (S, softmax, P·V), and interleave on the tensor cores: no
//     wgmma sits in a branch that differs between them, which ptxas would
//     serialise.  (Issuing tile i + 1's scores during tile i's softmax,
//     tiles of 128 keys, a third consumer warpgroup, a ping-pong order
//     between the two and Q as a register operand measured no faster on
//     the H100.)
//   * Loads: TMA over 4-D tensor maps of the [B, T, heads, d] layouts (d
//     innermost) in boxes of 64 rows × 64 bf16 (128 bytes) with 128-byte
//     swizzle, so each box lands in wgmma's canonical layout.  d = 112 is
//     two boxes; TMA fills lanes 112–127 of the second with zeros (past the
//     tensor's innermost extent), as it fills rows past Tq or Tk.  The Q
//     tiles load once; K and V tiles of 64 keys go through a ring of 3
//     stages (2 at d = 256: shared memory) with full / empty mbarriers.
//   * Scores: S = Q·Kᵀ by wgmma m64n64k16, both operands from shared
//     memory (K-major), f32 accumulate; the descriptor steps 32 bytes per
//     k16 inside a swizzled box and one box per 64 of d.
//   * Softmax: mask and online softmax on the accumulator fragments in
//     registers (rows r and r + 8 of each thread's quad); the row max by
//     quad shuffles, the row sum kept per thread and reduced once at the
//     end.  Scores are scaled into log2 units for the SFU's ex2; the
//     masked value stays NEG_INF, so a row that a window empties still
//     averages V.  The mask is evaluated only on tiles that some row of
//     the block does not keep whole (a condition uniform over the block).
//   * Values: P is rounded to bf16 in registers and fed as wgmma's register
//     A operand (the accumulator layout of S is the A layout of P·V); V is
//     the shared-memory B operand, MN-major (transpose flag), one wgmma of
//     N = 64 per 64-wide box of d (N = 48 for d = 112's last box).
//   * Registers: setmaxnreg lowers the producer to 24 and raises the
//     consumers to 240 (d = 256 holds a 64×256 f32 accumulator: 128 a
//     thread); 128 × (168 − 24) = 2 × 128 × (240 − 168).
//   * Masks and edges as flash_attention.cu: keys past Tk weigh exactly 0
//     (−inf), rows past Tq are not stored, and KV tiles the mask leaves
//     empty for every row of the block are skipped only when no row of the
//     block is left without keys; otherwise every tile runs.  A tile a
//     warpgroup runs that is fully masked for its own rows changes nothing:
//     after a kept key its weights are e^(−1e30 − m) = 0, and before one
//     they are wiped by the correction e^(−1e30 − m) = 0 at the first kept
//     key.
//   * Epilogue: normalise by max(l, 1e-20), store bf16 pairs.
//   * Statistics (the training path, `flash_attention_tc_stats_launch`):
//     the kernel instantiated with STATS also stores the f32 output o32
//     [B, Tq, H, d] and each row's final running max and sum, f32 [B, H,
//     Tq], by lane 0 of the row's quad after the quad's l reduction.  m is
//     kept in log2 units here; it is stored in natural units (m·ln 2), and
//     a row the mask leaves without keys keeps NEG_INF, as the plain
//     version's m, so that the backward's exp(s − m) is 1 there.  The
//     serving launch is the instantiation without them, the same code as
//     before they existed.
//
// bf16 P in the value product is what scaled_dot_product_attention does
// too; the result is held to the plain version within the reference's
// bf16 bound (2e-2).

#include <cuda.h>            // CUtensorMap and its enums; no driver library linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

struct FlashTcArgs {
  int B, Tq, Tk, H, KV, d, causal, window, q_offset;
  float scale;
};

namespace {

constexpr int ROWS = 64;                // query rows per consumer warpgroup
constexpr int BK = 64;                  // keys per K/V tile
constexpr int BOX = 64;                 // bf16 per 128-byte swizzled row
constexpr int BOX_BYTES = 64 * 128;     // one box of 64 rows (ROWS == BK)
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D_>
struct Cfg {
  static constexpr int D = D_;
  static constexpr int NB = (D + BOX - 1) / BOX;     // boxes across d
  static constexpr int LAST = D - BOX * (NB - 1);    // width of the last: 64 or 48
  static constexpr int CW = 2;                       // consumer warpgroups
  static constexpr int THREADS = (CW + 1) * 128;     // + the producer group
  static constexpr int PRODUCER_WARP = CW * 4;
  static constexpr int STAGES = D > 128 ? 2 : 3;
  static constexpr int Q_BYTES = CW * NB * BOX_BYTES;
  static constexpr int KV_BYTES = NB * BOX_BYTES;    // one K or V tile
  static constexpr int SMEM =
      1024 + Q_BYTES + 2 * STAGES * KV_BYTES + 8 * (2 * STAGES + 1);
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

// spin until the phase of parity `parity` has completed.  The loop is in
// PTX, so the compiler sees no divergent path beside the asynchronous
// products; a wait that lasts 4 s (a fault in the pipeline: no wait here
// takes more than microseconds) traps rather than holding the card.
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

// wgmma descriptor of a 1024-byte-aligned run of 128-byte swizzled rows:
// 8-row groups 1,024 bytes apart (SBO); the leading offset is unused for
// these operands (one swizzle atom across K, or one box of N)
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
// keep the compiler from moving register reads or writes across the
// asynchronous products
__device__ __forceinline__ void fence_regs(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
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

// D[64×64] += A·B, A (bf16 pairs) from registers, B from shared memory
// (MN-major, 128-byte swizzle: the transpose flag set)
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
          "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
          "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// D[64×48] += A·B, A (bf16 pairs) from registers, B from shared memory
// (MN-major, 128-byte swizzle: the transpose flag set)
__device__ __forceinline__ void wgmma_rs_n48(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, 1, 1, 1, 1;\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
          "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// 2^x by the SFU (ex2.approx, ~2 ulp; subnormal results flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ bool keep(const FlashTcArgs& a, int qp, int kp) {
  return (!a.causal || kp <= qp) && (!a.window || kp > qp - a.window);
}

// [lo, hi) of the KV tiles holding a kept key for some of `rows` query rows from position q_offset + pos0; every tile if one of
// those rows keeps no key at all (the mask is monotone in the position:
// only the first row can lose every key to causality, only the last to the
// window); none if rows <= 0
__device__ __forceinline__ void kv_range(const FlashTcArgs& a, int pos0,
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

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

template <int R>
__device__ __forceinline__ void fence_all(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) fence_regs(r[i]);
}

template <int K>
__device__ __forceinline__ void fence_all(uint32_t (&p)[K][4]) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) fence_regs(p[kk][i]);
}

// S = Q·Kᵀ for one K tile, issued and committed
template <int D>
__device__ __forceinline__ void issue_scores(float (&s)[BK / 2], uint32_t sQw,
                                             uint32_t sKs) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk >> 2) * BOX_BYTES + (kk & 3) * 32;
    wgmma_ss_n64(s, sw128_desc(sQw + off), sw128_desc(sKs + off), kk > 0);
  }
  wgmma_commit();
}

// O += P·V for one V tile, issued and committed
template <class C>
__device__ __forceinline__ void issue_values(float (&o)[C::NB][32],
                                             uint32_t (&p)[BK / 16][4],
                                             uint32_t sVs) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int nb = 0; nb < C::NB; ++nb) {
      const uint64_t dv = sw128_desc(sVs + nb * BOX_BYTES + kk * 16 * 128);
      if (nb < C::NB - 1 || C::LAST == 64)
        wgmma_rs_n64(o[nb], p[kk], dv);
      else
        wgmma_rs_n48(o[nb], p[kk], dv);
    }
  wgmma_commit();
}

// The rows of one consumer thread: positions qp0 and qp0 + 8.
struct RowCtx {
  int qp0, lane;
  float sl2;        // scale · log2(e)
};

// mask (where MASK) and online softmax of one score tile in place (log2
// units): s becomes the probabilities, (m, l) advance, c is the rescale of
// the earlier rows
template <bool MASK>
__device__ __forceinline__ void softmax_tile(const FlashTcArgs& a,
                                             const RowCtx& r, int k0,
                                             float (&s)[BK / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&c)[2]) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int kp = k0 + 8 * j + 2 * (r.lane & 3) + e;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float x = s[4 * j + 2 * h + e] * r.sl2;
        if (MASK)
          x = kp >= a.Tk ? -INFINITY
                         : keep(a, r.qp0 + 8 * h, kp) ? x : NEG_INF;
        s[4 * j + 2 * h + e] = x;
        mx[h] = fmaxf(mx[h], x);
      }
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1)
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], off));
    const float mn = fmaxf(m[h], mx[h]);
    c[h] = ex2(m[h] - mn);
    m[h] = mn;
    float ps = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = ex2(s[4 * j + 2 * h + e] - mn);
        s[4 * j + 2 * h + e] = p;
        ps += p;
      }
    l[h] = l[h] * c[h] + ps;
  }
}

template <int NB>
__device__ __forceinline__ void rescale(float (&o)[NB][32],
                                        const float (&c)[2]) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      o[nb][4 * j] *= c[0];
      o[nb][4 * j + 1] *= c[0];
      o[nb][4 * j + 2] *= c[1];
      o[nb][4 * j + 3] *= c[1];
    }
}

// P in bf16 as wgmma's register A operand: the score accumulator's layout
// for columns 16·kk … 16·kk + 15 is the A fragment of k-step kk
__device__ __forceinline__ void pack_p(uint32_t (&p)[BK / 16][4],
                                       const float (&s)[BK / 2]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
}

template <class C, bool STATS>
__global__ void __launch_bounds__(C::THREADS, 1)
    flash_tc_kernel(const __grid_constant__ CUtensorMap tmq,
                    const __grid_constant__ CUtensorMap tmk,
                    const __grid_constant__ CUtensorMap tmv,
                    const FlashTcArgs a, __nv_bfloat16* __restrict__ out,
                    float* __restrict__ o32, float* __restrict__ m_out,
                    float* __restrict__ l_out) {
  constexpr int D = C::D, NB = C::NB, CW = C::CW;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = sQ + C::Q_BYTES;
  const uint32_t sV = sK + C::STAGES * C::KV_BYTES;
  const uint32_t bars = sV + C::STAGES * C::KV_BYTES;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (C::STAGES + s); };
  const uint32_t qbar = bars + 8u * (2 * C::STAGES);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = a.H / a.KV;
  // CW heads × 64 rows when the GQA group holds CW heads, else CW × 64 rows
  // of one head
  const bool heads = g % CW == 0;
  const int tile = gridDim.x - 1 - blockIdx.x, b = blockIdx.z;
  int pos0[CW], head[CW], rows[CW];
  int blo = 1 << 30, bhi = 0, qlo = 1 << 30, qhi = -(1 << 30);
#pragma unroll
  for (int w = 0; w < CW; ++w) {
    pos0[w] = heads ? tile * ROWS : (tile * CW + w) * ROWS;
    head[w] = heads ? blockIdx.y * CW + w : blockIdx.y;
    rows[w] = min(ROWS, a.Tq - pos0[w]);
    int lo, hi;
    kv_range(a, pos0[w], rows[w], lo, hi);
    if (rows[w] > 0) {
      blo = min(blo, lo);
      bhi = max(bhi, hi);
      qlo = min(qlo, a.q_offset + pos0[w]);
      qhi = max(qhi, a.q_offset + pos0[w] + rows[w] - 1);
    }
  }
  const int kvh = head[0] / g;

  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * CW);        // one arrival per consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= C::PRODUCER_WARP) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (warp == C::PRODUCER_WARP && lane == 0) {
      int qbytes = 0;
#pragma unroll
      for (int w = 0; w < CW; ++w)
        if (rows[w] > 0) qbytes += NB * BOX_BYTES;
      mbar_expect_tx(qbar, qbytes);
#pragma unroll
      for (int w = 0; w < CW; ++w)
        if (rows[w] > 0)
#pragma unroll
          for (int nb = 0; nb < NB; ++nb)
            tma_load(sQ + (w * NB + nb) * BOX_BYTES, &tmq, qbar, nb * BOX,
                     head[w], pos0[w], b);
      int stage = 0, phase = 0;
      for (int kb = blo; kb < bhi; ++kb) {
        mbar_wait(empty(stage), phase ^ 1);
        mbar_expect_tx(full(stage), 2 * C::KV_BYTES);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          tma_load(sK + stage * C::KV_BYTES + nb * BOX_BYTES, &tmk,
                   full(stage), nb * BOX, kvh, kb * BK, b);
          tma_load(sV + stage * C::KV_BYTES + nb * BOX_BYTES, &tmv,
                   full(stage), nb * BOX, kvh, kb * BK, b);
        }
        if (++stage == C::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int w = warp >> 2;
    const int r0 = (warp & 3) * 16 + (lane >> 2);   // rows r0 and r0 + 8
    const uint32_t sQw = sQ + w * NB * BOX_BYTES;
    const RowCtx rc{a.q_offset + pos0[w] + r0, lane, a.scale * LOG2E};

    float o[NB][32], s[BK / 2], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f},
        c[2];
    uint32_t p[BK / 16][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[nb][i] = 0.f;

    // Every warpgroup runs every tile of the block's range [blo, bhi), so
    // that no product sits in a branch that differs between them (ptxas
    // serialises wgmma there).  A tile outside a warpgroup's own range is
    // fully masked for its rows, which is exact (see the header).  A
    // warpgroup without rows computes on a Q tile that was not loaded and
    // stores nothing.  One tile at a time: S, softmax, P·V; the block's
    // warpgroups interleave on the tensor cores.
    mbar_wait(qbar, 0);
    int stage = 0, phase = 0;
    for (int kb = blo; kb < bhi; ++kb) {
      mbar_wait(full(stage), phase);
      issue_scores<D>(s, sQw, sK + stage * C::KV_BYTES);
      wgmma_wait<0>();
      fence_all(s);
      // the mask only where the tile is not kept whole by every row of the
      // block (a condition the same for the whole block)
      const int k0 = kb * BK;
      if (k0 + BK <= a.Tk && (!a.causal || k0 + BK - 1 <= qlo) &&
          (!a.window || k0 > qhi - a.window))
        softmax_tile<false>(a, rc, k0, s, m, l, c);
      else
        softmax_tile<true>(a, rc, k0, s, m, l, c);
      rescale(o, c);
      pack_p(p, s);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) fence_all(o[nb]);
      issue_values<C>(o, p, sV + stage * C::KV_BYTES);
      wgmma_wait<0>();
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) fence_all(o[nb]);
      fence_all(p);
      mbar_arrive_if(empty(stage), lane == 0);
      if (++stage == C::STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }

    if (rows[w] > 0) {
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        l[0] += __shfl_xor_sync(0xffffffffu, l[0], off);
        l[1] += __shfl_xor_sync(0xffffffffu, l[1], off);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int pos = pos0[w] + r0 + 8 * r;
        if (pos >= a.Tq) continue;
        const float norm = fmaxf(l[r], 1e-20f);
        const size_t base = ((size_t(b) * a.Tq + pos) * a.H + head[w]) * D;
        __nv_bfloat16* row = out + base;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = nb * BOX + 8 * j + 2 * (lane & 3);
            if (col < D) {
              const float lo = o[nb][4 * j + 2 * r] / norm,
                          hi = o[nb][4 * j + 2 * r + 1] / norm;
              *reinterpret_cast<__nv_bfloat162*>(row + col) =
                  __floats2bfloat162_rn(lo, hi);
              if (STATS)
                *reinterpret_cast<float2*>(o32 + base + col) =
                    make_float2(lo, hi);
            }
          }
        if (STATS && (lane & 3) == 0) {
          const size_t srow = (size_t(b) * a.H + head[w]) * a.Tq + pos;
          m_out[srow] = m[r] == NEG_INF ? NEG_INF : m[r] * LN2;
          l_out[srow] = l[r];
        }
      }
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

// [B, T, heads, d] bf16, d innermost, in boxes of `rows` rows × 64 of d
bool tensor_map(CUtensorMap* map, const void* ptr, int B, int T, int heads,
                int d, int rows) {
  const EncodeTiled enc = encode_tiled();
  if (!enc) return false;
  const cuuint64_t dims[4] = {cuuint64_t(d), cuuint64_t(heads), cuuint64_t(T),
                              cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(d) * 2, cuuint64_t(heads) * d * 2,
                                 cuuint64_t(T) * heads * d * 2};
  const cuuint32_t box[4] = {BOX, 1, cuuint32_t(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <class C, bool STATS>
int launch(const FlashTcArgs& a, const void* q, const void* k, const void* v,
           void* out, float* o32, float* m, float* l, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  if (!tensor_map(&mq, q, a.B, a.Tq, a.H, a.d, ROWS) ||
      !tensor_map(&mk, k, a.B, a.Tk, a.KV, a.d, BK) ||
      !tensor_map(&mv, v, a.B, a.Tk, a.KV, a.d, BK))
    return int(cudaErrorNotSupported);
  cudaError_t err = cudaFuncSetAttribute(
      flash_tc_kernel<C, STATS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM);
  if (err != cudaSuccess) return int(err);
  const bool heads = (a.H / a.KV) % C::CW == 0;
  const int per_block = heads ? ROWS : C::CW * ROWS;
  const dim3 grid((a.Tq + per_block - 1) / per_block,
                  heads ? a.H / C::CW : a.H, a.B);
  flash_tc_kernel<C, STATS><<<grid, C::THREADS, C::SMEM, stream>>>(
      mq, mk, mv, a, static_cast<__nv_bfloat16*>(out), o32, m, l);
  return int(cudaGetLastError());
}

template <bool STATS>
int dispatch(const FlashTcArgs* a, const void* q, const void* k,
             const void* v, void* out, float* o32, float* m, float* l,
             void* stream) {
  if (a->B < 1 || a->Tq < 1 || a->Tk < 1 || a->H < 1 || a->KV < 1 ||
      a->H % a->KV || a->window < 0 || a->B > 65535 || a->H > 65535 ||
      (a->d != 64 && a->d != 112 && a->d != 128 && a->d != 256) ||
      ((uintptr_t(q) | uintptr_t(k) | uintptr_t(v) | uintptr_t(out) |
        uintptr_t(o32)) & 15))
    return int(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (a->d) {
    case 64: return launch<Cfg<64>, STATS>(*a, q, k, v, out, o32, m, l, st);
    case 112: return launch<Cfg<112>, STATS>(*a, q, k, v, out, o32, m, l, st);
    case 128: return launch<Cfg<128>, STATS>(*a, q, k, v, out, o32, m, l, st);
    default: return launch<Cfg<256>, STATS>(*a, q, k, v, out, o32, m, l, st);
  }
}

}  // namespace

// q, k, v, out bf16, contiguous, 16-byte aligned (the wrapper's contract).
// Returns a cudaError_t; cudaErrorInvalidValue for arguments it does not
// take, cudaErrorNotSupported if a tensor map cannot be encoded.
extern "C" int flash_attention_tc_launch(const FlashTcArgs* a, const void* q,
                                         const void* k, const void* v,
                                         void* out, void* stream) {
  return dispatch<false>(a, q, k, v, out, nullptr, nullptr, nullptr, stream);
}

// The same with the statistics: o32 [B, Tq, H, d] (16-byte aligned), m and
// l [B, H, Tq], all f32.
extern "C" int flash_attention_tc_stats_launch(const FlashTcArgs* a,
                                               const void* q, const void* k,
                                               const void* v, void* out,
                                               float* o32, float* m, float* l,
                                               void* stream) {
  return dispatch<true>(a, q, k, v, out, o32, m, l, stream);
}
