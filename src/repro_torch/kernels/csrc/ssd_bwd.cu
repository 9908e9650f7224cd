// The gradient of the chunked linear recurrence ("SSD") on Hopper (sm_90a),
// hand-written CUDA C++.
//
// Replaces no TPU kernel: the reference differentiates `ref.chunked_ssd`
// (src/repro/kernels/ref.py) with XLA, whose Pallas forward `ssd` has no
// backward of its own.  The forward is ssd.cu; its states variant keeps the
// state entering each chunk, hs [B, nc, H, N, P] f32, which this file reads.
// For d, b, c [B, T, H, N] and x [B, T, H, P] (each f32 or bf16), u [H, N]
// f32, the output's gradient dy [B, T, H, P] (x's type) and, optionally, the
// final state's dhT [B, H, N, P] f32, it writes dd, db, dx, dc (each in its
// input's type, summed in f32 and rounded once), du [H, N] f32 and dh0
// [B, H, N, P] f32.  The plain version is `ssd_backward_reference` in
// ssm_scan.py; per chunk g, with h_g the state entering it and dh the state
// gradient leaving it:
//
//   dS  = mask(dy·xᵀ)          dx = Sᵀ·dy + su·dy + b̃·dh
//   dĉ  = dS·b̂ + dy·h_gᵀ       db̂ = dSᵀ·ĉ        db̃ = x·dhᵀ
//   dLc = Σ_p h_g⊙dh·e^{Lc} + Σ_t db̃⊙b̃
//   dL  = dĉ⊙ĉ − db̂⊙b̂ − db̃⊙b̃,  dlog d_s = Σ_{t≥s} dL_t + dLc
//   dd  = dlog d / d (d > 1e-20, else 0),  dc = dĉ⊙e^L (+ dsu·u·b),
//   db  = db̂⊙e^{−L} + db̃⊙e^{Lc−L} (+ dsu·u·c),  dsu = Σ_p dy⊙x,
//   du += Σ dsu·c·b,  and the walk dh ← e^{Lc}⊙dh + ĉᵀ·dy (dh0 its end).
//
// What bounds it.  Each input byte read once and each output written once:
// at Zamba2-7B's training shape [8, 1,024, 112, N = P = 64] (d, b f32; c, x
// and dy bf16) with the states read back about 1.78 GB, 0.53 ms at 3.35
// TB/s.  The products, counting only the entries the causal masks keep,
// are ~51 GFLOP: 0.76 ms at the 67 TFLOP/s f32 rate of the CUDA cores, 0.31
// ms at a third of the 495 TFLOP/s TF32 tensor-core peak (the rate of the
// split below).  So bytes bound it (RWKV6-1.6B's shape [8, 1,024, 32,
// 64/64]: 0.13 ms).  `ssd_backward_cost`.
//
// Precision: 3×TF32.  The leaves are held to the f32 plain version within
// 1e-4 of each leaf's largest magnitude, and dd's reverse sum cancels in
// pairs, so the products need f32-grade results: one TF32 product (10
// fraction bits) lands ~1e-3 off.  Each f32 operand is split into two TF32
// parts, hi = rna(v) (cvt.rna.tf32.f32's rounding, done on the bits) and
// lo = v − hi cut to TF32, leaving v − hi − lo below 2⁻²¹ |v|; a product is
// lo·hi + hi·lo + hi·hi into one f32 accumulator, lo·lo (below 2⁻²²)
// dropped.  Not bf16 parts (as
// flash_attention_bwd_tc.cu splits p and ds): an f32 value needs three bf16
// parts, and a product of two such operands five or six bf16 products to
// reach the same precision — the same tensor-core time as three TF32
// products at mma.sync's doubled bf16 rate, with twice the splitting work
// and registers; and bf16 packs two k values into a register, so the
// operands read across their rows would need repacking, where a TF32
// fragment is one element loaded from any layout.  Operands that arrive in
// bf16 (x and dy in training) are exact in TF32: their lo part is zero and
// its product skipped, so dy·xᵀ is one product.  The instruction is
// mma.sync.m16n8k8 with fragments loaded by hand from shared memory, not
// wgmma: wgmma takes TF32 operands only K-major, and half the operands
// here are read across their rows.
//
// Design.  The only sequential part is the state gradient's walk over the
// chunks, so it runs on its own:
//   * Pass A (`state_grad_kernel`), a block of 4 warps per (16 state rows,
//     head, batch) — 3,584 blocks at Zamba2-7B's shape, 1,024 at RWKV6's —
//     walks the chunks from the last, its rows of the state gradient in
//     registers (16 × P/4 a warp, the product's accumulator layout).  Chunk
//     g − 1's d and c columns and dy rows load by cp.async into the buffer
//     chunk g + 1 has left while chunk g computes.  Per chunk: L by 8
//     segments of steps a column (their sums meet by shuffles), ĉ, the
//     state gradient leaving the chunk to the scratch dhs [B, nc, H, N, P],
//     and dh ← e^{Lc}⊙dh + ĉᵀ·dy on the tensor cores; two barriers a chunk;
//     dh0 is the walk's last value.
//   * Pass B (`chunk_grad_kernel`), a block of 8 warps per (chunk, head,
//     batch), from (h_g, dh) forms every other gradient.  d, b and c arrive
//     by cp.async (group 0), x, dy and dh (group 1) while L, ĉ and b̂ are
//     formed in place of the raw inputs, h (group 2) while the first
//     products run.  Warps 0-3 own the key side: Sᵀ = mask(b̂·ĉᵀ), then dx
//     = Sᵀ·dy + b̃·dh, on rows 16w .. 16w + 15; dSᵀ = mask(x·dyᵀ), then db̂ =
//     dSᵀ·ĉ, on the row blocks in reverse, so that the masks give every
//     warp the same work.  Warps 4-7 the query side: dS = mask(dy·xᵀ), then
//     dĉ = dS·b̂ + dy·hᵀ; and db̃ = x·dhᵀ.  S and dS never touch shared
//     memory: the second product of each pair takes the first's
//     accumulators as its A fragments (their k order permuted, B's rows
//     read to match), and the tiles past the causal masks are skipped.  b̃
//     = b̂·e^{Lc} is formed where it is read.  Shared memory: six [64][68]
//     f32 tiles (x and dy at half width in bf16), and with bf16 x a
//     seventh that keeps L — ~107 KB in f32, ~108 KB with bf16 x, two
//     blocks an SM for P ≤ 64 (P = 128 doubles four tiles: one).  Then
//     dĉ, db̂ and db̃ go to shared memory over the tiles the products have
//     left, and the block turns to one lane a state column, a pair of warps
//     a quarter of the steps: dL, dc and db per entry over those three
//     tiles (L from its tile, else summed again from d in the same order);
//     dL summed from the chunk's last step down, the quarters in turn, as
//     the plain version sums it (its terms cancel in pairs); dd; and dc,
//     db and dd out by rows, 16 bytes a thread.
//   * Pass C (`du_sum_kernel`) adds du's partials over batch and chunk in a
//     fixed order.  No atomics: two launches give the same bits.
// Code size is a cost of its own here: each phase of pass B runs once a
// block, so a kernel unrolled throughout spends its time fetching its
// instructions (scripts/ssd_bwd_code_size.py measures it).  Loops over
// k-steps and steps stay rolled (`a_acc` selects an accumulator tile
// rather than indexing one), the staging helpers are not inlined, and the
// products interleave their three parts over four tiles (`kstep`).
// The chunk is the wrapper's (at most 64; a shorter one is padded with
// zero rows), N ≤ 64, P ≤ 128, as the forward.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

struct SsdBwdArgs {
  int B, T, H, N, P, chunk, include_current, has_u, has_dhT;
  int d_bf16, b_bf16, x_bf16, c_bf16;
};

namespace {

constexpr int C = 64;           // largest chunk
constexpr int THREADS = 256;    // pass B: 8 warps
constexpr int MAX_N = 64;
constexpr int MAX_P = 128;
constexpr int S = C + 4;        // row stride of the [64][64] f32 tiles

__device__ __forceinline__ void store(void* p, size_t i, float v, int bf16) {
  if (bf16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(p)[i] = v;
}

// 16 bytes global → shared, asynchronously (cp.async, bypassing L1)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// rows × W elements of `es` bytes from global (row stride gstride elements)
// into shared memory (row stride sw elements), by the threads i0, i0 +
// step, ...: 16-byte cp.async when every row is 16-byte aligned, element
// copies otherwise (visible after the next barrier)
__device__ __noinline__ void stage(void* dst, const void* src, int es,
                                      int rows, int W, int sw, size_t gstride,
                                      int i0, int step) {
  char* dp = static_cast<char*>(dst);
  const char* sp = static_cast<const char*>(src);
  const bool vec = (reinterpret_cast<uintptr_t>(src) & 15) == 0 &&
                   (W * es) % 16 == 0 && (gstride * es) % 16 == 0;
  if (vec) {
    // (row, 16-byte column) of element e, stepped without a division
    const int per = W * es / 16, dr = step / per, dq = step - dr * per;
    int r = i0 / per, q = i0 - r * per;
    for (int e = i0; e < rows * per; e += step) {
      cp_async16(dp + size_t(r) * sw * es + q * 16,
                 sp + size_t(r) * gstride * es + q * 16);
      r += dr;
      q += dq;
      if (q >= per) {
        q -= per;
        ++r;
      }
    }
  } else if (es == 4) {
    for (int e = i0; e < rows * W; e += step) {
      const int r = e / W, q = e - r * W;
      reinterpret_cast<float*>(dp)[r * sw + q] =
          reinterpret_cast<const float*>(sp)[size_t(r) * gstride + q];
    }
  } else {
    for (int e = i0; e < rows * W; e += step) {
      const int r = e / W, q = e - r * W;
      reinterpret_cast<uint16_t*>(dp)[r * sw + q] =
          reinterpret_cast<const uint16_t*>(sp)[size_t(r) * gstride + q];
    }
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int G>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(G) : "memory");
}
// a barrier among the 128 threads of warps 4-7 (named barrier 1)
__device__ __forceinline__ void bar_sync_query_side() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

// zero the elements [r0, r1) × [c0, c1) of a tile of `es`-byte elements
// (row stride ld), by the threads i0, i0 + step, ...
__device__ __noinline__ void zero(void* t, int es, int ld, int r0, int r1,
                                     int c0, int c1, int i0, int step) {
  const int w = c1 - c0;
  if (w <= 0 || r1 <= r0) return;
  for (int e = i0; e < (r1 - r0) * w; e += step) {
    const int r = r0 + e / w, q = c0 + e % w;
    if (es == 4)
      static_cast<float*>(t)[r * ld + q] = 0.f;
    else
      static_cast<uint16_t*>(t)[r * ld + q] = 0;
  }
}

__device__ __forceinline__ float raw(const void* t, int i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(t)[i])
              : static_cast<const float*>(t)[i];
}
__device__ __forceinline__ float xf(float v) { return v; }
__device__ __forceinline__ float xf(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The TF32 part of v: rounded to nearest, ties away from zero, to 10
// fraction bits, as cvt.rna.tf32.f32 rounds, done on the bits (half a unit
// of the 13 dropped bits added to the magnitude, then cleared; inf and NaN
// pass as they are): two integer operations and a select, fewer than the
// conversion compiles to on sm_90a
__device__ __forceinline__ uint32_t tf32_hi(float v) {
  const uint32_t u = __float_as_uint(v);
  return (u & 0x7f800000u) == 0x7f800000u ? u : (u + 0x1000u) & 0xffffe000u;
}

// v = hi + lo + r, hi and lo TF32: hi = v rounded (`tf32_hi`), lo = v − hi
// (exact) with its 13 low bits cleared, |r| < 2⁻²¹ |v|.  EX: v is exact in
// TF32 (a widened bf16), lo is zero and never used.
template <bool EX, int K>
__device__ __forceinline__ void split(const float (&v)[K], uint32_t (&hi)[K],
                                      uint32_t (&lo)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) {
    if (EX) {
      hi[i] = __float_as_uint(v[i]);
      lo[i] = 0u;
    } else {
      hi[i] = tf32_hi(v[i]);
      lo[i] = __float_as_uint(v[i] - __uint_as_float(hi[i])) & 0xffffe000u;
    }
  }
}

// c += a·b, one m16n8k8 TF32 product accumulated in f32
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[j] += A·B_j for the 8-column tiles lo ≤ j < hi of one 8-deep k-step,
// in three TF32 products, the small ones first: lo·hi, hi·lo, hi·hi (lo·lo,
// below 2⁻²² of the product, dropped); a part that is zero (AX, BX: the
// operand is exact in TF32) is skipped.  Four tiles at a time, each part
// over the four before the next, so that back-to-back products are
// independent; ldb(j, v) gives tile j's two B values.
template <bool AX, bool BX, int NT, class LdB>
__device__ __forceinline__ void kstep(float (&acc)[NT][4], int lo, int hi,
                                      const uint32_t (&ah)[4],
                                      const uint32_t (&al)[4], LdB ldb) {
  constexpr int G = NT < 4 ? NT : 4;
#pragma unroll
  for (int j0 = 0; j0 < NT; j0 += G) {
    uint32_t bh[G][2], bl[G][2];
#pragma unroll
    for (int i = 0; i < G; ++i) {
      if (j0 + i < lo || j0 + i >= hi) continue;
      float v[2];
      ldb(j0 + i, v);
      split<BX>(v, bh[i], bl[i]);
    }
    if (!AX) {
#pragma unroll
      for (int i = 0; i < G; ++i)
        if (j0 + i >= lo && j0 + i < hi) mma(acc[j0 + i], al, bh[i]);
    }
    if (!BX) {
#pragma unroll
      for (int i = 0; i < G; ++i)
        if (j0 + i >= lo && j0 + i < hi) mma(acc[j0 + i], ah, bl[i]);
    }
#pragma unroll
    for (int i = 0; i < G; ++i)
      if (j0 + i >= lo && j0 + i < hi) mma(acc[j0 + i], ah, bh[i]);
  }
}

// Fragment values of an m16n8k8 product, for the lane (g = lane / 4, q =
// lane % 4): A's rows r0 + {g, g + 8} at columns k0 + {q, q + 4}; B's
// column c0 + g at rows k0 + {q, q + 4}.  A tile is row-major (row stride
// ld); B is read from a tile stored [col][k] or [k][col].
template <class T>
__device__ __forceinline__ void a_rows(const T* t, int ld, int r0, int k0,
                                       int g, int q, float (&v)[4]) {
  v[0] = xf(t[(r0 + g) * ld + k0 + q]);
  v[1] = xf(t[(r0 + g + 8) * ld + k0 + q]);
  v[2] = xf(t[(r0 + g) * ld + k0 + q + 4]);
  v[3] = xf(t[(r0 + g + 8) * ld + k0 + q + 4]);
}
template <class T>
__device__ __forceinline__ void b_colk(const T* t, int ld, int k0, int c0,
                                       int g, int q, float (&v)[2]) {
  v[0] = xf(t[(c0 + g) * ld + k0 + q]);
  v[1] = xf(t[(c0 + g) * ld + k0 + q + 4]);
}
template <class T>
__device__ __forceinline__ void b_kcol(const T* t, int ld, int k0, int c0,
                                       int g, int q, float (&v)[2]) {
  v[0] = xf(t[(k0 + q) * ld + c0 + g]);
  v[1] = xf(t[(k0 + q + 4) * ld + c0 + g]);
}
// The A operand of k-step ks taken from the accumulator tiles of the
// previous product (tile ks: rows g, g + 8; columns 2q, 2q + 1): its k
// order is permuted, logical k = q at column 2q and k = q + 4 at 2q + 1,
// and B's rows follow (`b_perm`).  The tile is selected, not indexed, so
// the accumulators stay in registers.
__device__ __forceinline__ void a_acc(const float (&acc)[8][4], int ks,
                                      float (&v)[4]) {
  v[0] = v[1] = v[2] = v[3] = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k)
    if (k == ks) {
      v[0] = acc[k][0];
      v[1] = acc[k][2];
      v[2] = acc[k][1];
      v[3] = acc[k][3];
    }
}
template <class T>
__device__ __forceinline__ void b_perm(const T* t, int ld, int k0, int c0,
                                       int g, int q, float (&v)[2]) {
  v[0] = xf(t[(k0 + 2 * q) * ld + c0 + g]);
  v[1] = xf(t[(k0 + 2 * q + 1) * ld + c0 + g]);
}

// ---- pass A: the state gradient leaving each chunk, walked from the last;
// a block per (16 state rows, head, batch), its product on the tensor cores

constexpr int A_THREADS = 128;  // 4 warps, each 16 state rows × P/4 columns
constexpr int A_SEG = A_THREADS / 16;  // the scan: lanes (segments) a column
constexpr int A_Q = 256 / A_THREADS;   // 8-column tiles a warp for P ≤ 64
constexpr int A_ROWS = 16;
constexpr int A_SC = 24;        // row stride of ĉ [t][16 rows], floats

// Shared-memory layout of pass A, in bytes (offsets 16-aligned): two
// buffers each of d and c (the block's 16 columns, row stride 16 elements,
// in their own types) and of dy [64][ly] in x's type; ĉ [64][A_SC] f32;
// e^{Lc} [16]
struct ALayout {
  int ly, d, c, y, buf, ch, elc, total;  // buffer i at d, c, y + i·buf
};

__host__ __device__ inline ALayout a_layout(int P, bool db, bool cb, bool xb) {
  const int p8 = (P + 7) & ~7, pw = p8 > 64 ? p8 : 64;
  ALayout l;
  l.ly = pw + 8;                // ≡ 8 (mod 32) banks for dy's rows by k
  l.d = 0;
  l.c = 64 * 16 * (db ? 2 : 4);
  l.y = l.c + 64 * 16 * (cb ? 2 : 4);
  l.buf = l.y + 64 * l.ly * (xb ? 2 : 4);
  int o = 2 * l.buf;
  l.ch = o;
  o += 64 * A_SC * 4;
  l.elc = o;
  o += 16 * 4;
  l.total = o;
  return l;
}

template <bool XB, int Q>
__global__ void __launch_bounds__(A_THREADS)
    state_grad_kernel(const SsdBwdArgs a, const void* __restrict__ d,
                      const void* __restrict__ c, const void* __restrict__ dy,
                      const float* __restrict__ dhT, float* __restrict__ dhs,
                      float* __restrict__ dh0) {
  using XT = typename std::conditional<XB, __nv_bfloat16, float>::type;
  constexpr int ES_X = XB ? 2 : 4;
  extern __shared__ __align__(16) unsigned char smem[];
  const ALayout l = a_layout(a.P, a.d_bf16, a.c_bf16, XB);
  float* sCh = reinterpret_cast<float*>(smem + l.ch);
  float* sElc = reinterpret_cast<float*>(smem + l.elc);

  const int N = a.N, P = a.P, ck = a.chunk, H = a.H, T = a.T, nc = T / ck;
  // the warp index through a shuffle from lane 0: the compiler then knows
  // it is uniform in the warp, and every branch on it too
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int gi = lane >> 2, qi = lane & 3;
  const int n0 = blockIdx.x * A_ROWS, h = blockIdx.y, bb = blockIdx.z;
  const int nw = min(A_ROWS, N - n0);          // the block's state rows
  const int esd = a.d_bf16 ? 2 : 4, esc = a.c_bf16 ? 2 : 4;
  const int cj = (ck + 7) >> 3;
  const int sl = (ck + A_SEG - 1) / A_SEG;    // A_SEG segments of sl steps
  // the scan: a warp 4 columns, 8 lanes a column, a lane a segment
  const int col = warp * (32 / A_SEG) + lane / A_SEG, sg = lane % A_SEG;
  const int ly = l.ly;
  const int pc = 8 * Q * warp;                 // the warp's first column

  // chunk g's d and c columns and dy rows into buffer g & 1
  auto fetch = [&](int g) {
    const size_t row = (size_t(bb) * T + size_t(g) * ck) * H + h;
    const int bi = g & 1;
    unsigned char* buf = smem + bi * l.buf;
    stage(buf + l.d, static_cast<const char*>(d) + (row * N + n0) * esd,
          esd, ck, nw, 16, size_t(H) * N, tid, A_THREADS);
    stage(buf + l.c, static_cast<const char*>(c) + (row * N + n0) * esc,
          esc, ck, nw, 16, size_t(H) * N, tid, A_THREADS);
    stage(buf + l.y, static_cast<const char*>(dy) + row * P * ES_X, ES_X,
          ck, P, ly, size_t(H) * P, tid, A_THREADS);
  };
  // dy's rows past the chunk's end, which the product reads
  for (int bi = 0; bi < 2; ++bi)
    zero(smem + l.y + bi * l.buf, ES_X, ly, ck, 8 * cj, 0, P, tid, A_THREADS);
  fetch(nc - 1);
  cp_commit();

  const size_t state0 = (size_t(bb) * H + h) * N * P;
  float dh[Q][4];
#pragma unroll
  for (int j = 0; j < Q; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int nn = n0 + gi + (e >> 1) * 8, p = pc + 8 * j + 2 * qi + (e & 1);
      dh[j][e] = a.has_dhT && nn < N && p < P ? dhT[state0 + nn * P + p]
                                               : 0.f;
    }

  for (int g = nc - 1; g >= 0; --g) {
    const int bi = g & 1;
    cp_wait<0>();
    __syncthreads();            // chunk g has landed; chunk g + 1 is done
    if (g >= 1) {               // chunk g − 1 into the buffer g + 1 has left
      fetch(g - 1);
      cp_commit();
    }
    // L over the chunk by segments of sl steps (the segments' sums meet by
    // shuffles), then ĉ and e^{Lc}
    {
      const void* sd = smem + l.d + bi * l.buf;
      const void* sc = smem + l.c + bi * l.buf;
      float Lr[64 / A_SEG], cv[64 / A_SEG];
      float run = 0.f;
#pragma unroll
      for (int i = 0; i < 64 / A_SEG; ++i) {
        const int t = sg * sl + i;
        float lg = 0.f, e = 0.f;
        if (i < sl && t < ck && col < nw) {
          lg = logf(fmaxf(raw(sd, t * 16 + col, a.d_bf16), 1e-20f));
          e = raw(sc, t * 16 + col, a.c_bf16);
        }
        run = run + lg;
        Lr[i] = run;
        cv[i] = e;
      }
      float before = 0.f, lc = 0.f;
#pragma unroll
      for (int q = 0; q < A_SEG; ++q) {
        const float v =
            __shfl_sync(0xffffffffu, run, (lane & ~(A_SEG - 1)) | q);
        if (q < sg) before = before + v;
        lc = lc + v;
      }
#pragma unroll
      for (int i = 0; i < 64 / A_SEG; ++i)
        if (i < sl) sCh[(sg * sl + i) * A_SC + col] =
            cv[i] * expf(before + Lr[i]);
      if (sg == 0) sElc[col] = expf(lc);
    }
    __syncthreads();
    // dh leaving chunk g to the scratch, then dh ← e^{Lc}⊙dh + ĉᵀ·dy
    const size_t base = ((size_t(bb) * nc + g) * H + h) * N * P;
    float acc[Q][4];
#pragma unroll
    for (int j = 0; j < Q; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int nn = n0 + gi + (e >> 1) * 8, p = pc + 8 * j + 2 * qi +
                                                   (e & 1);
        if (nn < N && p < P) dhs[base + nn * P + p] = dh[j][e];
        acc[j][e] = 0.f;
      }
    const XT* sY = reinterpret_cast<const XT*>(smem + l.y + bi * l.buf);
#pragma unroll 1
    for (int ks = 0; ks < cj; ++ks) {
      float av[4];
      uint32_t ah[4], al[4];
      av[0] = sCh[(8 * ks + qi) * A_SC + gi];
      av[1] = sCh[(8 * ks + qi) * A_SC + gi + 8];
      av[2] = sCh[(8 * ks + qi + 4) * A_SC + gi];
      av[3] = sCh[(8 * ks + qi + 4) * A_SC + gi + 8];
      split<false>(av, ah, al);
      kstep<false, XB>(acc, 0, (P - pc + 7) / 8, ah, al,
                       [&](int j, float (&bv)[2]) {
                         b_kcol(sY, ly, 8 * ks, pc + 8 * j, gi, qi, bv);
                       });
    }
#pragma unroll
    for (int j = 0; j < Q; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float decay = sElc[gi + (e >> 1) * 8];
        dh[j][e] = decay * dh[j][e] + acc[j][e];
      }
  }
  if (dh0) {
#pragma unroll
    for (int j = 0; j < Q; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int nn = n0 + gi + (e >> 1) * 8, p = pc + 8 * j + 2 * qi +
                                                   (e & 1);
        if (nn < N && p < P) dh0[state0 + nn * P + p] = dh[j][e];
      }
  }
}

// ---- pass B: every other gradient of one (chunk, head, batch), on the
// tensor cores in three TF32 products

// Shared-memory layout of pass B, in bytes from the base (every offset and
// row stride 16-aligned).  pw: the value width P rounded up to 8, at least
// 64, so that every tile holds a [64][64] f32 block.
struct BLayout {
  int lh;     // row stride of the h and dh tiles, floats
  int lx;     // row stride of the x and dy tiles, elements of x's type
  int c;      // raw c, then ĉ [t][n] f32 (row stride S)
  int b;      // raw b, then b̂ [s][n] f32 (row stride S)
  int h;      // raw d, then h [n][p] f32, then db̂ [s][n]
  int dh;     // dh [n][p] f32, then dĉ [t][n]
  int x;      // x [s][p] in x's type; with dy's tile, db̃ [s][n] f32 at the end
  int y;      // dy [t][p] in x's type
  int L;      // with bf16 x (room for it at two blocks an SM): L [t][n] f32
  int small;  // BSMALL floats: see chunk_grad_kernel
  int total;
};

constexpr int BSMALL = 256 + 128 + 7 * 64 + 2 * 256;

__host__ __device__ inline BLayout b_layout(int P, bool xb) {
  const int p8 = (P + 7) & ~7, pw = p8 > 64 ? p8 : 64;
  BLayout l;
  l.lh = pw + 4;                    // ≡ 4 (mod 32) banks for P ≤ 64, 128
  l.lx = xb ? pw + 8 : pw + 4;
  const int xbytes = 64 * l.lx * (xb ? 2 : 4);
  int o = 0;
  l.c = o;
  o += 64 * S * 4;
  l.b = o;
  o += 64 * S * 4;
  l.h = o;
  o += 64 * l.lh * 4;
  l.dh = o;
  o += 64 * l.lh * 4;
  l.x = o;
  o += xbytes;
  l.y = o;
  o += xbytes;
  l.L = o;
  o += xb ? 64 * S * 4 : 0;
  l.small = o;
  o += BSMALL * 4;
  l.total = o;
  return l;
}

// Column n of rows t0 .. t0 + cnt − 1 of a chunk (row r of the chunk at
// element (row0 + r·H)·W), widened to f32, 0 past the chunk or W; the
// dtype decided once for the row of loads
__device__ __forceinline__ void load_col(const void* p, int bf16,
                                         size_t row0, int H, int W, int n,
                                         int t0, int cnt, int ck,
                                         float (&v)[16]) {
  if (bf16) {
    const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p);
#pragma unroll
    for (int i = 0; i < 16; ++i)
      v[i] = i < cnt && t0 + i < ck && n < W
                 ? __bfloat162float(q[(row0 + size_t(t0 + i) * H) * W + n])
                 : 0.f;
  } else {
    const float* q = static_cast<const float*>(p);
#pragma unroll
    for (int i = 0; i < 16; ++i)
      v[i] = i < cnt && t0 + i < ck && n < W
                 ? q[(row0 + size_t(t0 + i) * H) * W + n] : 0.f;
  }
}

// The chunk's rows [0, ck) × [0, W) of an f32 tile (row stride ld) out to
// global (row r at element (row0 + r·H)·W) in f32 or bf16, 16 bytes a
// thread where the rows are 16-byte aligned, one element otherwise
__device__ __noinline__ void unstage(void* dst, int bf16, const float* t,
                                        int ld, size_t row0, int H, int W,
                                        int ck, int tid) {
  const int es = bf16 ? 2 : 4, per = 16 / es;
  const bool vec = (reinterpret_cast<uintptr_t>(dst) & 15) == 0 &&
                   (W * es) % 16 == 0;
  if (vec) {
    const int cw = W / per;
    for (int e = tid; e < ck * cw; e += THREADS) {
      const int r = e / cw, q = (e - r * cw) * per;
      const float* s = t + r * ld + q;
      char* g = static_cast<char*>(dst) + ((row0 + size_t(r) * H) * W + q) *
                                              es;
      if (bf16) {
        uint4 w;
        uint32_t* u = reinterpret_cast<uint32_t*>(&w);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const __nv_bfloat16 lo = __float2bfloat16_rn(s[2 * k]);
          const __nv_bfloat16 hi = __float2bfloat16_rn(s[2 * k + 1]);
          u[k] = uint32_t(*reinterpret_cast<const uint16_t*>(&lo)) |
                 (uint32_t(*reinterpret_cast<const uint16_t*>(&hi)) << 16);
        }
        *reinterpret_cast<uint4*>(g) = w;
      } else {
        *reinterpret_cast<float4*>(g) =
            make_float4(s[0], s[1], s[2], s[3]);
      }
    }
  } else {
    for (int e = tid; e < ck * W; e += THREADS) {
      const int r = e / W, q = e - r * W;
      store(dst, (row0 + size_t(r) * H) * W + q, t[r * ld + q], bf16);
    }
  }
}

__device__ __forceinline__ void zero_acc(float (&acc)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

// An accumulator tile set of a warp's 16 rows from R (columns 8j + 2q,
// + 1 of rows g, g + 8) to a row-major f32 tile, the first nk·8 columns
__device__ __forceinline__ void store_acc(const float (&acc)[8][4], float* t,
                                          int ld, int R, int g, int q,
                                          int nk) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j >= nk) continue;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      *reinterpret_cast<float2*>(t + (R + g + 8 * hf) * ld + 8 * j + 2 * q) =
          make_float2(acc[j][2 * hf], acc[j][2 * hf + 1]);
  }
}

template <bool XB>
__global__ void __launch_bounds__(THREADS, 2)
    chunk_grad_kernel(const SsdBwdArgs a, const void* __restrict__ d,
                      const void* __restrict__ b, const void* __restrict__ x,
                      const void* __restrict__ c, const float* __restrict__ u,
                      const float* __restrict__ hs,
                      const void* __restrict__ dy,
                      const float* __restrict__ dhs,
                      float* __restrict__ du_part, void* __restrict__ dd,
                      void* __restrict__ db, void* __restrict__ dx,
                      void* __restrict__ dc) {
  using XT = typename std::conditional<XB, __nv_bfloat16, float>::type;
  constexpr int ES_X = XB ? 2 : 4;
  extern __shared__ __align__(16) unsigned char smem[];
  const BLayout l = b_layout(a.P, XB);
  float* sC = reinterpret_cast<float*>(smem + l.c);
  float* sB = reinterpret_cast<float*>(smem + l.b);
  float* sH = reinterpret_cast<float*>(smem + l.h);
  float* sD = reinterpret_cast<float*>(smem + l.dh);
  XT* sX = reinterpret_cast<XT*>(smem + l.x);
  XT* sY = reinterpret_cast<XT*>(smem + l.y);
  float* sTot = reinterpret_cast<float*>(smem + l.small);  // [4][64]
  float* sSu = sTot + 256;      // the bonus sums' halves [2][64]
  float* sElc = sSu + 128;      // e^{Lc} [64]
  float* sU = sElc + 64;        // u [64]
  float* sDsu = sU + 64;        // dsu = Σ_p dy⊙x [64]
  float* sHdh = sDsu + 64;      // Σ_p h⊙dh [64]
  float* sCarry = sHdh + 64;    // the reverse walk's carry [64]
  float* sQ = sCarry + 64;      // Σ_t db̃⊙b̃ by quarter [4][64]
  float* sQu = sQ + 256;        // du's terms by quarter [4][64]
  float* sLc = sQu + 256;       // Lc [64]
  float* sL = reinterpret_cast<float*>(smem + l.L);  // L [t][n] (bf16 x)
  float* sDBh = sH;             // after the products: db̂ [s][n]
  float* sDC = sD;              //   dĉ [t][n]
  float* sDBt = reinterpret_cast<float*>(smem + l.x);  // db̃ [s][n], stride S

  const int N = a.N, P = a.P, ck = a.chunk, T = a.T, H = a.H, nc = T / ck;
  const int lh = l.lh, lx = l.lx;
  // the warp index through a shuffle from lane 0: the compiler then knows
  // it is uniform in the warp, and every branch on it too
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int gi = lane >> 2, qi = lane & 3;
  const int ch = blockIdx.x, h = blockIdx.y, bb = blockIdx.z;
  const size_t row0 = (size_t(bb) * T + size_t(ch) * ck) * H + h;
  const size_t cstate = ((size_t(bb) * nc + ch) * H + h) * N * P;
  const int esd = a.d_bf16 ? 2 : 4, esb = a.b_bf16 ? 2 : 4,
            esc = a.c_bf16 ? 2 : 4;
  // the scan layout: a pair of warps a quarter of the steps, a lane a
  // state column
  const int tq = warp >> 1, n = (warp & 1) * 32 + lane;
  const int sl = (ck + 3) >> 2;
  // 8-wide k-steps (or column tiles) over N, P and the chunk's steps
  const int nk = (N + 7) >> 3, pk = (P + 7) >> 3, cj = (ck + 7) >> 3;
  const int n8 = nk * 8, p8 = pk * 8;
  const bool inc = a.include_current;
  auto keep = [&](int t, int s) {
    return t < ck && s < ck && (inc ? s <= t : s < t);
  };

  // ---- loads: d, b, c (group 0) into the h, b and c tiles, row stride S
  // floats, in their own types; x, dy, dh (group 1)
  stage(sH, static_cast<const char*>(d) + row0 * N * esd, esd, ck, N,
        S * 4 / esd, size_t(H) * N, tid, THREADS);
  stage(sB, static_cast<const char*>(b) + row0 * N * esb, esb, ck, N,
        S * 4 / esb, size_t(H) * N, tid, THREADS);
  stage(sC, static_cast<const char*>(c) + row0 * N * esc, esc, ck, N,
        S * 4 / esc, size_t(H) * N, tid, THREADS);
  cp_commit();
  stage(sX, static_cast<const char*>(x) + row0 * P * ES_X, ES_X, ck, P, lx,
        size_t(H) * P, tid, THREADS);
  stage(sY, static_cast<const char*>(dy) + row0 * P * ES_X, ES_X, ck, P, lx,
        size_t(H) * P, tid, THREADS);
  stage(sD, dhs + cstate, 4, N, P, lh, P, tid, THREADS);
  cp_commit();
  // the padding the products read: x, dy rows from the chunk's end and
  // columns P..p8; dh rows N..n8 and columns P..p8; ĉ, b̂ rows the scan
  // does not write
  zero(sX, ES_X, lx, ck, 64, 0, p8, tid, THREADS);
  zero(sX, ES_X, lx, 0, ck, P, p8, tid, THREADS);
  zero(sY, ES_X, lx, ck, 64, 0, p8, tid, THREADS);
  zero(sY, ES_X, lx, 0, ck, P, p8, tid, THREADS);
  zero(sD, 4, lh, N, n8, 0, p8, tid, THREADS);
  zero(sD, 4, lh, 0, N, P, p8, tid, THREADS);
  zero(sC, 4, S, 4 * sl, 64, 0, 64, tid, THREADS);
  zero(sB, 4, S, 4 * sl, 64, 0, 64, tid, THREADS);
  if (tid < 64) sU[tid] = a.has_u && tid < N ? u[size_t(h) * N + tid] : 0.f;
  cp_wait<1>();
  __syncthreads();

  // ---- L by the forward's quarter scan; ĉ and b̂ over their raw inputs,
  // e^{Lc}, the bonus sums.  b̃ = b̂·e^{Lc} is formed where it is read.
  {
    // the lane's column of each raw tile at the quarter's first step (rows
    // of S floats whatever the type)
    const size_t r0 = size_t(tq) * sl * S * 4;
    const char* rd = reinterpret_cast<const char*>(sH) + r0 + n * esd;
    const char* rb = reinterpret_cast<const char*>(sB) + r0 + n * esb;
    const char* rc = reinterpret_cast<const char*>(sC) + r0 + n * esc;
    float Lr[16], bv[16], cv[16];
    float run = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int t = tq * sl + i, at = i * S * 4;
      float lg = 0.f, e1 = 0.f, e2 = 0.f;
      if (i < sl && t < ck && n < N) {
        lg = logf(fmaxf(raw(rd + at, 0, a.d_bf16), 1e-20f));
        e1 = raw(rb + at, 0, a.b_bf16);
        e2 = raw(rc + at, 0, a.c_bf16);
      }
      run = run + lg;
      Lr[i] = run;
      bv[i] = e1;
      cv[i] = e2;
    }
    sTot[tq * 64 + n] = run;
    __syncthreads();            // every raw read is done
    float before = 0.f;
#pragma unroll
    for (int q = 0; q < 3; ++q)
      if (q < tq) before = before + sTot[q * 64 + n];
    const float lc =
        ((sTot[n] + sTot[64 + n]) + sTot[128 + n]) + sTot[192 + n];
    const float uu = sU[n];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      if (i < sl) {
        const int t = tq * sl + i;
        const float Lt = before + Lr[i];
        if (XB) sL[t * S + n] = Lt;
        sC[t * S + n] = cv[i] * expf(Lt);
        sB[t * S + n] = bv[i] * expf(-Lt);
        if (a.has_u) {
          float su = cv[i] * uu * bv[i];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            su += __shfl_xor_sync(0xffffffffu, su, off);
          if (lane == 0) sSu[(warp & 1) * 64 + t] = su;
        }
      }
    }
    if (tq == 0) {
      sElc[n] = expf(lc);
      sLc[n] = lc;
    }
  }
  // h (group 2, by the warps that read it) into the tile d has left
  if (warp >= 4) {
    zero(sH, 4, lh, N, n8, 0, p8, tid - 128, 128);
    zero(sH, 4, lh, 0, N, P, p8, tid - 128, 128);
    stage(sH, hs + cstate, 4, N, P, lh, P, tid - 128, 128);
    cp_commit();
    cp_wait<1>();
  } else {
    cp_wait<0>();
  }
  __syncthreads();

  // ---- the products, m16n8k8 on the tensor cores: warps 0-3 own the rows
  // s of the key-side gradients, warps 4-7 the rows t of the query side;
  // warp w's rows are 16·(w mod 4) .. + 15.  A masked product's tiles past
  // the mask are skipped; the second product of a pair takes the first's
  // accumulators as its A operand (`a_acc`, `b_perm`).
  // Each side keeps its accumulators to itself and stores them after the
  // barrier that ends the products (one in each branch: the branch is
  // uniform in a warp), so neither side's registers hold the other's.
  const int R = 16 * (warp & 3);
  if (warp < 4) {
    const int j0 = R / 8;       // t ≥ s: the tiles from the warp's first row
    // Sᵀ = mask(b̂·ĉᵀ) [s][t]
    float st[8][4];
    zero_acc(st);
#pragma unroll 1
    for (int ks = 0; ks < nk; ++ks) {
      float av[4];
      uint32_t ah[4], al[4];
      a_rows(sB, S, R, 8 * ks, gi, qi, av);
      split<false>(av, ah, al);
      kstep<false, false>(st, j0, cj, ah, al,
                      [&](int j, float (&bv)[2]) {
                        b_colk(sC, S, 8 * ks, 8 * j, gi, qi, bv);
                      });
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (!keep(8 * j + 2 * qi + (e & 1), R + gi + (e >> 1) * 8))
          st[j][e] = 0.f;
    // dx = Sᵀ·dy + b̃·dh (+ su·dy), 64 value columns at a time
#pragma unroll 1
    for (int p0 = 0; p0 < P; p0 += 64) {
      float xa[8][4];
      zero_acc(xa);
#pragma unroll 1
      for (int ks = j0; ks < cj; ++ks) {
        float av[4];
        uint32_t ah[4], al[4];
        a_acc(st, ks, av);
        split<false>(av, ah, al);
        kstep<false, XB>(xa, 0, (p8 - p0) / 8, ah, al,
                        [&](int j, float (&bv)[2]) {
                          b_perm(sY, lx, 8 * ks, p0 + 8 * j, gi, qi, bv);
                        });
      }
#pragma unroll 1
      for (int ks = 0; ks < nk; ++ks) {
        float av[4];
        uint32_t ah[4], al[4];
        a_rows(sB, S, R, 8 * ks, gi, qi, av);
        const float e0 = sElc[8 * ks + qi], e4 = sElc[8 * ks + qi + 4];
        av[0] = av[0] * e0;
        av[1] = av[1] * e0;
        av[2] = av[2] * e4;
        av[3] = av[3] * e4;
        split<false>(av, ah, al);
        kstep<false, false>(xa, 0, (p8 - p0) / 8, ah, al,
                        [&](int j, float (&bv)[2]) {
                          b_kcol(sD, lh, 8 * ks, p0 + 8 * j, gi, qi, bv);
                        });
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int s = R + gi + (e >> 1) * 8, p = p0 + 8 * j + 2 * qi +
                                                   (e & 1);
          if (s >= ck || p >= P) continue;
          float v = xa[j][e];
          if (a.has_u)
            v = v + (sSu[s] + sSu[64 + s]) * xf(sY[s * lx + p]);
          store(dx, (row0 + size_t(s) * H) * P + p, v, XB);
        }
    }
    // dSᵀ = mask(x·dyᵀ) [s][t], then db̂ = dSᵀ·ĉ, on the row blocks in
    // reverse (warp 0 the last rows): the masks leave the first rows the
    // most work in Sᵀ and dx and the least here, so the warps even out
    const int R2 = 48 - R, j2 = R2 / 8;
    zero_acc(st);
#pragma unroll 1
    for (int ks = 0; ks < pk; ++ks) {
      float av[4];
      uint32_t ah[4], al[4];
      a_rows(sX, lx, R2, 8 * ks, gi, qi, av);
      split<XB>(av, ah, al);
      kstep<XB, XB>(st, j2, cj, ah, al,
                      [&](int j, float (&bv)[2]) {
                        b_colk(sY, lx, 8 * ks, 8 * j, gi, qi, bv);
                      });
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (!keep(8 * j + 2 * qi + (e & 1), R2 + gi + (e >> 1) * 8))
          st[j][e] = 0.f;
    float gbh[8][4];
    zero_acc(gbh);
#pragma unroll 1
    for (int ks = j2; ks < cj; ++ks) {
      float av[4];
      uint32_t ah[4], al[4];
      a_acc(st, ks, av);
      split<false>(av, ah, al);
      kstep<false, false>(gbh, 0, nk, ah, al,
                      [&](int j, float (&bv)[2]) {
                        b_perm(sC, S, 8 * ks, 8 * j, gi, qi, bv);
                      });
    }
    __syncthreads();            // (A) every product has read its tiles
    store_acc(gbh, sDBh, lh, R2, gi, qi, nk);
  } else {
    const int j1 = min(R / 8 + 2, cj);  // s ≤ t: the tiles to the last row
    float gch[8][4];                    // dĉ
    zero_acc(gch);
    // dS = mask(dy·xᵀ) [t][s], then dĉ = dS·b̂
    float ds[8][4];
    zero_acc(ds);
#pragma unroll 1
    for (int ks = 0; ks < pk; ++ks) {
      float av[4];
      uint32_t ah[4], al[4];
      a_rows(sY, lx, R, 8 * ks, gi, qi, av);
      split<XB>(av, ah, al);
      kstep<XB, XB>(ds, 0, j1, ah, al,
                      [&](int j, float (&bv)[2]) {
                        b_colk(sX, lx, 8 * ks, 8 * j, gi, qi, bv);
                      });
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (!keep(R + gi + (e >> 1) * 8, 8 * j + 2 * qi + (e & 1)))
          ds[j][e] = 0.f;
#pragma unroll 1
    for (int ks = 0; ks < j1; ++ks) {
      float av[4];
      uint32_t ah[4], al[4];
      a_acc(ds, ks, av);
      split<false>(av, ah, al);
      kstep<false, false>(gch, 0, nk, ah, al,
                      [&](int j, float (&bv)[2]) {
                        b_perm(sB, S, 8 * ks, 8 * j, gi, qi, bv);
                      });
    }
    // db̃ = x·dhᵀ [s][n]
    float gbt[8][4];
    zero_acc(gbt);
#pragma unroll 1
    for (int ks = 0; ks < pk; ++ks) {
      float av[4];
      uint32_t ah[4], al[4];
      a_rows(sX, lx, R, 8 * ks, gi, qi, av);
      split<XB>(av, ah, al);
      kstep<XB, false>(gbt, 0, nk, ah, al,
                      [&](int j, float (&bv)[2]) {
                        b_colk(sD, lh, 8 * ks, 8 * j, gi, qi, bv);
                      });
    }
    // h has arrived: dĉ += dy·hᵀ
    cp_wait<0>();
    bar_sync_query_side();
#pragma unroll 1
    for (int ks = 0; ks < pk; ++ks) {
      float av[4];
      uint32_t ah[4], al[4];
      a_rows(sY, lx, R, 8 * ks, gi, qi, av);
      split<XB>(av, ah, al);
      kstep<XB, false>(gch, 0, nk, ah, al,
                      [&](int j, float (&bv)[2]) {
                        b_colk(sH, lh, 8 * ks, 8 * j, gi, qi, bv);
                      });
    }
    // Σ_p h⊙dh by state row, dsu = Σ_p dy⊙x by step
    const int i = tid - 128;
    if (i < N) {
      float s = 0.f;
      for (int p = 0; p < P; ++p) s = s + sH[i * lh + p] * sD[i * lh + p];
      sHdh[i] = s;
    } else if (a.has_u && i >= 64 && i - 64 < ck) {
      const int t = i - 64;
      float s = 0.f;
      for (int p = 0; p < P; ++p)
        s = s + xf(sY[t * lx + p]) * xf(sX[t * lx + p]);
      sDsu[t] = s;
    }
    __syncthreads();            // (A)
    store_acc(gbt, sDBt, S, R, gi, qi, nk);
    store_acc(gch, sDC, lh, R, gi, qi, nk);
  }
  // ---- the end, one lane a state column and a pair of warps a quarter of
  // the steps.  d again (from L2: it was read at the start) for dd, and,
  // with f32 x, for L
  float dv[16];
  load_col(d, a.d_bf16, row0, H, N, n, tq * sl, sl, ck, dv);
  __syncthreads();              // (B) the three gradients are in place

  // Per (step, column): dc and db over dĉ and db̂, dL over db̃ (each entry
  // read, then written, by one thread); Σ_t db̃⊙b̃ and du's terms by
  // quarter.  The bonus's b and c are b̂·e^L and ĉ·e^{−L} (a few ulps from
  // the inputs).  Entries past the chunk or N are computed on the padding
  // and left out of the sums and stores.
  float tsum = 0.f, dup = 0.f;
  const float uu = sU[n], elc = sElc[n], lc = sLc[n];
  auto element = [&](int t, float Lt) {
    const bool ok = t < ck && n < N;
    const float chat = sC[t * S + n], bhat = sB[t * S + n];
    const float btld = bhat * elc;
    const float dch = sDC[t * lh + n], dbh = sDBh[t * lh + n];
    const float dbt = sDBt[t * S + n];
    const float eL = expf(Lt), ei = expf(-Lt);
    float gc = dch * eL;
    float gb = dbh * ei + dbt * expf(lc - Lt);
    if (a.has_u) {
      const float bx = bhat * eL, cx = chat * ei;
      const float su = sDsu[t] * uu;
      gc = gc + su * bx;
      gb = gb + su * cx;
      dup = dup + (ok ? sDsu[t] * cx * bx : 0.f);
    }
    sDC[t * lh + n] = gc;
    sDBh[t * lh + n] = gb;
    sDBt[t * S + n] = ok ? dch * chat - dbh * bhat - dbt * btld : 0.f;
    tsum = tsum + (ok ? dbt * btld : 0.f);
  };
  if (XB) {                     // L from its tile, a step at a time
#pragma unroll 1
    for (int i = 0; i < sl; ++i) {
      const int t = tq * sl + i;
      element(t, sL[t * S + n]);
    }
  } else {                      // L again: the first scan's sums and order
    float Lr[16], run = 0.f, before = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float lg = i < sl && tq * sl + i < ck && n < N
                           ? logf(fmaxf(dv[i], 1e-20f)) : 0.f;
      run = run + lg;
      Lr[i] = run;
    }
    sTot[tq * 64 + n] = run;
    __syncthreads();
#pragma unroll
    for (int q = 0; q < 3; ++q)
      if (q < tq) before = before + sTot[q * 64 + n];
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (i < sl) element(tq * sl + i, before + Lr[i]);
  }
  sQ[tq * 64 + n] = tsum;
  sQu[tq * 64 + n] = dup;
  __syncthreads();
  const float dLc = sHdh[n] * elc +
                    (((sQ[n] + sQ[64 + n]) + sQ[128 + n]) + sQ[192 + n]);
  // dL summed from the chunk's last step down, as the plain version: the
  // quarters in turn, the running sum carried between them
  for (int qq = 3; qq >= 0; --qq) {
    if (tq == qq) {
      float run = qq == 3 ? 0.f : sCarry[n];
#pragma unroll 1
      for (int t = tq * sl + sl - 1; t >= tq * sl; --t) {
        run = run + sDBt[t * S + n];
        sDBt[t * S + n] = run;
      }
      sCarry[n] = run;
    }
    __syncthreads();
  }
  // dd over dL, then dc, db and dd out by rows
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    if (i >= sl) continue;
    const int t = tq * sl + i;
    sDBt[t * S + n] = dv[i] > 1e-20f
                          ? __fdividef(sDBt[t * S + n] + dLc, dv[i]) : 0.f;
  }
  if (a.has_u && tq == 0 && n < N)
    du_part[((size_t(bb) * nc + ch) * H + h) * N + n] =
        ((sQu[n] + sQu[64 + n]) + sQu[128 + n]) + sQu[192 + n];
  __syncthreads();
  unstage(dc, a.c_bf16, sDC, lh, row0, H, N, ck, tid);
  unstage(db, a.b_bf16, sDBh, lh, row0, H, N, ck, tid);
  unstage(dd, a.d_bf16, sDBt, S, row0, H, N, ck, tid);
}

// ---- pass C: du = Σ over batch and chunk of the partials, in order
__global__ void du_sum_kernel(const SsdBwdArgs a,
                              const float* __restrict__ du_part,
                              float* __restrict__ du) {
  const int h = blockIdx.x, n = threadIdx.x;
  if (n >= a.N) return;
  const int nc = a.T / a.chunk;
  float s = 0.f;
  for (int bb = 0; bb < a.B; ++bb)
    for (int g = 0; g < nc; ++g)
      s = s + du_part[((size_t(bb) * nc + g) * a.H + h) * a.N + n];
  du[size_t(h) * a.N + n] = s;
}

template <bool XB>
cudaError_t launch_state_grad(const SsdBwdArgs& a, const void* d,
                              const void* c, const void* dy, const float* dhT,
                              float* dhs, float* dh0, cudaStream_t st) {
  const int smem = a_layout(a.P, a.d_bf16, a.c_bf16, XB).total;
  auto k = a.P > 64 ? state_grad_kernel<XB, 2 * A_Q>
                    : state_grad_kernel<XB, A_Q>;
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  k<<<dim3((a.N + A_ROWS - 1) / A_ROWS, a.H, a.B), A_THREADS, smem, st>>>(a, d, c, dy, dhT, dhs, dh0);
  return cudaGetLastError();
}

template <bool XB>
cudaError_t launch_chunk_grad(const SsdBwdArgs& a, const void* d,
                              const void* b, const void* x, const void* c,
                              const float* u, const float* hs, const void* dy,
                              const float* dhs, float* du_part, void* dd,
                              void* db, void* dx, void* dc, cudaStream_t st) {
  const int smem = b_layout(a.P, XB).total;
  cudaError_t err = cudaFuncSetAttribute(
      chunk_grad_kernel<XB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  chunk_grad_kernel<XB><<<dim3(a.T / a.chunk, a.H, a.B), THREADS, smem, st>>>(a, d, b, x, c, u, hs, dy, dhs, du_part, dd, db, dx, dc);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ssd_bwd_launch(const SsdBwdArgs* a, const void* d,
                              const void* b, const void* x, const void* c,
                              const float* u, const float* hs, const void* dy,
                              const float* dhT, float* dhs, float* du_part,
                              void* dd, void* db, void* dx, void* dc,
                              float* du, float* dh0, void* stream) {
  if (a->B < 1 || a->T < 1 || a->H < 1 || a->N < 1 || a->N > MAX_N ||
      a->P < 1 || a->P > MAX_P || a->chunk < 1 || a->chunk > C ||
      a->T % a->chunk || (a->has_u && (!u || !du || !du_part)) ||
      (a->has_dhT && !dhT) || !hs || !dy || !dhs || !dh0 || a->H > 65535 ||
      a->B > 65535)
    return int(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      a->x_bf16 ? launch_state_grad<true>(*a, d, c, dy, dhT, dhs, dh0, st)
                : launch_state_grad<false>(*a, d, c, dy, dhT, dhs, dh0, st);
  if (err != cudaSuccess) return int(err);
  err = a->x_bf16 ? launch_chunk_grad<true>(*a, d, b, x, c, u, hs, dy, dhs,
                                            du_part, dd, db, dx, dc, st)
                  : launch_chunk_grad<false>(*a, d, b, x, c, u, hs, dy, dhs,
                                             du_part, dd, db, dx, dc, st);
  if (err != cudaSuccess || !a->has_u) return int(err);
  du_sum_kernel<<<a->H, 64, 0, st>>>(*a, du_part, du);
  return int(cudaGetLastError());
}

// Shared bytes a block and resident blocks an SM of pass A (pass 0) or
// pass B (pass 1) for these widths and types
extern "C" int ssd_bwd_resources(int pass, int P, int d_bf16, int c_bf16,
                                 int x_bf16, int* smem_bytes,
                                 int* blocks_per_sm) {
  if (P < 1 || P > MAX_P) return int(cudaErrorInvalidValue);
  const void* k;
  int threads;
  if (pass == 0) {
    *smem_bytes = a_layout(P, d_bf16, c_bf16, x_bf16).total;
    threads = A_THREADS;
    k = x_bf16 ? (P > 64 ? reinterpret_cast<const void*>(
                               state_grad_kernel<true, 2 * A_Q>)
                         : reinterpret_cast<const void*>(
                               state_grad_kernel<true, A_Q>))
               : (P > 64 ? reinterpret_cast<const void*>(
                               state_grad_kernel<false, 2 * A_Q>)
                         : reinterpret_cast<const void*>(
                               state_grad_kernel<false, A_Q>));
  } else {
    *smem_bytes = b_layout(P, x_bf16).total;
    threads = THREADS;
    k = x_bf16 ? reinterpret_cast<const void*>(chunk_grad_kernel<true>)
               : reinterpret_cast<const void*>(chunk_grad_kernel<false>);
  }
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem_bytes);
  if (err != cudaSuccess) return int(err);
  return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, k, threads, *smem_bytes));
}
