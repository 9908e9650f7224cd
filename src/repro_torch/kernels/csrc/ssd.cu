// Chunked linear recurrence ("SSD", the Mamba2 / RWKV6 core) on Hopper
// (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel `repro.kernels.ssm_scan.ssd` (Pallas body
// `_kernel`, src/repro/kernels/ssm_scan.py).  For d, b, c [B, T, H, N] and
// x [B, T, H, P] (each f32 or bf16), an optional per-head bonus u [H, N] and
// initial state h0 [B, H, N, P] (f32):
//
//     h_t = d_t ⊙ h_{t−1} + b_t ⊗ x_t,      y_t = c_t · h_t
//
// in chunks of C steps, each computed as `ref.chunked_ssd` computes it: the
// inclusive log-decay cumsum L (log of max(d, 1e-20)); ĉ = c·e^L,
// b̂ = b·e^{−L}, b̃ = b·e^{L_C − L}; y = mask(ĉ·b̂ᵀ)·x (+ (Σ_n c·u·b)·x) + ĉ·h;
// then h ← e^{L_C}·h + b̃ᵀ·x.  The mask keeps s ≤ t with include_current and
// s < t without.  y is written in x's type, the final state in f32.  The
// plain version is `ssd_reference` in ssm_scan.py.
//
// What bounds it.  Each input byte read once and each output written once:
// at Zamba2-7B's prefill [8, 1,024, 112, N = P = 64] (d, b f32; c, x bf16)
// about 0.84 GB, 0.25 ms at 3.35 TB/s.  The four chunk products are ~30
// GFLOP, 0.46 ms at the 67 TFLOP/s f32 peak of the CUDA cores: in f32, as
// the reference computes them (its f32 bounds, 3e-5, rest on that; no
// tensor cores and no TF32), the FMA rate is the floor.
//
// Design.  The TPU kernel's grid (B, H, nChunks) ran the chunk axis in
// order with the [N, P] state in VMEM scratch.  Here one block of 256
// threads owns one (head, batch) and walks the chunks in order, the state
// in shared memory for the whole sequence: 8 × 112 = 896 blocks at
// Zamba2's width, two resident per SM (~108 KB of shared memory each).
//   * Loads are asynchronous: d, b, c and x of chunk k + 1 are copied with
//     16-byte cp.async (element copies where a row is not 16-byte aligned)
//     into staging buffers in their own types while chunk k computes; x is
//     double-buffered, d and c are refilled once the transform has read
//     them, b once its buffer (which then holds b̃ᵀ) has been read by the
//     state product.  bf16 is widened where it is first read.
//   * The log-decay cumsum is a parallel scan: each lane takes one state
//     column and each pair of warps a quarter of the chunk's steps; a lane
//     sums its quarter in order, the quarters' sums meet in shared memory,
//     and each lane adds those before its own.  The same lanes then form
//     ĉ, b̂ᵀ and b̃ᵀ (b̃ = b·e^{−L}·e^{L_C}, one exponential fewer than
//     e^{L_C − L}; e^{L_C} is the state's decay), b̂ᵀ and b̃ᵀ written four
//     steps at a time, and the bonus's row sums (a shuffle reduction over
//     the columns).
//   * The products run on a 16 × 16 grid of threads, each holding a 4 × 4
//     (or, for P > 64, a 4 × 8) block of outputs in registers and reading
//     its operands as float4: per four reduction steps four float4 of A
//     and four (eight) of B feed 64 (128) FMAs.  Rows of the [64, 64]
//     operands are padded to 68 floats, so the two rows a warp reads sit
//     in different banks; B rows are read whole by 16 lanes.  The score
//     product's masked upper triangle is skipped in the value product
//     (each warp stops at its last row); y gathers scores·x, the bonus
//     and ĉ·h in one register block.  The state product runs beside
//     the scores (its operands are ready), so the b buffer is free for the
//     next chunk before y is formed; the new state lands after y has read
//     the old one.
// The chunk length is what the wrapper gives (the Pallas wrapper's rule:
// min(64, T) halved until it divides T), at most 64.
//
// Training.  `ssd_states_launch` is the same kernel instantiated with
// STATES: before each chunk's state update every thread also writes its
// tile of the state entering the chunk to hs [B, nc, H, N, P] (f32), which
// the backward (ssd_bwd.cu) reads.  Nothing else changes, so its y and hT
// are the serving launch's bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

struct SsdArgs {
  int B, T, H, N, P, chunk, include_current, has_u, has_h0;
  int d_bf16, b_bf16, x_bf16, c_bf16;
};

namespace {

constexpr int C = 64;           // largest chunk
constexpr int THREADS = 256;    // 16 × 16 for the products, 8 warps
constexpr int MAX_N = 64;
constexpr int MAX_P = 128;
constexpr int S = C + 4;        // padded row stride of the [64, 64] operands

__device__ __forceinline__ float load(const void* p, size_t i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store(void* p, size_t i, float v, int bf16) {
  if (bf16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(p)[i] = v;
}

// four consecutive elements of a raw staging row, widened to f32
__device__ __forceinline__ void load4(const void* p, int i, int bf16,
                                      float* v) {
  if (bf16) {
    const uint2 u = *reinterpret_cast<const uint2*>(
        static_cast<const __nv_bfloat16*>(p) + i);
    v[0] = __uint_as_float(u.x << 16);
    v[1] = __uint_as_float(u.x & 0xffff0000u);
    v[2] = __uint_as_float(u.y << 16);
    v[3] = __uint_as_float(u.y & 0xffff0000u);
  } else {
    const float4 f = *reinterpret_cast<const float4*>(
        static_cast<const float*>(p) + i);
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Shared-memory layout, in bytes from the base (every offset 16-aligned).
struct Layout {
  int ch;    // ĉ [64][S] f32
  int bh;    // b̂ᵀ [64][S] f32, then the masked scores [64][S]
  int sb;    // raw b [C][N], then b̃ᵀ [64][S] f32
  int sd;    // raw d [C][N]
  int sc;    // raw c [C][N]
  int sx;    // raw x, two buffers of [64][PT] (rows C.. zero)
  int sh;    // state [N4][PT] f32 (rows N.., columns P.. zero)
  int su;    // bonus row sums by column half [2][C] f32 (only with u)
  int tot;   // the log-decay sums of the chunk's quarters [4][64] f32
  int lc;    // e^L at the chunk's last step [64] f32
  int u;     // u [64] f32
  int xbuf;  // bytes of one x buffer
  int total;
};

__host__ __device__ inline int up16(int x) { return (x + 15) & ~15; }

__host__ __device__ inline Layout layout(const SsdArgs& a) {
  const int pt = a.P > 64 ? 128 : 64, n4 = (a.N + 3) & ~3;
  const int es_x = a.x_bf16 ? 2 : 4;
  Layout l;
  int o = 0;
  auto take = [&o](int bytes) {
    const int at = o;
    o += up16(bytes);
    return at;
  };
  l.ch = take(64 * S * 4);
  l.bh = take(64 * S * 4);
  const int sb = C * a.N * (a.b_bf16 ? 2 : 4);
  l.sb = take(sb > 64 * S * 4 ? sb : 64 * S * 4);
  l.sd = take(C * a.N * (a.d_bf16 ? 2 : 4));
  l.sc = take(C * a.N * (a.c_bf16 ? 2 : 4));
  l.xbuf = up16(64 * pt * es_x);
  l.sx = take(2 * l.xbuf);
  l.sh = take(n4 * pt * 4);
  l.su = take(a.has_u ? 2 * C * 4 : 0);
  l.tot = take(4 * 64 * 4);
  l.lc = take(64 * 4);
  l.u = take(64 * 4);
  l.total = o;
  return l;
}

// rows × W elements of `es` bytes from global (row stride gstride elements)
// into a staging buffer (row stride sw elements): 16-byte cp.async when
// every row is 16-byte aligned, element copies otherwise
__device__ __forceinline__ void stage(void* dst, const void* src, int es,
                                      int rows, int W, int sw,
                                      size_t gstride, bool vec, int tid) {
  char* d = static_cast<char*>(dst);
  const char* s = static_cast<const char*>(src);
  if (vec) {
    const int per = W * es / 16;
    for (int e = tid; e < rows * per; e += THREADS) {
      const int r = e / per, q = e - r * per;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       smem_u32(d + size_t(r) * sw * es + q * 16)),
                   "l"(s + size_t(r) * gstride * es + q * 16)
                   : "memory");
    }
  } else if (es == 4) {
    for (int e = tid; e < rows * W; e += THREADS) {
      const int r = e / W, c = e - r * W;
      reinterpret_cast<float*>(d)[r * sw + c] =
          reinterpret_cast<const float*>(s)[size_t(r) * gstride + c];
    }
  } else {
    for (int e = tid; e < rows * W; e += THREADS) {
      const int r = e / W, c = e - r * W;
      reinterpret_cast<uint16_t*>(d)[r * sw + c] =
          reinterpret_cast<const uint16_t*>(s)[size_t(r) * gstride + c];
    }
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// acc[i][j] += Σ_k A[r0 + i][k] · B[k][c0 + j'] for k < K (a multiple of 4):
// A f32 with row stride sa, read as float4 along k; B raw (f32 or bf16)
// with row stride sb, read as 4-wide vectors at columns c0 and, for Q = 8,
// c0 + 64
template <int Q>
__device__ __forceinline__ void tile_product(float (&acc)[4][Q],
                                             const float* A, int sa,
                                             const void* B, int sb,
                                             int b_bf16, int K, int r0,
                                             int c0) {
  for (int k = 0; k < K; k += 4) {
    float a[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 v =
          *reinterpret_cast<const float4*>(A + (r0 + i) * sa + k);
      a[i][0] = v.x;
      a[i][1] = v.y;
      a[i][2] = v.z;
      a[i][3] = v.w;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float bv[Q];
      load4(B, (k + kk) * sb + c0, b_bf16, bv);
      if (Q == 8) load4(B, (k + kk) * sb + c0 + 64, b_bf16, bv + 4);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < Q; ++j) acc[i][j] = fmaf(a[i][kk], bv[j], acc[i][j]);
    }
  }
}

template <int Q, bool STATES>
__global__ void __launch_bounds__(THREADS, Q == 4 ? 2 : 1)
    ssd_kernel(const SsdArgs a, const void* __restrict__ d,
               const void* __restrict__ b, const void* __restrict__ x,
               const void* __restrict__ c, const float* __restrict__ u,
               const float* __restrict__ h0, void* __restrict__ y,
               float* __restrict__ hT, float* __restrict__ hs) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay = layout(a);
  float* sCh = reinterpret_cast<float*>(smem + lay.ch);
  float* sBh = reinterpret_cast<float*>(smem + lay.bh);
  float* sBt = reinterpret_cast<float*>(smem + lay.sb);
  void* sBraw = smem + lay.sb;
  void* sD = smem + lay.sd;
  void* sC = smem + lay.sc;
  unsigned char* sX = smem + lay.sx;
  float* sH = reinterpret_cast<float*>(smem + lay.sh);
  float* sSu = reinterpret_cast<float*>(smem + lay.su);
  float* sTot = reinterpret_cast<float*>(smem + lay.tot);
  float* sLc = reinterpret_cast<float*>(smem + lay.lc);   // e^{L_C}
  float* sU = reinterpret_cast<float*>(smem + lay.u);

  constexpr int PT = 16 * Q;                 // output columns of a tile row
  const int N = a.N, P = a.P, ck = a.chunk, T = a.T, H = a.H;
  const int n4 = (N + 3) & ~3, ck4 = (ck + 3) & ~3, xs = (P + 3) & ~3;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.x, bb = blockIdx.y;
  const size_t state0 = (size_t(bb) * H + h) * N * P;
  const int es_d = a.d_bf16 ? 2 : 4, es_b = a.b_bf16 ? 2 : 4;
  const int es_c = a.c_bf16 ? 2 : 4, es_x = a.x_bf16 ? 2 : 4;
  const bool vd = (N * es_d) % 16 == 0 && (uintptr_t(d) & 15) == 0;
  const bool vb = (N * es_b) % 16 == 0 && (uintptr_t(b) & 15) == 0;
  const bool vc = (N * es_c) % 16 == 0 && (uintptr_t(c) & 15) == 0;
  const bool vx = (P * es_x) % 16 == 0 && (uintptr_t(x) & 15) == 0;
  // element offset of step t0's row of this (batch, head), width W
  auto row = [&](int t0, int W) {
    return ((size_t(bb) * T + t0) * H + h) * W;
  };
  auto load_dcx = [&](int t0, int buf) {
    stage(sD, static_cast<const char*>(d) + row(t0, N) * es_d, es_d, ck, N,
          N, size_t(H) * N, vd, tid);
    stage(sC, static_cast<const char*>(c) + row(t0, N) * es_c, es_c, ck, N,
          N, size_t(H) * N, vc, tid);
    stage(sX + buf * lay.xbuf, static_cast<const char*>(x) + row(t0, P) * es_x,
          es_x, ck, P, xs, size_t(H) * P, vx, tid);
  };
  auto load_b = [&](int t0) {
    stage(sBraw, static_cast<const char*>(b) + row(t0, N) * es_b, es_b, ck,
          N, N, size_t(H) * N, vb, tid);
  };

  // x's rows past the chunk (and columns past P) stay zero; the state's
  // rows past N and columns past P too
  for (int e = tid; e < 2 * lay.xbuf / 16; e += THREADS)
    reinterpret_cast<float4*>(sX)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int e = tid; e < n4 * PT; e += THREADS) {
    const int n = e / PT, p = e - n * PT;
    sH[e] = a.has_h0 && n < N && p < P ? h0[state0 + n * P + p] : 0.f;
  }
  if (tid < 64) sU[tid] = a.has_u && tid < N ? u[size_t(h) * N + tid] : 0.f;
  __syncthreads();
  load_dcx(0, 0);
  load_b(0);
  cp_commit();

  const int r0 = ty * 4, c0 = tx * 4;          // this thread's output tile
  // the transform's lanes: a quarter of the chunk's steps by warp pairs,
  // one state column by lane
  const int tq = warp >> 1, n = (warp & 1) * 32 + lane;
  const int sl = (ck + 3) >> 2;                // steps per quarter
  const unsigned full = 0xffffffffu;
  int buf = 0;
  for (int t0 = 0; t0 < T; t0 += ck, buf ^= 1) {
    cp_wait_all();
    __syncthreads();            // chunk t0 staged; the last chunk is done
    const void* sXc = sX + buf * lay.xbuf;

    // ---- transform: L by a scan over the quarters, then ĉ, b̂ᵀ, b̃ᵀ
    float Lr[16], bv[16], cv[16];
    float run = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int t = tq * sl + i;
      float lg = 0.f, bx = 0.f, cx = 0.f;
      if (i < sl && t < ck && n < N) {
        lg = logf(fmaxf(load(sD, t * N + n, a.d_bf16), 1e-20f));
        bx = load(sBraw, t * N + n, a.b_bf16);
        cx = load(sC, t * N + n, a.c_bf16);
      }
      run = run + lg;
      Lr[i] = run;
      bv[i] = bx;
      cv[i] = cx;
    }
    sTot[tq * 64 + n] = run;
    __syncthreads();            // raw d, b, c are read; the quarters' sums
    if (t0 + ck < T) {
      load_dcx(t0 + ck, buf ^ 1);
      cp_commit();
    }
    float before = 0.f;         // L before this quarter
#pragma unroll
    for (int q = 0; q < 3; ++q)
      if (q < tq) before = before + sTot[q * 64 + n];
    // L at step ck − 1 (the quarters past it add 0), summed as `before` is
    const float lc =
        ((sTot[n] + sTot[64 + n]) + sTot[128 + n]) + sTot[192 + n];
    const float elc = expf(lc);                          // the state's decay
    const float uu = sU[n];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      if (i < sl) {
        const int t = tq * sl + i;
        const float Lt = before + Lr[i];
        const float einv = expf(-Lt);
        sCh[t * S + n] = cv[i] * expf(Lt);
        if (a.has_u) {
          float su = cv[i] * uu * bv[i];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            su += __shfl_xor_sync(full, su, off);
          if (lane == 0) sSu[(warp & 1) * C + t] = su;
        }
        cv[i] = bv[i] * einv;                    // b̂
        bv[i] = bv[i] * (einv * elc);            // b̃ = b·e^{L_C − L}
      }
    }
    // b̂ᵀ and b̃ᵀ rows: float4 along the steps where quarters are aligned
    if ((sl & 3) == 0) {
#pragma unroll
      for (int i = 0; i < 16; i += 4)
        if (i < sl) {
          const int at = n * S + tq * sl + i;
          *reinterpret_cast<float4*>(sBh + at) =
              make_float4(cv[i], cv[i + 1], cv[i + 2], cv[i + 3]);
          *reinterpret_cast<float4*>(sBt + at) =
              make_float4(bv[i], bv[i + 1], bv[i + 2], bv[i + 3]);
        }
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i)
        if (i < sl) {
          sBh[n * S + tq * sl + i] = cv[i];
          sBt[n * S + tq * sl + i] = bv[i];
        }
    }
    if (tq == 0) sLc[n] = elc;
    __syncthreads();

    // ---- scores ĉ·b̂ᵀ and the state's update b̃ᵀ·x, side by side
    float sc[4][4], st[4][Q];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll
      for (int j = 0; j < Q; ++j) st[i][j] = 0.f;
    }
    tile_product<4>(sc, sCh, S, sBh, S, 0, n4, r0, c0);
    tile_product<Q>(st, sBt, S, sXc, xs, a.x_bf16, ck4, r0, c0);
    __syncthreads();            // b̂ᵀ and b̃ᵀ are read
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = r0 + i;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = c0 + j;
        const bool keep = t < ck && s < ck &&
                          (a.include_current ? s <= t : s < t);
        v[j] = keep ? sc[i][j] : 0.f;
      }
      *reinterpret_cast<float4*>(sBh + t * S + c0) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
    if (t0 + ck < T) {
      load_b(t0 + ck);
      cp_commit();
    }
    __syncthreads();

    // ---- y = scores·x (+ bonus·x) + ĉ·h, in one accumulator
    float yi[4][Q];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < Q; ++j) yi[i][j] = 0.f;
    // rows of this warp are 8·warp … 8·warp + 7: scores past them are 0
    tile_product<Q>(yi, sBh, S, sXc, xs, a.x_bf16, min(ck4, 8 * warp + 8),
                    r0, c0);
    if (a.has_u) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = r0 + i;
        if (t < ck) {
          const float su = sSu[t] + sSu[C + t];
          float xv[Q];
          load4(sXc, t * xs + c0, a.x_bf16, xv);
          if (Q == 8) load4(sXc, t * xs + c0 + 64, a.x_bf16, xv + 4);
#pragma unroll
          for (int j = 0; j < Q; ++j) yi[i][j] = yi[i][j] + su * xv[j];
        }
      }
    }
    tile_product<Q>(yi, sCh, S, sH, PT, 0, n4, r0, c0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = r0 + i;
      if (t >= ck) continue;
      const size_t base = row(t0 + t, P);
#pragma unroll
      for (int g4 = 0; g4 < Q / 4; ++g4) {
        const int p = c0 + 64 * g4;
        const float v[4] = {yi[i][4 * g4], yi[i][4 * g4 + 1],
                            yi[i][4 * g4 + 2], yi[i][4 * g4 + 3]};
        if (P % 4 == 0 && p < P) {       // four aligned outputs at once
          if (a.x_bf16) {
            __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
            __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
            uint2 u;
            u.x = *reinterpret_cast<uint32_t*>(&lo);
            u.y = *reinterpret_cast<uint32_t*>(&hi);
            *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(y) + base +
                                      p) = u;
          } else {
            *reinterpret_cast<float4*>(static_cast<float*>(y) + base + p) =
                make_float4(v[0], v[1], v[2], v[3]);
          }
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (p + j < P) store(y, base + p + j, v[j], a.x_bf16);
        }
      }
    }
    __syncthreads();            // every read of h is done

    // ---- h ← e^{L_C}·h + b̃ᵀ·x (with STATES, the old h to hs first)
    const size_t chunk_state =
        ((size_t(bb) * (T / ck) + t0 / ck) * H + h) * N * P;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int nn = r0 + i;
      if (nn >= N) continue;
      const float decay = sLc[nn];
#pragma unroll
      for (int j = 0; j < Q; ++j) {
        const int p = c0 + j + (j >= 4 ? 60 : 0);
        if (p < P) {
          if constexpr (STATES) hs[chunk_state + nn * P + p] = sH[nn * PT + p];
          sH[nn * PT + p] = decay * sH[nn * PT + p] + st[i][j];
        }
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < N * P; e += THREADS) {
    const int nn = e / P, p = e - nn * P;
    hT[state0 + e] = sH[nn * PT + p];
  }
}

template <int Q, bool STATES>
int launch(const SsdArgs& a, const void* d, const void* b, const void* x,
           const void* c, const float* u, const float* h0, void* y,
           float* hT, float* hs, cudaStream_t stream) {
  const int smem = layout(a).total;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<Q, STATES>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_kernel<Q, STATES>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               int(cudaSharedmemCarveoutMaxShared));
  if (err != cudaSuccess) return int(err);
  ssd_kernel<Q, STATES><<<dim3(a.H, a.B), THREADS, smem, stream>>>(
      a, d, b, x, c, u, h0, y, hT, hs);
  return int(cudaGetLastError());
}

bool valid(const SsdArgs* a, const float* u, const float* h0) {
  return !(a->B < 1 || a->T < 1 || a->H < 1 || a->N < 1 || a->N > MAX_N ||
           a->P < 1 || a->P > MAX_P || a->chunk < 1 || a->chunk > C ||
           a->T % a->chunk || (a->has_u && !u) || (a->has_h0 && !h0) ||
           a->H > 65535 || a->B > 65535);
}

}  // namespace

extern "C" int ssd_launch(const SsdArgs* a, const void* d, const void* b,
                          const void* x, const void* c, const float* u,
                          const float* h0, void* y, float* hT, void* stream) {
  if (!valid(a, u, h0)) return int(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return a->P > 64
             ? launch<8, false>(*a, d, b, x, c, u, h0, y, hT, nullptr, st)
             : launch<4, false>(*a, d, b, x, c, u, h0, y, hT, nullptr, st);
}

// the forward that also writes the state entering each chunk to hs
// [B, T / chunk, H, N, P] f32
extern "C" int ssd_states_launch(const SsdArgs* a, const void* d,
                                 const void* b, const void* x, const void* c,
                                 const float* u, const float* h0, void* y,
                                 float* hT, float* hs, void* stream) {
  if (!valid(a, u, h0) || !hs) return int(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return a->P > 64 ? launch<8, true>(*a, d, b, x, c, u, h0, y, hT, hs, st)
                   : launch<4, true>(*a, d, b, x, c, u, h0, y, hT, hs, st);
}
