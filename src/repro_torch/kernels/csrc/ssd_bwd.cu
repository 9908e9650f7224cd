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
// TB/s; the products, counting only the entries the causal masks keep,
// are ~51 GFLOP, 0.76 ms at the 67 TFLOP/s f32 peak of the CUDA cores (in
// f32 as the forward: no tensor cores, no TF32).  `ssd_backward_cost`.
//
// Design.  The only sequential part is the state gradient's walk over the
// chunks, so it runs on its own:
//   * Pass A (`state_grad_kernel`), one block per (head, batch), walks the
//     chunks from the last, the [N, P] state gradient in registers (a 4 × 4
//     or 4 × 8 block a thread on the forward's 16 × 16 grid).  Per chunk it
//     forms L by the forward's quarter scan and ĉ into shared memory, stores
//     dh (the gradient leaving the chunk) to the scratch dhs [B, nc, H, N,
//     P], and steps dh ← e^{Lc}⊙dh + ĉᵀ·dy; dh0 is its last value.
//   * Pass B (`chunk_grad_kernel`) is parallel over (chunk, head, batch):
//     from (h_g, dh) it forms every other gradient.  Ten [64, 68] f32
//     buffers in shared memory (174 KB, one block an SM): ĉ, b̂, b̃, L, the
//     masked scores, b̂ᵀ (then dS) and four panels of 64 value columns —
//     xᵀ, dy, hᵀ, dh — loaded once for P ≤ 64, twice for P ≤ 128, the
//     products over the value axis summed across the panels.  Every
//     product runs on the 16 × 16 grid of 4 × 4 register blocks, with A
//     read as float4 along the reduction (`prod_rows`) or across its rows
//     (`prod_cols`), so no operand needs a transpose beyond those four.
//     The last phase: dL, dc and db elementwise; then one thread a state
//     column sums dL from the chunk's last step down, as the plain version
//     does (its terms cancel in pairs), and writes dd, and du's partial for
//     this (batch, chunk).
//   * Pass C (`du_sum_kernel`) adds du's partials over batch and chunk in a
//     fixed order.  No atomics: two launches give the same bits.
// The chunk is the wrapper's (at most 64), N ≤ 64, P ≤ 128, as the forward.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

struct SsdBwdArgs {
  int B, T, H, N, P, chunk, include_current, has_u, has_dhT;
  int d_bf16, b_bf16, x_bf16, c_bf16;
};

namespace {

constexpr int C = 64;           // largest chunk
constexpr int THREADS = 256;    // 16 × 16 for the products, 8 warps
constexpr int MAX_N = 64;
constexpr int MAX_P = 128;
constexpr int S = C + 4;        // padded row stride of the [64, 64] buffers
constexpr int TILE = 64 * S;    // floats of one buffer

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

// acc[i][j] += Σ_{k<K} A[r0 + i][k] · B[k][c0 + j]: A's rows read as float4
// along k (K a multiple of 4, the padding zero), B's as float4 along j
__device__ __forceinline__ void prod_rows(float (&acc)[4][4], const float* A,
                                          const float* B, int K, int r0,
                                          int c0) {
  for (int k = 0; k < K; k += 4) {
    float a[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(A + (r0 + i) * S + k);
      a[i][0] = v.x;
      a[i][1] = v.y;
      a[i][2] = v.z;
      a[i][3] = v.w;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 v =
          *reinterpret_cast<const float4*>(B + (k + kk) * S + c0);
      const float bv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = fmaf(a[i][kk], bv[j], acc[i][j]);
    }
  }
}

// acc[i][j'] += Σ_{k<K} A[k][r0 + i] · B[k][c0 + j'] (j' = j, and j + 64 for
// Q = 8): A stored with the reduction along its rows (row stride sa), B
// with row stride sb, both read as float4
template <int Q>
__device__ __forceinline__ void prod_cols(float (&acc)[4][Q], const float* A,
                                          int sa, const float* B, int sb,
                                          int K, int r0, int c0) {
  for (int k = 0; k < K; ++k) {
    const float4 av = *reinterpret_cast<const float4*>(A + k * sa + r0);
    const float a[4] = {av.x, av.y, av.z, av.w};
    float bv[Q];
#pragma unroll
    for (int q = 0; q < Q / 4; ++q) {
      const float4 v =
          *reinterpret_cast<const float4*>(B + k * sb + c0 + 64 * q);
      bv[4 * q] = v.x;
      bv[4 * q + 1] = v.y;
      bv[4 * q + 2] = v.z;
      bv[4 * q + 3] = v.w;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < Q; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
  }
}

// The inclusive log-decay cumsum of one chunk, as the forward forms it: lane
// (tq, n) sums quarter tq of the steps of state column n in order, the
// quarters' sums meet in sTot.  Leaves the lane's steps' sums in Lr, L
// before its quarter in *before and the chunk's total in *lc.  Reads d (and
// the column's values of up to two more [B, T, H, N] inputs into v1, v2).
__device__ __forceinline__ void log_decay_scan(
    const SsdBwdArgs& a, const void* d, const void* p1, int bf1,
    const void* p2, int bf2, size_t row0, int tq, int n, int sl,
    float (&Lr)[16], float (&v1)[16], float (&v2)[16], float* sTot,
    float* before, float* lc) {
  float run = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int t = tq * sl + i;
    float lg = 0.f, e1 = 0.f, e2 = 0.f;
    if (i < sl && t < a.chunk && n < a.N) {
      const size_t at = row0 + size_t(t) * a.H * a.N + n;
      lg = logf(fmaxf(load(d, at, a.d_bf16), 1e-20f));
      e1 = load(p1, at, bf1);
      if (p2) e2 = load(p2, at, bf2);
    }
    run = run + lg;
    Lr[i] = run;
    v1[i] = e1;
    v2[i] = e2;
  }
  sTot[tq * 64 + n] = run;
  __syncthreads();
  float b4 = 0.f;
#pragma unroll
  for (int q = 0; q < 3; ++q)
    if (q < tq) b4 = b4 + sTot[q * 64 + n];
  *before = b4;
  *lc = ((sTot[n] + sTot[64 + n]) + sTot[128 + n]) + sTot[192 + n];
}

// ---- pass A: the state gradient leaving each chunk, walked from the last
template <int Q>
__global__ void __launch_bounds__(THREADS)
    state_grad_kernel(const SsdBwdArgs a, const void* __restrict__ d,
                      const void* __restrict__ c, const void* __restrict__ dy,
                      const float* __restrict__ dhT, float* __restrict__ dhs,
                      float* __restrict__ dh0) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int PT = 16 * Q;                 // dy's row stride
  float* sCh = reinterpret_cast<float*>(smem);   // ĉ [64][S]
  float* sDy = sCh + TILE;                       // dy [64][PT] f32
  float* sTot = sDy + 64 * PT;                   // [4][64]
  float* sElc = sTot + 256;                      // e^{Lc} [64]

  const int N = a.N, P = a.P, ck = a.chunk, H = a.H, nc = a.T / ck;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.x, bb = blockIdx.y;
  const size_t state0 = (size_t(bb) * H + h) * N * P;
  const int r0 = ty * 4, c0 = tx * 4;
  const int tq = warp >> 1, n = (warp & 1) * 32 + lane;
  const int sl = (ck + 3) >> 2;

  for (int e = tid; e < TILE + 64 * PT; e += THREADS) sCh[e] = 0.f;
  float dh[4][Q];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      const int nn = r0 + i, p = c0 + j + (j >= 4 ? 60 : 0);
      dh[i][j] = a.has_dhT && nn < N && p < P ? dhT[state0 + nn * P + p]
                                               : 0.f;
    }

  for (int g = nc - 1; g >= 0; --g) {
    const int t0 = g * ck;
    __syncthreads();            // the last chunk's product has read ĉ, dy
    float Lr[16], cv[16], unused[16];
    float before, lc;
    const size_t row0 = (size_t(bb) * a.T + t0) * H * N + size_t(h) * N;
    // dy's rows of the chunk, widened (before the scan's barrier)
    for (int e = tid; e < ck * P; e += THREADS) {
      const int t = e / P, p = e - t * P;
      sDy[t * PT + p] =
          load(dy, ((size_t(bb) * a.T + t0 + t) * H + h) * P + p, a.x_bf16);
    }
    log_decay_scan(a, d, c, a.c_bf16, nullptr, 0, row0, tq, n, sl, Lr, cv,
                   unused, sTot, &before, &lc);
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (i < sl) sCh[(tq * sl + i) * S + n] = cv[i] * expf(before + Lr[i]);
    if (tq == 0) sElc[n] = expf(lc);
    __syncthreads();

    const size_t base = ((size_t(bb) * nc + g) * H + h) * N * P;
    float acc[4][Q];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < Q; ++j) {
        const int nn = r0 + i, p = c0 + j + (j >= 4 ? 60 : 0);
        if (nn < N && p < P) dhs[base + nn * P + p] = dh[i][j];
        acc[i][j] = 0.f;
      }
    prod_cols<Q>(acc, sCh, S, sDy, PT, ck, r0, c0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float decay = sElc[r0 + i];
#pragma unroll
      for (int j = 0; j < Q; ++j) dh[i][j] = decay * dh[i][j] + acc[i][j];
    }
  }
  if (dh0) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < Q; ++j) {
        const int nn = r0 + i, p = c0 + j + (j >= 4 ? 60 : 0);
        if (nn < N && p < P) dh0[state0 + nn * P + p] = dh[i][j];
      }
  }
}

// ---- pass B: every other gradient of one (chunk, head, batch)
struct BwdSmem {
  static constexpr int CH = 0;    // ĉ [t][n]
  static constexpr int BH = 1;    // b̂ [s][n]
  static constexpr int BT = 2;    // b̃ [s][n]
  static constexpr int L = 3;     // L [t][n]
  static constexpr int SC = 4;    // masked scores [t][s], then dL [t][n]
  static constexpr int BHT = 5;   // b̂ᵀ [n][s], then masked dS [t][s]
  static constexpr int XT = 6;    // xᵀ panel [p][s], then db̃ᵀ [n][s]
  static constexpr int DY = 7;    // dy panel [t][p], then dĉ [t][n]
  static constexpr int HT = 8;    // hᵀ panel [p][n], then db̂ [s][n]
  static constexpr int DH = 9;    // dh panel [n][p]
  static constexpr int TILES = 10;
  // then: sTot [4][64], the bonus sums' halves [2][64], dsu, Σ_p h⊙dh, Lc,
  // e^{Lc}, u [64] each
  static constexpr int FLOATS = TILES * TILE + 256 + 128 + 5 * 64;
};

__global__ void __launch_bounds__(THREADS, 1)
    chunk_grad_kernel(const SsdBwdArgs a, const void* __restrict__ d,
                      const void* __restrict__ b, const void* __restrict__ x,
                      const void* __restrict__ c, const float* __restrict__ u,
                      const float* __restrict__ hs,
                      const void* __restrict__ dy,
                      const float* __restrict__ dhs,
                      float* __restrict__ du_part, void* __restrict__ dd,
                      void* __restrict__ db, void* __restrict__ dx,
                      void* __restrict__ dc) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* base = reinterpret_cast<float*>(smem);
  float* sCh = base + BwdSmem::CH * TILE;
  float* sBh = base + BwdSmem::BH * TILE;
  float* sBt = base + BwdSmem::BT * TILE;
  float* sL = base + BwdSmem::L * TILE;
  float* sS = base + BwdSmem::SC * TILE;
  float* sBhT = base + BwdSmem::BHT * TILE;
  float* sXt = base + BwdSmem::XT * TILE;
  float* sDy = base + BwdSmem::DY * TILE;
  float* sHt = base + BwdSmem::HT * TILE;
  float* sDh = base + BwdSmem::DH * TILE;
  float* sTot = base + BwdSmem::TILES * TILE;
  float* sSu = sTot + 256;
  float* sDsu = sSu + 128;
  float* sHdh = sDsu + 64;
  float* sLc = sHdh + 64;
  float* sElc = sLc + 64;
  float* sU = sElc + 64;
  float* sDS = sBhT;            // after the scores product
  float* sDbt = sXt;            // after the panels
  float* sDC = sDy;
  float* sDBh = sHt;

  const int N = a.N, P = a.P, ck = a.chunk, T = a.T, H = a.H, nc = T / ck;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = blockIdx.x, h = blockIdx.y, bb = blockIdx.z;
  const int t0 = g * ck;
  const int r0 = ty * 4, c0 = tx * 4;
  const int tq = warp >> 1, n = (warp & 1) * 32 + lane;
  const int sl = (ck + 3) >> 2;
  const int n4 = (N + 3) & ~3, ck4 = (ck + 3) & ~3;
  const size_t cstate = ((size_t(bb) * nc + g) * H + h) * N * P;
  // element offsets of step t's row of this (batch, head), width N or P
  auto rowN = [&](int t) { return ((size_t(bb) * T + t0 + t) * H + h) * N; };
  auto rowP = [&](int t) { return ((size_t(bb) * T + t0 + t) * H + h) * P; };
  auto keep = [&](int t, int s) {
    return t < ck && s < ck && (a.include_current ? s <= t : s < t);
  };

  for (int e = tid; e < BwdSmem::TILES * TILE / 4; e += THREADS)
    reinterpret_cast<float4*>(base)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (tid < 64) {
    sDsu[tid] = 0.f;
    sHdh[tid] = 0.f;
    sU[tid] = a.has_u && tid < N ? u[size_t(h) * N + tid] : 0.f;
  }
  __syncthreads();

  // ---- the forward's intermediates: L, ĉ, b̂ (both ways), b̃, bonus sums
  {
    float Lr[16], bv[16], cv[16];
    float before, lc;
    log_decay_scan(a, d, b, a.b_bf16, c, a.c_bf16, rowN(0), tq, n, sl, Lr,
                   bv, cv, sTot, &before, &lc);
    const float uu = sU[n];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      if (i < sl) {
        const int t = tq * sl + i;
        const float Lt = before + Lr[i];
        const float einv = expf(-Lt);
        sL[t * S + n] = Lt;
        sCh[t * S + n] = cv[i] * expf(Lt);
        if (a.has_u) {
          float su = cv[i] * uu * bv[i];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            su += __shfl_xor_sync(0xffffffffu, su, off);
          if (lane == 0) sSu[(warp & 1) * C + t] = su;
        }
        const float bh = bv[i] * einv;
        sBh[t * S + n] = bh;
        sBhT[n * S + t] = bh;
        sBt[t * S + n] = bv[i] * expf(lc - Lt);
      }
    }
    if (tq == 0) {
      sLc[n] = lc;
      sElc[n] = expf(lc);
    }
  }
  __syncthreads();

  // ---- the masked scores S = mask(ĉ·b̂ᵀ)
  {
    float acc[4][4] = {};
    prod_rows(acc, sCh, sBhT, n4, r0, c0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = r0 + i;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = keep(t, c0 + j) ? acc[i][j] : 0.f;
      *reinterpret_cast<float4*>(sS + t * S + c0) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  }

  // ---- the products over the value axis, 64 columns a panel
  float gS[4][4] = {}, gCy[4][4] = {}, gBtT[4][4] = {};
  for (int p0 = 0; p0 < P; p0 += 64) {
    const int pw = min(64, P - p0), pw4 = (pw + 3) & ~3;
    __syncthreads();            // the scores are stored; the last panel read
    for (int e = tid; e < 64 * 64; e += THREADS) {
      const int r = e >> 6, q = e & 63;
      const bool in_t = r < ck && q < pw, in_n = r < N && q < pw;
      sXt[q * S + r] = in_t ? load(x, rowP(r) + p0 + q, a.x_bf16) : 0.f;
      sDy[r * S + q] = in_t ? load(dy, rowP(r) + p0 + q, a.x_bf16) : 0.f;
      sHt[q * S + r] = in_n ? hs[cstate + r * P + p0 + q] : 0.f;
      sDh[r * S + q] = in_n ? dhs[cstate + r * P + p0 + q] : 0.f;
    }
    __syncthreads();
    prod_rows(gS, sDy, sXt, pw4, r0, c0);     // dy·xᵀ     [t][s]
    prod_rows(gCy, sDy, sHt, pw4, r0, c0);    // dy·hᵀ     [t][n]
    prod_rows(gBtT, sDh, sXt, pw4, r0, c0);   // dh·xᵀ     [n][s]
    // dx = Sᵀ·dy + b̃·dh (+ su·dy), this panel's columns
    float gx[4][4] = {};
    prod_cols<4>(gx, sS, S, sDy, S, ck, r0, c0);
    prod_rows(gx, sBt, sDh, n4, r0, c0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = r0 + i;
      if (s >= ck) continue;
      const float su = a.has_u ? sSu[s] + sSu[C + s] : 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = c0 + j;
        if (p >= pw) continue;
        float v = gx[i][j];
        if (a.has_u) v = v + su * sDy[s * S + p];
        store(dx, rowP(s) + p0 + p, v, a.x_bf16);
      }
    }
    // dsu = Σ_p dy⊙x by step, Σ_p h⊙dh by state row
    if (a.has_u && tid < ck) {
      float acc = 0.f;
      for (int p = 0; p < pw; ++p)
        acc = acc + sDy[tid * S + p] * sXt[p * S + tid];
      sDsu[tid] = sDsu[tid] + acc;
    }
    if (tid >= 64 && tid - 64 < N) {
      const int nn = tid - 64;
      float acc = 0.f;
      for (int p = 0; p < pw; ++p)
        acc = acc + sHt[p * S + nn] * sDh[nn * S + p];
      sHdh[nn] = sHdh[nn] + acc;
    }
  }
  __syncthreads();              // the panels are read

  // ---- masked dS and db̃ᵀ to shared memory, then dĉ and db̂
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = r0 + i;
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = keep(t, c0 + j) ? gS[i][j] : 0.f;
    *reinterpret_cast<float4*>(sDS + t * S + c0) =
        make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(sDbt + t * S + c0) =
        make_float4(gBtT[i][0], gBtT[i][1], gBtT[i][2], gBtT[i][3]);
  }
  __syncthreads();
  {
    float gBh[4][4] = {};
    prod_rows(gCy, sDS, sBh, ck4, r0, c0);          // dĉ = dy·hᵀ + dS·b̂
    prod_cols<4>(gBh, sDS, S, sCh, S, ck, r0, c0);  // db̂ = dSᵀ·ĉ
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + i;
      *reinterpret_cast<float4*>(sDC + r * S + c0) =
          make_float4(gCy[i][0], gCy[i][1], gCy[i][2], gCy[i][3]);
      *reinterpret_cast<float4*>(sDBh + r * S + c0) =
          make_float4(gBh[i][0], gBh[i][1], gBh[i][2], gBh[i][3]);
    }
  }
  __syncthreads();

  // ---- dL, dc and db elementwise; d and du's terms dsu·c·b staged for
  // the walk below, in the dS and dh tiles (free after the products)
  float* sDv = sDS;
  float* sDu = sDh;
  for (int e = tid; e < ck * N; e += THREADS) {
    const int t = e / N, nn = e - t * N;
    const size_t gi = rowN(t) + nn;
    const float Lt = sL[t * S + nn];
    const float dch = sDC[t * S + nn], dbh = sDBh[t * S + nn];
    const float dbt = sDbt[nn * S + t];
    sS[t * S + nn] = dch * sCh[t * S + nn] - dbh * sBh[t * S + nn] -
                     dbt * sBt[t * S + nn];
    float gc = dch * expf(Lt);
    float gb = dbh * expf(-Lt) + dbt * expf(sLc[nn] - Lt);
    if (a.has_u) {
      const float bx = load(b, gi, a.b_bf16), cx = load(c, gi, a.c_bf16);
      const float su = sDsu[t] * sU[nn];
      gc = gc + su * bx;
      gb = gb + su * cx;
      sDu[t * S + nn] = sDsu[t] * cx * bx;
    }
    sDv[t * S + nn] = load(d, gi, a.d_bf16);
    store(dc, gi, gc, a.c_bf16);
    store(db, gi, gb, a.b_bf16);
  }
  __syncthreads();

  // ---- dd: dL summed from the chunk's last step down, one thread a column
  if (tid < N) {
    const int nn = tid;
    float tsum = 0.f;
    for (int t = 0; t < ck; ++t)
      tsum = tsum + sDbt[nn * S + t] * sBt[t * S + nn];
    const float dLc = sHdh[nn] * sElc[nn] + tsum;
    float run = 0.f, dup = 0.f;
    for (int t = ck - 1; t >= 0; --t) {
      run = run + sS[t * S + nn];
      const float dlog = run + dLc;
      const float dv = sDv[t * S + nn];
      store(dd, rowN(t) + nn, dv > 1e-20f ? dlog / dv : 0.f, a.d_bf16);
      if (a.has_u) dup = dup + sDu[t * S + nn];
    }
    if (a.has_u) du_part[((size_t(bb) * nc + g) * H + h) * N + nn] = dup;
  }
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

template <int Q>
cudaError_t launch_state_grad(const SsdBwdArgs& a, const void* d,
                              const void* c, const void* dy, const float* dhT,
                              float* dhs, float* dh0, cudaStream_t st) {
  const int smem = (TILE + 64 * 16 * Q + 256 + 64) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      state_grad_kernel<Q>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  state_grad_kernel<Q><<<dim3(a.H, a.B), THREADS, smem, st>>>(a, d, c, dy, dhT, dhs, dh0);
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
      a->P > 64 ? launch_state_grad<8>(*a, d, c, dy, dhT, dhs, dh0, st)
                : launch_state_grad<4>(*a, d, c, dy, dhT, dhs, dh0, st);
  if (err != cudaSuccess) return int(err);
  const int smem = BwdSmem::FLOATS * 4;
  err = cudaFuncSetAttribute(chunk_grad_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return int(err);
  chunk_grad_kernel<<<dim3(a->T / a->chunk, a->H, a->B), THREADS, smem, st>>>(*a, d, b, x, c, u, hs, dy, dhs, du_part, dd, db, dx, dc);
  err = cudaGetLastError();
  if (err != cudaSuccess || !a->has_u) return int(err);
  du_sum_kernel<<<a->H, 64, 0, st>>>(*a, du_part, du);
  return int(cudaGetLastError());
}
