// Flash attention backward on Hopper (sm_90a), hand-written CUDA C++.
//
// The gradient of `flash_attention` (flash_attention.cu and
// flash_attention_tc.cu are its forward).  The TPU kernel
// `repro.kernels.flash_attention.flash_attention` has no VJP: the JAX
// package trains through `repro.kernels.ref.make_flash`, a jax.custom_vjp
// whose bwd (src/repro/kernels/ref.py:201) this kernel computes.  For q
// [B, Tq, H, d], k [B, Tk, KV, d], v [B, Tk, KV, dv] (f32 or bf16; k and v
// of one type), the forward's f32 output o [B, Tq, H, dv], its row
// statistics m, l [B, H, Tq] and the output's gradient do (q's type):
//
//     D_i  = Σ_c do_ic · o_ic
//     s_ij = (q_i · k_j)·scale, or NEG_INF = −1e30 where the mask drops it
//     p_ij = exp(s_ij − m_i) / max(l_i, 1e-20)
//     ds_ij = p_ij · (do_i · v_j − D_i) · scale
//     dq_i = Σ_j ds_ij k_j,   dk_j = Σ_i ds_ij q_i,   dv_j = Σ_i p_ij do_i
//
// with dk and dv summed over the H / KV query heads of each key/value head
// (GQA, MQA).  As in the reference, a masked score is NEG_INF and not −inf:
// a row that a window leaves without keys has m = NEG_INF, so each of its
// keys gets p = 1 / l (the forward gave it the mean of V), and ds is not
// masked.  The plain version is `flash_attention_backward_reference` in
// flash_attention.py.
//
// What bounds it.  Each input read once and each gradient written once:
// at Gemma-2B's training shape [8, 1,024, 8 on 1, 256] in bf16 about
// 0.17 GB, 0.05 ms at 3.35 TB/s.  The causal half of the five products
// (s, do·vᵀ, dv, dk, dq) is ~86 GFLOP, 0.09 ms on the bf16 tensor cores,
// 1.3 ms at the 67 TFLOP/s f32 peak of the CUDA cores this kernel uses.
// Two passes recompute s and do·vᵀ (seven products' work), and operands
// come from shared memory at about one load per two FMAs: it is bound by
// shared-memory loads and, at d = 256, by one block of 8 warps per SM.  A
// tensor-core and TMA redesign is later work (ROADMAP queue 2).
//
// Design: three launches, no float atomics, so the gradients are the same
// bits from run to run.
//   * delta_kernel: D, one warp per (b, position, head).
//   * dkdv_kernel: one block of 256 threads per (K tile of 32 keys, KV
//     head, b).  K and V stay in shared memory; the block walks the group's
//     g query heads and, per head, the Q tiles of 64 rows the mask keeps
//     (causal and window skip the rest), staging Q and do (bf16 upcast to
//     f32).  Thread (ty, tx) of a 16×16 grid computes a 4×2 block of s and
//     do·vᵀ (rows ty + 16i, keys tx + 16j), writes p and ds to shared
//     memory, then accumulates dk and dv for keys ty, ty + 16 and columns
//     tx + 16c in registers; both are written once.
//   * dq_kernel: one block per (Q tile of 64 rows, head, b), walking the
//     K tiles the mask keeps; dq for rows ty + 16i in registers.
//   * The grid order (`grid`): with fewer (b, head) groups than SMs the
//     tile is the slowest index, heavy tiles first (Gemma-2B's MQA: 8
//     groups); with more, the fastest, for L2 locality.
// A (Q tile, K tile) pair is skipped only when no row of the Q tile keeps
// a key of the K tile and no row of the Q tile keeps no key at all (then
// every p of the pair is exactly 0).  Rows past Tq and keys past Tk get
// p = ds = 0.  Shared memory: (64 + 32)·(d + 1 + dv + 1) + 2·64·33 + 3·64
// floats, 215,040 bytes at d = dv = 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

struct FlashBwdArgs {
  int B, Tq, Tk, H, KV, d, dv, causal, window, q_offset, q_bf16, kv_bf16;
  float scale;
};

namespace {

constexpr int BQ = 64;          // query rows per tile
constexpr int BK = 32;          // keys per tile
constexpr int THREADS = 256;    // 16 × 16
constexpr int MAX_DIM = 256;
constexpr float NEG_INF = -1e30f;

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

size_t smem_bytes(int d, int dv) {
  return sizeof(float) * (size_t(BQ + BK) * (d + 1 + dv + 1) +
                          size_t(2) * BQ * (BK + 1) + 3 * BQ);
}

// n rows from r0 of the [B, T, heads, w] tensor src at (b, head) into
// s[n][ld] as f32, zeros past T
__device__ __forceinline__ void stage(float* s, int ld, const void* src,
                                      int bf16, int b, int T, int heads,
                                      int head, int w, int r0, int n) {
  for (int e = threadIdx.x; e < n * w; e += THREADS) {
    const int i = e / w, c = e - i * w;
    s[i * ld + c] =
        r0 + i < T
            ? load(src, ((size_t(b) * T + r0 + i) * heads + head) * w + c,
                   bf16)
            : 0.f;
  }
}

// whether the pair (Q tile from row q0, K tile from key k0) can hold a
// nonzero p: some row keeps a key of the tile, or some row keeps no key at
// all (the mask is monotone in the position: only the first row can lose
// every key to causality, only the last to the window)
__device__ __forceinline__ bool pair_live(const FlashBwdArgs& a, int q0,
                                          int k0) {
  const int qlo = a.q_offset + q0,
            qhi = qlo + min(BQ, a.Tq - q0) - 1;
  if ((a.causal && qlo < 0) || (a.window && qhi - a.window + 1 > a.Tk - 1))
    return true;
  const int lo = a.window ? max(0, qlo - a.window + 1) : 0;
  const int hi = a.causal ? min(a.Tk - 1, qhi) : a.Tk - 1;
  return k0 <= hi && k0 + BK - 1 >= lo;
}

// p (where sP) and ds of one (Q tile, K tile) pair into shared memory:
// thread (ty, tx) computes rows ty + 16i and keys tx + 16j
__device__ __forceinline__ void scores(const FlashBwdArgs& a, int q0, int k0,
                                       const float* sQ, const float* sO,
                                       const float* sK, const float* sV,
                                       const float* sM, const float* sL,
                                       const float* sD, float* sP,
                                       float* sS) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int ldq = a.d + 1, ldv = a.dv + 1;
  float s[4][2], dp[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) s[i][j] = dp[i][j] = 0.f;
  for (int c = 0; c < a.d; ++c) {
    float x[4], y[2];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = sQ[(ty + 16 * i) * ldq + c];
#pragma unroll
    for (int j = 0; j < 2; ++j) y[j] = sK[(tx + 16 * j) * ldq + c];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) s[i][j] = fmaf(x[i], y[j], s[i][j]);
  }
  for (int c = 0; c < a.dv; ++c) {
    float x[4], y[2];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = sO[(ty + 16 * i) * ldv + c];
#pragma unroll
    for (int j = 0; j < 2; ++j) y[j] = sV[(tx + 16 * j) * ldv + c];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) dp[i][j] = fmaf(x[i], y[j], dp[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty + 16 * i, qp = a.q_offset + q0 + row;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int key = tx + 16 * j, kp = k0 + key;
      float p = 0.f, ds = 0.f;
      if (q0 + row < a.Tq && kp < a.Tk) {
        const bool keep = (!a.causal || kp <= qp) &&
                          (!a.window || kp > qp - a.window);
        const float x = keep ? s[i][j] * a.scale : NEG_INF;
        p = expf(x - sM[row]) / fmaxf(sL[row], 1e-20f);
        ds = p * (dp[i][j] - sD[row]) * a.scale;
      }
      if (sP) sP[row * (BK + 1) + key] = p;
      sS[row * (BK + 1) + key] = ds;
    }
  }
}

// m, l and D of rows q0 … q0 + BQ − 1 of head h (rows past Tq: 0, 1, 0)
__device__ __forceinline__ void stage_rows(const FlashBwdArgs& a, int b,
                                           int h, int q0, const float* m,
                                           const float* l, const float* dl,
                                           float* sM, float* sL, float* sD) {
  for (int i = threadIdx.x; i < BQ; i += THREADS) {
    const bool in = q0 + i < a.Tq;
    const size_t r = (size_t(b) * a.H + h) * a.Tq + q0 + i;
    sM[i] = in ? m[r] : 0.f;
    sL[i] = in ? l[r] : 1.f;
    sD[i] = in ? dl[r] : 0.f;
  }
}

__global__ void __launch_bounds__(THREADS)
    delta_kernel(const FlashBwdArgs a, const void* __restrict__ dout,
                 const float* __restrict__ o, float* __restrict__ delta) {
  const size_t row = size_t(blockIdx.x) * (THREADS / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= size_t(a.B) * a.Tq * a.H) return;
  float s = 0.f;
  for (int c = lane; c < a.dv; c += 32)
    s = fmaf(load(dout, row * a.dv + c, a.q_bf16), o[row * a.dv + c], s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {
    const size_t h = row % a.H, t = row / a.H, i = t % a.Tq, b = t / a.Tq;
    delta[(b * a.H + h) * a.Tq + i] = s;
  }
}

// (tile, head, batch) of this block.  Blocks start roughly in index order,
// x fastest.  tile_major: the tile is the slowest index, so the heavy
// tiles of every (batch, head) group start first; else the fastest, so
// the blocks running at once share few groups' tiles in L2 (see launch)
__device__ __forceinline__ void coords(bool tile_major, int& tile,
                                       int& head, int& b) {
  tile = tile_major ? blockIdx.z : blockIdx.x;
  b = tile_major ? blockIdx.x : blockIdx.z;
  head = blockIdx.y;
}

template <int NC>
__global__ void __launch_bounds__(THREADS)
    dkdv_kernel(const FlashBwdArgs a, bool tile_major,
                const void* __restrict__ q,
                const void* __restrict__ k, const void* __restrict__ v,
                const float* __restrict__ m, const float* __restrict__ l,
                const float* __restrict__ delta,
                const void* __restrict__ dout, void* __restrict__ dk,
                void* __restrict__ dv) {
  extern __shared__ float smem[];
  const int d = a.d, w = a.dv, ldq = d + 1, ldv = w + 1;
  float* sQ = smem;                   // [BQ][d + 1]
  float* sO = sQ + BQ * ldq;          // do: [BQ][dv + 1]
  float* sK = sO + BQ * ldv;          // [BK][d + 1]
  float* sV = sK + BK * ldq;          // [BK][dv + 1]
  float* sP = sV + BK * ldv;          // [BQ][BK + 1]
  float* sS = sP + BQ * (BK + 1);     // ds: [BQ][BK + 1]
  float* sM = sS + BQ * (BK + 1);     // [BQ] each
  float* sL = sM + BQ;
  float* sD = sL + BQ;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  int kt, kvh, b;
  coords(tile_major, kt, kvh, b);      // the first K tiles hold the most
  const int k0 = kt * BK;              // kept pairs under a causal mask
  const int g = a.H / a.KV;

  stage(sK, ldq, k, a.kv_bf16, b, a.Tk, a.KV, kvh, d, k0, BK);
  stage(sV, ldv, v, a.kv_bf16, b, a.Tk, a.KV, kvh, w, k0, BK);
  float acc_k[2][NC], acc_v[2][NC];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc_k[j][c] = acc_v[j][c] = 0.f;

  for (int hh = 0; hh < g; ++hh) {
    const int h = kvh * g + hh;
    for (int q0 = 0; q0 < a.Tq; q0 += BQ) {
      if (!pair_live(a, q0, k0)) continue;
      __syncthreads();               // the last pair's tiles are read
      stage(sQ, ldq, q, a.q_bf16, b, a.Tq, a.H, h, d, q0, BQ);
      stage(sO, ldv, dout, a.q_bf16, b, a.Tq, a.H, h, w, q0, BQ);
      stage_rows(a, b, h, q0, m, l, delta, sM, sL, sD);
      __syncthreads();
      scores(a, q0, k0, sQ, sO, sK, sV, sM, sL, sD, sP, sS);
      __syncthreads();
      for (int i = 0; i < BQ; ++i) {
        const float p0 = sP[i * (BK + 1) + ty], p1 = sP[i * (BK + 1) + ty + 16];
        const float s0 = sS[i * (BK + 1) + ty], s1 = sS[i * (BK + 1) + ty + 16];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int col = tx + 16 * c;
          if (col < w) {
            const float x = sO[i * ldv + col];
            acc_v[0][c] = fmaf(p0, x, acc_v[0][c]);
            acc_v[1][c] = fmaf(p1, x, acc_v[1][c]);
          }
          if (col < d) {
            const float x = sQ[i * ldq + col];
            acc_k[0][c] = fmaf(s0, x, acc_k[0][c]);
            acc_k[1][c] = fmaf(s1, x, acc_k[1][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int key = k0 + ty + 16 * j;
    if (key >= a.Tk) continue;
    const size_t row = size_t(b) * a.Tk + key;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < d)
        store(dk, (row * a.KV + kvh) * d + col, acc_k[j][c], a.kv_bf16);
      if (col < w)
        store(dv, (row * a.KV + kvh) * w + col, acc_v[j][c], a.kv_bf16);
    }
  }
}

template <int NC>
__global__ void __launch_bounds__(THREADS)
    dq_kernel(const FlashBwdArgs a, bool tile_major,
              const void* __restrict__ q,
              const void* __restrict__ k, const void* __restrict__ v,
              const float* __restrict__ m, const float* __restrict__ l,
              const float* __restrict__ delta, const void* __restrict__ dout,
              void* __restrict__ dq) {
  extern __shared__ float smem[];
  const int d = a.d, w = a.dv, ldq = d + 1, ldv = w + 1;
  float* sQ = smem;
  float* sO = sQ + BQ * ldq;
  float* sK = sO + BQ * ldv;
  float* sV = sK + BK * ldq;
  float* sS = sV + BK * ldv + BQ * (BK + 1);
  float* sM = sS + BQ * (BK + 1);
  float* sL = sM + BQ;
  float* sD = sL + BQ;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  int qt, h, b;
  coords(tile_major, qt, h, b);
  // tile-major: the last Q tiles (the most kept pairs) first
  const int q0 = (tile_major ? (a.Tq + BQ - 1) / BQ - 1 - qt : qt) * BQ;
  const int kvh = h / (a.H / a.KV);

  stage(sQ, ldq, q, a.q_bf16, b, a.Tq, a.H, h, d, q0, BQ);
  stage(sO, ldv, dout, a.q_bf16, b, a.Tq, a.H, h, w, q0, BQ);
  stage_rows(a, b, h, q0, m, l, delta, sM, sL, sD);
  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;

  for (int k0 = 0; k0 < a.Tk; k0 += BK) {
    if (!pair_live(a, q0, k0)) continue;
    __syncthreads();                 // the last pair's K, V and ds are read
    stage(sK, ldq, k, a.kv_bf16, b, a.Tk, a.KV, kvh, d, k0, BK);
    stage(sV, ldv, v, a.kv_bf16, b, a.Tk, a.KV, kvh, w, k0, BK);
    __syncthreads();
    scores(a, q0, k0, sQ, sO, sK, sV, sM, sL, sD, nullptr, sS);
    __syncthreads();
    for (int j = 0; j < BK; ++j) {
      float s[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i] = sS[(ty + 16 * i) * (BK + 1) + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = tx + 16 * c;
        if (col < d) {
          const float x = sK[j * ldq + col];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(s[i], x, acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= a.Tq) continue;
    const size_t base = ((size_t(b) * a.Tq + row) * a.H + h) * d;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < d) store(dq, base + col, acc[i][c], a.q_bf16);
    }
  }
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
// more, the tile is the fastest, so a wave keeps a few groups' Q / dO or
// K / V in L2.  (H100: the tile-major order took Gemma-2B's backward from
// 15.7 to 12.2 ms, and MLA's 128-head one from 32.2 to 37.7 ms.)
dim3 grid(int tiles, int heads, int B, bool& tile_major) {
  tile_major = size_t(B) * heads < size_t(sm_count());
  return tile_major ? dim3(B, heads, tiles) : dim3(tiles, heads, B);
}

template <int NC>
int launch(const FlashBwdArgs& a, const void* q, const void* k,
           const void* v, const float* o, const float* m, const float* l,
           const void* dout, float* delta, void* dq, void* dk, void* dv,
           cudaStream_t st) {
  const size_t smem = smem_bytes(a.d, a.dv);
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dq_kernel<NC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(smem));
  if (err != cudaSuccess) return int(err);
  const size_t rows = size_t(a.B) * a.Tq * a.H;
  const int per = THREADS / 32;
  delta_kernel<<<unsigned((rows + per - 1) / per), THREADS, 0, st>>>(
      a, dout, o, delta);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  bool tm;
  const dim3 gk = grid((a.Tk + BK - 1) / BK, a.KV, a.B, tm);
  dkdv_kernel<NC><<<gk, THREADS, smem, st>>>(a, tm, q, k, v, m, l, delta,
                                             dout, dk, dv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const dim3 gq = grid((a.Tq + BQ - 1) / BQ, a.H, a.B, tm);
  dq_kernel<NC><<<gq, THREADS, smem, st>>>(a, tm, q, k, v, m, l, delta,
                                           dout, dq);
  return int(cudaGetLastError());
}

}  // namespace

// q, k, v, do, dq, dk, dv contiguous in the layouts above (do and dq in
// q's type, dk and dv in k's); o [B, Tq, H, dv], m, l [B, H, Tq] f32;
// delta [B, H, Tq] f32 scratch.  Returns a cudaError_t:
// cudaErrorInvalidValue for arguments it does not take.
extern "C" int flash_attention_bwd_launch(
    const FlashBwdArgs* a, const void* q, const void* k, const void* v,
    const float* o, const float* m, const float* l, const void* dout,
    float* delta, void* dq, void* dk, void* dv, void* stream) {
  if (a->B < 1 || a->Tq < 1 || a->Tk < 1 || a->H < 1 || a->KV < 1 ||
      a->H % a->KV || a->d < 1 || a->d > MAX_DIM || a->dv < 1 ||
      a->dv > MAX_DIM || a->window < 0 || a->H > 65535 || a->B > 65535 ||
      (a->Tk + BK - 1) / BK > 65535 || (a->Tq + BQ - 1) / BQ > 65535)
    return int(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int w = a->d > a->dv ? a->d : a->dv;
  if (w <= 64) return launch<4>(*a, q, k, v, o, m, l, dout, delta, dq, dk, dv, st);
  if (w <= 128) return launch<8>(*a, q, k, v, o, m, l, dout, delta, dq, dk, dv, st);
  if (w <= 192) return launch<12>(*a, q, k, v, o, m, l, dout, delta, dq, dk, dv, st);
  return launch<16>(*a, q, k, v, o, m, l, dout, delta, dq, dk, dv, st);
}
