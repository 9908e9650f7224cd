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
// about 0.82 GB, 0.25 ms at 3.35 TB/s.  The four chunk products are ~30
// GFLOP; this first kernel does them in f32 on the CUDA cores (no tensor
// cores, so no TF32), ~0.45 ms at the 67 TFLOP/s f32 peak, with about one
// shared-memory load per two FMAs and its loads not overlapped with its
// arithmetic, so it sits well above both.
//
// Design.  The TPU kernel's grid (B, H, nChunks) ran the chunk axis in
// order with the [N, P] state in VMEM scratch.  Here one block of 256
// threads owns one (head, batch) and walks the chunks in order inside the
// block, the state in shared memory for the whole sequence: 8 × 112 = 896
// blocks at Zamba2's width, two resident per SM (~100 KB of shared memory
// each).  Per chunk the block stages d, b, c and x (upcast to f32), runs the
// cumsum with one thread per state column while other threads form the
// bonus's row sums, transforms in place, and then does the four products
// with each thread holding a 4 × 4 block of scores or a 4 × 8 block of
// y / state outputs in registers (rows ty + 16·i, columns tx + 16·j of a
// 16 × 16 thread grid).  Shared-memory rows of the [C, N] operands are
// padded to an odd stride so the rows a warp reads fall in distinct banks.
// The chunk length is what the wrapper gives (the Pallas wrapper's rule:
// min(64, T) halved until it divides T), at most 64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

struct SsdArgs {
  int B, T, H, N, P, chunk, include_current, has_u, has_h0;
  int d_bf16, b_bf16, x_bf16, c_bf16;
};

namespace {

constexpr int C = 64;           // largest chunk
constexpr int THREADS = 256;    // 16 × 16
constexpr int MAX_N = 64;
constexpr int MAX_P = 128;
constexpr int PJ = MAX_P / 16;  // output columns per thread

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

// floats of the union holding L, then the scores
__host__ __device__ inline int ls_floats(int ns) {
  return C * (ns > C + 1 ? ns : C + 1);
}

size_t smem_bytes(int n, int p) {
  const int ns = n | 1;
  return sizeof(float) * (size_t(ls_floats(ns)) + 3 * size_t(C) * ns +
                          size_t(C) * p + size_t(n) * p + C + 2 * n);
}

__global__ void __launch_bounds__(THREADS)
    ssd_kernel(const SsdArgs a, const void* __restrict__ d,
               const void* __restrict__ b, const void* __restrict__ x,
               const void* __restrict__ c, const float* __restrict__ u,
               const float* __restrict__ h0, void* __restrict__ y,
               float* __restrict__ hT) {
  extern __shared__ float smem[];
  const int N = a.N, P = a.P, ck = a.chunk, T = a.T, H = a.H;
  const int ns = N | 1;             // odd row stride of the [C, N] operands
  const int ss = C + 1;             // row stride of the scores
  float* sLS = smem;                // [C][ns]: d, then L; then scores [C][ss]
  float* sB = sLS + ls_floats(ns);  // [C][ns]: b, then b̃
  float* sC = sB + C * ns;          // [C][ns]: c, then ĉ
  float* sBh = sC + C * ns;         // [C][ns]: b̂
  float* sX = sBh + C * ns;         // [C][P]
  float* sH = sX + C * P;           // [N][P]
  float* sSu = sH + N * P;          // [C]: Σ_n c·u·b per step
  float* sLc = sSu + C;             // [N]: L at the chunk's last step
  float* sU = sLc + N;              // [N]
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int h = blockIdx.x, bb = blockIdx.y;
  const size_t state0 = (size_t(bb) * H + h) * N * P;

  for (int e = tid; e < N * P; e += THREADS)
    sH[e] = a.has_h0 ? h0[state0 + e] : 0.f;
  if (a.has_u)
    for (int n = tid; n < N; n += THREADS) sU[n] = u[size_t(h) * N + n];

  for (int t0 = 0; t0 < T; t0 += ck) {
    __syncthreads();                // the last chunk is done with every array
    for (int e = tid; e < ck * N; e += THREADS) {
      const int t = e / N, n = e - t * N;
      const size_t gi = ((size_t(bb) * T + t0 + t) * H + h) * N + n;
      sLS[t * ns + n] = load(d, gi, a.d_bf16);
      sB[t * ns + n] = load(b, gi, a.b_bf16);
      sC[t * ns + n] = load(c, gi, a.c_bf16);
    }
    for (int e = tid; e < ck * P; e += THREADS) {
      const int t = e / P, p = e - t * P;
      sX[e] = load(x, ((size_t(bb) * T + t0 + t) * H + h) * P + p, a.x_bf16);
    }
    __syncthreads();

    // the log-decay cumsum, one thread per state column; the bonus's row
    // sums on threads 128 … 128 + ck − 1 meanwhile (N ≤ 64, ck ≤ 64)
    if (tid < N) {
      float run = 0.f;
      for (int t = 0; t < ck; ++t) {
        run = run + logf(fmaxf(sLS[t * ns + tid], 1e-20f));
        sLS[t * ns + tid] = run;
      }
      sLc[tid] = run;
    } else if (a.has_u && tid >= 128 && tid - 128 < ck) {
      const int t = tid - 128;
      float su = 0.f;
      for (int n = 0; n < N; ++n)
        su = su + sC[t * ns + n] * sU[n] * sB[t * ns + n];
      sSu[t] = su;
    }
    __syncthreads();

    for (int e = tid; e < ck * N; e += THREADS) {
      const int t = e / N, n = e - t * N, i = t * ns + n;
      const float L = sLS[i], bv = sB[i];
      sC[i] = sC[i] * expf(L);
      sBh[i] = bv * expf(-L);
      sB[i] = bv * expf(sLc[n] - L);
    }
    __syncthreads();

    // masked intra-chunk scores ĉ·b̂ᵀ, over the L array (no longer read)
    {
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = sC[(ty + 16 * i) * ns + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = sBh[(tx + 16 * j) * ns + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(cv[i], bv[j], s[i][j]);
      }
      // L was last read before the transform's barrier: reuse its array
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int sj = tx + 16 * j;
          const bool keep = t < ck && sj < ck &&
                            (a.include_current ? sj <= t : sj < t);
          sLS[t * ss + sj] = keep ? s[i][j] : 0.f;
        }
      }
    }
    __syncthreads();

    // y = scores·x (+ bonus·x) + ĉ·h
    {
      float yi[4][PJ], ye[4][PJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < PJ; ++j) yi[i][j] = ye[i][j] = 0.f;
      for (int sj = 0; sj < ck; ++sj) {
        float sc[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) sc[i] = sLS[(ty + 16 * i) * ss + sj];
#pragma unroll
        for (int j = 0; j < PJ; ++j) {
          const int p = tx + 16 * j;
          if (p < P) {
            const float xv = sX[sj * P + p];
#pragma unroll
            for (int i = 0; i < 4; ++i) yi[i][j] = fmaf(sc[i], xv, yi[i][j]);
          }
        }
      }
      if (a.has_u) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = ty + 16 * i;
          if (t < ck) {
#pragma unroll
            for (int j = 0; j < PJ; ++j) {
              const int p = tx + 16 * j;
              if (p < P) yi[i][j] = yi[i][j] + sSu[t] * sX[t * P + p];
            }
          }
        }
      }
      for (int n = 0; n < N; ++n) {
        float cv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = sC[(ty + 16 * i) * ns + n];
#pragma unroll
        for (int j = 0; j < PJ; ++j) {
          const int p = tx + 16 * j;
          if (p < P) {
            const float hv = sH[n * P + p];
#pragma unroll
            for (int i = 0; i < 4; ++i) ye[i][j] = fmaf(cv[i], hv, ye[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
        if (t >= ck) continue;
        const size_t base = ((size_t(bb) * T + t0 + t) * H + h) * P;
#pragma unroll
        for (int j = 0; j < PJ; ++j) {
          const int p = tx + 16 * j;
          if (p < P) store(y, base + p, yi[i][j] + ye[i][j], a.x_bf16);
        }
      }
    }
    __syncthreads();                // every read of h is done

    // h ← e^{L_C}·h + b̃ᵀ·x
    {
      float up[4][PJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < PJ; ++j) up[i][j] = 0.f;
      for (int sj = 0; sj < ck; ++sj) {
        float bt[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int n = ty + 16 * i;
          bt[i] = n < N ? sB[sj * ns + n] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < PJ; ++j) {
          const int p = tx + 16 * j;
          if (p < P) {
            const float xv = sX[sj * P + p];
#pragma unroll
            for (int i = 0; i < 4; ++i) up[i][j] = fmaf(bt[i], xv, up[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = ty + 16 * i;
        if (n >= N) continue;
        const float decay = expf(sLc[n]);
#pragma unroll
        for (int j = 0; j < PJ; ++j) {
          const int p = tx + 16 * j;
          if (p < P) sH[n * P + p] = decay * sH[n * P + p] + up[i][j];
        }
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < N * P; e += THREADS) hT[state0 + e] = sH[e];
}

}  // namespace

extern "C" int ssd_launch(const SsdArgs* a, const void* d, const void* b,
                          const void* x, const void* c, const float* u,
                          const float* h0, void* y, float* hT, void* stream) {
  if (a->B < 1 || a->T < 1 || a->H < 1 || a->N < 1 || a->N > MAX_N ||
      a->P < 1 || a->P > MAX_P || a->chunk < 1 || a->chunk > C ||
      a->T % a->chunk || (a->has_u && !u) || (a->has_h0 && !h0) ||
      a->H > 65535 || a->B > 65535)
    return int(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(a->N, a->P);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  ssd_kernel<<<dim3(a->H, a->B), THREADS, smem,
               static_cast<cudaStream_t>(stream)>>>(*a, d, b, x, c, u, h0, y,
                                                    hT);
  return int(cudaGetLastError());
}
