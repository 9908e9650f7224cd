// Flash attention forward on Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel `repro.kernels.flash_attention.flash_attention`
// (Pallas body `_kernel`, src/repro/kernels/flash_attention.py).  For
// q [B, Tq, H, d], k [B, Tk, KV, d], v [B, Tk, KV, dv] (f32 or bf16; k and v
// of one type) and out [B, Tq, H, dv] in q's type:
//
//     s[i, j] = (q_i · k_j)·scale, or NEG_INF = −1e30 where the causal /
//               sliding-window mask drops (j, i) (positions i + q_offset, j)
//     out_i   = Σ_j softmax_j(s[i, ·]) v_j, normalised by max(l, 1e-20)
//
// with query head h reading key/value head h / (H / KV) (GQA, MQA).  The
// plain version is `flash_attention_reference` in flash_attention.py.
//
// What bounds it.  Each input byte read once and the output written once:
// at Zamba2-7B's prefill [8, 1,024, 32, 112] bf16 about 235 MB, 0.07 ms at
// 3.35 TB/s; the causal half of the score and value products is ~64 GFLOP,
// also ~0.07 ms on the bf16 tensor cores.  This first kernel does the
// products in f32 on the CUDA cores (no tensor cores, so no TF32), where the
// same work takes ~1 ms at the 67 TFLOP/s f32 peak, and with about one
// shared-memory load per two FMAs it is bound by operand loads well above
// that.
//
// Design.  The TPU kernel's grid (B, H, nQ, nKV) ran the KV axis in order on
// one core with (m, l, acc) in VMEM scratch.  Here one block of 256 threads
// owns one (Q tile of 64 rows, head, batch) and loops over the KV tiles of
// 64 keys inside the block.  The Q tile stays in shared memory; each KV tile
// is staged into shared memory (bf16 upcast to f32 on load).  Thread (ty,
// tx) of a 16×16 grid holds a 4×4 block of scores (rows ty + 16·i, keys
// tx + 16·j) and, for the same rows, up to 16 columns of the f32
// accumulator (tx + 16·c) in registers.  The row max and row sum reduce
// over the 16 lanes that share a row with warp shuffles, so every lane of a
// row holds the same running (m, l).  Probabilities go through shared
// memory to the value product.  Tiles the mask leaves empty for every row
// of the Q tile are skipped — exact, since a fully masked tile contributes
// e^(−1e30 − m) = 0 after any kept key and is wiped by the correction
// e^(−1e30 − m) = 0 before one — unless some row of the tile has no kept
// key at all (a window can empty it): then every tile runs, so that row
// gets the reference's mean of V.  Keys past Tk (the ragged last tile) are
// −inf and weigh exactly 0; rows past Tq are computed and not stored.  The
// Pallas wrapper halved its blocks until they divided T instead.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

struct FlashArgs {
  int B, Tq, Tk, H, KV, d, dv, causal, window, q_offset, q_bf16, kv_bf16;
  float scale;
};

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per tile
constexpr int THREADS = 256;    // 16 × 16
constexpr int MAX_DIM = 256;
constexpr int MAXC = MAX_DIM / 16;   // accumulator columns per thread
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
  return sizeof(float) * (size_t(BQ + BK) * (d + 1) + size_t(BK) * dv +
                          size_t(BQ) * (BK + 1));
}

__global__ void __launch_bounds__(THREADS)
    flash_kernel(const FlashArgs a, const void* __restrict__ q,
                 const void* __restrict__ k, const void* __restrict__ v,
                 void* __restrict__ out) {
  extern __shared__ float smem[];
  const int d = a.d, dv = a.dv, qs = d + 1;
  float* sQ = smem;                  // [BQ][d + 1]
  float* sK = sQ + BQ * qs;          // [BK][d + 1]
  float* sV = sK + BK * qs;          // [BK][dv]
  float* sP = sV + BK * dv;          // [BQ][BK + 1]
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.KV);
  const int rows = min(BQ, a.Tq - q0);

  for (int e = tid; e < BQ * d; e += THREADS) {
    const int i = e / d, c = e - i * d;
    sQ[i * qs + c] =
        i < rows ? load(q, ((size_t(b) * a.Tq + q0 + i) * a.H + h) * d + c,
                        a.q_bf16)
                 : 0.f;
  }

  // the KV tiles that hold a kept key for some row of this Q tile — all of
  // them if a row has none (see the header)
  int kb_lo = 0, kb_hi = (a.Tk + BK - 1) / BK;
  bool empty_row = false;
  for (int i = 0; i < rows; ++i) {
    const int qp = a.q_offset + q0 + i;
    const int lo = a.window ? max(0, qp - a.window + 1) : 0;
    const int hi = a.causal ? min(a.Tk - 1, qp) : a.Tk - 1;
    empty_row |= lo > hi;
  }
  if (!empty_row) {
    const int qlo = a.q_offset + q0, qhi = qlo + rows - 1;
    kb_lo = (a.window ? max(0, qlo - a.window + 1) : 0) / BK;
    kb_hi = (a.causal ? min(a.Tk - 1, qhi) : a.Tk - 1) / BK + 1;
  }

  float m[4], l[4], acc[4][MAXC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < MAXC; ++c) acc[i][c] = 0.f;
  }

  for (int kb = kb_lo; kb < kb_hi; ++kb) {
    const int k0 = kb * BK, cols = min(BK, a.Tk - k0);
    __syncthreads();                 // the last tile's sK, sV, sP are read
    for (int e = tid; e < BK * d; e += THREADS) {
      const int j = e / d, c = e - j * d;
      sK[j * qs + c] =
          j < cols ? load(k, ((size_t(b) * a.Tk + k0 + j) * a.KV + kvh) * d + c,
                          a.kv_bf16)
                   : 0.f;
    }
    for (int e = tid; e < BK * dv; e += THREADS) {
      const int j = e / dv, c = e - j * dv;
      sV[e] = j < cols ? load(v, ((size_t(b) * a.Tk + k0 + j) * a.KV + kvh) *
                                         dv + c,
                              a.kv_bf16)
                       : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int c = 0; c < d; ++c) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty + 16 * i) * qs + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(tx + 16 * j) * qs + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // online softmax over the tile, row by row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = a.q_offset + q0 + ty + 16 * i;
      float rmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int jj = tx + 16 * j, kp = k0 + jj;
        float x;
        if (jj >= cols) {
          x = -INFINITY;
        } else {
          const bool keep = (!a.causal || kp <= qp) &&
                            (!a.window || kp > qp - a.window);
          x = keep ? s[i][j] * a.scale : NEG_INF;
        }
        s[i][j] = x;
        rmax = fmaxf(rmax, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      const float corr = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        psum += s[i][j];
        sP[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l[i] = l[i] * corr + psum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < MAXC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    for (int j = 0; j < cols; ++j) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sP[(ty + 16 * i) * (BK + 1) + j];
#pragma unroll
      for (int c = 0; c < MAXC; ++c) {
        const int col = tx + 16 * c;
        if (col < dv) {
          const float vv = sV[j * dv + col];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty + 16 * i;
    if (row >= rows) continue;
    const float norm = fmaxf(l[i], 1e-20f);
    const size_t base = ((size_t(b) * a.Tq + q0 + row) * a.H + h) * dv;
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      const int col = tx + 16 * c;
      if (col < dv) store(out, base + col, acc[i][c] / norm, a.q_bf16);
    }
  }
}

}  // namespace

extern "C" int flash_attention_launch(const FlashArgs* a, const void* q,
                                      const void* k, const void* v,
                                      void* out, void* stream) {
  if (a->B < 1 || a->Tq < 1 || a->Tk < 1 || a->H < 1 || a->KV < 1 ||
      a->H % a->KV || a->d < 1 || a->d > MAX_DIM || a->dv < 1 ||
      a->dv > MAX_DIM || a->window < 0 || a->H > 65535 || a->B > 65535)
    return int(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(a->d, a->dv);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((a->Tq + BQ - 1) / BQ, a->H, a->B);
  flash_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      *a, q, k, v, out);
  return int(cudaGetLastError());
}
