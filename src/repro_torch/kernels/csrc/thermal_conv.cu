// Γ-coupled pole-bank thermal trace on Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel `repro.kernels.thermal_conv.thermal_conv` (Pallas
// body `_kernel`, src/repro/kernels/thermal_conv.py).  For a [T, N] power
// stream P, a row-major Γ [N, N] and an n-pole bank (a_k, c_k = (1 − a_k)·G_k):
//
//     p_eff[t, i] = Σ_j Γ[i, j]·P[t, j]
//     s[i, k]    ← a_k·s[i, k] + c_k·p_eff[t, i]
//     dts[t, i]  = Σ_k s[i, k]
//
// with the pole state s read from state0 [N, n_poles] and written back at the
// end.  The plain version is `thermal_conv_reference` in thermal_conv.py.
//
// What bounds it.  Every input byte is read once and every output written
// once: 8·T·N bytes, 0.37 GB at 512 tiles × 90,000 steps — 0.11 ms at
// 3.35 TB/s.  Γ·P counted by Γ's non-zeros is below that; counted dense it
// is 2·N²·T = 47 GFLOP, 0.70 ms at 67 TFLOP/s f32.  This first kernel does
// the dense product on the CUDA cores and is bound by its shared-memory
// operand loads (about one load per FMA), by the SMs it can fill (N/8
// blocks) and by the block's serial IIR between chunks.
//
// Design.  Γ·P does not depend on the pole state and each tile's IIR reads
// only its own p_eff column, so blocks own disjoint sets of TB = 8 tiles and
// need no grid-wide sync.  A block keeps its Γ rows in shared memory for the
// whole run, walks time in chunks of CK = 256 steps, stages P for the chunk
// JK = 64 source tiles at a time — asynchronously (cp.async, 16 bytes a
// copy when rows allow), double buffered, so the next block streams in
// while this one is multiplied — and forms p_eff with one FMA per (i, j) in
// source order j = 0 … N−1 — the order of the plain version's
// `apply_coupling`, so the two agree bit for bit (f32 throughout, no
// tensor cores, so no TF32).  Each thread accumulates one tile at R = 8
// steps (strided by 32); then the block's first TB threads run the IIR over
// the chunk, 8 steps per unrolled group, writing ΔT back into shared memory
// for the whole block to store, with
// separately rounded multiplies and adds, as the plain version's separate
// tensor ops do.  Ragged T and N are masked in place: no padding of the
// operands, no chunk that must divide T.

#include <cuda_runtime.h>

#define MAX_POLES 8

struct ThermalConvConsts {
  int T;          // steps
  int n;          // tiles
  int n_poles;
  float decay[MAX_POLES];   // a_k
  float coef[MAX_POLES];    // (1 − a_k)·G_k, one f32 product
};

namespace {

constexpr int TB = 8;               // tiles per block
constexpr int THREADS = 256;
constexpr int TG = THREADS / TB;    // time groups per block
constexpr int R = 8;                // steps accumulated per thread
constexpr int CK = TG * R;          // steps per chunk
constexpr int JK = 64;              // source tiles staged at a time
constexpr int PS = JK + 4;          // row stride of the staged P: 16-B
                                    // aligned rows, and with a thread's
                                    // steps strided by TG the 4 step rows
                                    // a warp reads sit in distinct banks
constexpr int U = 8;                // IIR steps per unrolled group

__host__ __device__ inline int gamma_stride(int n) { return n | 1; }

size_t smem_bytes(int n) {
  return sizeof(float) * (size_t(TB) * gamma_stride(n) + 2 * size_t(CK) * PS +
                          size_t(CK) * TB);
}

// asynchronous global → shared copies of 4 or 16 bytes; zero-fill when !pred
__device__ __forceinline__ void cp_async_f32(float* dst, const float* src,
                                             bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(pred ? 4 : 0));
}
__device__ __forceinline__ void cp_async_f32x4(float* dst, const float* src,
                                               bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// one step of the pole bank for one tile: s_k ← a_k·s_k + c_k·p, ΔT = Σ s_k
template <int NP>
__device__ __forceinline__ float tick(float (&s)[NP],
                                      const ThermalConvConsts& c, float p) {
  float dt = 0.f;
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    s[k] = __fadd_rn(__fmul_rn(c.decay[k], s[k]), __fmul_rn(c.coef[k], p));
    dt = k == 0 ? s[0] : __fadd_rn(dt, s[k]);
  }
  return dt;
}

// NP (the pole count) is a compile-time constant: a runtime bound on the
// per-step pole loop put a branch per pole on the serial IIR path
template <int NP>
__global__ void __launch_bounds__(THREADS)
thermal_conv_kernel(ThermalConvConsts c, const float* __restrict__ power,
                    const float* __restrict__ gamma,
                    const float* __restrict__ state0,
                    float* __restrict__ dts, float* __restrict__ state_out) {
  extern __shared__ float smem[];
  const int n = c.n;
  const int gs_stride = gamma_stride(n);   // odd: conflict-free row reads
  float* gs = smem;                        // [TB][gs_stride] Γ rows
  float* ps = gs + TB * gs_stride;         // [2][CK][PS] P blocks
  float* pe = ps + 2 * CK * PS;            // [CK][TB] p_eff chunk

  const int tid = threadIdx.x;
  const int i0 = blockIdx.x * TB;
  const int tb = min(TB, n - i0);
  const int ti = tid % TB;                 // tile of this thread's sums
  const int tg = tid / TB;                 // its steps: tg + TG·r, r < R
  const int nb = (n + JK - 1) / JK;        // column blocks per chunk
  const int total = nb * ((c.T + CK - 1) / CK);

  // P block `idx` = (chunk idx / nb, columns (idx % nb)·JK …) into buffer
  // `buf`, asynchronously, 16 bytes a copy when rows are 16-B aligned
  // (N % 4 == 0); the ragged edges are zero-filled
  const bool vec = (n & 3) == 0;
  auto stage = [&](int idx, int buf) {
    const int t0 = (idx / nb) * CK, j0 = (idx % nb) * JK;
    const int ck = min(CK, c.T - t0), jk = min(JK, n - j0);
    float* dst = ps + buf * CK * PS;
    if (vec) {
      for (int k = tid; k < CK * JK / 4; k += THREADS) {
        const int t = k / (JK / 4), jj = 4 * (k % (JK / 4));
        const bool in = t < ck && jj < jk;
        cp_async_f32x4(dst + t * PS + jj,
                       in ? power + size_t(t0 + t) * n + j0 + jj : power, in);
      }
    } else {
      for (int k = tid; k < CK * JK; k += THREADS) {
        const int t = k / JK, jj = k % JK;
        const bool in = t < ck && jj < jk;
        cp_async_f32(dst + t * PS + jj,
                     in ? power + size_t(t0 + t) * n + j0 + jj : power, in);
      }
    }
    cp_async_commit();
  };
  stage(0, 0);

  for (int k = tid; k < TB * n; k += THREADS) {
    const int i = k / n, j = k - (k / n) * n;
    gs[i * gs_stride + j] = i < tb ? gamma[size_t(i0 + i) * n + j] : 0.f;
  }

  float st[NP];
#pragma unroll
  for (int k = 0; k < NP; ++k)
    st[k] = tid < tb ? state0[size_t(i0 + tid) * NP + k] : 0.f;

  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;

  for (int idx = 0; idx < total; ++idx) {
    // the next block streams in while this one is multiplied
    if (idx + 1 < total) {
      stage(idx + 1, (idx + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                       // block idx (and gs) visible
    const int j0 = (idx % nb) * JK;
    const int jk = min(JK, n - j0);
    const float* grow = gs + ti * gs_stride + j0;
    const float* prow = ps + (idx & 1) * CK * PS + tg * PS;
    for (int jj = 0; jj < jk; ++jj) {
      const float g = grow[jj];
#pragma unroll
      for (int r = 0; r < R; ++r)
        acc[r] = fmaf(g, prow[r * TG * PS + jj], acc[r]);
    }

    if (idx % nb == nb - 1) {              // the chunk's p_eff is complete
      const int t0 = (idx / nb) * CK;
      const int ck = min(CK, c.T - t0);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        pe[(tg + TG * r) * TB + ti] = acc[r];
        acc[r] = 0.f;
      }
      __syncthreads();
      if (tid < tb) {
        // ΔT overwrites p_eff in place; U steps at a time with their loads
        // up front, so only the pole recurrence itself is sequential
        int t = 0;
        for (; t + U <= ck; t += U) {
          float p[U];
#pragma unroll
          for (int u = 0; u < U; ++u) p[u] = pe[(t + u) * TB + tid];
#pragma unroll
          for (int u = 0; u < U; ++u) pe[(t + u) * TB + tid] = tick(st, c, p[u]);
        }
        for (; t < ck; ++t) pe[t * TB + tid] = tick(st, c, pe[t * TB + tid]);
      }
      __syncthreads();
      // the whole block writes the chunk's ΔT out
      for (int k = tid; k < ck * TB; k += THREADS) {
        const int t = k / TB, i = k % TB;
        if (i < tb) dts[size_t(t0 + t) * n + i0 + i] = pe[k];
      }
    }
    __syncthreads();                       // buffer idx & 1 free to refill
  }

  if (tid < tb) {
#pragma unroll
    for (int k = 0; k < NP; ++k) state_out[size_t(i0 + tid) * NP + k] = st[k];
  }
}

template <int NP>
cudaError_t launch(const ThermalConvConsts& c, const float* power,
                   const float* gamma, const float* state0, float* dts,
                   float* state_out, cudaStream_t stream) {
  const size_t smem = smem_bytes(c.n);
  cudaError_t err = cudaFuncSetAttribute(
      thermal_conv_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  const int blocks = (c.n + TB - 1) / TB;
  thermal_conv_kernel<NP><<<blocks, THREADS, smem, stream>>>(
      c, power, gamma, state0, dts, state_out);
  return cudaGetLastError();
}

}  // namespace

extern "C" int thermal_conv_launch(const ThermalConvConsts* c,
                                   const float* power, const float* gamma,
                                   const float* state0, float* dts,
                                   float* state_out, void* stream) {
  if (c->T < 1 || c->n < 1) return int(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  switch (c->n_poles) {
#define CONV_CASE(P) \
    case P: return int(launch<P>(*c, power, gamma, state0, dts, state_out, st));
    CONV_CASE(1) CONV_CASE(2) CONV_CASE(3) CONV_CASE(4)
    CONV_CASE(5) CONV_CASE(6) CONV_CASE(7) CONV_CASE(8)
#undef CONV_CASE
    default: return int(cudaErrorInvalidValue);
  }
}
