// Microbenchmarks of what bounds the thermal_conv kernel on one card
// (scripts/thermal_conv_limits.py builds and runs them):
//   * the pole recurrence alone, in cycles a step: the kernel's own
//     16-step loop over shared memory, the same ticks from registers, and
//     a bare dependent FMUL→FADD chain;
//   * L2 read bandwidth, coalesced and in scattered 32-byte sectors;
//   * the kernel's staging alone: its 4-byte cp.async of each block's
//     union columns, with nothing consuming them.
#include "../src/repro_torch/kernels/csrc/thermal_conv.cu"

namespace {

template <int MODE>
__global__ void chain_kernel(ThermalConvConsts c, int chunks, float* out,
                             long long* cycles) {
  __shared__ __align__(16) float ring[4 * RS];
  const int lane = threadIdx.x;
  for (int i = lane; i < 4 * RS; i += 32) ring[i] = 1.0f + (i % 97) * 1e-3f;
  __syncwarp();
  float st[2] = {0.f, 0.f}, acc = 0.f;
  const long long t0 = clock64();
  for (int ch = 0; ch < chunks; ++ch) {
    if (lane < 4) {
      if (MODE == 0) {
        run_chunk<2>(ring + lane * RS, CK, st, c);
      } else if (MODE == 1) {
        const float p0 = ring[lane], p1 = ring[lane + 1];
#pragma unroll 16
        for (int t = 0; t < CK; ++t)
          acc = __fadd_rn(acc, tick<2>(st, c, (t & 1) ? p1 : p0));
      } else {
        float s = st[0];
        const float b = ring[lane];
#pragma unroll 16
        for (int t = 0; t < CK; ++t) s = __fadd_rn(__fmul_rn(c.decay[0], s), b);
        st[0] = s;
      }
    }
    __syncwarp();
  }
  if (lane == 0) cycles[0] = clock64() - t0;
  if (lane < 4) out[lane] = st[0] + st[1] + acc;
}

__global__ void l2_coalesced(const float4* __restrict__ buf, int words,
                             int reps, float* out) {
  float acc = 0.f;
  for (int r = 0; r < reps; ++r)
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < words;
         i += gridDim.x * blockDim.x) {
      const float4 v = __ldcg(buf + (i + r * 977) % words);
      acc += v.x + v.y + v.z + v.w;
    }
  if (acc == 12345.f) out[0] = acc;
}

__global__ void l2_sectors(const float* __restrict__ buf, int sectors,
                           int reps, float* out) {
  float acc = 0.f;
  unsigned h = blockIdx.x * 7919u + threadIdx.x * 104729u;
  for (int r = 0; r < reps; ++r) {
    h = h * 1664525u + 1013904223u;
    acc += __ldcg(buf + size_t(h % sectors) * 8);
  }
  if (acc == 12345.f) out[0] = acc;
}

// the kernel's staging warps' loop, alone: block b copies its union columns
// (ucols[b][0 .. count[b])) of every CK-step chunk of P into [u][t]
__global__ void __launch_bounds__(96) stage_only(
    const float* __restrict__ power, int T, int n,
    const int* __restrict__ ucols, const int* __restrict__ count, int maxu,
    float* out) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31, sw = threadIdx.x >> 5;
  const int nu = count[blockIdx.x];
  const int* cols = ucols + blockIdx.x * maxu;
  const int nchunks = (T + CK - 1) / CK;
  for (int ch = 0; ch < nchunks; ++ch) {
    float* dp = smem + (ch & 1) * JU * S;
    const int t0 = ch * CK, ck = min(CK, T - t0);
    const int nub = (nu + 31) >> 5;
    for (int unit = sw; unit < nub * (CK / 32); unit += 3) {
      const int ub = unit / (CK / 32), tlo = (unit - ub * (CK / 32)) * 32;
      const int u = ub * 32 + lane, thi = min(tlo + 32, ck);
      if (u < nu) {
        const float* src = power + size_t(t0 + tlo) * n + cols[u];
        float* dst = dp + u * S + tlo;
#pragma unroll 4
        for (int t = tlo; t < thi; ++t, ++dst, src += n)
          cp_async_f32(dst, src);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  if (smem[threadIdx.x] == 12345.f) out[0] = smem[threadIdx.x];
}

}  // namespace

extern "C" int limits_chain(const ThermalConvConsts* c, int mode, int chunks,
                            float* out, long long* cycles) {
  if (mode == 0) chain_kernel<0><<<1, 32>>>(*c, chunks, out, cycles);
  else if (mode == 1) chain_kernel<1><<<1, 32>>>(*c, chunks, out, cycles);
  else chain_kernel<2><<<1, 32>>>(*c, chunks, out, cycles);
  return int(cudaGetLastError());
}

extern "C" int limits_l2(const float* buf, int floats, int reps, int sectors,
                         float* out) {
  if (sectors)
    l2_sectors<<<132 * 4, 256>>>(buf, floats / 8, reps, out);
  else
    l2_coalesced<<<132 * 4, 256>>>(reinterpret_cast<const float4*>(buf),
                                   floats / 4, reps, out);
  return int(cudaGetLastError());
}

extern "C" int limits_stage(const float* power, int T, int n,
                            const int* ucols, const int* count, int maxu,
                            int blocks, float* out) {
  if (maxu > JU) return int(cudaErrorInvalidValue);
  const int smem = int(2 * JU * S * sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      stage_only, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  stage_only<<<blocks, 96, smem>>>(power, T, n, ucols, count, maxu, out);
  return int(cudaGetLastError());
}
