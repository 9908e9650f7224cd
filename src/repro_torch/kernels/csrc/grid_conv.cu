// RC-grid thermal plant trace on Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel `repro.kernels.thermal_conv.grid_conv` (Pallas
// body `_grid_kernel`, src/repro/kernels/thermal_conv.py), the whole-trace
// path of `GridPlant`.  The grid is [gy, W], W = n_tiles·gx: tile i owns
// columns i·gx … i·gx + gx−1.  For each step t:
//
//     d = Rth·P[t, i] on every cell of tile i
//     substeps × :  lap = (vert + horiz) − deg·s
//                   s   = s + r·((d − ĝ·s) + κ·lap)
//     dts[t, i] = Σ_x (Σ_y s[y, x])·(1/(gy·gx))   over the tile's columns
//
// where vert/horiz sum a cell's vertical/horizontal neighbours.  There is no
// horizontal edge across a tile wall (the walls are adiabatic) and none past
// the grid's edge; deg and ĝ (the bridge-shadow band) are read per cell.
// The plain version is `grid_conv_reference` in thermal_conv.py, which runs
// the reference's adjacency products; with at most two unit terms per cell,
// those products give the same f32 sums as the direct stencil here, so the
// state agrees bit for bit and the readout to rounding.
//
// What bounds it.  The bytes are tiny (power in, dts out: 8·T·n_tiles) and
// so are the operations (~25 per cell per substep); the recurrence is
// sequential in T, so the floor is T × one step's chain of dependent
// latencies (a neighbour exchange and ~7 dependent f32 operations per
// substep), far above the roofline bound.
//
// Design.  Tiles never exchange heat inside the grid, so each tile's gy×gx
// patch evolves on its own: one warp carries 32/gx tiles, one lane per
// column, with the column's gy cells, ĝ and deg in registers (the patch
// edge gy = gx is a template parameter).  Vertical neighbours are in the lane's own
// registers, horizontal ones one shuffle away (the wall weighting is
// branch-free: per-lane branches inside the row loop diverged and cost more
// than the stencil's arithmetic); the tile's mean goes through shared
// memory.  No barriers, no grid-wide sync.  Power streams into shared memory 32 steps at a time (cp.async,
// double buffered), so no step waits on device memory.  Every multiply
// and add rounds on its own (no FMA), as the plain version's tensor ops do.

#include <cuda_runtime.h>

#define MAX_CELLS 16    // cells per tile edge (a column lives in registers)

struct GridConvConsts {
  int T;
  int n_tiles;
  int g;          // cells per tile edge (gy = gx)
  int substeps;
  float rth;        // tile → cell drive scale
  float r;          // dt/(τ·substeps)
  float kappa;      // lateral / vertical conductance ratio
  float inv_cells;  // readout weight 1/(gy·gx), f32
};

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int TCH = 32;    // steps of power staged at a time

// 4-byte asynchronous global → shared copy; zero-fills when !pred
__device__ __forceinline__ void cp_async_f32(float* dst, const float* src,
                                             bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(pred ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// one warp per block; G (cells per tile edge, gy = gx) is a compile-time
// constant, so a column lives in registers and no loop over rows or
// columns carries a branch per iteration
template <int G>
__global__ void __launch_bounds__(32)
grid_conv_kernel(GridConvConsts c, const float* __restrict__ power,
                 const float* __restrict__ ghat, const float* __restrict__ deg,
                 const float* __restrict__ state0, float* __restrict__ dts,
                 float* __restrict__ state_out) {
  __shared__ float pw[2][TCH][32];           // [buffer][step][tile of warp]
  __shared__ float wsum[32];                 // each column's weighted sum
  const int lane = threadIdx.x;
  constexpr int GY = G, GX = G;
  const int gx = GX;
  const int tpw = 32 / GX;                   // tiles per warp
  const int local = lane / gx;
  const int x = lane - local * gx;
  const int tile0 = blockIdx.x * tpw;
  const int tile = tile0 + local;
  const bool valid = local < tpw && tile < c.n_tiles;
  const int W = c.n_tiles * gx;
  const int col = valid ? tile * gx + x : 0;
  // 0/1 weights of the horizontal neighbours: a missing one (tile wall or
  // grid edge) adds an exact 0, so the sums equal the adjacency product's
  // without a branch per lane
  const float w_left = x > 0 ? 1.f : 0.f, w_right = x < gx - 1 ? 1.f : 0.f;
  const int base = local * gx;               // first lane of this tile

  // power for steps t0 … t0 + TCH − 1 of this warp's tiles: lane l
  // stages step t0 + l, asynchronously; the ragged edges are zero-filled
  auto stage = [&](int chunk, int buf) {
    const int t = chunk * TCH + lane;
    for (int k = 0; k < tpw; ++k) {
      const bool in = t < c.T && tile0 + k < c.n_tiles;
      cp_async_f32(&pw[buf][lane][k],
                   in ? power + size_t(t) * c.n_tiles + tile0 + k : power,
                   in);
    }
    cp_async_commit();
  };
  stage(0, 0);

  float s[GY], gh[GY], dg[GY];
#pragma unroll
  for (int y = 0; y < GY; ++y) {
    s[y] = valid ? state0[size_t(y) * W + col] : 0.f;
    gh[y] = valid ? ghat[size_t(y) * W + col] : 0.f;
    dg[y] = valid ? deg[size_t(y) * W + col] : 0.f;
  }

  const int n_chunks = (c.T + TCH - 1) / TCH;
  for (int ch = 0; ch < n_chunks; ++ch) {
    if (ch + 1 < n_chunks) {
      stage(ch + 1, (ch + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();                            // every lane's copies visible
    const int steps = min(TCH, c.T - ch * TCH);
    for (int i = 0; i < steps; ++i) {
      const float d = __fmul_rn(c.rth, pw[ch & 1][i][local < tpw ? local : 0]);
      for (int sub = 0; sub < c.substeps; ++sub) {
        float left[GY], right[GY], nxt[GY];
#pragma unroll
        for (int y = 0; y < GY; ++y) {
          left[y] = __shfl_up_sync(FULL, s[y], 1);
          right[y] = __shfl_down_sync(FULL, s[y], 1);
        }
#pragma unroll
        for (int y = 0; y < GY; ++y) {
          // vertical neighbours (GY >= 2: at least one)
          float v;
          if (y == 0) v = s[1];
          else if (y == GY - 1) v = s[GY - 2];
          else v = __fadd_rn(s[y > 0 ? y - 1 : 0], s[y + 1 < GY ? y + 1 : y]);
          const float h = __fadd_rn(__fmul_rn(w_left, left[y]),
                                    __fmul_rn(w_right, right[y]));
          const float nb = __fadd_rn(v, h);
          const float lap = __fsub_rn(nb, __fmul_rn(dg[y], s[y]));
          const float u = __fadd_rn(__fsub_rn(d, __fmul_rn(gh[y], s[y])),
                                    __fmul_rn(c.kappa, lap));
          nxt[y] = __fadd_rn(s[y], __fmul_rn(c.r, u));
        }
#pragma unroll
        for (int y = 0; y < GY; ++y) s[y] = nxt[y];
      }
      // readout: column sum over y, weighted, then summed over the tile's
      // columns in order x = 0 … gx−1
      float colsum = s[0];
#pragma unroll
      for (int y = 1; y < GY; ++y) colsum = __fadd_rn(colsum, s[y]);
      wsum[lane] = __fmul_rn(colsum, c.inv_cells);
      __syncwarp();
      if (valid && x == 0) {
        float mean = wsum[base];
#pragma unroll
        for (int k = 1; k < GX; ++k) mean = __fadd_rn(mean, wsum[base + k]);
        dts[size_t(ch * TCH + i) * c.n_tiles + tile] = mean;
      }
      __syncwarp();                          // wsum free for the next step
    }
    __syncwarp();                            // buffer ch & 1 free to refill
  }

#pragma unroll
  for (int y = 0; y < GY; ++y)
    if (valid) state_out[size_t(y) * W + col] = s[y];
}

template <int G>
cudaError_t launch(const GridConvConsts& c, const float* power,
                   const float* ghat, const float* deg, const float* state0,
                   float* dts, float* state_out, cudaStream_t stream) {
  const int tpw = 32 / G;
  const int blocks = (c.n_tiles + tpw - 1) / tpw;
  grid_conv_kernel<G><<<blocks, 32, 0, stream>>>(c, power, ghat, deg,
                                                 state0, dts, state_out);
  return cudaGetLastError();
}

}  // namespace

extern "C" int grid_conv_launch(const GridConvConsts* c, const float* power,
                                const float* ghat, const float* deg,
                                const float* state0, float* dts,
                                float* state_out, void* stream) {
  if (c->T < 1 || c->n_tiles < 1 || c->substeps < 1)
    return int(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  switch (c->g) {
#define GRID_CASE(G) \
    case G: return int(launch<G>(*c, power, ghat, deg, state0, dts, state_out, st));
    GRID_CASE(2) GRID_CASE(3) GRID_CASE(4) GRID_CASE(5) GRID_CASE(6)
    GRID_CASE(7) GRID_CASE(8) GRID_CASE(9) GRID_CASE(10) GRID_CASE(11)
    GRID_CASE(12) GRID_CASE(13) GRID_CASE(14) GRID_CASE(15) GRID_CASE(16)
#undef GRID_CASE
    default: return int(cudaErrorInvalidValue);
  }
}
