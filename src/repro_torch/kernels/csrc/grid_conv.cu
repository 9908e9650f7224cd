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
//     dts[t, i] = (Σ over the tile's cells of s)·(1/(gy·gx))
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
// so are the operations (~25 per cell per substep): the roofline bound is
// 0.0506 ms by operations at [90,000, 47] (chip_smoke.py prints it).  The
// recurrence is sequential in T, so the real floor is T × one substep's
// chain of dependent latencies: a shuffle and 8 dependent f32 operations
// (w·left, + w·right, + vert, − deg·s, κ·, + (d − ĝ·s), r·, s +) — an
// ESTIMATE from assumed latencies (24 + 8 × 4 cycles, ~2.5 ms per 90k-step
// trace at 1,980 MHz; chip_smoke.py prints it beside the time).
//
// Design.  Tiles never exchange heat inside the grid, so each tile's G×G
// patch (G = gy = gx, a template parameter) evolves on its own, spread over
// one warp's lanes: lane = (row group, column), R consecutive rows of one
// column per lane (R = ⌈G / ⌊32/G⌋⌉: 2 rows at G = 8, so 4 groups × 8
// columns fill the warp).  Patches of G² < 32 cells use one cell per lane
// and share a warp (a power-of-two span of lanes each).  A substep is ~2R + 2
// shuffles — left and right of each row, the row above the group and the
// row below it — and ~12 f32 operations per cell; vertical neighbours inside
// a group are the lane's own registers.  Edge rows take their one vertical
// neighbour by a select; the horizontal wall weights are branch-free 0/1
// factors (per-lane branches diverged).  Rows past the patch
// (when R does not divide G) and lanes past it are held at 0.
//
// Readout off the recurrence's chain: each step, each lane stores the sum
// of its rows to shared memory (a store the warp does not wait on); after
// each chunk of 32 steps, lane i of a patch's span sums the span's lane sums
// of step i and writes the patch mean — a few dependent adds once per 32
// steps instead of a reduction on every step's path (a shuffle butterfly
// per step, even one step behind, sets the pace of an in-order warp with
// its five dependent shuffle-adds).  Each step's drive is read from shared
// memory a step ahead, and the step loop is unrolled by 8 with the substep
// count fixed at 1 on the main path.  The readout's summation order is not
// the plain version's matrix product; it is held to 1e-5.
//
// Power streams into shared memory 32 steps at a time (cp.async, double
// buffered), so no step waits on device memory.  Every multiply and add
// rounds on its own (no FMA), as the plain version's tensor ops do.
// Registers and spills (`nvcc -Xptxas -v`, CUDA 12.8, printed by
// chip_smoke.py): 59 registers at G = 8, no spills.

#include <cuda_runtime.h>

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

// How a G×G patch sits on a warp's lanes.
template <int G>
struct Patch {
  static constexpr int R = (G + 32 / G - 1) / (32 / G);   // rows per lane
  static constexpr int GROUPS = (G + R - 1) / R;          // row groups used
  static constexpr int L = GROUPS * G;                    // lanes per patch
  static constexpr int SPAN = L <= 4 ? 4 : L <= 8 ? 8 : L <= 16 ? 16 : 32;
  static constexpr int TPW = 32 / SPAN;                   // patches per warp
  // whether some lane or row computes outside the patch (held at 0)
  static constexpr bool MASKED = L < SPAN || GROUPS * R != G || TPW > 1;
};

// One explicit-Euler substep of the lane's R cells, in the plain version's
// operation order: v = up + down (an edge row takes its one neighbour),
// h = w_l·left + w_r·right, nb = v + h, lap = nb − deg·s,
// u = (d − ĝ·s) + κ·lap, s + r·u — each rounded on its own.
template <int G, int R, bool MASKED>
__device__ __forceinline__ void substep(float (&s)[R], const float (&gh)[R],
                                        const float (&dg)[R],
                                        const bool (&live)[R], int y0,
                                        float w_left, float w_right, float d,
                                        float r, float kappa) {
  float left[R], right[R], nxt[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    left[i] = __shfl_up_sync(FULL, s[i], 1);
    right[i] = __shfl_down_sync(FULL, s[i], 1);
  }
  const float above = __shfl_up_sync(FULL, s[R - 1], G);   // row y0 − 1
  const float below = __shfl_down_sync(FULL, s[0], G);     // row y0 + R
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const float up = i > 0 ? s[i - 1] : above;
    const float dn = i < R - 1 ? s[i + 1] : below;
    const int y = y0 + i;
    const float v = y == 0 ? dn : (y == G - 1 ? up : __fadd_rn(up, dn));
    const float h = __fadd_rn(__fmul_rn(w_left, left[i]),
                              __fmul_rn(w_right, right[i]));
    const float nb = __fadd_rn(v, h);
    const float lap = __fsub_rn(nb, __fmul_rn(dg[i], s[i]));
    const float u = __fadd_rn(__fsub_rn(d, __fmul_rn(gh[i], s[i])),
                              __fmul_rn(kappa, lap));
    nxt[i] = __fadd_rn(s[i], __fmul_rn(r, u));
  }
#pragma unroll
  for (int i = 0; i < R; ++i) s[i] = (!MASKED || live[i]) ? nxt[i] : 0.f;
}

// one warp per block
template <int G>
__global__ void __launch_bounds__(32)
grid_conv_kernel(GridConvConsts c, const float* __restrict__ power,
                 const float* __restrict__ ghat, const float* __restrict__ deg,
                 const float* __restrict__ state0, float* __restrict__ dts,
                 float* __restrict__ state_out) {
  using P = Patch<G>;
  constexpr int R = P::R, SPAN = P::SPAN, TPW = P::TPW;
  __shared__ float pw[2][TCH][TPW];          // [buffer][step][patch of warp]
  __shared__ float part[TCH][33];            // [step][lane] lane sums
  const int lane = threadIdx.x;
  const int local = lane / SPAN, lt = lane % SPAN;   // patch, lane in its span
  const int grp = lt / G, x = lt - grp * G;
  const int y0 = grp * R;
  const int tile0 = blockIdx.x * TPW;
  const int tile = tile0 + local;
  const bool tile_ok = tile < c.n_tiles;
  const bool lane_ok = tile_ok && lt < P::L;
  const int W = c.n_tiles * G;
  const int col = lane_ok ? tile * G + x : 0;
  // 0/1 weights of the horizontal neighbours: a missing one (tile wall or
  // grid edge) adds an exact 0, so the sums equal the adjacency product's
  const float w_left = x > 0 ? 1.f : 0.f, w_right = x < G - 1 ? 1.f : 0.f;

  // power for steps t0 … t0 + TCH − 1 of this warp's tiles: lane l
  // stages step t0 + l, asynchronously; the ragged edges are zero-filled
  auto stage = [&](int chunk, int buf) {
    const int t = chunk * TCH + lane;
#pragma unroll
    for (int k = 0; k < TPW; ++k) {
      const bool in = t < c.T && tile0 + k < c.n_tiles;
      cp_async_f32(&pw[buf][lane][k],
                   in ? power + size_t(t) * c.n_tiles + tile0 + k : power,
                   in);
    }
    cp_async_commit();
  };
  stage(0, 0);

  float s[R], gh[R], dg[R];
  bool live[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    live[i] = lane_ok && y0 + i < G;
    const size_t at = size_t(live[i] ? y0 + i : 0) * W + col;
    s[i] = live[i] ? state0[at] : 0.f;
    gh[i] = live[i] ? ghat[at] : 0.f;
    dg[i] = live[i] ? deg[at] : 0.f;
  }

  // the steps of one staged chunk; each step's drive is read a step ahead
  // (the slot past the chunk's end is read and unused), so no step waits on
  // shared memory, and the lane's share of the readout goes to `part`
  auto run_steps = [&](int b, int steps, int substeps) {
    float d_next = __fmul_rn(c.rth, pw[b][0][local]);
#pragma unroll 8
    for (int i = 0; i < steps; ++i) {
      const float d = d_next;
      d_next = __fmul_rn(c.rth, pw[b][(i + 1) & (TCH - 1)][local]);
      for (int sub = 0; sub < substeps; ++sub)
        substep<G, R, P::MASKED>(s, gh, dg, live, y0, w_left, w_right, d,
                                 c.r, c.kappa);
      float p = s[0];
#pragma unroll
      for (int k = 1; k < R; ++k) p = __fadd_rn(p, s[k]);
      part[i][lane] = p;
    }
  };

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
    if (c.substeps == 1)
      run_steps(ch & 1, steps, 1);
    else
      run_steps(ch & 1, steps, c.substeps);
    __syncwarp();                            // the chunk's lane sums visible
    // readout: lane lt of a span sums its patch's lane sums of steps lt,
    // lt + SPAN, … of the chunk in four interleaved chains (rows of 33
    // floats: no bank conflict)
    for (int k = lt; k < steps; k += SPAN) {
      const float* row = &part[k][local * SPAN];
      float a[4] = {row[0], row[1], row[2], row[3]};   // four chains
#pragma unroll
      for (int j = 4; j < SPAN; ++j) a[j & 3] = __fadd_rn(a[j & 3], row[j]);
      const float sum = __fadd_rn(__fadd_rn(a[0], a[1]),
                                  __fadd_rn(a[2], a[3]));
      if (tile_ok)
        dts[size_t(ch * TCH + k) * c.n_tiles + tile] =
            __fmul_rn(sum, c.inv_cells);
    }
    __syncwarp();                  // pw buffer ch & 1 and part free to refill
  }

#pragma unroll
  for (int i = 0; i < R; ++i)
    if (live[i]) state_out[size_t(y0 + i) * W + col] = s[i];
}

template <int G>
cudaError_t launch(const GridConvConsts& c, const float* power,
                   const float* ghat, const float* deg, const float* state0,
                   float* dts, float* state_out, cudaStream_t stream) {
  const int tpw = Patch<G>::TPW;
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
