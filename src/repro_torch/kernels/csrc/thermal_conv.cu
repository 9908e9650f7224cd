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
// 3.35 TB/s; Γ·P by Γ's non-zeros is 2.4 GFLOP, below that.  Two things
// sit above that bound.  (1) The pole update is a serial chain per tile:
// one f32 multiply and one add a step, each rounded; a dependent FMUL→FADD
// pair takes ~8.7 cycles on an H100 (700 W), so 90,000 steps take
// ≥ ~0.4 ms at 1.98 GHz however many tiles run beside each other.  (2)
// Each block reads the union of its rows' Γ columns from every P row: at
// 512 tiles, 4 tiles a block, that is ~1,400 scattered 32-byte L2 sectors
// a step over the 128 blocks, and staging them alone takes ~0.77 ms on
// the same card (the SMs' load path and the L2 sector rate, not bytes).
// scripts/thermal_conv_limits.py measures both.  The design runs every
// tile's chain at once and keeps the staging and the product beside it.
//
// Design.
//   * Blocks own disjoint runs of TB adjacent tiles (TB = 1, 2, 4, 8 or 16,
//     chosen by the wrapper so the grid is one block an SM: 4 at 512 tiles,
//     128 blocks), so they need no grid-wide sync.
//   * A sparse Γ walk.  The block's prologue scans its TB Γ rows into the
//     union of their non-zero columns (a NaN entry counts as non-zero),
//     ascending — one ballot per 32 columns.  p_eff of each of its rows is
//     one fmaf per union column in that order, from +0: a row's zero at
//     another row's column adds an exact 0 for finite power, so the walk
//     equals the plain version's dense j = 0 … N−1 order
//     (`core.coupling.apply_coupling`) bit for bit, and a non-finite power
//     in a union column reaches every row as 0·inf = NaN does there.
//   * Non-finite power outside the union.  Every block checks the power of
//     its own tiles' columns (together they are every column) and sets the
//     step's bit in a device-wide step mask.  The dense product gives NaN
//     to a row at any step where a column its Γ row is zero at holds a
//     non-finite power, and the pole state stays NaN from then on.  So the
//     last block to finish (a counter, no waiting) reads the step mask, the
//     flagged steps' power rows and every block's union mask, finds each
//     block's first step with a non-finite power outside its union, and
//     writes NaN to that block's ΔT from there on and to its final state —
//     the dense result, which the walk alone would miss.  With finite
//     power it finds the mask empty (one parallel pass) and stops.
//   * Warp specialisation, so the product runs beside the recurrence.
//     Warp 0, the recurrence warp, has one lane per tile of the block and
//     its SM sub-partition to itself (warp 4, the other warp there, only
//     waits at the end): its chain leaves it little issue to spare.  Three
//     staging warps (1–3) copy a stage — CK = 384 steps of up to JU = 48
//     union columns of P, [column][step], and Γ's values beside them — with
//     4-byte cp.async, 32 consecutive union columns of a row (a run,
//     coalesced) a warp instruction, and arrive on the stage buffer's
//     mbarrier as their copies land (cp.async.mbarrier.arrive.noinc), so
//     they never wait for device memory and run a stage ahead.  Three
//     product warps (5–7) wait on that mbarrier, form p_eff four steps a
//     thread into a ring of two chunk slots and hand each slot to the
//     recurrence warp; meanwhile it runs the previous chunk.  Slots and
//     stage buffers go back and forth through named barriers (bar.arrive
//     on the side that does not wait); there is no block-wide barrier
//     inside the time loop.
//   * The recurrence lane runs pairs of 16-step groups in two register sets:
//     one group's p_eff is loaded (16-byte shared loads) while the other's
//     ticks run, and its ΔT stored over its p_eff a group later; the
//     product warps store a slot's ΔT to device memory when they next
//     refill it — so neither loads nor stores sit on the chain.
//   * Blocks walk time at the same pace, so a row of P (2 KB at 512 tiles)
//     is read from HBM about once and from L2 by every block whose union
//     holds a column of it.
//
// Numerics: f32 throughout, no tensor cores (so no TF32), built with
// -fmad=false and no fast math: the pole update's multiplies and add round
// separately (__fmul_rn / __fadd_rn), as the plain version's separate
// tensor ops do; (1 − a)·G arrives as one f32 product from the wrapper; ΔT
// sums the poles in order.  Ragged T and N are masked in place.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define MAX_POLES 8

struct ThermalConvConsts {
  int T;          // steps
  int n;          // tiles
  int n_poles;
  float decay[MAX_POLES];   // a_k
  float coef[MAX_POLES];    // (1 − a_k)·G_k, one f32 product
  int tiles_per_block;      // TB: 1, 2, 4, 8 or 16
};

namespace {

// warp w runs on SM sub-partition w % 4: the recurrence warp 0 has
// partition 0 to itself (warp 4 only waits); partitions 1–3 each hold one
// staging warp (1–3) and one product warp (5–7)
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int REC_WARP = 0;
constexpr int IDLE_WARP = 4;
constexpr int NSWT = 96;           // staging threads
constexpr int NCWT = 96;           // product threads
constexpr int R = 4;               // steps a product thread forms per chunk
constexpr int CK = NCWT * R;       // steps per chunk
constexpr int S = CK + 1;          // staged P, [column][step]: odd stride
constexpr int JU = 48;             // union columns per stage
constexpr int NST = 2;             // stage buffers
constexpr int RS = CK + 4;         // ring, [tile][step]: 16-byte rows that a
                                   // warp's 16-byte loads take conflict-free
constexpr int NSLOT = 2;           // ring slots
constexpr int U = 16;              // recurrence steps per unrolled group
// named barriers (0 is __syncthreads): a stage buffer emptied by the
// product warps for the staging warps; a ring slot filled by the product
// warps for the recurrence warp, and emptied back
constexpr int BAR_EMPTY = 1;                  // + buffer
constexpr int BAR_FULL = 1 + NST;             // + slot
constexpr int BAR_DONE = 1 + NST + NSLOT;     // + slot
static_assert(CK % 32 == 0 && CK % (2 * U) == 0,
              "chunk of whole warps and group pairs");

size_t smem_bytes(int n, int tb) {
  return sizeof(float) * (size_t(NSLOT) * tb * RS + NST * size_t(JU) * S +
                          NST * size_t(JU) * tb) +
         sizeof(int) * (size_t(n) + (n + 31) / 32);
}

// scratch, 32-bit words: [0] the finished-block counter, then one bit per
// step (a non-finite power in that step's row), then each block's union
// mask (ceil(N / 32) words a block).  The first two are zeroed per launch.
int flag_words(int t) { return 1 + (t + 31) / 32; }

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

// asynchronous 4-byte global → shared copy; zero-fills when !pred
__device__ __forceinline__ void cp_async_f32(float* dst, const float* src,
                                             bool pred = true) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(pred ? 4 : 0));
}
// arrives on the mbarrier once every cp.async this thread issued so far
// has landed (the arrival is not counted in advance: .noinc)
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  const unsigned b = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(b) : "memory");
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  const unsigned b = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(b), "r"(count) : "memory");
}
// spin until the mbarrier's phase of parity `parity` has completed; a wait
// of 4 s (a fault: no wait here takes more than microseconds) traps rather
// than holding the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const unsigned b = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  asm volatile(
      "{\n.reg .pred done, late;\n.reg .u64 t0, t1;\n"
      "mov.u64 t0, %%globaltimer;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@done bra.uni DONE;\n"
      "mov.u64 t1, %%globaltimer;\n"
      "sub.u64 t1, t1, t0;\n"
      "setp.gt.u64 late, t1, 4000000000;\n"
      "@late trap;\n"
      "bra.uni WAIT;\n"
      "DONE:\n}\n" :: "r"(b), "r"(parity) : "memory");
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

// the recurrence lane's chunk: p_eff in q[0 .. ck) becomes ΔT in place, in
// pairs of U-step groups held in two register sets: group B's loads are
// issued before group A's ticks, A's stores after them and before B's
// ticks, so every load or store is a whole group away from the registers
// it fills or reads, and no register set rotates (a rotating prefetch
// costs a move per step)
template <int NP>
__device__ __forceinline__ void run_chunk(float* q, int ck, float (&st)[NP],
                                          const ThermalConvConsts& c) {
  constexpr int V = U / 4;
  auto ticks = [&](const float4 (&p)[V], float4 (&d)[V]) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      d[v].x = tick(st, c, p[v].x);
      d[v].y = tick(st, c, p[v].y);
      d[v].z = tick(st, c, p[v].z);
      d[v].w = tick(st, c, p[v].w);
    }
  };
  auto load = [&](float4 (&p)[V], int t) {
#pragma unroll
    for (int v = 0; v < V; ++v)
      p[v] = *reinterpret_cast<const float4*>(q + t + 4 * v);
  };
  auto store = [&](const float4 (&d)[V], int t) {
#pragma unroll
    for (int v = 0; v < V; ++v) *reinterpret_cast<float4*>(q + t + 4 * v) = d[v];
  };
  int t = 0;
  if (ck >= 2 * U) {
    float4 pa[V], pb[V], da[V], db[V];
    load(pa, 0);
    for (; t + 2 * U <= ck; t += 2 * U) {
      load(pb, t + U);
      if (t > 0) store(db, t - U);
      ticks(pa, da);
      if (t + 3 * U <= ck) load(pa, t + 2 * U);
      store(da, t);
      ticks(pb, db);
    }
    store(db, t - U);
  }
  for (; t < ck; ++t) q[t] = tick(st, c, q[t]);
}

// TB Γ values of one union column, [column][tile] in shared memory
template <int TB>
__device__ __forceinline__ void load_g(const float* p, float (&g)[TB]) {
  if constexpr (TB % 4 == 0) {
#pragma unroll
    for (int q = 0; q < TB; q += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + q);
      g[q] = v.x; g[q + 1] = v.y; g[q + 2] = v.z; g[q + 3] = v.w;
    }
  } else if constexpr (TB == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    g[0] = v.x; g[1] = v.y;
  } else {
    g[0] = p[0];
  }
}

// NP (the pole count) and TB (tiles a block) are compile-time constants:
// the pole loop sits on the serial chain, the tile loop in the product's
// registers
template <int NP, int TB>
__global__ void __launch_bounds__(THREADS, 1)
thermal_conv_kernel(ThermalConvConsts c, const float* __restrict__ power,
                    const float* __restrict__ gamma,
                    const float* __restrict__ state0, float* dts,
                    float* state_out, unsigned* __restrict__ scratch) {
  extern __shared__ __align__(16) float smem[];
  const int n = c.n, T = c.T;
  float* ring = smem;                              // [NSLOT][TB][RS]
  float* pst = ring + NSLOT * TB * RS;             // [NST][JU][S]
  float* gst = pst + NST * JU * S;                 // [NST][JU][TB]
  int* cols = reinterpret_cast<int*>(gst + NST * JU * TB);   // [n]
  unsigned* umask = reinterpret_cast<unsigned*>(cols + n); // [nw]
  __shared__ int last_block, n_hit;
  __shared__ int own_pos[TB];   // each own column's place in the union, or -1
  __shared__ __align__(8) uint64_t staged[NST];   // a stage buffer landed

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = (n + 31) >> 5, tw = (T + 31) >> 5;
  const int i0 = blockIdx.x * TB;
  const int tb = min(TB, n - i0);
  unsigned* counter = scratch;
  unsigned* step_bad = scratch + 1;
  unsigned* masks = scratch + 1 + tw;              // [gridDim.x][nw]

  // prologue: the union of the block's Γ rows' non-zero columns, ascending
  for (int w = warp; w < nw; w += WARPS) {
    const int j = w * 32 + lane;
    bool nz = false;
    if (j < n)
      for (int i = 0; i < tb; ++i) nz |= gamma[size_t(i0 + i) * n + j] != 0.f;
    const unsigned m = __ballot_sync(0xffffffffu, nz);
    if (lane == 0) {
      umask[w] = m;
      masks[size_t(blockIdx.x) * nw + w] = m;
    }
  }
  __syncthreads();
  int n_union = 0;
  for (int w = 0; w < nw; ++w) n_union += __popc(umask[w]);
  for (int w = warp; w < nw; w += WARPS) {
    int base = 0;
    for (int v = 0; v < w; ++v) base += __popc(umask[v]);
    const unsigned m = umask[w];
    if ((m >> lane) & 1u)
      cols[base + __popc(m & ((1u << lane) - 1u))] = w * 32 + lane;
  }
  if (tid < TB) {
    const int j = i0 + tid, w = j >> 5;
    int pos = -1;
    if (tid < tb && ((umask[w] >> (j & 31)) & 1u)) {
      pos = __popc(umask[w] & ((1u << (j & 31)) - 1u));
      for (int v = 0; v < w; ++v) pos += __popc(umask[v]);
    }
    own_pos[tid] = pos;
  }
  if (tid == 0) {
    for (int b = 0; b < NST; ++b) mbar_init(&staged[b], NSWT);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int ncb = max(1, (n_union + JU - 1) / JU);   // stages per chunk
  const int nchunks = (T + CK - 1) / CK;

  if (warp == REC_WARP) {
    // ------------------------------------------------- the recurrence warp
    float st[NP];
#pragma unroll
    for (int k = 0; k < NP; ++k)
      st[k] = lane < tb ? state0[size_t(i0 + lane) * NP + k] : 0.f;
    for (int ch = 0; ch < nchunks; ++ch) {
      const int slot = ch % NSLOT;
      bar_sync(BAR_FULL + slot, NCWT + 32);
      if (lane < tb)
        run_chunk<NP>(ring + (slot * TB + lane) * RS,
                      min(CK, T - ch * CK), st, c);
      __syncwarp();
      bar_arrive(BAR_DONE + slot, NCWT + 32);
    }
    if (lane < tb) {
#pragma unroll
      for (int k = 0; k < NP; ++k)
        state_out[size_t(i0 + lane) * NP + k] = st[k];
    }
  } else if (warp < IDLE_WARP) {
    // ------------------------------------------------ the staging warps
    // stage k = (chunk k / ncb, union columns (k % ncb)·JU …) into buffer
    // k % NST: a warp instruction copies one step of 32 consecutive union
    // columns (a run of P's row, coalesced), with Γ's values beside them;
    // each thread then arrives on the buffer's mbarrier when its copies
    // land, so these warps never wait for device memory
    const int sw = warp - 1, st = sw * 32 + lane;
    for (int k = 0; k < nchunks * ncb; ++k) {
      const int buf = k % NST, ch = k / ncb, cb = k - ch * ncb;
      if (k >= NST) bar_sync(BAR_EMPTY + buf, NSWT + NCWT);
      const int t0 = ch * CK, ck = min(CK, T - t0);
      const int u0 = cb * JU, nu = min(JU, n_union - u0);
      float* dp = pst + buf * JU * S;
      const int nub = (nu + 31) >> 5;
      for (int unit = sw; unit < nub * (CK / 32); unit += NSWT / 32) {
        const int ub = unit / (CK / 32), tlo = (unit - ub * (CK / 32)) * 32;
        const int u = ub * 32 + lane, thi = min(tlo + 32, ck);
        if (u < nu) {
          const float* src = power + size_t(t0 + tlo) * n + cols[u0 + u];
          float* dst = dp + u * S + tlo;
#pragma unroll 4
          for (int t = tlo; t < thi; ++t, ++dst, src += n)
            cp_async_f32(dst, src);
        }
      }
      float* dg = gst + buf * JU * TB;
      for (int e = st; e < nu * TB; e += NSWT) {
        const int u = e / TB, i = e - u * TB;
        const bool in = i < tb;
        cp_async_f32(dg + e,
                     in ? gamma + size_t(i0 + i) * n + cols[u0 + u] : gamma,
                     in);
      }
      cp_async_mbar_arrive(&staged[buf]);
    }
  } else if (warp > IDLE_WARP) {
    // ------------------------------------------------ the product warps
    const int ct = (warp - IDLE_WARP - 1) * 32 + lane;
    const int npairs = nchunks * ncb;

    // ΔT of chunk ch, out of its ring slot, to device memory
    auto write_out = [&](int ch) {
      const float* rp = ring + (ch % NSLOT) * TB * RS;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int s = ct + r * NCWT, t = ch * CK + s;
        if (t >= T) continue;
        float* out = dts + size_t(t) * n + i0;
        if (TB % 4 == 0 && tb == TB && (n & 3) == 0) {
#pragma unroll
          for (int q = 0; q < TB; q += 4)
            *reinterpret_cast<float4*>(out + q) = make_float4(
                rp[q * RS + s], rp[(q + 1) * RS + s], rp[(q + 2) * RS + s],
                rp[(q + 3) * RS + s]);
        } else {
          for (int i = 0; i < tb; ++i) out[i] = rp[i * RS + s];
        }
      }
    };

    for (int ch = 0; ch < nchunks; ++ch) {
      const int t0 = ch * CK;
      float acc[R][TB];
      bool bad[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        bad[r] = false;
#pragma unroll
        for (int i = 0; i < TB; ++i) acc[r][i] = 0.f;
      }
      for (int cb = 0; cb < ncb; ++cb) {
        const int k = ch * ncb + cb, buf = k % NST;
        mbar_wait(&staged[buf], (k / NST) & 1);
        const int nu = min(JU, n_union - cb * JU);
        const float* pp = pst + buf * JU * S + ct;
        const float* gp = gst + buf * JU * TB;
#pragma unroll 2
        for (int u = 0; u < nu; ++u) {
          float g[TB];
          load_g<TB>(gp + u * TB, g);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float p = pp[u * S + r * NCWT];
#pragma unroll
            for (int i = 0; i < TB; ++i) acc[r][i] = fmaf(g[i], p, acc[r][i]);
          }
        }
        // the block's own columns in this stage: a non-finite power marks
        // its step
        for (int i = 0; i < tb; ++i) {
          const int up = own_pos[i] - cb * JU;
          if (own_pos[i] >= 0 && up >= 0 && up < nu) {
#pragma unroll
            for (int r = 0; r < R; ++r)
              bad[r] |= !isfinite(pp[up * S + r * NCWT]);
          }
        }
        // the buffer is free for stage k + NST, if there is one
        if (k + NST < npairs) bar_arrive(BAR_EMPTY + buf, NSWT + NCWT);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int t = t0 + ct + r * NCWT;
        if (t >= T) continue;
        // an own column outside the union (Γ's column zero in every row of
        // the block) is not staged: read it from device memory
        for (int i = 0; i < tb; ++i)
          if (own_pos[i] < 0) bad[r] |= !isfinite(power[size_t(t) * n + i0 + i]);
        if (bad[r]) atomicOr(step_bad + (t >> 5), 1u << (t & 31));
      }
      const int slot = ch % NSLOT;
      if (ch >= NSLOT) {
        bar_sync(BAR_DONE + slot, NCWT + 32);   // chunk ch − NSLOT's ΔT is in
        write_out(ch - NSLOT);
      }
      float* rp = ring + slot * TB * RS + ct;
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int i = 0; i < TB; ++i) rp[i * RS + r * NCWT] = acc[r][i];
      bar_arrive(BAR_FULL + slot, NCWT + 32);
    }
    for (int ch = max(0, nchunks - NSLOT); ch < nchunks; ++ch) {
      bar_sync(BAR_DONE + ch % NSLOT, NCWT + 32);
      write_out(ch);
    }
  }

  // ---------------------------------------- the last block: outside-union
  // non-finite power, as the dense product has it
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    last_block = atomicAdd(counter, 1u) == gridDim.x - 1;
    n_hit = 0;
  }
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  bool any_bad = false;   // with finite power the step mask is empty
  for (int w = tid; w < tw; w += THREADS) any_bad |= __ldcg(step_bad + w) != 0;
  if (!__syncthreads_or(any_bad)) return;
  const int nb = gridDim.x;
  int* hit = reinterpret_cast<int*>(pst);          // [nb] first NaN step
  unsigned* rowm = reinterpret_cast<unsigned*>(hit + nb);   // [nw]
  for (int b = tid; b < nb; b += THREADS) hit[b] = T;
  __syncthreads();
  for (int w = 0; w < tw && n_hit < nb; ++w) {
    unsigned bits = __ldcg(step_bad + w);
    while (bits) {
      const int t = w * 32 + __ffs(bits) - 1;
      bits &= bits - 1;
      for (int v = warp; v < nw; v += WARPS) {
        const int j = v * 32 + lane;
        const bool bad = j < n && !isfinite(power[size_t(t) * n + j]);
        const unsigned m = __ballot_sync(0xffffffffu, bad);
        if (lane == 0) rowm[v] = m;
      }
      __syncthreads();
      for (int b = tid; b < nb; b += THREADS) {
        if (hit[b] < T) continue;
        for (int v = 0; v < nw; ++v) {
          if (rowm[v] & ~__ldcg(masks + size_t(b) * nw + v)) {
            hit[b] = t;
            atomicAdd(&n_hit, 1);
            break;
          }
        }
      }
      __syncthreads();
      if (n_hit == nb) break;
    }
  }
  const float qnan = __int_as_float(0x7fffffff);
  for (int b = 0; b < nb; ++b) {
    const int h = hit[b];
    if (h >= T) continue;
    const int bi0 = b * TB, btb = min(TB, n - bi0);
    const int cnt = (T - h) * btb;
    for (int e = tid; e < cnt; e += THREADS) {
      const int t = h + e / btb, i = e - (e / btb) * btb;
      dts[size_t(t) * n + bi0 + i] = qnan;
    }
    for (int e = tid; e < btb * NP; e += THREADS)
      state_out[size_t(bi0) * NP + e] = qnan;
  }
}

template <int NP, int TB>
cudaError_t launch(const ThermalConvConsts& c, const float* power,
                   const float* gamma, const float* state0, float* dts,
                   float* state_out, unsigned* scratch, cudaStream_t stream) {
  const size_t smem = smem_bytes(c.n, TB);
  cudaError_t err = cudaFuncSetAttribute(
      thermal_conv_kernel<NP, TB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const int blocks = (c.n + TB - 1) / TB;
  thermal_conv_kernel<NP, TB><<<blocks, THREADS, smem, stream>>>(
      c, power, gamma, state0, dts, state_out, scratch);
  return cudaGetLastError();
}

template <int NP>
cudaError_t launch_np(const ThermalConvConsts& c, const float* power,
                      const float* gamma, const float* state0, float* dts,
                      float* state_out, unsigned* scratch,
                      cudaStream_t stream) {
  switch (c.tiles_per_block) {
#define CONV_TB(B) \
    case B: return launch<NP, B>(c, power, gamma, state0, dts, state_out, \
                                 scratch, stream);
    CONV_TB(1) CONV_TB(2) CONV_TB(4) CONV_TB(8) CONV_TB(16)
#undef CONV_TB
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// 32-bit words of scratch `thermal_conv_launch` needs (the wrapper
// allocates them; see `flag_words` for the layout)
extern "C" int thermal_conv_scratch_words(int T, int n, int tiles_per_block) {
  if (T < 1 || n < 1 || tiles_per_block < 1) return -1;
  return flag_words(T) +
         (n + tiles_per_block - 1) / tiles_per_block * ((n + 31) / 32);
}

extern "C" int thermal_conv_launch(const ThermalConvConsts* c,
                                   const float* power, const float* gamma,
                                   const float* state0, float* dts,
                                   float* state_out, unsigned* scratch,
                                   void* stream) {
  if (c->T < 1 || c->n < 1) return int(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, sizeof(unsigned) * size_t(flag_words(c->T)), st);
  if (err != cudaSuccess) return int(err);
  switch (c->n_poles) {
#define CONV_CASE(P) \
    case P: return int(launch_np<P>(*c, power, gamma, state0, dts, \
                                    state_out, scratch, st));
    CONV_CASE(1) CONV_CASE(2) CONV_CASE(3) CONV_CASE(4)
    CONV_CASE(5) CONV_CASE(6) CONV_CASE(7) CONV_CASE(8)
#undef CONV_CASE
    default: return int(cudaErrorInvalidValue);
  }
}
