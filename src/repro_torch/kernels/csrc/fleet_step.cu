// fleet_step.cu — the whole fleet scheduler step over a T-step flush window,
// one launch per window, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `src/repro/kernels/fleet_step.py::fleet_step`
// (Pallas body `_kernel`).  Each step of each (package, tile): O(1) sliding
// filtration with an exact refresh every W steps, Γ-coupled PDU-gate hint,
// the v24 / reactive / reactive_poll / off control law with the +0.05 slew
// cap, the n-pole plant, and the per-package event count over its tiles.
// The op order is the plain version's (`fleet_step_reference` in
// repro_torch/kernels/fleet_step.py), which the tests hold to the reference.
//
// Packed layout (up to 128 tiles).  A block holds 32 packages, one per
// lane, and NW warps; warp w carries the TPT adjacent tiles w·TPT …
// w·TPT + TPT − 1 (TPT a template parameter, the fewest of 1, 2, 4, 8 that
// keep NW ≤ FS_MAX_WARPS: 2 tiles × 24 warps at 47 tiles, 8 × 16 at 128).
// So a warp is 32 packages at one tile: every load of ρ and store of temps
// and freqs is 128 consecutive bytes (packages are the contiguous axis of
// every plane), and a warp's Γ rows are the same for every lane.  Pole,
// stats, frequency and latch state live in registers for the whole
// window.  The main path's configuration (coupled v24, cubic power law) is
// a second template parameter, so its kernel carries no other mode's
// branches; the per-package planes are a third (PLANES, never with MAIN).
//
// Per-package planes (PLANES).  The lane that owns a package holds its own
// values: the het rows (decay and gain per pole, η, ΣG, poll) are loaded
// in the prologue as registers per tile — −(1 − η) and 1/(η·ΣG) formed
// there with the plain version's f32 ops, (1 − a)·G per pole likewise — so
// identical draws give the homogeneous kernel's bits.  The degraded
// fallback holds the last finite ρ per tile in a register and replaces a
// non-finite word before anything reads it (the filtration, P_now, the Γ
// walk: a sanitised plane keeps the sparse walk exact); the sanitised ρ
// goes to a scratch plane, which the ring reads instead of ρ.  Whether a
// package's step was finite over all its tiles crosses warps: a shared
// step stamp, read after the step's barrier, where every warp advances its
// own copy of the package's f32 staleness counter and latch (the same
// values in every warp).  The operator pin is one register.  A reactive
// lane (latched or pinned) takes the merged branch: the plant at last
// step's frequency, the sensor polled on the global step step0 + s with
// its own period, the hysteresis latch, fresh engagements as events.
//
// Wide layout (more than 128 tiles; the packed layout's shared memory, two
// exchange planes of n_tiles × 128 floats and the walk records, outgrows
// the SM past that; up to 4,096 tiles).  One block per package, one thread
// per tile (WT tiles a thread past 1,024), everything else as above, in a
// simpler schedule: two barriers per step (after the pre-decision planes,
// after the power plane).  Each thread walks its own Γ row through a
// compact list the wrapper builds once per Γ — the row's non-zero columns,
// ascending, stored [entry][row] so a warp's reads are consecutive — and a
// block whose plane holds a non-finite value in a step walks Γ densely.
// A coupled fleet with a reactive plane (fallback or pin) takes this
// layout at any width: the packed schedule forms step s + 1's P_prev
// before step s's merged branch settles a reactive lane's frequency.
//
// Γ products.  The prologue compacts Γ (dense, as the wrapper passes it),
// per warp, into the columns where any of the warp's TPT rows is non-zero,
// ascending — one ballot per 32 columns; 530 columns over 24 warps at 47
// tiles, where the rows alone hold 811 non-zeros.  A record (column offset,
// TPT Γ values) is one broadcast 8- or 16-byte shared read with the same
// trip count for every lane (no divergence over rows of 10 to 25
// non-zeros), and each column's plane values, read once for all TPT rows,
// are 32 consecutive floats (no bank conflict).  The three pre-decision
// products (Γ·P_ahead, Γ·P_now, Γ·P_prev) of step s and the plant product
// of step s − 1 share each read: one pass over the records per step.  A
// skipped zero, or a zero of one row at another row's column, is an fmaf
// that adds an exact 0 for a finite power, so the walk equals
// core.coupling.apply_coupling's dense j = 0…n−1 order bit for bit; where
// a package's plane holds a non-finite value in a step (0·inf and 0·NaN
// reach every row densely), that package takes the dense walk for that
// step, reading Γ from device memory.  The flag rides in shared memory as
// a step stamp (no reset needed).
//
// One barrier per step.  The exchange planes are double-buffered by step
// parity, and a column's four values (P_ahead, P_now, P_prev, the plant
// power) sit 32 floats apart.  Iteration s runs step s − 1's plant product
// on the last barrier's power plane, step s's law on its planes (writing
// step s's power), and step s + 1's filtration and pre-decision planes
// (its P_prev takes step s's frequency), then one barrier.  "Any real tile
// over t_crit" is an OR across a package's tile threads through shared
// step stamps, folded by tile 0's thread two steps later.
//
// Filtration ring.  Not stored: ring slot (s − a) mod W holds ρ of step
// s − a, which is in this launch's input (or in buf0 before the window),
// so the evicted and the recent-quarter samples are re-read from ρ / buf0
// (L1 or L2 hits: the block read them a few steps earlier), a phase ahead
// of their use with the step's own ρ, and the final ring is gathered the
// same way.  That keeps shared memory to Γ and the exchange planes at any
// window depth.
//
// Control law: one pow per (package, tile, step).  clip and min are
// monotone and a correctly rounded pow is monotone in its base, so
// min(clip(pow(a)), clip(pow(b))) = clip(pow(min(a, b))), NaN included
// (nmin propagates it); the one exception, pow(−inf) = +inf above the NaN
// of a finite negative base, is taken by `law_base`.
//
// Bound on the H100 (per package-step, v24 coupled, n tiles), counted as
// `fleet_step_cost` in repro_torch/kernels/fleet_step.py counts it:
//   operations: 4 Γ mat-vecs (hint, load floor, neighbour heat, plant) at 2
//               FLOP per NON-ZERO of Γ — the 47-tile Ponte-Vecchio Γ has 811
//               of 2,209 entries non-zero, so 6,488 FLOP — plus ~67·n
//               elementwise (3,161 at n = 47), each pow counted as one f32
//               operation;
//   bytes:      ρ in, temp and freq out = 12·n B (n = 47: 564 B), plus the
//               state once per window;
//   47 tiles:   ~17 FLOP/B, below the f32 ridge (67 TFLOP/s / 3.35 TB/s ≈ 20
//               FLOP/B) — bound by bytes (0.186 ms per [256, 47, 4,096]
//               window, as chip_smoke.py prints it);
//   1–4 tiles:  ≤ ~9 FLOP/B — bound by bytes.
// What keeps it above that bound: instruction issue.  A warp issues over a
// thousand instructions per tile and step (its SASS): the walks' reads and
// FMAs, the f64 pow, and the elementwise work with its addressing and
// predicates; 4,096 packages are 128 blocks of 24 warps on 132 SMs, whose
// registers (80 a thread) leave no room for a second block.  Registers and
// spills (`nvcc -Xptxas -v`, CUDA 12.8, printed by chip_smoke.py): the
// main-path kernel <2, true> 80 registers, no spills; <1, *> 64–70 and
// <2, false>, <4, *> 80, no spills; <8, *> 40 with 40–64 bytes of spill.
// ρ is fetched into registers a phase ahead rather than staged in shared
// memory: the issued instructions alone account for the kernel's time.
// Few packages use few SMs (n / 32 blocks): 47 tiles × 64 packages run on
// two.
//
// Numerics: built without fast math and with -fmad=false, so each
// elementwise multiply and add rounds separately as in the plain version;
// explicit fmaf only where every version fuses: the mat-vecs (accumulated
// over j = 0..n-1, the order of core.coupling.apply_coupling), the
// multiply-adds of the three results that cancel — ΔT = α·R_tok + β in the
// power chain, the centered moment csum (update and refresh) and the v24
// budget (repro_torch.fma_f32) — and the pole update a·s + (1 − a)·G·P,
// which the reference's compiled loop contracts (thermal.step_fused); the 1/exponent law is pow (never cbrt) in
// f64 rounded once to f32 (repro_torch.pow_f32); the budget multiplies by
// the explicit reciprocal; min/max/clip propagate NaN like torch.minimum /
// torch.clamp.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define FS_MAX_POLES 4
#define FS_MAX_WARPS 24   // warps per block; past it a thread takes more tiles
#define FS_PACKED_TILES 128   // the packed layout's widest fleet
#define FS_WIDE_THREADS 1024  // the wide layout's block

enum { MODE_V24 = 0, MODE_REACTIVE = 1, MODE_REACTIVE_POLL = 2, MODE_OFF = 3 };

// Mirrors `_Consts` in repro_torch/kernels/fleet_step.py field for field
// (every field is 4 bytes, so there is no padding).
struct FleetStepConsts {
  int T, n_tiles, n, window, recent, n_poles, mode, use_gamma, poll_ticks;
  int step0;
  int exp_kind;  // 3: x*x*x, 2: x*x, else powf(x, power_exponent)
  int het, fallback, mixed, stale_limit, recover;  // the per-package planes
  float power_exponent, inv_exp;
  float tm, tm1, inv_q, inv_denom, ahead, rho_hi;
  float rtok_slope, rtok_icept, alpha, beta, inv_rth;
  float t_allow, one_m_eta, inv_eta_gain;
  float t_crit, t_ambient, throttle_floor, throttle_level, resume_below, ramp;
  float decay[FS_MAX_POLES], coef[FS_MAX_POLES];
};

namespace {

constexpr unsigned FULL = 0xffffffffu;

// min / max with NaN in either operand propagating, as torch.minimum /
// torch.clamp: one min.NaN / max.NaN instruction (sm_80+)
__device__ __forceinline__ float nmin(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float nmax(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return nmin(nmax(x, lo), hi);
}
template <bool MAIN>
__device__ __forceinline__ float powe(const FleetStepConsts& c, float x) {
  if (MAIN || c.exp_kind == 3) return (x * x) * x;
  if (c.exp_kind == 2) return x * x;
  return powf(x, c.power_exponent);
}
// x ** y correctly rounded to f32: pow in f64, one rounding (pow_f32)
__device__ __forceinline__ float pow_rn(float x, float y) {
  return (float)pow((double)x, (double)y);
}
// The base whose pow gives min(clip(pow(a)), clip(pow(b))) for the law's
// positive exponent: the lower one — but pow(−inf) = +inf, above every
// finite base's, so a −inf yields to the other
__device__ __forceinline__ float law_base(float a, float b) {
  const float lo = nmin(a, b);
  return lo == -INFINITY ? nmax(a, b) : lo;
}
__device__ __forceinline__ float power_from(const FleetStepConsts& c, float r) {
  return fmaf(c.alpha, fmaf(c.rtok_slope, r, c.rtok_icept), c.beta) * c.inv_rth;
}
__device__ __forceinline__ bool finite3(float a, float b, float d) {
  return isfinite(a) && isfinite(b) && isfinite(d);
}

// Words of one union-walk record: the plane offset j·128 (as int bits), then
// Γ[tile_k, j] of the thread's TPT tiles, padded to whole 8- or 16-byte loads
__host__ __device__ constexpr int rec_words(int tpt) {
  return tpt == 1 ? 2 : (tpt + 4) / 4 * 4;
}

template <int TPT>
__device__ __forceinline__ int load_rec(const float* r, float (&g)[TPT]) {
  constexpr int RW = rec_words(TPT);
  float w[RW];
  if constexpr (RW == 2) {
    const float2 v = *reinterpret_cast<const float2*>(r);
    w[0] = v.x; w[1] = v.y;
  } else {
#pragma unroll
    for (int q = 0; q < RW / 4; ++q) {
      const float4 v = reinterpret_cast<const float4*>(r)[q];
      w[4 * q] = v.x; w[4 * q + 1] = v.y; w[4 * q + 2] = v.z;
      w[4 * q + 3] = v.w;
    }
  }
#pragma unroll
  for (int k = 0; k < TPT; ++k) g[k] = w[1 + k];
  return __float_as_int(w[0]);
}

// The per-package planes' pointers: inputs (het rows [2·np + 3, nt, n],
// held ρ [nt, n], counter [n], latch [n], pin [n]) and outputs (held ρ,
// counter, latch, and the sanitised ρ [T, nt, n] the ring reads)
struct Planes {
  const float *het, *rl0, *st0, *dg0, *mode0;
  float *rl, *st, *dg, *rho_s;
};

// Per-thread physics constants of one tile: the baked ones, or the het
// rows' with the same f32 ops (so identical draws give the same bits)
struct TileConsts {
  float decay[FS_MAX_POLES], coef[FS_MAX_POLES];
  float neg_one_m_eta, inv_eta_gain;
  int poll;
};

__device__ __forceinline__ TileConsts tile_consts(const FleetStepConsts& c,
                                                  const float* het,
                                                  size_t at, size_t plane,
                                                  bool ok) {
  TileConsts t;
#pragma unroll
  for (int j = 0; j < FS_MAX_POLES; ++j) {
    t.decay[j] = c.decay[j];
    t.coef[j] = c.coef[j];
  }
  t.neg_one_m_eta = -c.one_m_eta;
  t.inv_eta_gain = c.inv_eta_gain;
  t.poll = c.poll_ticks;
  if (c.het && ok) {
    const int np_ = c.n_poles;
#pragma unroll
    for (int j = 0; j < FS_MAX_POLES; ++j) {
      if (j < np_) {
        const float a = het[j * plane + at], g = het[(np_ + j) * plane + at];
        t.decay[j] = a;
        t.coef[j] = (1.0f - a) * g;
      }
    }
    const float eta = het[2 * np_ * plane + at];
    const float gsum = het[(2 * np_ + 1) * plane + at];
    t.neg_one_m_eta = -(1.0f - eta);
    t.inv_eta_gain = 1.0f / (eta * gsum);
    t.poll = (int)het[(2 * np_ + 2) * plane + at];
  }
  return t;
}

// The fallback's per-package counter and latch after one step
__device__ __forceinline__ void fallback_step(const FleetStepConsts& c,
                                              bool valid_step, float& stale,
                                              float& degp) {
  stale = valid_step ? fmaxf(stale - 1.0f, 0.0f)
                     : fminf(stale + 1.0f, (float)(c.stale_limit + c.recover));
  degp = ((degp > 0.5f && stale > 0.5f) || stale >= (float)c.stale_limit)
             ? 1.0f : 0.0f;
}

// MAIN: the main path's configuration — coupled v24 with the cubic power
// law — fixed at compile time, so its kernel carries no other mode's code.
// PLANES: the per-package planes (het rows, fallback, pin) are compiled in
template <int TPT, bool MAIN, bool PLANES>
__global__ void __launch_bounds__(32 * FS_MAX_WARPS)
fleet_step_kernel(const FleetStepConsts c,
                  const float* __restrict__ rho, const float* __restrict__ gamma,
                  const float* __restrict__ buf0, const float* __restrict__ th0,
                  const float* __restrict__ stats0,
                  const float* __restrict__ freq0,
                  const float* __restrict__ ev0, const float* __restrict__ thr0,
                  float* __restrict__ temps, float* __restrict__ freqs,
                  float* __restrict__ buf, float* __restrict__ th,
                  float* __restrict__ ev, float* __restrict__ thr,
                  const Planes pl) {
  constexpr int RW = rec_words(TPT);
  const int nt = c.n_tiles, n = c.n, W = c.window, Q = c.recent;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int pkg = blockIdx.x * 32 + lane;
  const bool valid = pkg < n;     // padded lanes compute, never touch memory
  const bool coupled = MAIN || c.use_gamma != 0;
  const bool v24 = MAIN || c.mode == MODE_V24;
  const bool rpoll = !MAIN && c.mode == MODE_REACTIVE_POLL;
  const bool fb = PLANES && c.fallback != 0;
  const bool merged = PLANES && (c.fallback != 0 || c.mixed != 0);
  const bool het_poll = PLANES && c.het != 0;
  const int lag = Q == 0 ? W : Q;  // age of ring slot (ptr − Q) mod W
  const size_t plane = (size_t)nt * n;
  // the ring's samples inside the window: raw ρ, or the fallback's
  // sanitised copy (written by this thread before it reads it back)
  const float* ring_src = fb ? pl.rho_s : rho;

  extern __shared__ __align__(16) float smem[];
  // exchange planes [2 steps][tile][P_ahead, P_now, P_prev, plant power]
  // [lane]: one column's four values sit 32 floats apart, so a walk
  // reaches them from one address with immediate offsets
  const int pn = coupled ? nt * 128 : 0;              // floats per step
  float* s_x = smem;
  float* s_rec = s_x + 2 * pn;        // [warp][union column][RW]
  int* s_ulen = reinterpret_cast<int*>(s_rec + (coupled ? nw * nt * RW : 0));
  int* s_ev = s_ulen + 32;            // [2][32] event stamps
  int* s_bx = s_ev + 64;              // [2][32] non-finite stamps, x planes
  int* s_bp = s_bx + 64;              // [2][32] non-finite stamps, pw plane
  int* s_nf = s_bp + 64;              // [2][32] non-finite ρ stamps (fb)

  for (int i = threadIdx.x; i < 256; i += blockDim.x) s_ev[i] = 0;
  if (coupled) {
    // this warp's union walk: the columns where any of its tiles' Γ rows is
    // non-zero, ascending, one ballot per 32 columns (a NaN entry counts as
    // non-zero, NaN != 0, so it stays in the walk)
    float* rec = s_rec + warp * nt * RW;
    int cnt = 0;
    for (int j0 = 0; j0 < nt; j0 += 32) {
      const int j = j0 + lane;
      float g[TPT];
      bool any = false;
#pragma unroll
      for (int k = 0; k < TPT; ++k) {
        const int tile = warp * TPT + k;
        g[k] = (j < nt && tile < nt) ? gamma[(size_t)tile * nt + j] : 0.0f;
        any = any || g[k] != 0.0f;
      }
      const unsigned m = __ballot_sync(FULL, any);
      if (any) {
        float* r = rec + (cnt + __popc(m & ((1u << lane) - 1u))) * RW;
        r[0] = __int_as_float(j * 128);
#pragma unroll
        for (int q = 1; q < RW; ++q) r[q] = q <= TPT ? g[q - 1] : 0.0f;
      }
      cnt += __popc(m);
    }
    if (lane == 0) s_ulen[warp] = cnt;
  }

  // ring slot written at `step` (step < 0: before the window, from buf0);
  // the sanitised copy is read through L2 (ld.cg), never a read-only path
  auto ld_src = [&](size_t i) -> float {
    return fb ? __ldcg(ring_src + i) : ring_src[i];
  };
  auto ring_at = [&](int step, size_t at) -> float {
    return step >= 0 ? ld_src((size_t)step * plane + at)
                     : buf0[(size_t)(step + W) * plane + at];
  };

  float th_r[TPT][FS_MAX_POLES], wsum[TPT], csum[TPT], rsum[TPT], f[TPT];
  float gd[TPT], r_n[TPT], xo_n[TPT], xr_n[TPT];
  float p_now[TPT], p_prev[TPT], hint_u[TPT], f_new[TPT], power[TPT];
  bool latch[TPT];
  TileConsts tc[PLANES ? TPT : 1];
  float held[PLANES ? TPT : 1];      // the fallback's last finite ρ
#pragma unroll
  for (int k = 0; k < TPT; ++k) {
    const int tile = warp * TPT + k;
    const bool ok = tile < nt && valid;
    const size_t at = (size_t)tile * n + pkg;
#pragma unroll
    for (int j = 0; j < FS_MAX_POLES; ++j)
      th_r[k][j] = (j < c.n_poles && ok) ? th0[j * plane + at] : 0.0f;
    wsum[k] = ok ? stats0[at] : 0.0f;
    csum[k] = ok ? stats0[plane + at] : 0.0f;
    rsum[k] = ok ? stats0[2 * plane + at] : 0.0f;
    f[k] = ok ? freq0[at] : 1.0f;
    f_new[k] = f[k];
    power[k] = 0.0f;
    latch[k] = ((rpoll || merged) && ok) ? thr0[at] > 0.5f : false;
    gd[k] = (coupled && tile < nt) ? gamma[(size_t)tile * nt + tile] : 1.0f;
    r_n[k] = ok ? rho[at] : 1.0f;              // step 0's ρ and ring reads
    xo_n[k] = ok ? ring_at(-W, at) : 0.0f;
    xr_n[k] = ok ? ring_at(-lag, at) : 0.0f;
    if constexpr (PLANES) {
      tc[k] = tile_consts(c, pl.het, at, plane, ok);
      held[k] = (fb && ok) ? pl.rl0[at] : 1.0f;
    }
  }
  float evc = (warp == 0 && valid) ? ev0[pkg] : 0.0f;  // tile 0 owns the count
  // the package's fallback counter and latch (every warp keeps a copy)
  float stale = (fb && valid) ? pl.st0[pkg] : 0.0f;
  float degp = (fb && valid) ? pl.dg0[pkg] : 0.0f;
  const float pin = (PLANES && c.mixed && valid) ? pl.mode0[pkg] : 0.0f;
  bool deg = false;          // this step's reactive mask (merged branch)
  int to_refresh = W - 1;   // steps until the ring is age-ordered again
  int to_poll = (int)(((long long)c.poll_ticks
                       - ((long long)c.step0 % c.poll_ticks)) % c.poll_ticks);

  // ---- the step's three phases ------------------------------------------
  // pre(s): the fallback's hold, O(1) sliding filtration (+ exact refresh
  // at wraparound), P_now and, for v24, P_ahead and P_prev = P_now·f^e with
  // f = step s − 1's frequency; the coupled planes go to x buffer s & 1
  auto pre = [&](int s) {
    const bool refresh = to_refresh == 0;
    to_refresh = refresh ? W - 1 : to_refresh - 1;
    bool bad = false, stale_word = false;
#pragma unroll
    for (int k = 0; k < TPT; ++k) {
      const int tile = warp * TPT + k;
      if (tile >= nt) continue;
      const size_t at = (size_t)tile * n + pkg;
      float r = r_n[k];
      if constexpr (PLANES) {
        if (fb) {
          if (!isfinite(r)) {
            r = held[k];
            stale_word = true;
          }
          held[k] = r;
          if (valid) pl.rho_s[(size_t)s * plane + at] = r;
        }
      }
      const float x_old = xo_n[k], x_rec = xr_n[k];
      float wsum_n = (wsum[k] - x_old) + r;
      float csum_n = fmaf(c.tm, r, fmaf(c.tm1, x_old, csum[k] - wsum[k]));
      float rsum_n = (rsum[k] - x_rec) + r;
      if (refresh) {
        // recompute the three sums slot by slot, the order of the port's
        // `exact_stats`; slot j holds ρ of step s − W + 1 + j
        float a = 0.0f, b = 0.0f, d = 0.0f;
        const size_t x = (size_t)(s - W + 1) * plane + at;
#pragma unroll 4
        for (int j = 0; j < W; ++j) {
          const float xj = valid ? ld_src(x + (size_t)j * plane) : 0.0f;
          a = a + xj;
          b = fmaf((float)j - c.tm, xj, b);
          if (j >= W - Q) d = d + xj;
        }
        wsum_n = a; csum_n = b; rsum_n = d;
      }
      wsum[k] = wsum_n; csum[k] = csum_n; rsum[k] = rsum_n;
      p_now[k] = power_from(c, r);
      if (v24) {
        const float pred = clip(rsum[k] * c.inv_q
                                + (csum[k] * c.inv_denom) * c.ahead,
                                0.0f, c.rho_hi);
        const float p_ahead = power_from(c, pred);
        if (coupled) {
          p_prev[k] = p_now[k] * powe<MAIN>(c, f_new[k]);
          float* x = s_x + (s & 1) * pn + tile * 128 + lane;
          x[0] = p_ahead; x[32] = p_now[k]; x[64] = p_prev[k];
          bad = bad || !finite3(p_ahead, p_now[k], p_prev[k]);
        } else {
          hint_u[k] = nmax(p_ahead, p_now[k]);
        }
      }
    }
    if (bad && valid) s_bx[(s & 1) * 32 + lane] = s + 1;
    if (stale_word && valid) s_nf[(s & 1) * 32 + lane] = s + 1;
  };

  // The Γ walk of iteration s: the plant product on step s − 1's power
  // plane and, for v24, the three pre-decision products on step s's planes,
  // in one pass over the records (without Γ, the plant takes the power
  // itself).  At s = 0 the power plane and at s = T the x planes hold
  // nothing of use: those products are computed and discarded.  Each
  // record's zero entries add exact zeros for finite values, so the walk
  // equals the dense order; a package flagged non-finite in either plane
  // takes the dense walk for all of them.
  const float* rec = s_rec + warp * nt * RW;
  auto walk = [&](int s, float (&p_eff)[TPT], float (&ga)[TPT],
                  float (&gn)[TPT], float (&gp)[TPT]) {
    if (!coupled) {
#pragma unroll
      for (int k = 0; k < TPT; ++k) p_eff[k] = power[k];
      return;
    }
    const float* x = s_x + (s & 1) * pn + lane;
    const float* pw = s_x + ((s - 1) & 1) * pn + 96 + lane;
    if (s_bx[(s & 1) * 32 + lane] != s + 1 &&
        (s == 0 || s_bp[((s - 1) & 1) * 32 + lane] != s)) {
      const int len = s_ulen[warp];
#pragma unroll 2
      for (int e = 0; e < len; ++e) {
        float g[TPT];
        const int off = load_rec<TPT>(rec + e * RW, g);
        const float q = pw[off];
#pragma unroll
        for (int k = 0; k < TPT; ++k) p_eff[k] = fmaf(g[k], q, p_eff[k]);
        if (v24) {
          const float* xj = x + off;
          const float a = xj[0], b = xj[32], d = xj[64];
#pragma unroll
          for (int k = 0; k < TPT; ++k) {
            ga[k] = fmaf(g[k], a, ga[k]);
            gn[k] = fmaf(g[k], b, gn[k]);
            gp[k] = fmaf(g[k], d, gp[k]);
          }
        }
      }
    } else {
      for (int j = 0; j < nt; ++j) {
        const float* xj = x + j * 128;
#pragma unroll
        for (int k = 0; k < TPT; ++k) {
          const int tile = warp * TPT + k;
          const float g = tile < nt ? gamma[(size_t)tile * nt + j] : 0.0f;
          p_eff[k] = fmaf(g, pw[j * 128], p_eff[k]);
          if (v24) {
            ga[k] = fmaf(g, xj[0], ga[k]);
            gn[k] = fmaf(g, xj[32], gn[k]);
            gp[k] = fmaf(g, xj[64], gp[k]);
          }
        }
      }
    }
  };

  // law(s): the fallback's counter and latch for step s (its finite stamp
  // is complete after the barrier), then the control law on step s's walk
  // results; power to pw buffer s & 1
  auto law = [&](int s, const float (&ga)[TPT], const float (&gn)[TPT],
                 const float (&gp)[TPT]) {
    if constexpr (PLANES) {
      if (fb) fallback_step(c, s_nf[(s & 1) * 32 + lane] != s + 1, stale,
                            degp);
      deg = (c.fallback ? (c.mixed ? fmaxf(degp, pin) : degp) : pin) > 0.5f;
    }
    bool bad = false;
    float* pw = s_x + (s & 1) * pn + 96 + lane;
#pragma unroll
    for (int k = 0; k < TPT; ++k) {
      const int tile = warp * TPT + k;
      if (tile >= nt) continue;
      float dt = th_r[k][0];
#pragma unroll
      for (int j = 1; j < FS_MAX_POLES; ++j)
        if (j < c.n_poles) dt = dt + th_r[k][j];
      float fu;
      if (v24) {
        float nme = -c.one_m_eta, ieg = c.inv_eta_gain;
        if constexpr (PLANES) {
          nme = tc[k].neg_one_m_eta;
          ieg = tc[k].inv_eta_gain;
        }
        const float budget = fmaf(nme, dt, c.t_allow) * ieg;
        if (coupled) {
          // the lower of the law's two bases, one pow (see law_base)
          const float neigh = gp[k] - gd[k] * p_prev[k];
          const float base = law_base(
              budget / nmax(nmax(ga[k], gn[k]), 1e-3f),
              nmax(budget - neigh, 1e-6f) / nmax(gd[k] * p_now[k], 1e-3f));
          f_new[k] = nmin(clip(pow_rn(base, c.inv_exp), 0.05f, 1.0f),
                          f[k] + 0.05f);
        } else {
          f_new[k] = clip(pow_rn(budget / nmax(hint_u[k], 1e-3f), c.inv_exp),
                          0.05f, 1.0f);
        }
        // a reactive lane's plant runs at last step's frequency
        fu = (merged && deg) ? f[k] : f_new[k];
      } else if (!MAIN && c.mode == MODE_REACTIVE) {
        const bool hot = (c.t_ambient + dt) >= c.t_crit;
        f_new[k] = hot ? c.throttle_floor : nmin(f[k] + 0.1f, 1.0f);
        fu = f_new[k];
      } else if (!MAIN && c.mode == MODE_OFF) {
        f_new[k] = 1.0f;
        fu = 1.0f;
      } else {  // reactive_poll: the plant runs at LAST step's frequency
        f_new[k] = f[k];
        fu = f[k];
      }
      power[k] = p_now[k] * powe<MAIN>(c, fu);
      if (coupled) {
        pw[tile * 128] = power[k];
        bad = bad || !isfinite(power[k]);
      }
    }
    if (bad && valid) s_bp[(s & 1) * 32 + lane] = s + 1;
  };

  // plant(s): the poles on step s's Γ·power, temp, events, outputs
  auto plant = [&](int s, const float (&p_eff)[TPT]) {
    // sensor polled on the GLOBAL step, so window boundaries never reset a
    // package's cadence (reactive_poll and the merged branch)
    const bool polled_all = to_poll == 0;
    to_poll = polled_all ? c.poll_ticks - 1 : to_poll - 1;
    bool event = false;
#pragma unroll
    for (int k = 0; k < TPT; ++k) {
      const int tile = warp * TPT + k;
      if (tile >= nt) continue;
      float dt = 0.0f;
#pragma unroll
      for (int j = 0; j < FS_MAX_POLES; ++j) {
        if (j < c.n_poles) {
          float a = c.decay[j], b = c.coef[j];
          if constexpr (PLANES) {
            a = tc[k].decay[j];
            b = tc[k].coef[j];
          }
          th_r[k][j] = fmaf(a, th_r[k][j], b * p_eff[k]);
          dt = (j == 0) ? th_r[k][0] : dt + th_r[k][j];
        }
      }
      const float temp = c.t_ambient + dt;
      bool polled = polled_all;
      if constexpr (PLANES) {
        if (het_poll) polled = (c.step0 + s) % tc[k].poll == 0;
      }
      if (rpoll || (merged && deg)) {
        // events = fresh throttle engagements
        const bool trig = polled && temp >= c.t_crit;
        const bool cool = polled && temp <= c.resume_below;
        if (trig && !latch[k]) event = true;
        latch[k] = (latch[k] || trig) && !cool;
        f_new[k] = latch[k] ? c.throttle_level : nmin(f[k] + c.ramp, 1.0f);
      } else {
        latch[k] = false;
        if (temp > c.t_crit) event = true;
      }
      f[k] = f_new[k];
      if (valid) {
        const size_t o = (size_t)s * plane + (size_t)tile * n + pkg;
        temps[o] = temp;
        freqs[o] = f_new[k];
      }
    }
    if (event) s_ev[(s & 1) * 32 + lane] = s + 1;
  };

  // next step's ρ and ring reads, issued a phase ahead of their use
  auto fetch = [&](int s) {
#pragma unroll
    for (int k = 0; k < TPT; ++k) {
      const int tile = warp * TPT + k;
      if (tile >= nt || !valid) continue;
      const size_t at = (size_t)tile * n + pkg;
      r_n[k] = rho[(size_t)s * plane + at];
      xo_n[k] = ring_at(s - W, at);
      xr_n[k] = ring_at(s - lag, at);
    }
  };

  // One barrier per step: step s's law and step s + 1's pre-decision planes
  // are written between the same two barriers (x and pw double-buffered),
  // and step s's plant product runs after the barrier, in one walk with
  // step s + 1's pre-decision products; iteration T runs the last plant.
  __syncthreads();           // stamps zeroed before any step writes one
  pre(0);
  __syncthreads();
  for (int s = 0;; ++s) {
    if (s + 1 < c.T) fetch(s + 1);
    float p_eff[TPT], ga[TPT], gn[TPT], gp[TPT];
#pragma unroll
    for (int k = 0; k < TPT; ++k) p_eff[k] = ga[k] = gn[k] = gp[k] = 0.0f;
    walk(s, p_eff, ga, gn, gp);
    if (s > 0) plant(s - 1, p_eff);
    if (s == c.T) break;
    // step s − 2's event stamps are complete: fold them into the counter
    if (warp == 0 && s >= 2 && s_ev[(s & 1) * 32 + lane] == s - 1)
      evc = evc + 1.0f;
    law(s, ga, gn, gp);
    if (s + 1 < c.T) pre(s + 1);
    __syncthreads();
  }
  __syncthreads();
  if (warp == 0) {
    if (c.T >= 2 && s_ev[(c.T & 1) * 32 + lane] == c.T - 1) evc = evc + 1.0f;
    if (s_ev[((c.T - 1) & 1) * 32 + lane] == c.T) evc = evc + 1.0f;
  }

  if (!valid) return;
#pragma unroll
  for (int k = 0; k < TPT; ++k) {
    const int tile = warp * TPT + k;
    if (tile >= nt) continue;
    const size_t at = (size_t)tile * n + pkg;
    // ring slot j after the window: the last step s ≡ j (mod W) before T
    for (int j = 0; j < W; ++j) {
      const int last = (c.T - 1) - (((c.T - 1 - j) % W) + W) % W;
      buf[j * plane + at] = ring_at(last, at);
    }
#pragma unroll
    for (int j = 0; j < FS_MAX_POLES; ++j)
      if (j < c.n_poles) th[j * plane + at] = th_r[k][j];
    if (thr != nullptr) thr[at] = latch[k] ? 1.0f : 0.0f;
    if constexpr (PLANES) {
      if (fb) pl.rl[at] = held[k];
    }
  }
  if (warp == 0) {
    ev[pkg] = evc;
    if (fb) {
      pl.st[pkg] = stale;
      pl.dg[pkg] = degp;
    }
  }
}

// The wide layout: one block per package, thread i carries tiles i, i + B,
// … (WT of them, B = blockDim.x).  The Γ rows come as the wrapper's
// compact lists: entry e of row r at cols/vals[e·nt + r], e < len,
// ascending columns, zero-padded past a row's non-zeros (a padded entry
// adds an exact zero to a finite walk).  Shared memory: the three
// pre-decision planes and the power plane, [4][nt] floats.
template <int WT>
__global__ void __launch_bounds__(FS_WIDE_THREADS)
fleet_step_wide_kernel(const FleetStepConsts c,
                       const float* __restrict__ rho,
                       const float* __restrict__ gamma,
                       const int* __restrict__ g_cols,
                       const float* __restrict__ g_vals, int g_len,
                       const float* __restrict__ buf0,
                       const float* __restrict__ th0,
                       const float* __restrict__ stats0,
                       const float* __restrict__ freq0,
                       const float* __restrict__ ev0,
                       const float* __restrict__ thr0,
                       float* __restrict__ temps, float* __restrict__ freqs,
                       float* __restrict__ buf, float* __restrict__ th,
                       float* __restrict__ ev, float* __restrict__ thr,
                       const Planes pl) {
  const int nt = c.n_tiles, n = c.n, W = c.window, Q = c.recent;
  const int pkg = blockIdx.x, B = blockDim.x;
  const bool coupled = c.use_gamma != 0;
  const bool v24 = c.mode == MODE_V24;
  const bool rpoll = c.mode == MODE_REACTIVE_POLL;
  const bool fb = c.fallback != 0;
  const bool merged = c.fallback != 0 || c.mixed != 0;
  const int lag = Q == 0 ? W : Q;
  const size_t plane = (size_t)nt * n;
  const float* ring_src = fb ? pl.rho_s : rho;

  extern __shared__ __align__(16) float smem[];
  float* s_pa = smem;               // P_ahead [nt]
  float* s_pn = s_pa + nt;          // P_now
  float* s_pp = s_pn + nt;          // P_prev
  float* s_pw = s_pp + nt;          // the plant's power
  int* s_flag = reinterpret_cast<int*>(s_pw + nt);
  // stamps: [0] non-finite pre-decision plane, [1] non-finite power plane,
  // [2] non-finite ρ (fallback), [3..4] event of step parity 0/1
  if (threadIdx.x < 5) s_flag[threadIdx.x] = 0;

  auto ld_src = [&](size_t i) -> float {
    return fb ? __ldcg(ring_src + i) : ring_src[i];
  };
  auto ring_at = [&](int step, size_t at) -> float {
    return step >= 0 ? ld_src((size_t)step * plane + at)
                     : buf0[(size_t)(step + W) * plane + at];
  };
  // row r of Γ times plane x: the compact list, or dense where a value of
  // x is non-finite this step (0·inf and 0·NaN reach every row)
  auto row_dot = [&](int r, const float* x, bool dense) -> float {
    float acc = 0.0f;
    if (dense) {
      for (int j = 0; j < nt; ++j)
        acc = fmaf(gamma[(size_t)r * nt + j], x[j], acc);
    } else {
      for (int e = 0; e < g_len; ++e)
        acc = fmaf(g_vals[(size_t)e * nt + r], x[g_cols[(size_t)e * nt + r]],
                   acc);
    }
    return acc;
  };

  float th_r[WT][FS_MAX_POLES], wsum[WT], csum[WT], rsum[WT], f[WT];
  float gd[WT], p_now[WT], p_prev[WT], hint_u[WT], f_new[WT], power[WT];
  float held[WT];
  bool latch[WT];
  TileConsts tc[WT];
#pragma unroll
  for (int k = 0; k < WT; ++k) {
    const int tile = threadIdx.x + k * B;
    const bool ok = tile < nt;
    const size_t at = (size_t)tile * n + pkg;
#pragma unroll
    for (int j = 0; j < FS_MAX_POLES; ++j)
      th_r[k][j] = (j < c.n_poles && ok) ? th0[j * plane + at] : 0.0f;
    wsum[k] = ok ? stats0[at] : 0.0f;
    csum[k] = ok ? stats0[plane + at] : 0.0f;
    rsum[k] = ok ? stats0[2 * plane + at] : 0.0f;
    f[k] = ok ? freq0[at] : 1.0f;
    f_new[k] = f[k];
    latch[k] = ((rpoll || merged) && ok) ? thr0[at] > 0.5f : false;
    gd[k] = (coupled && ok) ? gamma[(size_t)tile * nt + tile] : 1.0f;
    tc[k] = tile_consts(c, pl.het, at, plane, ok);
    held[k] = (fb && ok) ? pl.rl0[at] : 1.0f;
  }
  float evc = threadIdx.x == 0 ? ev0[pkg] : 0.0f;
  float stale = fb ? pl.st0[pkg] : 0.0f;
  float degp = fb ? pl.dg0[pkg] : 0.0f;
  const float pin = c.mixed ? pl.mode0[pkg] : 0.0f;
  int to_refresh = W - 1;
  __syncthreads();

  for (int s = 0; s < c.T; ++s) {
    // -- pre: the fallback's hold, filtration, pre-decision planes --------
    const bool refresh = to_refresh == 0;
    to_refresh = refresh ? W - 1 : to_refresh - 1;
    bool bad = false, stale_word = false;
#pragma unroll
    for (int k = 0; k < WT; ++k) {
      const int tile = threadIdx.x + k * B;
      if (tile >= nt) continue;
      const size_t at = (size_t)tile * n + pkg;
      float r = rho[(size_t)s * plane + at];
      if (fb) {
        if (!isfinite(r)) {
          r = held[k];
          stale_word = true;
        }
        held[k] = r;
        pl.rho_s[(size_t)s * plane + at] = r;
      }
      const float x_old = ring_at(s - W, at), x_rec = ring_at(s - lag, at);
      float wsum_n = (wsum[k] - x_old) + r;
      float csum_n = fmaf(c.tm, r, fmaf(c.tm1, x_old, csum[k] - wsum[k]));
      float rsum_n = (rsum[k] - x_rec) + r;
      if (refresh) {
        float a = 0.0f, b = 0.0f, d = 0.0f;
        const size_t x = (size_t)(s - W + 1) * plane + at;
        for (int j = 0; j < W; ++j) {
          const float xj = ld_src(x + (size_t)j * plane);
          a = a + xj;
          b = fmaf((float)j - c.tm, xj, b);
          if (j >= W - Q) d = d + xj;
        }
        wsum_n = a; csum_n = b; rsum_n = d;
      }
      wsum[k] = wsum_n; csum[k] = csum_n; rsum[k] = rsum_n;
      p_now[k] = power_from(c, r);
      if (v24) {
        const float pred = clip(rsum[k] * c.inv_q
                                + (csum[k] * c.inv_denom) * c.ahead,
                                0.0f, c.rho_hi);
        const float p_ahead = power_from(c, pred);
        if (coupled) {
          p_prev[k] = p_now[k] * powe<false>(c, f[k]);
          s_pa[tile] = p_ahead; s_pn[tile] = p_now[k]; s_pp[tile] = p_prev[k];
          bad = bad || !finite3(p_ahead, p_now[k], p_prev[k]);
        } else {
          hint_u[k] = nmax(p_ahead, p_now[k]);
        }
      }
    }
    if (bad) s_flag[0] = s + 1;
    if (stale_word) s_flag[2] = s + 1;
    __syncthreads();
    // step s − 1's events are complete
    if (threadIdx.x == 0 && s >= 1 && s_flag[3 + ((s - 1) & 1)] == s)
      evc = evc + 1.0f;
    if (fb) fallback_step(c, s_flag[2] != s + 1, stale, degp);
    const bool deg =
        (c.fallback ? (c.mixed ? fmaxf(degp, pin) : degp) : pin) > 0.5f;

    // -- law ------------------------------------------------------------
    const bool dense_x = s_flag[0] == s + 1;
    bool pbad = false;
#pragma unroll
    for (int k = 0; k < WT; ++k) {
      const int tile = threadIdx.x + k * B;
      if (tile >= nt) continue;
      float dt = th_r[k][0];
#pragma unroll
      for (int j = 1; j < FS_MAX_POLES; ++j)
        if (j < c.n_poles) dt = dt + th_r[k][j];
      float fu;
      if (v24) {
        const float budget =
            fmaf(tc[k].neg_one_m_eta, dt, c.t_allow) * tc[k].inv_eta_gain;
        if (coupled) {
          const float ga = row_dot(tile, s_pa, dense_x);
          const float gn = row_dot(tile, s_pn, dense_x);
          const float gp = row_dot(tile, s_pp, dense_x);
          const float neigh = gp - gd[k] * p_prev[k];
          const float base = law_base(
              budget / nmax(nmax(ga, gn), 1e-3f),
              nmax(budget - neigh, 1e-6f) / nmax(gd[k] * p_now[k], 1e-3f));
          f_new[k] = nmin(clip(pow_rn(base, c.inv_exp), 0.05f, 1.0f),
                          f[k] + 0.05f);
        } else {
          f_new[k] = clip(pow_rn(budget / nmax(hint_u[k], 1e-3f), c.inv_exp),
                          0.05f, 1.0f);
        }
        fu = (merged && deg) ? f[k] : f_new[k];
      } else if (c.mode == MODE_REACTIVE) {
        const bool hot = (c.t_ambient + dt) >= c.t_crit;
        f_new[k] = hot ? c.throttle_floor : nmin(f[k] + 0.1f, 1.0f);
        fu = f_new[k];
      } else if (c.mode == MODE_OFF) {
        f_new[k] = 1.0f;
        fu = 1.0f;
      } else {
        f_new[k] = f[k];
        fu = f[k];
      }
      power[k] = p_now[k] * powe<false>(c, fu);
      if (coupled) {
        s_pw[tile] = power[k];
        pbad = pbad || !isfinite(power[k]);
      }
    }
    if (pbad) s_flag[1] = s + 1;
    __syncthreads();

    // -- plant, sensor, events, outputs ----------------------------------
    const bool dense_p = s_flag[1] == s + 1;
    bool event = false;
#pragma unroll
    for (int k = 0; k < WT; ++k) {
      const int tile = threadIdx.x + k * B;
      if (tile >= nt) continue;
      const float pe = coupled ? row_dot(tile, s_pw, dense_p) : power[k];
      float dt = 0.0f;
#pragma unroll
      for (int j = 0; j < FS_MAX_POLES; ++j) {
        if (j < c.n_poles) {
          th_r[k][j] = fmaf(tc[k].decay[j], th_r[k][j], tc[k].coef[j] * pe);
          dt = (j == 0) ? th_r[k][0] : dt + th_r[k][j];
        }
      }
      const float temp = c.t_ambient + dt;
      const bool polled = (c.step0 + s) % tc[k].poll == 0;
      if (rpoll || (merged && deg)) {
        const bool trig = polled && temp >= c.t_crit;
        const bool cool = polled && temp <= c.resume_below;
        if (trig && !latch[k]) event = true;
        latch[k] = (latch[k] || trig) && !cool;
        f_new[k] = latch[k] ? c.throttle_level : nmin(f[k] + c.ramp, 1.0f);
      } else {
        latch[k] = false;
        if (temp > c.t_crit) event = true;
      }
      f[k] = f_new[k];
      const size_t o = (size_t)s * plane + (size_t)tile * n + pkg;
      temps[o] = temp;
      freqs[o] = f_new[k];
    }
    if (event) s_flag[3 + (s & 1)] = s + 1;
  }
  __syncthreads();
  if (threadIdx.x == 0 && s_flag[3 + ((c.T - 1) & 1)] == c.T)
    evc = evc + 1.0f;

#pragma unroll
  for (int k = 0; k < WT; ++k) {
    const int tile = threadIdx.x + k * B;
    if (tile >= nt) continue;
    const size_t at = (size_t)tile * n + pkg;
    for (int j = 0; j < W; ++j) {
      const int last = (c.T - 1) - (((c.T - 1 - j) % W) + W) % W;
      buf[j * plane + at] = ring_at(last, at);
    }
#pragma unroll
    for (int j = 0; j < FS_MAX_POLES; ++j)
      if (j < c.n_poles) th[j * plane + at] = th_r[k][j];
    if (thr != nullptr) thr[at] = latch[k] ? 1.0f : 0.0f;
    if (fb) pl.rl[at] = held[k];
  }
  if (threadIdx.x == 0) {
    ev[pkg] = evc;
    if (fb) {
      pl.st[pkg] = stale;
      pl.dg[pkg] = degp;
    }
  }
}

// Tiles per thread: the fewest of 1, 2, 4, 8 that keep a block's warps
// (one per tile of each thread) within FS_MAX_WARPS; 0 if none does.
int tiles_per_thread(int n_tiles) {
  static const int choices[] = {1, 2, 4, 8};
  for (int t : choices)
    if ((n_tiles + t - 1) / t <= FS_MAX_WARPS) return t;
  return 0;
}

template <int TPT, bool MAIN, bool PLANES>
cudaError_t launch(const FleetStepConsts& c, const float* rho,
                   const float* gamma, const float* buf0, const float* th0,
                   const float* stats0, const float* freq0, const float* ev0,
                   const float* thr0, float* temps, float* freqs, float* buf,
                   float* th, float* ev, float* thr, const Planes& pl,
                   cudaStream_t stream) {
  const int nt = c.n_tiles;
  const int warps = (nt + TPT - 1) / TPT;
  const size_t pn = c.use_gamma ? (size_t)nt * 128 : 0;
  const size_t smem =
      sizeof(float) * (2 * pn + (c.use_gamma ? (size_t)warps * nt *
                                                   rec_words(TPT) : 0)) +
      sizeof(int) * (32 + 256);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fleet_step_kernel<TPT, MAIN, PLANES>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int blocks = (c.n + 31) / 32;
  fleet_step_kernel<TPT, MAIN, PLANES><<<blocks, 32 * warps, smem, stream>>>(
      c, rho, gamma, buf0, th0, stats0, freq0, ev0, thr0, temps, freqs, buf,
      th, ev, thr, pl);
  return cudaGetLastError();
}

template <int WT>
cudaError_t launch_wide(const FleetStepConsts& c, const float* rho,
                        const float* gamma, const int* g_cols,
                        const float* g_vals, int g_len, const float* buf0,
                        const float* th0, const float* stats0,
                        const float* freq0, const float* ev0,
                        const float* thr0, float* temps, float* freqs,
                        float* buf, float* th, float* ev, float* thr,
                        const Planes& pl, cudaStream_t stream) {
  const int threads = ((c.n_tiles + WT - 1) / WT + 31) / 32 * 32;
  const size_t smem = sizeof(float) * 4 * (size_t)c.n_tiles + sizeof(int) * 8;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fleet_step_wide_kernel<WT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  fleet_step_wide_kernel<WT><<<c.n, threads, smem, stream>>>(
      c, rho, gamma, g_cols, g_vals, g_len, buf0, th0, stats0, freq0, ev0,
      thr0, temps, freqs, buf, th, ev, thr, pl);
  return cudaGetLastError();
}

}  // namespace

// The layout a launch takes: 1 for the packed layout, 2 for the wide one.
// Wide past FS_PACKED_TILES tiles, and for a coupled fleet with a reactive
// lane plane (fallback or pin): the packed layout's one-barrier schedule
// forms a step's P_prev before that step's merged branch has settled the
// frequency a reactive lane ends on.
extern "C" int fleet_step_layout(int n_tiles, int use_gamma, int fallback,
                                 int mixed) {
  return (n_tiles > FS_PACKED_TILES || (use_gamma && (fallback || mixed)))
             ? 2 : 1;
}

// Launches one window on `stream`; returns the cudaError_t of the launch
// (0 on success).  thr0/thr are null unless mode is reactive_poll or a
// reactive plane is on; the plane pointers are null where the plane is
// off; g_cols/g_vals/g_len are the compact Γ rows of the wide layout.
extern "C" int fleet_step_launch(const FleetStepConsts* hc, const float* rho,
                                 const float* gamma, const int* g_cols,
                                 const float* g_vals, int g_len,
                                 const float* buf0, const float* th0,
                                 const float* stats0, const float* freq0,
                                 const float* ev0, const float* thr0,
                                 const float* het, const float* rl0,
                                 const float* st0, const float* dg0,
                                 const float* mode0, float* temps,
                                 float* freqs, float* buf, float* th,
                                 float* ev, float* thr, float* rl, float* st,
                                 float* dg, float* rho_s, void* stream) {
  const FleetStepConsts c = *hc;
  if (c.n_tiles < 1 || c.n < 1 || c.window < 1 || c.recent < 0 ||
      c.recent > c.window || c.n_poles < 1 || c.n_poles > FS_MAX_POLES ||
      c.poll_ticks < 1 || c.T < 1 || c.step0 < 0 ||
      (c.fallback && (c.stale_limit < 1 || c.recover < 1)))
    return (int)cudaErrorInvalidValue;
  auto st_ = static_cast<cudaStream_t>(stream);
  const Planes pl{het, rl0, st0, dg0, mode0, rl, st, dg, rho_s};
  const bool planes = c.het || c.fallback || c.mixed;
  if (fleet_step_layout(c.n_tiles, c.use_gamma, c.fallback, c.mixed) == 2) {
    if (c.use_gamma && (g_cols == nullptr || g_vals == nullptr || g_len < 0))
      return (int)cudaErrorInvalidValue;
    const int wt = (c.n_tiles + FS_WIDE_THREADS - 1) / FS_WIDE_THREADS;
#define FS_WIDE(K)                                                          \
    if (wt <= K)                                                            \
      return (int)launch_wide<K>(c, rho, gamma, g_cols, g_vals, g_len, buf0, \
                                 th0, stats0, freq0, ev0, thr0, temps,      \
                                 freqs, buf, th, ev, thr, pl, st_);
    FS_WIDE(1) FS_WIDE(2) FS_WIDE(4)
#undef FS_WIDE
    return (int)cudaErrorInvalidValue;
  }
  const bool main_path = c.use_gamma && c.mode == MODE_V24 &&
                         c.exp_kind == 3 && !planes;
  switch (tiles_per_thread(c.n_tiles)) {
#define FS_CASE(K)                                                          \
    case K:                                                                 \
      return (int)(main_path                                                \
          ? launch<K, true, false>(c, rho, gamma, buf0, th0, stats0, freq0, \
                                   ev0, thr0, temps, freqs, buf, th, ev,    \
                                   thr, pl, st_)                            \
          : planes                                                          \
          ? launch<K, false, true>(c, rho, gamma, buf0, th0, stats0, freq0, \
                                   ev0, thr0, temps, freqs, buf, th, ev,    \
                                   thr, pl, st_)                            \
          : launch<K, false, false>(c, rho, gamma, buf0, th0, stats0,       \
                                    freq0, ev0, thr0, temps, freqs, buf,    \
                                    th, ev, thr, pl, st_));
    FS_CASE(1) FS_CASE(2) FS_CASE(4) FS_CASE(8)
#undef FS_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}
