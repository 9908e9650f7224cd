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
// Layout.  One thread per (package, tile): a block holds PB packages × all
// n_tiles tiles, thread id = tile·PB + package, so a warp spans packages at
// one or a few tiles and every load of ρ and store of temps/freqs is a run
// of consecutive package addresses (packages are the contiguous axis of
// every plane) that coalesces into whole 32-byte sectors (PB ≥ 8).  At 47
// tiles a package carries ~1,000 floats of state (W·tiles ring, pole,
// stats, freq planes) — far past one thread's registers under a
// "thread per package" layout; split over its 47 tile threads it is ~20
// floats each: pole/stats/freq/latch state in registers, the W-deep ring in
// shared memory (each thread only touches its own ring column, no bank
// conflicts).  Γ sits in shared memory; a mat-vec is a loop over the
// package's tiles reading Γ[i][j] (one address per tile row in a warp) and
// the tile-j power of the same package (broadcast across the warp's tile
// rows) from a shared exchange plane.  The three pre-decision products
// (Γ·P_ahead, Γ·P_now, Γ·P_prev) share one pass over Γ.  "Any real tile over
// t_crit" is an OR across the package's tile threads through a shared flag,
// double-buffered so a step needs only the two barriers the mat-vecs need.
// The whole window's time loop runs inside the launch; all state stays on
// chip and reaches device memory only at the end.
//
// Bound on the H100 (per package-step, v24 coupled, n tiles), counted as
// `fleet_step_cost` in repro_torch/kernels/fleet_step.py counts it:
//   operations: 4 Γ mat-vecs (hint, load floor, neighbour heat, plant) at 2
//               FLOP per NON-ZERO of Γ — the work the function needs; the
//               47-tile Ponte-Vecchio Γ has 811 of 2,209 entries non-zero,
//               so 6,488 FLOP — plus ~67·n elementwise (3,161 at n = 47),
//               each pow counted as one f32 operation;
//   bytes:      ρ in, temp and freq out = 12·n B (n = 47: 564 B), plus the
//               state once per window;
//   47 tiles:   ~17 FLOP/B, below the f32 ridge (67 TFLOP/s / 3.35 TB/s ≈ 20
//               FLOP/B) — bound by bytes (0.186 ms per [256, 47, 4,096]
//               window, as chip_smoke.py prints it);
//   1–4 tiles:  ≤ ~9 FLOP/B — bound by bytes.
// This first version does more than the function needs: its mat-vecs loop
// over Γ densely (2·n² FLOP each, 2.7× the non-zero count at 47 tiles), each
// multiply-add reads two shared-memory operands (4/3 in the shared pass),
// and the law's pow runs in f64 — together most of its gap to the bound.
// Skipping Γ's zeros and register-blocking its rows is the next step.
//
// Numerics: built without fast math and with -fmad=false, so each
// elementwise multiply and add rounds separately as in the plain version;
// explicit fmaf only where every version fuses: the mat-vecs (accumulated
// over j = 0..n-1, the order of core.coupling.apply_coupling) and the
// multiply-adds of the three
// results that cancel — ΔT = α·R_tok + β in the power chain, the centered
// moment csum (update and refresh) and the v24 budget (repro_torch.fma_f32);
// the 1/exponent law is pow (never cbrt) in f64 rounded once to f32
// (repro_torch.pow_f32); the budget multiplies by the explicit reciprocal;
// min/max/clip propagate NaN like torch.minimum / torch.clamp.
#include <cuda_runtime.h>
#include <stdint.h>

#define FS_MAX_POLES 4
#define FS_MAX_THREADS 1024

enum { MODE_V24 = 0, MODE_REACTIVE = 1, MODE_REACTIVE_POLL = 2, MODE_OFF = 3 };

// Mirrors `_Consts` in repro_torch/kernels/fleet_step.py field for field
// (every field is 4 bytes, so there is no padding).
struct FleetStepConsts {
  int T, n_tiles, n, window, recent, n_poles, mode, use_gamma, poll_ticks;
  int step0;
  int exp_kind;  // 3: x*x*x, 2: x*x, else powf(x, power_exponent)
  float power_exponent, inv_exp;
  float tm, tm1, inv_q, inv_denom, ahead, rho_hi;
  float rtok_slope, rtok_icept, alpha, beta, inv_rth;
  float t_allow, one_m_eta, inv_eta_gain;
  float t_crit, t_ambient, throttle_floor, throttle_level, resume_below, ramp;
  float decay[FS_MAX_POLES], coef[FS_MAX_POLES];
};

__device__ __forceinline__ float nmin(float a, float b) {
  return (a < b || a != a) ? a : b;  // NaN in either operand propagates
}
__device__ __forceinline__ float nmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return nmin(nmax(x, lo), hi);
}
__device__ __forceinline__ float powe(const FleetStepConsts& c, float x) {
  if (c.exp_kind == 3) return (x * x) * x;
  if (c.exp_kind == 2) return x * x;
  return powf(x, c.power_exponent);
}
// x ** y correctly rounded to f32: pow in f64, one rounding (pow_f32)
__device__ __forceinline__ float pow_rn(float x, float y) {
  return (float)pow((double)x, (double)y);
}
__device__ __forceinline__ float power_from(const FleetStepConsts& c, float r) {
  return fmaf(c.alpha, fmaf(c.rtok_slope, r, c.rtok_icept), c.beta) * c.inv_rth;
}

__global__ void __launch_bounds__(FS_MAX_THREADS)
fleet_step_kernel(const FleetStepConsts c, const int pb,
                  const float* __restrict__ rho, const float* __restrict__ gamma,
                  const float* __restrict__ buf0, const float* __restrict__ th0,
                  const float* __restrict__ stats0,
                  const float* __restrict__ freq0,
                  const float* __restrict__ ev0, const float* __restrict__ thr0,
                  float* __restrict__ temps, float* __restrict__ freqs,
                  float* __restrict__ buf, float* __restrict__ th,
                  float* __restrict__ ev, float* __restrict__ thr) {
  const int nt = c.n_tiles, n = c.n, W = c.window, Q = c.recent;
  const int nth = pb * nt;
  const int tid = threadIdx.x;
  const int pl = tid % pb;        // package within the block
  const int tile = tid / pb;
  const int pkg = blockIdx.x * pb + pl;
  const bool valid = pkg < n;     // padded lanes compute, never touch memory
  const bool coupled = c.use_gamma != 0;

  extern __shared__ float smem[];
  float* s_gamma = smem;                              // [nt·nt] if coupled
  float* s_x0 = s_gamma + (coupled ? nt * nt : 0);    // Γ·P exchange planes
  float* s_x1 = s_x0 + nth;
  float* s_x2 = s_x1 + nth;
  float* s_pw = s_x2 + nth;                           // plant power plane
  float* s_flag = s_pw + nth;                         // [2][pb] event flags
  float* s_ring = s_flag + 2 * pb;                    // [W][nth]

  if (coupled)
    for (int i = tid; i < nt * nt; i += nth) s_gamma[i] = gamma[i];
  for (int i = tid; i < 2 * pb; i += nth) s_flag[i] = 0.0f;

  const size_t plane = (size_t)nt * n;
  const size_t at = (size_t)tile * n + pkg;           // (tile, pkg) in a plane
  float* ring = s_ring + tid;
  for (int k = 0; k < W; ++k) ring[k * nth] = valid ? buf0[k * plane + at] : 0.0f;
  float th_r[FS_MAX_POLES];
#pragma unroll
  for (int j = 0; j < FS_MAX_POLES; ++j)
    th_r[j] = (j < c.n_poles && valid) ? th0[j * plane + at] : 0.0f;
  float wsum = valid ? stats0[at] : 0.0f;
  float csum = valid ? stats0[plane + at] : 0.0f;
  float rsum = valid ? stats0[2 * plane + at] : 0.0f;
  float f = valid ? freq0[at] : 1.0f;
  bool latch = (c.mode == MODE_REACTIVE_POLL && valid) ? thr0[at] > 0.5f : false;
  float evc = (tile == 0 && valid) ? ev0[pkg] : 0.0f;
  const float* grow = s_gamma + tile * nt;            // this tile's Γ row
  __syncthreads();
  const float gd = coupled ? grow[tile] : 1.0f;

  for (int s = 0; s < c.T; ++s) {
    const size_t o = (size_t)s * plane + at;
    const float r = valid ? rho[o] : 1.0f;

    // -- O(1) sliding filtration + exact refresh at wraparound -------------
    const int ptr = s % W;
    const float x_old = ring[ptr * nth];
    const float x_rec = ring[((ptr + W - Q) % W) * nth];
    float wsum_n = (wsum - x_old) + r;
    float csum_n = fmaf(c.tm, r, fmaf(c.tm1, x_old, csum - wsum));
    float rsum_n = (rsum - x_rec) + r;
    ring[ptr * nth] = r;
    if ((s + 1) % W == 0) {
      // the ring is age-ordered again (next ptr = 0): recompute the three
      // sums slot by slot, the order of the port's `exact_stats`
      float a = 0.0f, b = 0.0f, d = 0.0f;
      for (int k = 0; k < W; ++k) {
        const float x = ring[k * nth];
        a = a + x;
        b = fmaf((float)k - c.tm, x, b);
        if (k >= W - Q) d = d + x;
      }
      wsum_n = a; csum_n = b; rsum_n = d;
    }
    wsum = wsum_n; csum = csum_n; rsum = rsum_n;

    const float p_now = power_from(c, r);
    float dt_now = th_r[0];
#pragma unroll
    for (int j = 1; j < FS_MAX_POLES; ++j)
      if (j < c.n_poles) dt_now = dt_now + th_r[j];
    float p_ahead = 0.0f, p_prev = 0.0f;
    if (c.mode == MODE_V24) {
      const float pred = clip(rsum * c.inv_q + (csum * c.inv_denom) * c.ahead,
                              0.0f, c.rho_hi);
      p_ahead = power_from(c, pred);
      p_prev = p_now * powe(c, f);
      if (coupled) { s_x0[tid] = p_ahead; s_x1[tid] = p_now; s_x2[tid] = p_prev; }
    }
    __syncthreads();                                        // barrier A

    // last step's event flags are complete: fold them into the counter
    if (s > 0 && tile == 0) {
      float* fl = s_flag + ((s - 1) & 1) * pb + pl;
      evc = evc + *fl;
      *fl = 0.0f;
    }

    // -- control law --------------------------------------------------------
    float f_new, f_used;
    if (c.mode == MODE_V24) {
      float hint;
      float ga = 0.0f, gn = 0.0f, gp = 0.0f;
      if (coupled) {
        for (int j = 0; j < nt; ++j) {
          const float g = grow[j];
          const int xj = j * pb + pl;
          ga = fmaf(g, s_x0[xj], ga);
          gn = fmaf(g, s_x1[xj], gn);
          gp = fmaf(g, s_x2[xj], gp);
        }
        hint = nmax(ga, gn);
      } else {
        hint = nmax(p_ahead, p_now);
      }
      const float budget = fmaf(-c.one_m_eta, dt_now, c.t_allow) * c.inv_eta_gain;
      const float f_uni = clip(pow_rn(budget / nmax(hint, 1e-3f), c.inv_exp),
                               0.05f, 1.0f);
      if (coupled) {
        const float neigh = gp - gd * p_prev;
        const float f_cpl = clip(
            pow_rn(nmax(budget - neigh, 1e-6f) / nmax(gd * p_now, 1e-3f),
                   c.inv_exp), 0.05f, 1.0f);
        f_new = nmin(nmin(f_uni, f_cpl), f + 0.05f);
      } else {
        f_new = f_uni;
      }
      f_used = f_new;
    } else if (c.mode == MODE_REACTIVE) {
      const bool hot = (c.t_ambient + dt_now) >= c.t_crit;
      f_new = hot ? c.throttle_floor : nmin(f + 0.1f, 1.0f);
      f_used = f_new;
    } else if (c.mode == MODE_OFF) {
      f_new = 1.0f;
      f_used = f_new;
    } else {  // reactive_poll: the plant runs at LAST step's frequency
      f_new = f;
      f_used = f;
    }

    // -- plant ----------------------------------------------------------------
    const float power = p_now * powe(c, f_used);
    if (coupled) s_pw[tid] = power;
    __syncthreads();                                        // barrier B
    float p_eff = power;
    if (coupled) {
      p_eff = 0.0f;
      for (int j = 0; j < nt; ++j) p_eff = fmaf(grow[j], s_pw[j * pb + pl], p_eff);
    }
    float dt = 0.0f;
#pragma unroll
    for (int j = 0; j < FS_MAX_POLES; ++j) {
      if (j < c.n_poles) {
        th_r[j] = c.decay[j] * th_r[j] + c.coef[j] * p_eff;
        dt = (j == 0) ? th_r[0] : dt + th_r[j];
      }
    }
    const float temp = c.t_ambient + dt;

    // -- events ---------------------------------------------------------------
    float* flag = s_flag + (s & 1) * pb + pl;
    if (c.mode == MODE_REACTIVE_POLL) {
      // sensor polled on the GLOBAL step, so window boundaries never reset
      // a package's cadence; events = fresh throttle engagements
      const bool polled = ((long long)c.step0 + s) % c.poll_ticks == 0;
      const bool trig = polled && temp >= c.t_crit;
      const bool cool = polled && temp <= c.resume_below;
      if (trig && !latch) *flag = 1.0f;
      latch = (latch || trig) && !cool;
      f_new = latch ? c.throttle_level : nmin(f + c.ramp, 1.0f);
    } else if (temp > c.t_crit) {
      *flag = 1.0f;
    }
    f = f_new;
    if (valid) { temps[o] = temp; freqs[o] = f_new; }
  }
  __syncthreads();
  if (c.T > 0 && tile == 0) evc = evc + s_flag[((c.T - 1) & 1) * pb + pl];

  if (!valid) return;
  for (int k = 0; k < W; ++k) buf[k * plane + at] = ring[k * nth];
#pragma unroll
  for (int j = 0; j < FS_MAX_POLES; ++j)
    if (j < c.n_poles) th[j * plane + at] = th_r[j];
  if (tile == 0) ev[pkg] = evc;
  if (c.mode == MODE_REACTIVE_POLL) thr[at] = latch ? 1.0f : 0.0f;
}

// ---- host launch ------------------------------------------------------------

// Packages per block: ~256 threads, at least 8 packages (whole 32-byte
// sectors per tile row), halved down to 32 while the grid would leave the
// SMs underfilled.
static int packages_per_block(int n_tiles, int n) {
  int pb = 8;
  while (pb * 2 * n_tiles <= 256 && pb < 256) pb *= 2;
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  while (pb > 32 && (n + pb - 1) / pb < 2 * sms) pb /= 2;
  return pb;
}

// Launches one window on `stream`; returns the cudaError_t of the launch
// (0 on success).  thr0/thr may be null unless mode is reactive_poll.
extern "C" int fleet_step_launch(const FleetStepConsts* hc, const float* rho,
                                 const float* gamma, const float* buf0,
                                 const float* th0, const float* stats0,
                                 const float* freq0, const float* ev0,
                                 const float* thr0, float* temps, float* freqs,
                                 float* buf, float* th, float* ev, float* thr,
                                 void* stream) {
  const FleetStepConsts c = *hc;
  if (c.n_tiles < 1 || c.n < 1 || c.window < 1 || c.n_poles < 1 ||
      c.n_poles > FS_MAX_POLES || c.poll_ticks < 1)
    return (int)cudaErrorInvalidValue;
  const int pb = packages_per_block(c.n_tiles, c.n);
  const int nth = pb * c.n_tiles;
  if (nth > FS_MAX_THREADS) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) *
      ((c.use_gamma ? (size_t)c.n_tiles * c.n_tiles : 0) + 4 * (size_t)nth +
       2 * (size_t)pb + (size_t)c.window * nth);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fleet_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (c.n + pb - 1) / pb;
  fleet_step_kernel<<<blocks, nth, smem, (cudaStream_t)stream>>>(
      c, pb, rho, gamma, buf0, th0, stats0, freq0, ev0, thr0, temps, freqs,
      buf, th, ev, thr);
  return (int)cudaGetLastError();
}
