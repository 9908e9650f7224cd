"""fused backend — the hand-written `fleet_step` kernel as a fleet strategy.

Port of `repro.fleet.backends.fused`.  Per-step `update` is the broadcast
layout's (so `step()` works unchanged), but `run_block` — the unit of work of
`FleetEngine.run_block/run_chunked` and the streaming loop — advances the
whole [T, n_packages, n_tiles] window in ONE `fleet_step` call: on CUDA one
launch of the Hopper kernel, with ring, sliding statistics, control law,
pole states and event counters on chip for the whole window; on the CPU the
plain PyTorch version.

Caller contract kept from the reference:

  * the ring is rolled to ptr = 0 on entry, so the kernel's write pointer is
    just the window-local step mod W;
  * the sliding statistics are re-derived exactly (`exact_stats`) before the
    kernel and again from the returned ring after it, so f32 drift cannot
    accumulate across windows;
  * the state comes back in the common (broadcast) layout, either
    filtration representation;
  * temp/freq traces are returned as [T, n, tiles] views of the kernel's
    [T, tiles, n] planes;
  * active-lane masks never enter the kernel: the engine applies them in its
    telemetry reductions over the traces;
  * the per-package planes ride into the kernel: a heterogeneous fleet's
    draws as the het rows (`_het_rows`), a fitted ROM's per-tile bank as
    the same rows broadcast over the packages (`_rom_rows`), the degraded
    fallback's held ρ / counter / latch as ``fb0`` and the operator pins as
    ``mode0``; the returned state carries them back in its own dtypes;
  * a grid-family plant has no pole-bank plane: the backend drops
    `run_block` and the engine steps it through the per-step path.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import pdu_gate
from repro_torch.core.density import _RTOK_INTERCEPT, _RTOK_SLOPE
from repro_torch.core.fingerprint import FINGERPRINT
from repro_torch.core.scheduler import SchedulerState, ThermalScheduler
from repro_torch.fleet.backends.base import FleetBackend, register
from repro_torch.kernels.fleet_step import (FleetStepParams, compact_rows,
                                            fleet_step, layout)


@register
class FusedBackend(FleetBackend):
    name = "fused"

    def __init__(self, sched: ThermalScheduler):
        super().__init__(sched)
        plant = sched.plant
        if plant.family != "pole":
            # a grid state cannot live in the kernel's pole-bank plane:
            # shadow the method with None, so the engine's dispatch
            # (`backend_impl.run_block is not None`) runs the per-step path
            # for this backend, as the reference does
            self.run_block = None
            self.params = None
            return
        # a fitted ROM's per-tile bank rides the het rows (`_rom_rows`)
        self._rom_plant = plant if plant.name != "pole" else None
        c, fp = sched.cfg, sched.fp
        self.params = FleetStepParams(
            window=c.filtration_window,
            recent=pdu_gate.recent_len(c.filtration_window),
            n_poles=int(sched.poles.decay.shape[0]),
            mode=c.mode,
            use_gamma=sched.gamma is not None,
            power_exponent=float(c.power_exponent),
            eta=float(sched.eta),
            t_allow=float(fp.t_crit_c - c.t_safe_margin_c - fp.t_ambient_c),
            # a fitted ROM's gains differ per tile: they ride its het rows
            # alone, and the kernel refuses to run it without them
            gain_sum=(None if self._rom_plant is not None
                      else float(plant.gain_sum)),
            ahead=float(c.lookahead_ms / c.step_ms),
            # density.power_from_rho reads the module FINGERPRINT (not the
            # scheduler's fp): mirror that so both paths share one chain
            rtok_slope=float(_RTOK_SLOPE),
            rtok_icept=float(_RTOK_INTERCEPT),
            alpha=float(FINGERPRINT.alpha_c_per_mtps),
            beta=float(FINGERPRINT.beta_c),
            rth=float(FINGERPRINT.rth_c_per_w),
            rho_hi=float(1.5 * FINGERPRINT.rho_max),
            t_crit_c=float(fp.t_crit_c),
            t_ambient_c=float(fp.t_ambient_c),
            throttle_floor=float(fp.throttle_floor),
            decay=tuple(float(d) for d in sched.poles.decay),
            gain=(None if self._rom_plant is not None
                  else tuple(float(g) for g in sched.poles.gain)),
            throttle_level=float(c.throttle_level),
            resume_below_c=float(c.resume_below_c),
            ramp=float(sched.ramp),
            poll_ticks=int(sched.poll_ticks),
            fallback=bool(c.degraded_fallback),
            stale_limit=int(c.stale_limit_steps),
            recover=int(c.recover_steps),
            mixed=bool(c.mixed_mode),
        )
        # the kernel's wide layout walks Γ's compact rows: built here,
        # where Γ's lifetime is owned, once for every window
        self.rows = None
        if (sched.gamma is not None and self.device.type == "cuda"
                and layout(c.n_tiles, self.params) == "wide"):
            self.rows = compact_rows(sched.gamma)

    def _het_rows(self, pkg) -> torch.Tensor:
        """Per-package draws as the kernel's het rows [2·n_poles + 3,
        n_tiles | 1, n]: decay per pole, gain per pole, η, ΣG, poll."""
        f32 = lambda x: x.to(torch.float32)
        tr = lambda x: f32(x).permute(2, 1, 0)               # [np, t, n]
        one = lambda x: f32(x).mT[None]                      # [1, t, n]
        return torch.cat([tr(pkg.decay), tr(pkg.gain), one(pkg.eta),
                          one(pkg.gain_sum), one(pkg.poll_ticks)]
                         ).contiguous()

    def _rom_rows(self, n: int) -> torch.Tensor:
        """A fitted ROM bank as het rows [2·n_poles + 3, n_tiles, n]: the
        per-tile gains and ΣG, the shared decays, η and poll, the same for
        every package."""
        p = self._rom_plant
        n_poles, nt = p.poles.decay.shape[0], p.n_tiles
        rows = np.empty((2 * n_poles + 3, nt, 1), np.float32)
        rows[:n_poles] = np.asarray(p.poles.decay, np.float32)[:, None, None]
        rows[n_poles:2 * n_poles] = np.asarray(p.poles.gain,
                                               np.float32).T[:, :, None]
        rows[2 * n_poles] = np.float32(p.eta)
        rows[2 * n_poles + 1] = np.asarray(p.gain_sum, np.float32)[:, None]
        rows[2 * n_poles + 2] = np.float32(self.sched.poll_ticks)
        return torch.from_numpy(rows).to(self.device).expand(
            2 * n_poles + 3, nt, n).contiguous()

    def kernel_inputs(self, state: SchedulerState, rho_trace: torch.Tensor
                      ) -> tuple[tuple, dict]:
        """(args, kwargs) of the `fleet_step` call that advances ``state``
        over ``rho_trace`` [T, n, tiles]: the ring rolled to age order
        (ptr = 0), its exact statistics, every plane in the kernel's
        packages-last layout."""
        ft = state.filtration
        buf0 = torch.roll(ft.buf, -int(ft.ptr), dims=-2)     # age order
        wsum, csum, rsum = pdu_gate.exact_stats(buf0, 0)
        kn = lambda x: x.mT.contiguous()                     # [n, t] -> [t, n]
        args = (rho_trace.permute(0, 2, 1).contiguous(),     # [T, tiles, n]
                buf0.permute(1, 2, 0).contiguous(),          # [W, tiles, n]
                state.thermal.permute(2, 1, 0).contiguous(), # [poles, tiles, n]
                torch.stack([kn(wsum), kn(csum), kn(rsum)]),
                kn(state.freq),
                state.events.to(torch.float32)[None, :],
                self.sched.gamma,
                self.params)
        thr0 = (None if state.throttled is None
                else kn(state.throttled.to(torch.float32)))
        if state.pkg is not None:
            het = self._het_rows(state.pkg)
        elif self._rom_plant is not None:
            het = self._rom_rows(state.freq.shape[0])
        else:
            het = None
        fb0 = (None if state.degraded is None
               else (kn(state.rho_last.to(torch.float32)),
                     state.stale.to(torch.float32).contiguous(),
                     state.degraded.to(torch.float32).contiguous()))
        mode0 = (None if state.ctrl_mode is None
                 else state.ctrl_mode.to(torch.float32).contiguous())
        return args, dict(het=het, thr0=thr0, step0=int(state.step),
                          fb0=fb0, mode0=mode0, rows=self.rows)

    def run_block(self, state: SchedulerState, rho_trace: torch.Tensor):
        """Advance T steps in one kernel.  rho_trace: [T, n, tiles].

        Returns (state', temps [T, n, tiles], freqs [T, n, tiles]).
        """
        t = rho_trace.shape[0]
        ft = state.filtration
        w = ft.buf.shape[-2]
        args, kwargs = self.kernel_inputs(state, rho_trace)
        temps, freqs, buf, th, ev, thr, fb = fleet_step(*args, **kwargs)
        buf = buf.permute(2, 0, 1).contiguous()              # [n, W, tiles]
        ptr = torch.tensor(t % w, dtype=torch.int32)
        if isinstance(ft, pdu_gate.FiltrationStats):
            nwsum, ncsum, nrsum = pdu_gate.exact_stats(buf, ptr)
            ft_out = pdu_gate.FiltrationStats(buf=buf, ptr=ptr, wsum=nwsum,
                                              csum=ncsum, rsum=nrsum)
        else:
            ft_out = pdu_gate.Filtration(buf=buf, ptr=ptr)
        state = state._replace(
            thermal=th.permute(2, 1, 0).contiguous(),
            filtration=ft_out,
            freq=freqs[-1].mT.contiguous(),
            step=state.step + t,
            events=ev[0].to(state.events.dtype),
            throttled=None if thr is None else thr.mT > 0.5,
            rho_last=None if fb is None else fb[0].mT.contiguous(),
            stale=None if fb is None else fb[1].to(torch.int32),
            degraded=None if fb is None else fb[2] > 0.5,
        )
        return state, temps.permute(0, 2, 1), freqs.permute(0, 2, 1)
