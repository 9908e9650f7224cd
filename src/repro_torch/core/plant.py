"""Thermal-plant fidelity ladder — one plant interface, three rungs.

Port of `repro.core.plant`.  The interface (consumed by `ThermalScheduler`
and through it by every fleet backend):

  * ``init_state(batch_shape)`` → state with TWO trailing (non-batch) dims;
  * ``step(state, power_w, poles=None)`` — one dt tick;
  * ``delta_t(state)`` → [..., n_tiles] tile temperatures;
  * ``eta`` / ``gain_sum`` — the f32 control constants the v24 budget law
    consumes, derived from the plant's own slow mode / DC gain.

Three rungs, as in the reference:

  * ``pole`` — `PoleBankPlant`, the paper's bank (the regression oracle);
  * ``grid`` — `GridPlant`, an explicit-Euler RC grid over floorplan cells
    whose whole-trace path is the hand-written ``grid_conv`` kernel;
  * ``rom`` — `FittedROMPlant`, a pole bank least-squares-fit from the
    grid's step response.

Plant constants are numpy f32 derived with the reference's numpy ops, so
they match it exactly; the per-step operators are tensors on the plant's
device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import thermal
from repro_torch.core.fingerprint import FINGERPRINT, Fingerprint
from repro_torch.kernels.thermal_conv import grid_conv, grid_operators

# ROM-vs-grid agreement: peak-ΔT relative tolerance over the 90k-step trace
# (the reference's `repro.core.plant.ROM_PEAK_TOL`)
ROM_PEAK_TOL = 0.02

_REGISTRY: dict[str, type] = {}


def register_plant(cls):
    """Class decorator: register a ThermalPlant under ``cls.name``."""
    _REGISTRY[cls.name] = cls
    return cls


def available_plants() -> list[str]:
    return sorted(_REGISTRY)


def plant_class(name: str) -> type:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown plant {name!r} "
                         f"(available: {', '.join(available_plants())})")


def make_plant(cfg, fp: Fingerprint = FINGERPRINT,
               device=None) -> "ThermalPlant":
    """Build the plant named by ``cfg.plant`` from a SchedulerConfig."""
    return plant_class(cfg.plant)(cfg, fp, device=device)


def _eta_f32(decay_slow, ahead: float):
    """η = 1 − a_slow^ahead in f32, via numpy (bit-identical to the
    reference's derivation for identical inputs)."""
    a = np.asarray(decay_slow, np.float32)
    return np.float32(1.0) - a ** np.float32(ahead)


class ThermalPlant:
    """Base class: one rung of the fidelity ladder (see module docstring)."""

    name: str = ""
    family: str = ""
    poles: "thermal.PoleParams | None" = None

    def __init__(self, cfg, fp: Fingerprint, device=None):
        self.cfg, self.fp = cfg, fp
        self.n_tiles = cfg.n_tiles
        self.device = device
        self.eta: float = 0.0          # preposition fraction for v24
        self.gain_sum = None           # ΣG (numpy f32)

    def init_state(self, batch_shape: tuple[int, ...] = ()) -> torch.Tensor:
        raise NotImplementedError

    def step(self, state, power_w, poles=None):
        raise NotImplementedError

    def delta_t(self, state):
        raise NotImplementedError

    def describe(self) -> str:
        return self.name


@register_plant
class PoleBankPlant(ThermalPlant):
    """The paper's pole bank (§4.2/§5.2) behind the plant interface."""

    name = "pole"
    family = "pole"

    def __init__(self, cfg, fp: Fingerprint, device=None):
        super().__init__(cfg, fp, device)
        self.poles = (thermal.two_pole(fp, cfg.step_ms) if cfg.two_pole
                      else thermal.single_pole(fp, cfg.step_ms))
        self.eta = float(_eta_f32(self.poles.decay[-1],
                                  cfg.lookahead_ms / cfg.step_ms))
        self.gain_sum = self.poles.gain.sum()
        self._poles_dev = thermal.PoleParams(
            decay=torch.as_tensor(self.poles.decay, device=device),
            gain=torch.as_tensor(self.poles.gain, device=device))

    def init_state(self, batch_shape: tuple[int, ...] = ()) -> torch.Tensor:
        return thermal.init_state(self.poles, self.n_tiles, batch_shape,
                                  device=self.device)

    def step(self, state, power_w, poles=None):
        """One tick on the plant's bank, or on ``poles`` — per-package
        draws [*batch, n_tiles | 1, n_poles] of a heterogeneous fleet —
        with the reference's rounding (`thermal.step_fused`)."""
        return thermal.step_fused(self._poles_dev if poles is None
                                  else poles, state, power_w)

    def delta_t(self, state):
        return thermal.delta_t(state)

    def describe(self) -> str:
        return f"pole[n_poles={self.poles.decay.shape[0]}]"


@register_plant
class GridPlant(ThermalPlant):
    """Spatial RC grid: per tile a gy×gx cell patch, explicit Euler.

    Per-cell physics (hat units — conductances normalised by the mean
    vertical conductance, capacitance uniform):

        T' = T + r·(Rth·P_tile − ĝ∘T + κ·(A·T − deg∘T)),   r = dt/(τ·s)

    ĝ is the vertical-conductance map (mean 1): the trailing ``bridge_frac``
    columns of every tile sit in an EMIB "bridge shadow" with conductance
    scaled by (1 − grid_contrast), the §5.2 slow lateral pole recovered from
    geometry.  κ = grid_kappa; tile walls are adiabatic (no edge across
    them in A).  Power is injected uniformly over a tile's patch;
    `delta_t` reads the patch mean.  η comes from the patch operator's
    slowest eigen-decay, ΣG from its DC solve.

    State layout: [*batch, gy, n_tiles·gx].  `step` is the per-step form the
    fleet engine scans; `simulate` runs a whole trace through `grid_conv`.
    """

    name = "grid"
    family = "grid"
    bridge_frac = 0.25   # fraction of tile columns under the bridge shadow

    def __init__(self, cfg, fp: Fingerprint, device=None):
        super().__init__(cfg, fp, device)
        gy = gx = int(cfg.grid_cells)
        if gy < 2:
            raise ValueError(f"grid_cells must be >= 2, got {gy}")
        if not (0.0 <= cfg.grid_contrast < 1.0):
            raise ValueError(f"grid_contrast must be in [0, 1), got "
                             f"{cfg.grid_contrast}")
        if cfg.grid_substeps < 1:
            raise ValueError("grid_substeps must be >= 1")
        nt, W = cfg.n_tiles, cfg.n_tiles * gx
        self.gy, self.gx, self.W = gy, gx, W
        self.substeps = int(cfg.grid_substeps)
        self.kappa = np.float32(cfg.grid_kappa)
        self.r = np.float32(cfg.step_ms / (fp.tau_ms * self.substeps))
        self.rth = np.float32(fp.rth_c_per_w)

        # vertical-conductance column profile (mean exactly 1)
        n_b = max(1, round(gx * self.bridge_frac)) if cfg.grid_contrast else 0
        col = np.ones(gx, np.float64)
        if n_b:
            col[gx - n_b:] = 1.0 - cfg.grid_contrast
            col *= gx / col.sum()
        ops = grid_operators(gy, gx, nt, self.rth)
        self.inject, self.readout = ops["inject"], ops["readout"]
        self.set_operators(
            ghat=np.tile(col, nt)[None, :] * np.ones((gy, 1)),
            deg=ops["deg"], adj_h=ops["adj_h"], adj_v=ops["adj_v"])

        # one tile's patch operator (m×m, symmetric): its eigen-decays give
        # the stability check, η's slow mode and the ROM's rate spread; its
        # DC solve gives the budget law's ΣG
        m = gy * gx
        op = np.zeros((m, m), np.float64)
        for y in range(gy):
            for x in range(gx):
                i = y * gx + x
                op[i, i] -= col[x]
                for yy, xx in ((y - 1, x), (y + 1, x), (y, x - 1), (y, x + 1)):
                    if 0 <= yy < gy and 0 <= xx < gx:
                        op[i, yy * gx + xx] += cfg.grid_kappa
                        op[i, i] -= cfg.grid_kappa
        evals = np.linalg.eigvalsh(np.eye(m) + float(self.r) * op)
        if np.abs(evals).max() >= 1.0:
            raise ValueError(
                f"grid explicit-Euler unstable (spectral radius "
                f"{np.abs(evals).max():.3f} >= 1) — raise "
                f"SchedulerConfig.grid_substeps (now {self.substeps})")
        # discrete eigen-decays over a FULL step (substeps folded in)
        self.eigen_decay = np.sort(np.clip(evals, 0.0, None)) ** self.substeps
        self.eta = float(_eta_f32(self.eigen_decay[-1],
                                  cfg.lookahead_ms / cfg.step_ms))
        dc = np.linalg.solve(op, -float(self.rth) * np.ones(m))
        self.gain_sum = np.float32(dc.mean())

    def set_operators(self, *, ghat, deg, adj_h, adj_v) -> None:
        """Install the stencil's f32 operators (numpy) and their device
        copies: the plant's own, or the reference's (`convert`)."""
        f32 = lambda x: np.asarray(x, np.float32)
        self.ghat, self.deg = f32(ghat), f32(deg)
        self.adj_h, self.adj_v = f32(adj_h), f32(adj_v)
        dev = lambda x: torch.as_tensor(x, device=self.device)
        self._adj_h, self._adj_v = dev(self.adj_h), dev(self.adj_v)
        self._deg, self._ghat = dev(self.deg), dev(self.ghat)

    def init_state(self, batch_shape: tuple[int, ...] = ()) -> torch.Tensor:
        return torch.zeros(batch_shape + (self.gy, self.W),
                           dtype=torch.float32, device=self.device)

    def step(self, state, power_w, poles=None):
        if poles is not None:
            raise ValueError("GridPlant has no per-package pole override "
                             "(heterogeneous fleets need a pole-family "
                             "plant)")
        r, kappa = float(self.r), float(self.kappa)
        # [..., n_tiles] → uniform per-cell drive [..., 1, W]
        drive = torch.repeat_interleave(float(self.rth) * power_w, self.gx,
                                        dim=-1)[..., None, :]
        for _ in range(self.substeps):
            lap = (torch.einsum("ij,...jw->...iw", self._adj_v, state)
                   + state @ self._adj_h - self._deg * state)
            state = state + r * (drive - self._ghat * state + kappa * lap)
        return state

    def delta_t(self, state):
        s = state.reshape(state.shape[:-1] + (self.n_tiles, self.gx))
        return s.mean(dim=(-1, -3))

    def simulate(self, power_trace, state0=None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
        """Whole-trace [T, n_tiles] run through the `grid_conv` kernel (its
        plain version on the CPU).  Returns (dts [T, n_tiles], final state
        [gy, W])."""
        power = torch.as_tensor(power_trace, dtype=torch.float32,
                                device=self.device).contiguous()
        if state0 is None:
            state0 = self.init_state(())
        return grid_conv(power, self._ghat, self._deg,
                         torch.as_tensor(state0, dtype=torch.float32,
                                         device=self.device).contiguous(),
                         gy=self.gy, gx=self.gx, rth=float(self.rth),
                         r=float(self.r), kappa=float(self.kappa),
                         substeps=self.substeps)

    def step_response(self, n_steps: int, power_w: float = 1.0) -> np.ndarray:
        """[n_steps] tile-mean ΔT for a unit power step, in numpy.

        Tiles are identical and adiabatic, so one all-tiles-on run is every
        tile's self response — what `FittedROMPlant.fit` regresses against.
        """
        T = np.zeros((self.gy, self.W), np.float32)
        drive = np.float32(self.rth * power_w)
        out = np.empty(n_steps, np.float32)
        for t in range(n_steps):
            for _ in range(self.substeps):
                lap = self.adj_v @ T + T @ self.adj_h - self.deg * T
                T = T + self.r * (drive - self.ghat * T + self.kappa * lap)
            out[t] = T[:, :self.gx].mean()
        return out

    def describe(self) -> str:
        return (f"grid[{self.gy}x{self.gx}/tile,kappa={float(self.kappa):g},"
                f"contrast={self.cfg.grid_contrast:g},sub={self.substeps}]")


@register_plant
class FittedROMPlant(PoleBankPlant):
    """Reduced-order pole bank least-squares-fit from GridPlant responses.

    `fit` regresses the grid's tile-mean step response onto ``rom_poles``
    exponentials whose rates are log-spaced over the grid operator's own
    eigen-rate spread, so the slow pole is exact by construction.  A pole
    bank (family "pole") with per-tile gains [n_tiles, n_poles].
    """

    name = "rom"
    family = "pole"

    def __init__(self, cfg, fp: Fingerprint, device=None):
        ThermalPlant.__init__(self, cfg, fp, device)
        grid = GridPlant(cfg, fp, device)
        self.poles, self.fit_rel_err = self.fit(
            grid, n_poles=cfg.rom_poles, n_steps=cfg.rom_fit_steps)
        self.eta = float(_eta_f32(self.poles.decay[-1],
                                  cfg.lookahead_ms / cfg.step_ms))
        self.gain_sum = self.poles.gain.sum(-1)          # [n_tiles] f32
        self._poles_dev = thermal.PoleParams(
            decay=torch.as_tensor(self.poles.decay, device=device),
            gain=torch.as_tensor(self.poles.gain, device=device))

    @classmethod
    def fit(cls, source: GridPlant, *, n_poles: int = 3,
            n_steps: int = 2048):
        """(PoleParams, rel_err): LSQ pole bank from grid step responses.

        rel_err is max |fit − grid| / max grid over the fit window.
        """
        if n_poles < 1:
            raise ValueError("rom_poles must be >= 1")
        y = source.step_response(n_steps)                # [n_steps]
        lam = -np.log(np.clip(source.eigen_decay, 1e-12, 1.0))
        lam_slow = lam[lam > 1e-9].min()
        lam_fast = min(lam.max(), lam_slow * 32.0)
        rates = (np.geomspace(lam_slow, lam_fast, n_poles) if n_poles > 1
                 else np.asarray([lam_slow]))
        decay = np.exp(-np.sort(rates)[::-1]).astype(np.float32)  # ascending
        k = np.arange(1, n_steps + 1)[:, None]
        basis = 1.0 - np.asarray(decay, np.float64)[None, :] ** k
        g, *_ = np.linalg.lstsq(basis, np.asarray(y, np.float64), rcond=None)
        rel_err = float(np.abs(basis @ g - y).max() / np.abs(y).max())
        gain = np.tile(np.asarray(g, np.float32), (source.n_tiles, 1))
        return thermal.PoleParams(decay=decay, gain=gain), rel_err

    def describe(self) -> str:
        return (f"rom[n_poles={self.poles.decay.shape[0]},"
                f"fit_err={self.fit_rel_err:.2e}]")
