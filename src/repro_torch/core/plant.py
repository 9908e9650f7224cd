"""Thermal-plant fidelity ladder — one plant interface, three rungs.

Port of `repro.core.plant`.  The interface (consumed by `ThermalScheduler`
and through it by every fleet backend):

  * ``init_state(batch_shape)`` → state with TWO trailing (non-batch) dims;
  * ``step(state, power_w, poles=None)`` — one dt tick;
  * ``delta_t(state)`` → [..., n_tiles] tile temperatures;
  * ``eta`` / ``gain_sum`` — the f32 control constants the v24 budget law
    consumes, derived from the plant's own slow mode / DC gain.

This slice ports the ``pole`` rung (`PoleBankPlant`, the paper's bank and
the regression oracle).  The spatial ``grid`` rung and the ``rom`` fitted
from it are registered under their names but raise until they are ported.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import thermal
from repro_torch.core.fingerprint import FINGERPRINT, Fingerprint

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
        if poles is not None:
            raise NotImplementedError(
                "per-package pole banks (heterogeneous fleets) are not "
                "ported yet: ROADMAP queue 1 step 5")
        return thermal.step(self._poles_dev, state, power_w)

    def delta_t(self, state):
        return thermal.delta_t(state)

    def describe(self) -> str:
        return f"pole[n_poles={self.poles.decay.shape[0]}]"


@register_plant
class GridPlant(ThermalPlant):
    """Spatial RC grid (reference: `repro.core.plant.GridPlant`) — not ported."""

    name = "grid"
    family = "grid"

    def __init__(self, cfg, fp: Fingerprint, device=None):
        raise NotImplementedError(
            "plant='grid' (RC grid + grid_conv kernel) is not ported yet: "
            "ROADMAP queue 1 step 6")


@register_plant
class FittedROMPlant(ThermalPlant):
    """Reduced-order bank fitted from the grid — not ported."""

    name = "rom"
    family = "pole"

    def __init__(self, cfg, fp: Fingerprint, device=None):
        raise NotImplementedError(
            "plant='rom' (fitted from the RC grid) is not ported yet: "
            "ROADMAP queue 1 step 6")
