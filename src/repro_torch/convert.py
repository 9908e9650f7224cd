"""Carry scheduler state between the JAX reference and the PyTorch port.

For this system the "weights" are the scheduler's state and constants.  The
constants (Γ, the pole bank, η) are derived from `FINGERPRINT` on both sides
bit for bit; the state crosses over leaf by leaf through numpy:

  * `state_from_numpy` builds a port `SchedulerState` from the reference's
    `SchedulerState` (any object with its field names whose leaves are
    numpy-convertible — e.g. ``jax.device_get(state)``);
  * `state_to_numpy` turns a port state back into the same structure with
    numpy leaves (the reference's field names and dtypes), from which the
    reference's own NamedTuples can be rebuilt;
  * `telemetry_from_numpy` builds a port `FleetTelemetry` from a reference
    record or flush dict, for comparisons.

The shared clocks (``step``, filtration ``ptr``) stay on the host.  The
per-package planes cross over too: the degraded fallback's ``rho_last`` /
``stale`` / ``degraded``, the operator's ``ctrl_mode`` and the
heterogeneous draws ``pkg`` (`package_params_from_numpy`, also usable on
its own to feed the reference's `PackageParams` into a port fleet).

The plant ladder's constants cross over the same way:

  * `poles_from_numpy` — a reference `PoleParams` bank (the paper's, or a
    fitted ROM's with per-tile gains [n_tiles, n_poles]) as the port's;
  * `grid_from_numpy` — a port `GridPlant` running on the reference
    `GridPlant`'s operators (ĝ, deg, the adjacencies) and control
    constants (η, ΣG, eigen-decays) instead of its own derivation.

The serving models' weights and caches cross over leaf for leaf, the
port keeping the reference's dict keys and stacked [L, …] layout:

  * `params_from_numpy` — `repro.models.transformer.init_params`'s pytree
    (numpy leaves, e.g. ``jax.device_get(params)``) as the port's params;
  * `cache_from_numpy` — a reference prefill / decode cache the same way.

The train state crosses over the same way (`launch.steps.TrainState`):

  * `train_state_from_numpy` — a reference ``TrainState`` (params, AdamW
    moments and count, scheduler state, step) with numpy leaves;
  * `train_state_to_numpy` — a port train state as that structure with
    numpy leaves (bf16 parameters widened to f32 exactly: numpy has no
    bf16).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint.manager import tree_leaves, tree_unflatten
from repro_torch.core.fingerprint import FINGERPRINT
from repro_torch.core.pdu_gate import Filtration, FiltrationStats
from repro_torch.core.plant import GridPlant
from repro_torch.core.scheduler import PackageParams, SchedulerState
from repro_torch.core.thermal import PoleParams
from repro_torch.models import transformer
from repro_torch.fleet.engine import FleetTelemetry

_PLANES = ("throttled", "rho_last", "stale", "degraded", "ctrl_mode")


def _clock(x) -> torch.Tensor:
    return torch.tensor(int(np.asarray(x)), dtype=torch.int32)


def package_params_from_numpy(ref_pkg, device=None) -> PackageParams:
    """Port `PackageParams` from the reference's per-package draws (any
    object with its field names and numpy-convertible leaves): the same f32
    decay / gain / η / ΣG and int32 polling periods, nothing re-derived."""
    dev = resolve_device(device)
    return PackageParams(**{
        f: torch.tensor(np.asarray(getattr(ref_pkg, f)), device=dev)
        for f in PackageParams._fields})


def state_from_numpy(ref_state, device=None) -> SchedulerState:
    """Port `SchedulerState` from the reference's state leaves, the
    per-package planes included."""
    dev = resolve_device(device)
    leaf = lambda x: None if x is None else torch.tensor(np.asarray(x),
                                                         device=dev)
    ft = ref_state.filtration
    if hasattr(ft, "wsum"):
        filtration = FiltrationStats(buf=leaf(ft.buf), ptr=_clock(ft.ptr),
                                     wsum=leaf(ft.wsum), csum=leaf(ft.csum),
                                     rsum=leaf(ft.rsum))
    else:
        filtration = Filtration(buf=leaf(ft.buf), ptr=_clock(ft.ptr))
    pkg = getattr(ref_state, "pkg", None)
    return SchedulerState(
        thermal=leaf(ref_state.thermal), filtration=filtration,
        freq=leaf(ref_state.freq), step=_clock(ref_state.step),
        events=leaf(ref_state.events),
        pkg=None if pkg is None else package_params_from_numpy(pkg, dev),
        **{f: leaf(getattr(ref_state, f, None)) for f in _PLANES})


def state_to_numpy(state: SchedulerState) -> SchedulerState:
    """The same structure with numpy leaves (int32 clocks, bool latch)."""
    leaf = lambda x: None if x is None else x.detach().cpu().numpy()
    ft = state.filtration
    conv = {f: leaf(getattr(ft, f)) for f in ft._fields}
    conv["ptr"] = np.asarray(int(ft.ptr), np.int32)
    pkg = state.pkg
    return state._replace(
        thermal=leaf(state.thermal), filtration=type(ft)(**conv),
        freq=leaf(state.freq), step=np.asarray(int(state.step), np.int32),
        events=leaf(state.events),
        pkg=None if pkg is None else PackageParams(*map(leaf, pkg)),
        **{f: leaf(getattr(state, f)) for f in _PLANES})


def telemetry_from_numpy(ref_telem, device=None) -> FleetTelemetry:
    """Port `FleetTelemetry` from a reference record (its NamedTuple with
    numpy leaves, or the host dict `as_dict` and `stream` return)."""
    dev = resolve_device(device)
    get = (ref_telem.__getitem__ if isinstance(ref_telem, dict)
           else lambda f: getattr(ref_telem, f))
    return FleetTelemetry(**{f: torch.tensor(np.asarray(get(f)), device=dev)
                             for f in FleetTelemetry._fields})


def poles_from_numpy(ref_poles) -> PoleParams:
    """Port `PoleParams` (numpy f32) from the reference's bank: decay
    [n_poles], gain [n_poles] or per tile [n_tiles, n_poles]."""
    decay = np.asarray(ref_poles.decay, np.float32)
    gain = np.asarray(ref_poles.gain, np.float32)
    if decay.ndim != 1 or gain.shape[-1] != decay.shape[0] or gain.ndim > 2:
        raise ValueError(f"pole bank shapes decay {decay.shape}, gain "
                         f"{gain.shape}: want [n_poles] and [n_poles] or "
                         f"[n_tiles, n_poles]")
    return PoleParams(decay=decay.copy(), gain=gain.copy())


def grid_from_numpy(ref_grid, cfg, device=None) -> GridPlant:
    """Port `GridPlant` for ``cfg`` carrying the reference plant's operators
    and control constants (any object with its attribute names whose
    values are numpy-convertible)."""
    plant = GridPlant(cfg, FINGERPRINT, device=resolve_device(device))
    if (plant.gy, plant.W) != tuple(np.shape(ref_grid.ghat)):
        raise ValueError(f"reference grid is {np.shape(ref_grid.ghat)}, the "
                         f"config gives {(plant.gy, plant.W)}")
    plant.set_operators(ghat=ref_grid.ghat, deg=ref_grid.deg,
                        adj_h=ref_grid.adj_h, adj_v=ref_grid.adj_v)
    plant.r = np.float32(ref_grid.r)
    plant.kappa = np.float32(ref_grid.kappa)
    plant.rth = np.float32(ref_grid.rth)
    plant.eigen_decay = np.asarray(ref_grid.eigen_decay).copy()
    plant.eta = float(ref_grid.eta)
    plant.gain_sum = np.float32(ref_grid.gain_sum)
    return plant


def _tensor(x, dev) -> torch.Tensor:
    """A numpy leaf as a tensor of the same dtype (bfloat16 included: numpy
    holds it as the ml_dtypes extension type, crossed bit for bit)."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(dev)
    return torch.from_numpy(np.array(a)).to(dev)


def _tree(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree(v, dev) for k, v in tree.items()}
    return _tensor(tree, dev)


def params_from_numpy(cfg, tree, device=None) -> dict:
    """Port parameters for ``cfg`` from the reference's parameter pytree
    with numpy leaves: same keys, same stacked layout, same dtypes."""
    want = {"embed", "final_norm", "blocks"}
    if not cfg.tie_embeddings:
        want.add("lm_head")
    if cfg.family == "hybrid":
        want |= {"shared_attn_norm", "shared_attn", "shared_mlp_norm",
                 "shared_mlp"}
    if set(tree) != want:
        raise ValueError(f"{cfg.name}: parameter keys {sorted(tree)}, want "
                         f"{sorted(want)}")
    return _tree(tree, resolve_device(device))


def train_state_from_numpy(cfg, ref_state, device=None):
    """Port `TrainState` for ``cfg`` from the reference's train state (any
    object with its field names — params, opt (m, v, count), sched, step —
    whose leaves are numpy-convertible, e.g. ``jax.device_get(state)``).
    The moments are checked against the parameter tree; the count and the
    step become host int32 clocks."""
    from repro_torch.launch.steps import TrainState
    from repro_torch.optim.adamw import AdamWState

    dev = resolve_device(device)
    params = params_from_numpy(cfg, ref_state.params, dev)
    m = _tree(ref_state.opt.m, dev)
    v = _tree(ref_state.opt.v, dev)
    for name, tree in (("m", m), ("v", v)):
        got = [tuple(t.shape) for t in tree_leaves(tree)]
        if got != [tuple(t.shape) for t in tree_leaves(params)]:
            raise ValueError(f"{cfg.name}: AdamW {name} does not match the "
                             f"parameter tree")
    return TrainState(params=params,
                      opt=AdamWState(m=m, v=v,
                                     count=_clock(ref_state.opt.count)),
                      sched=state_from_numpy(ref_state.sched, dev),
                      step=_clock(ref_state.step))


def train_state_to_numpy(state):
    """The port's train state with numpy leaves: the same `TrainState` and
    `AdamWState` fields (the reference's), int32 count and step."""
    def leaf(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    tree = lambda x: tree_unflatten(x, [leaf(t) for t in tree_leaves(x)])
    return state._replace(
        params=tree(state.params),
        opt=state.opt._replace(m=tree(state.opt.m), v=tree(state.opt.v),
                               count=np.asarray(int(state.opt.count),
                                                np.int32)),
        sched=state_to_numpy(state.sched),
        step=np.asarray(int(state.step), np.int32))


def cache_from_numpy(cfg, tree, device=None) -> dict:
    """Port decode cache for ``cfg`` from a reference cache dict with numpy
    leaves, keyed as `transformer.init_cache` keys it: ``h``/``prev_t``/
    ``prev_c`` (RWKV6), ``h``/``conv``/``k``/``v``/``pos`` (hybrid),
    ``c``/``kr`` (MLA), ``k``/``v``/``ks``/``vs``/``pos`` (int8),
    ``k``/``v``/``pos`` (the rest)."""
    want = set(transformer.init_cache(cfg, 1, 1, device="meta"))
    if set(tree) != want:
        raise ValueError(f"{cfg.name}: cache keys {sorted(tree)}, want "
                         f"{sorted(want)}")
    return _tree(tree, resolve_device(device))
