"""Per-technology-node parameter banks (Lumos-style ``compute.py`` tables).

Port of `repro.core.nodebank`: the same tables and scaling laws, the poles
derived with the same numpy f32 ops, the rows handed to the port's
`ThermalScheduler.package_params`.

A 3.5D package mixes chiplets fabbed on different process nodes; each node
carries its own voltage window, threshold voltage, and thermal scaling.
`NodeBank` captures that as a small frozen table per node:

  * **vdd/freq scaling** — the alpha-power-law frequency model
    f(v) ∝ (v − Vth)^α / v (velocity-saturated MOSFET delay), normalised
    to 1.0 at the node's nominal supply, gives each node a *DVFS envelope*
    `dvfs_bounds()` = (f(vdd_min), f(vdd_max));
  * **power scaling** — dynamic C·V²·f relative to nominal
    (`power_scale`);
  * **thermal scaling** — `rth_scale` / `tau_scale` multipliers applied to
    the scheduler's fingerprint pole bank: a denser node concentrates the
    same power into less silicon (higher junction Rth) with a smaller
    thermal mass (shorter τ).

The integration point with the fleet is `PackageParams`: `node_poles`
scales the scheduler's OWN pole bank (so two-pole V7.0 configs scale both
poles consistently) and `fleet_package_params` stacks per-lane node draws
into the `[n, 1, n_poles]` rows the heterogeneous fleet state carries —
one fleet then sweeps 3.5D packages across process nodes exactly like the
§10 Monte-Carlo sweeps process variation.

Nodes register like plants and backends do (`register_node` /
`get_node` / `available_nodes`); the built-in ladder is ``base`` (the
fingerprint as-is — bit-identical to a homogeneous fleet), ``n7``,
``n5`` and ``n3``.  `from_scale` derives a bank from a single gate-pitch
scale factor with monotone scaling laws — the property surface
the reference's tests gate with hypothesis.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import thermal

__all__ = ["NodeBank", "register_node", "get_node", "available_nodes",
           "from_scale", "node_poles", "fleet_package_params"]


@dataclasses.dataclass(frozen=True)
class NodeBank:
    """One technology node's parameter table.

    Voltages in volts; ``alpha`` is the velocity-saturation exponent of
    the alpha-power delay model (≈1.3 for modern finFET nodes, 2.0 in the
    long-channel limit).  ``rth_scale``/``tau_scale`` multiply the
    fingerprint pole bank's gains / time constants.
    """

    name: str
    scale: float          # gate-pitch scale vs the n7 reference (n7 = 1.0)
    vdd_nom: float
    vdd_min: float
    vdd_max: float
    vth: float
    alpha: float = 1.3
    rth_scale: float = 1.0
    tau_scale: float = 1.0

    def __post_init__(self):
        if not (0.0 < self.vth < self.vdd_min <= self.vdd_nom
                <= self.vdd_max):
            raise ValueError(
                f"node {self.name!r} needs 0 < vth < vdd_min <= vdd_nom "
                f"<= vdd_max, got vth={self.vth} vdd=[{self.vdd_min}, "
                f"{self.vdd_nom}, {self.vdd_max}]")
        if self.alpha <= 0 or self.scale <= 0:
            raise ValueError(f"node {self.name!r}: alpha and scale must "
                             f"be > 0")
        if self.rth_scale <= 0 or self.tau_scale <= 0:
            raise ValueError(f"node {self.name!r}: rth_scale and tau_scale "
                             f"must be > 0")

    # ---------------------------------------------------------- vdd → freq
    def freq_at(self, vdd: float) -> float:
        """Alpha-power-law frequency multiplier at supply ``vdd``,
        normalised so `freq_at(vdd_nom) == 1.0` (f ∝ (v − Vth)^α / v)."""
        def raw(v: float) -> float:
            return (v - self.vth) ** self.alpha / v
        return raw(float(vdd)) / raw(self.vdd_nom)

    def dvfs_bounds(self) -> tuple[float, float]:
        """(f_lo, f_hi): the node's Vth-derived DVFS envelope — frequency
        multipliers at the voltage window's edges.  f_lo ≤ 1 ≤ f_hi."""
        return self.freq_at(self.vdd_min), self.freq_at(self.vdd_max)

    def power_scale(self, vdd: float) -> float:
        """Dynamic-power multiplier C·V²·f at ``vdd`` relative to
        nominal: (v/v_nom)² · f(v)."""
        return (float(vdd) / self.vdd_nom) ** 2 * self.freq_at(vdd)


# ----------------------------------------------------------------- registry
_NODES: dict[str, NodeBank] = {}


def register_node(bank: NodeBank) -> NodeBank:
    _NODES[bank.name] = bank
    return bank


def get_node(name: str) -> NodeBank:
    try:
        return _NODES[name]
    except KeyError:
        raise ValueError(f"unknown node {name!r} (available: "
                         f"{', '.join(available_nodes())})") from None


def available_nodes() -> tuple[str, ...]:
    return tuple(_NODES)


def from_scale(scale: float, name: str | None = None) -> NodeBank:
    """Derive a bank from one gate-pitch scale factor with monotone laws.

    Shrinking the node (scale ↓) lowers the voltage window and Vth
    (affine in scale), raises junction Rth (the same watts through less
    silicon: scale^-0.55) and shortens τ (less thermal mass: scale^0.45)
    — every derived quantity is monotone in ``scale``, which is the
    property surface the hypothesis tests gate.
    """
    if scale <= 0.25:
        raise ValueError(f"scale must be > 0.25, got {scale}")
    s = float(scale)
    return NodeBank(
        name=name or f"s{s:.2f}",
        scale=s,
        vdd_nom=0.55 + 0.20 * s,
        vdd_min=0.47 + 0.18 * s,
        vdd_max=0.66 + 0.24 * s,
        vth=0.20 + 0.12 * s,
        alpha=1.3,
        rth_scale=s ** -0.55,
        tau_scale=s ** 0.45,
    )


# the built-in ladder: `base` is the fingerprint bank untouched (a fleet of
# all-base nodes is bit-identical to a homogeneous fleet); n7/n5/n3 follow
# the from_scale laws at the canonical gate-pitch ratios
register_node(NodeBank(name="base", scale=1.0, vdd_nom=0.75, vdd_min=0.65,
                       vdd_max=0.90, vth=0.32, rth_scale=1.0, tau_scale=1.0))
register_node(from_scale(1.00, "n7"))
register_node(from_scale(0.78, "n5"))
register_node(from_scale(0.61, "n3"))


# ------------------------------------------------------- fleet integration
def node_poles(sched, bank: NodeBank) -> thermal.PoleParams:
    """The scheduler's own pole bank scaled to ``bank``'s node.

    decay_i = exp(−dt/(τ_i · tau_scale)) = decay_i^(1/tau_scale) and
    gain_i = G_i · rth_scale — both poles of a V7.0 two-pole config scale
    consistently, and a ``base`` bank (scales = 1) reproduces the
    fingerprint bank bit-for-bit (numpy f32, matching `package_params`'s
    eager derivation discipline).
    """
    if sched.poles is None:
        raise ValueError(
            f"node banks require a pole-family plant "
            f"(plant={sched.cfg.plant!r} carries no pole bank)")
    decay = np.asarray(sched.poles.decay, np.float32)
    gain = np.asarray(sched.poles.gain, np.float32)
    if bank.tau_scale != 1.0:
        decay = np.float32(decay) ** np.float32(1.0 / bank.tau_scale)
    if bank.rth_scale != 1.0:
        gain = gain * np.float32(bank.rth_scale)
    return thermal.PoleParams(decay=np.asarray(decay, np.float32),
                              gain=np.asarray(gain, np.float32))


def fleet_package_params(sched, nodes, poll_ticks=None):
    """Stack per-lane node banks into heterogeneous `PackageParams` rows.

    ``nodes``: a sequence of n node names (or `NodeBank`s), one per fleet
    lane.  Returns `PackageParams` with decay/gain `[n, 1, n_poles]` —
    ready for `FleetEngine.init(n, pkg=...)` (requires
    `SchedulerConfig(heterogeneous=True)`).
    """
    banks = [b if isinstance(b, NodeBank) else get_node(b) for b in nodes]
    poles = [node_poles(sched, b) for b in banks]
    stacked = thermal.PoleParams(
        decay=np.stack([p.decay for p in poles])[:, None, :],
        gain=np.stack([p.gain for p in poles])[:, None, :])
    return sched.package_params(stacked, poll_ticks=poll_ticks,
                                batch_shape=(len(banks),))
