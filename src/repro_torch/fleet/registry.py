"""Fleet membership registry — bucketed capacity pools for dynamic fleets.

Port of `repro.fleet.registry`, host-side bookkeeping in numpy, kept word
for word but for this note.  The control plane (`repro_torch.fleet.service`)
attaches and detaches packages while the engine steps a fixed
``[capacity, tiles]`` state: capacity is quantised to powers of two
("buckets"), membership lives in a ``[capacity]`` bool mask, and only a
crossing of a bucket boundary changes the state's shape — at most
O(log max_fleet) shapes over the service's life, all warmed by
`FleetService.warmup`.  (The reference does this so that its jitted step
never recompiles; the port keeps the same buckets, so after warmup no
kernel library is built or loaded and the surgery ops reuse shapes the
warmup already ran.)

The registry maps package ids → lanes, tracks free lanes, and owns the
per-tenant alert thresholds as dense ``[max_tenants]`` arrays (empty slots
at +inf) that `repro_torch.fleet.alerts.tenant_window_stats` reads as
operands — editing a tenant's threshold changes values, never shapes.

Capacity transitions:

  * grow  — occupancy exceeds capacity: next bucket is
    `max(min_capacity, next_pow2(n_active))`; existing lanes keep their
    indices (state grows in place, old lanes copied to the front).
  * shrink — occupancy falls to ≤ capacity/4 (hysteresis: one bucket of
    slack so attach/detach churn at a boundary doesn't thrash): the
    registry emits a COMPACTION PERMUTATION that gathers the surviving
    lanes to the front of the smaller state.

Both transition kinds are surfaced as `CapacityPlan` records so the service
can apply the matching surgery op.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np

__all__ = ["FleetRegistry", "Tenant", "CapacityPlan", "LaneProfile",
           "next_pow2"]


def next_pow2(n: int) -> int:
    """Smallest power of two ≥ n (and ≥ 1)."""
    n = max(int(n), 1)
    return 1 << (n - 1).bit_length()


_PROFILE_MODES = ("v24", "reactive_poll")


@dataclass(frozen=True)
class LaneProfile:
    """Per-lane membership profile: ``(node, mode, plant)``.

    * ``node`` — a `repro_torch.core.nodebank` bank name; the service resolves
      it to that lane's heterogeneous `PackageParams` row at attach time
      (process-node physics per lane).
    * ``mode`` — the lane's controller policy: ``"v24"`` (predictive) or
      ``"reactive_poll"`` (operator-pinned reactive).  Pins land in the
      ``ctrl_mode`` state plane, so shifting a fleet's mode mix (canary
      rollout) changes values, never shapes.
    * ``plant`` — the thermal-plant group the lane is dispatched under;
      profile-group dispatch (`repro_torch.fleet.groups`) steps each group as a
      sub-fleet under its own backend path.

    The registry stores profiles as plain bookkeeping; it never touches
    the device.  Name validity against the node/plant registries is the caller's
    concern (the service validates at attach)."""

    node: str = "base"
    mode: str = "v24"
    plant: str = "pole"

    def __post_init__(self):
        if self.mode not in _PROFILE_MODES:
            raise ValueError(f"profile mode must be one of "
                             f"{_PROFILE_MODES}, got {self.mode!r}")


@dataclass
class Tenant:
    """One OEM / operator slot: a named group of packages sharing alert
    thresholds.  `slot` indexes the dense threshold arrays handed to the
    per-tenant alert reductions."""
    name: str
    slot: int
    t_crit_c: float = float("inf")
    at_risk_limit: float = float("inf")
    drift_budget_nm: float = float("inf")
    degraded_limit: float = float("inf")   # max lanes on reactive fallback
    packages: set = field(default_factory=set)


@dataclass(frozen=True)
class CapacityPlan:
    """A capacity transition the service must apply to the engine state.

    kind:
      "none"   — membership changed but capacity didn't; no surgery.
      "grow"   — state grows old_capacity → new_capacity; surviving lanes
                 keep their indices (copy-to-front of a fresh template).
      "shrink" — state shrinks via `perm`: new_state[i] = old_state[perm[i]]
                 for i < new_capacity.  `perm` has length new_capacity and
                 lists the surviving old lanes in their new order.
    """
    kind: str
    old_capacity: int
    new_capacity: int
    perm: tuple = ()
    # plant group whose pool transitions (profile-group dispatch); "" on a
    # single-group fleet — the service routes the surgery to that group's
    # sub-state
    group: str = ""


class FleetRegistry:
    """Host-side package→lane map with power-of-two capacity pools.

    Pure bookkeeping: never touches the device.  The service reads
    `active_mask()` / `tenant_lane_ids()` / `threshold_arrays()` each
    flush and uploads them as operands of the flush.
    """

    def __init__(self, min_capacity: int = 4, max_tenants: int = 8):
        if min_capacity < 1 or next_pow2(min_capacity) != min_capacity:
            raise ValueError(f"min_capacity must be a power of two ≥ 1, "
                             f"got {min_capacity}")
        self.min_capacity = int(min_capacity)
        self.max_tenants = int(max_tenants)
        self.capacity = self.min_capacity
        self._lane_of: dict[str, int] = {}      # package id -> lane
        self._tenant_of: dict[str, str] = {}    # package id -> tenant name
        self._profile_of: dict[str, LaneProfile] = {}
        self._free: list[int] = list(range(self.capacity - 1, -1, -1))
        self._tenants: dict[str, Tenant] = {}

    # -- tenants -----------------------------------------------------------
    def tenant(self, name: str) -> Tenant:
        """Get or create the tenant slot for `name`."""
        t = self._tenants.get(name)
        if t is None:
            used = {t.slot for t in self._tenants.values()}
            free = [s for s in range(self.max_tenants) if s not in used]
            if not free:
                raise ValueError(f"all {self.max_tenants} tenant slots in "
                                 f"use; detach a tenant first")
            t = Tenant(name=name, slot=free[0])
            self._tenants[name] = t
        return t

    def set_thresholds(self, name: str, *, t_crit_c: float | None = None,
                       at_risk_limit: float | None = None,
                       drift_budget_nm: float | None = None,
                       degraded_limit: float | None = None) -> Tenant:
        t = self.tenant(name)
        if t_crit_c is not None:
            t.t_crit_c = float(t_crit_c)
        if at_risk_limit is not None:
            t.at_risk_limit = float(at_risk_limit)
        if drift_budget_nm is not None:
            t.drift_budget_nm = float(drift_budget_nm)
        if degraded_limit is not None:
            t.degraded_limit = float(degraded_limit)
        return t

    @property
    def tenants(self) -> dict[str, Tenant]:
        return dict(self._tenants)

    # -- membership --------------------------------------------------------
    @property
    def n_active(self) -> int:
        return len(self._lane_of)

    @property
    def packages(self) -> dict[str, int]:
        """package id -> lane, a copy."""
        return dict(self._lane_of)

    def lane(self, package: str) -> int:
        return self._lane_of[package]

    def attach(self, package: str, tenant: str = "default",
               profile: LaneProfile | None = None
               ) -> tuple[int, CapacityPlan]:
        """Attach a package; returns (lane, plan).  Apply the plan's state
        surgery FIRST, then scatter the fresh lane.  ``profile`` pins the
        lane's `(node, mode, plant)` membership attributes (defaults to
        the homogeneous base profile)."""
        if package in self._lane_of:
            raise ValueError(f"package {package!r} already attached "
                             f"(lane {self._lane_of[package]})")
        self.tenant(tenant)
        plan = self._plan(self.n_active + 1)
        self._apply_plan(plan)
        lane = self._free.pop()
        self._lane_of[package] = lane
        self._tenant_of[package] = tenant
        self._profile_of[package] = profile or LaneProfile()
        self._tenants[tenant].packages.add(package)
        return lane, plan

    def detach(self, package: str) -> tuple[int, CapacityPlan]:
        """Detach a package; returns (freed lane, plan).  A shrink plan's
        permutation already accounts for the departed lane."""
        if package not in self._lane_of:
            raise ValueError(f"package {package!r} is not attached")
        lane = self._lane_of.pop(package)
        tname = self._tenant_of.pop(package)
        self._tenants[tname].packages.discard(package)
        self._profile_of.pop(package, None)
        self._free.append(lane)
        plan = self._plan(self.n_active)
        self._apply_plan(plan)
        return lane, plan

    # -- per-lane profiles -------------------------------------------------
    def profile(self, package: str) -> LaneProfile:
        if package not in self._lane_of:
            raise ValueError(f"package {package!r} is not attached")
        return self._profile_of[package]

    def set_mode(self, package: str, mode: str) -> LaneProfile:
        """Pin one package's controller mode (validated by LaneProfile)."""
        pr = self.profile(package)
        pr = replace(pr, mode=mode)
        self._profile_of[package] = pr
        return pr

    def canary(self, reactive_frac: float) -> dict:
        """Pin a fleet FRACTION to reactive_poll, deterministically.

        The first ``round(frac · n_active)`` active packages in sorted-id
        order get ``mode="reactive_poll"``; the rest return to ``"v24"``.
        Sorted-id order makes repeated canary calls idempotent and
        monotone: raising the fraction only ever ADDS pinned lanes, so a
        25% → 50% rollout never flips an already-canaried package back.
        Returns a summary dict (the `POST /canary` response body)."""
        if not 0.0 <= reactive_frac <= 1.0:
            raise ValueError(f"reactive_frac must be in [0, 1], got "
                             f"{reactive_frac}")
        pkgs = sorted(self._lane_of)
        k = round(reactive_frac * len(pkgs))
        changed = 0
        for i, p in enumerate(pkgs):
            mode = "reactive_poll" if i < k else "v24"
            if self._profile_of[p].mode != mode:
                self._profile_of[p] = replace(self._profile_of[p], mode=mode)
                changed += 1
        return {"reactive_frac": float(reactive_frac),
                "pinned_reactive": k, "changed": changed,
                "n_active": len(pkgs)}

    def ctrl_mode_mask(self) -> np.ndarray:
        """[capacity] bool — True on lanes pinned to reactive_poll: an
        operand beside `active_mask`, so shifting the fleet's mode mix is a
        value change, never a shape change."""
        m = np.zeros(self.capacity, bool)
        for pkg, lane in self._lane_of.items():
            m[lane] = self._profile_of[pkg].mode == "reactive_poll"
        return m

    # -- capacity ----------------------------------------------------------
    def _plan(self, n_active: int) -> CapacityPlan:
        want = max(self.min_capacity, next_pow2(max(n_active, 1)))
        if want > self.capacity:
            return CapacityPlan("grow", self.capacity, want)
        # shrink hysteresis: only when occupancy drops to ≤ capacity/4, and
        # keep one spare bucket (2·want) so churn at the boundary can't
        # thrash between programs
        if n_active <= self.capacity // 4:
            new = max(self.min_capacity, 2 * next_pow2(max(n_active, 1)))
            if new < self.capacity:
                # compaction permutation: surviving lanes to the front, in
                # ascending old-lane order; pad with (dropped) free lanes
                survivors = sorted(self._lane_of.values())
                pad = [l for l in range(self.capacity)
                       if l not in set(survivors)][: new - len(survivors)]
                return CapacityPlan("shrink", self.capacity, new,
                                    tuple(survivors + pad))
        return CapacityPlan("none", self.capacity, self.capacity)

    def _apply_plan(self, plan: CapacityPlan) -> None:
        if plan.kind == "grow":
            self._free = ([l for l in range(plan.new_capacity - 1,
                                            plan.old_capacity - 1, -1)]
                          + self._free)
            self.capacity = plan.new_capacity
        elif plan.kind == "shrink":
            remap = {old: new for new, old in enumerate(plan.perm)}
            self._lane_of = {p: remap[l] for p, l in self._lane_of.items()}
            used = set(self._lane_of.values())
            self._free = [l for l in range(plan.new_capacity - 1, -1, -1)
                          if l not in used]
            self.capacity = plan.new_capacity

    # -- flush operands ----------------------------------------------------
    def active_mask(self) -> np.ndarray:
        """[capacity] bool — True on attached lanes."""
        m = np.zeros(self.capacity, bool)
        for lane in self._lane_of.values():
            m[lane] = True
        return m

    def tenant_lane_ids(self) -> np.ndarray:
        """[capacity] int32 — tenant slot per lane; free lanes get the dump
        slot `max_tenants` (segment reductions route them to a discard
        segment)."""
        ids = np.full(self.capacity, self.max_tenants, np.int32)
        for pkg, lane in self._lane_of.items():
            ids[lane] = self._tenants[self._tenant_of[pkg]].slot
        return ids

    def threshold_arrays(self) -> dict[str, np.ndarray]:
        """Dense [max_tenants] float32 threshold arrays, +inf on empty
        slots — flush operands, so editing them changes values only."""
        inf = np.full(self.max_tenants, np.inf, np.float32)
        t_crit, at_risk, drift, deg = (inf.copy(), inf.copy(), inf.copy(),
                                       inf.copy())
        for t in self._tenants.values():
            t_crit[t.slot] = t.t_crit_c
            at_risk[t.slot] = t.at_risk_limit
            drift[t.slot] = t.drift_budget_nm
            deg[t.slot] = t.degraded_limit
        return {"t_crit_c": t_crit, "at_risk_limit": at_risk,
                "drift_budget_nm": drift, "degraded_limit": deg}

    def slot_names(self) -> list[str | None]:
        """[max_tenants] tenant name per slot (None = empty)."""
        names: list[str | None] = [None] * self.max_tenants
        for t in self._tenants.values():
            names[t.slot] = t.name
        return names

    def describe(self) -> dict:
        return {
            "capacity": self.capacity,
            "n_active": self.n_active,
            "packages": {p: {"lane": l, "tenant": self._tenant_of[p],
                             "node": self._profile_of[p].node,
                             "mode": self._profile_of[p].mode,
                             "plant": self._profile_of[p].plant}
                         for p, l in sorted(self._lane_of.items())},
            "tenants": {t.name: {"slot": t.slot,
                                 "t_crit_c": t.t_crit_c,
                                 "at_risk_limit": t.at_risk_limit,
                                 "drift_budget_nm": t.drift_budget_nm,
                                 "degraded_limit": t.degraded_limit,
                                 "packages": sorted(t.packages)}
                        for t in self._tenants.values()},
        }
