"""Parity harness shared by the tests/test_torch_*.py files.

The same numpy inputs go through the JAX reference (`repro`) and the
PyTorch port (`repro_torch`); outputs are compared with the reference's own
bound taxonomy (tests/test_fleet_fused.py, CHANGES.md PR 3 and PR 7):

  * traces, state and continuous telemetry: rtol = atol = 1e-5 (the two
    frameworks order float reductions differently, and their pow
    implementations differ in the last ulp);
  * event counters and counts: exactly equal;
  * the knife-edge order statistics `freq_min` and `at_risk_frac`: 1e-3;
  * filtration sufficient statistics: 1e-5, never bit-exactness (on this
    tree the reference's own bit-exact wraparound check fails).
"""
from __future__ import annotations

import numpy as np

TOL = dict(rtol=1e-5, atol=1e-5)
KNIFE = dict(rtol=1e-3, atol=1e-3)
EXACT_FIELDS = ("n_packages", "events_total", "events_step", "degraded_count")
KNIFE_FIELDS = ("freq_min", "at_risk_frac")


def np_(x):
    """numpy view of a JAX array, torch tensor or numpy array."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def trace(steps: int, n: int, tiles: int, seed: int = 0) -> np.ndarray:
    """Seeded [T, n, tiles] f32 density trace over the paper's domain."""
    rng = np.random.default_rng(seed)
    return rng.uniform(0.9, 2.7, (steps, n, tiles)).astype(np.float32)


def assert_telemetry_close(ref, port, where: str = "") -> None:
    """Field-for-field comparison of two FleetTelemetry records (any leaf
    shape), with the bound taxonomy above."""
    for f in ref._fields:
        a = np.asarray(np_(getattr(ref, f)), np.float64)
        b = np.asarray(np_(getattr(port, f)), np.float64)
        msg = f"{where} telemetry[{f}]"
        if f in EXACT_FIELDS:
            np.testing.assert_array_equal(a, b, err_msg=msg)
        elif f in KNIFE_FIELDS:
            np.testing.assert_allclose(a, b, err_msg=msg, **KNIFE)
        else:
            np.testing.assert_allclose(a, b, err_msg=msg, **TOL)


def _ordered_ring(ft) -> np.ndarray:
    return np.roll(np_(ft.buf), -int(np_(ft.ptr)), axis=-2)


def assert_state_close(ref, port, where: str = "",
                       exact_stats=None) -> None:
    """Reference SchedulerState vs port SchedulerState.

    ``exact_stats`` (the reference's `pdu_gate.exact_stats`) compares the
    port's sliding statistics against the exact recompute from the
    reference's ring instead of the reference's carried running sums — for
    the fused backend, which re-derives them exactly at every window exit.
    """
    np.testing.assert_allclose(np_(port.thermal), np_(ref.thermal),
                               err_msg=f"{where} thermal", **TOL)
    np.testing.assert_allclose(np_(port.freq), np_(ref.freq),
                               err_msg=f"{where} freq", **TOL)
    np.testing.assert_array_equal(np_(port.events), np_(ref.events),
                                  err_msg=f"{where} events")
    assert int(np_(port.step)) == int(np_(ref.step)), where
    np.testing.assert_allclose(_ordered_ring(port.filtration),
                               _ordered_ring(ref.filtration),
                               err_msg=f"{where} ring", **TOL)
    if hasattr(ref.filtration, "wsum"):
        want = (dict(zip(("wsum", "csum", "rsum"), exact_stats(
                    ref.filtration.buf, ref.filtration.ptr)))
                if exact_stats is not None else ref.filtration._asdict())
        for f in ("wsum", "csum", "rsum"):
            np.testing.assert_allclose(
                np_(getattr(port.filtration, f)), np_(want[f]),
                err_msg=f"{where} {f}", **TOL)
    if ref.throttled is None:
        assert port.throttled is None, where
    else:
        np.testing.assert_array_equal(np_(port.throttled),
                                      np_(ref.throttled),
                                      err_msg=f"{where} throttled")


def lane4_coupling(gamma, p):
    """Γ·p in the order XLA/CPU's dot takes at the fleet's shapes (see
    `xla_dot_order`): the sources j ≡ k (mod 4) below 4·⌊n/4⌋ summed into
    lane k by f32 FMAs, the lanes added as (L0 + L1) + (L2 + L3), then the
    n mod 4 trailing sources as separately rounded products and adds, added
    last.  A diagnostic for `drift_probe`; the port keeps one FMA chain."""
    import torch

    from repro_torch import fma_f32

    n = gamma.shape[1]
    q = n - n % 4
    lanes = []
    for k in range(min(4, q)):
        acc = torch.zeros_like(p)
        for j in range(k, q, 4):
            acc = fma_f32(gamma[:, j], p[..., j:j + 1], acc)
        lanes.append(acc)
    rem = None
    for j in range(q, n):
        x = gamma[:, j] * p[..., j:j + 1]
        rem = x if rem is None else rem + x
    if not lanes:
        return rem
    tot = (lanes[0] + lanes[1]) + (lanes[2] + lanes[3])
    return tot if rem is None else tot + rem


def xla_dot_order(rows: int | None, n: int, seed: int = 0) -> str:
    """The summation order XLA/CPU's compiled dot takes for Γ·p, as the
    reference's engines spell it (``einsum("ij,...j->...i")`` on [rows, n];
    ``rows=None``: ``gamma @ p`` on a 1-D p, as its DVFS loop does).

    Returns the name of the candidate that reproduces the reference's f32
    bits on random inputs and a dense random Γ: "fma_chain" (the port's
    `apply_coupling`), "lane4" (`lane4_coupling`) or "other".
    """
    import jax
    import jax.numpy as jnp
    import torch

    from repro_torch.core.coupling import apply_coupling

    rng = np.random.default_rng(seed)
    g = rng.random((n, n), dtype=np.float32)
    x = (300.0 * rng.random((rows or 1, n), dtype=np.float32)).astype(
        np.float32)
    gj = jnp.asarray(g)
    if rows is None:
        want = np.asarray(jax.jit(lambda v: gj @ v)(x[0]))[None]
    else:
        want = np.asarray(jax.jit(
            lambda v: jnp.einsum("ij,...j->...i", gj, v))(x))
    for name, fn in (("fma_chain", apply_coupling), ("lane4", lane4_coupling)):
        if np.array_equal(np_(fn(torch.from_numpy(g), torch.from_numpy(x))),
                          want):
            return name
    return "other"


def drift_probe(steps: int = 60, n: int = 40, tiles: int = 4,
                seed: int = 7, coupling=None
                ) -> list[tuple[int, float, float, float, float]]:
    """Per-step divergence on a heavily throttled v24 trace, stepped one
    step at a time: (step, max |Δfreq| and |Δthrottled_mtps| of the port's
    broadcast engine vs the reference's broadcast engine, and the same two
    for the reference's own fused vs broadcast engines).

    Run as ``PYTHONPATH=src python tests/torch_parity.py``.  It shows the
    knife edge of the coupled law (ROADMAP queue 3): where `budget − neigh`
    cancels, the order of Γ's summation alone moves freq past 1e-5, for the
    reference's two engines as for the port.  ``coupling`` replaces the
    port's `apply_coupling` for the run (e.g. `lane4_coupling`).
    """
    import jax.numpy as jnp

    from repro_torch.core import dvfs, pdu_gate, scheduler, thermal

    from repro.core.scheduler import SchedulerConfig as JCfg
    from repro.fleet import FleetEngine as JEngine
    from repro_torch.core.scheduler import SchedulerConfig as TCfg
    from repro_torch.fleet import FleetEngine as TEngine

    if coupling is not None:
        users = (scheduler, pdu_gate, dvfs, thermal)
        saved = [m.apply_coupling for m in users]
        for m in users:
            m.apply_coupling = coupling
        try:
            return drift_probe(steps, n, tiles, seed)
        finally:
            for m, f in zip(users, saved):
                m.apply_coupling = f
    tr = trace(steps, n, tiles, seed=seed)
    jb = JEngine(JCfg(n_tiles=tiles), backend="broadcast")
    jf = JEngine(JCfg(n_tiles=tiles), backend="fused")
    tb = TEngine(TCfg(n_tiles=tiles), device="cpu")
    sb, sf, st = jb.init(n), jf.init(n), tb.init(n)
    rows = []
    for t in range(steps):
        sb, _, tel_b = jb.step(sb, tr[t])
        sf, tel_f = jf.run_block(sf, jnp.asarray(tr[t:t + 1]))
        st, _, tel_t = tb.step(st, tr[t])
        fb = np.asarray(sb.freq)
        thr = lambda x: float(np_(x.throttled_mtps))
        rows.append((t, float(np.abs(np_(st.freq) - fb).max()),
                     abs(thr(tel_t) - thr(tel_b)),
                     float(np.abs(np.asarray(sf.freq) - fb).max()),
                     abs(thr(tel_f) - thr(tel_b))))
    return rows


def _print_dot_orders() -> None:
    print("XLA/CPU dot order for Γ·p (rows = packages; 1-D = gamma @ p):")
    for n in (3, 4, 8, 47, 100, 512):
        cells = [f"{r or '1-D'}: {xla_dot_order(r, n)}"
                 for r in (None, 1, 4, 8, 40, 1000)]
        print(f"  n={n:3d}  " + ", ".join(cells))
    m = np.asarray(drift_probe(coupling=lane4_coupling))[:, 1:].max(axis=0)
    print(f"drift_probe with lane4_coupling in the port: max |dfreq| "
          f"{m[0]:.3e}, |dthrottled| {m[1]:.3e} (reference fused vs "
          f"broadcast {m[2]:.3e}, {m[3]:.3e})")


if __name__ == "__main__":
    import sys

    if "--dot-order" in sys.argv:
        _print_dot_orders()
        raise SystemExit(0)
    rows = drift_probe()
    print("step  port-ref |dfreq|  port-ref |dthrottled|  "
          "ref fused-bcast |dfreq|  ref fused-bcast |dthrottled|")
    for r in rows:
        print(f"{r[0]:4d}  {r[1]:15.3e}  {r[2]:20.3e}  {r[3]:22.3e}  "
              f"{r[4]:27.3e}")
    m = np.asarray(rows)[:, 1:].max(axis=0)
    print(f"max   {m[0]:15.3e}  {m[1]:20.3e}  {m[2]:22.3e}  {m[3]:27.3e}")
