"""PyTorch port, the resident control plane (`repro_torch.fleet.service`,
`registry`, `alerts`): the gates of tests/test_fleet_service*.py,
test_fleet_service_recovery.py and test_service_ingest_recovery.py, each
against the JAX reference where the two can be fed the same inputs.

The port's synthetic workloads are its own streams (``jax.random`` cannot
be reproduced), so every parity case feeds both services the same explicit
chunks (``tick(chunk=...)``) or `ingest` posts.  Bounds are
`torch_parity`'s: telemetry and state ≤1e-5, counters exact,
``freq_min`` / ``at_risk_frac`` ≤1e-3, alert lists equal.  The port runs
on the CPU here (plain kernel versions); tests/test_torch_cuda.py and
chip_smoke.py Phase J hold the same service on the card.
"""
import json
import os
import pathlib
import signal
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from torch_parity import EXACT_FIELDS, KNIFE, KNIFE_FIELDS, TOL, np_

from repro.core.scheduler import SchedulerConfig as JConfig
from repro.fleet import FleetService as JService
from repro.fleet.alerts import tenant_window_stats as j_stats
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.fleet import FleetEngine, FleetService, serve_http
from repro_torch.fleet.alerts import WebhookSink, tenant_window_stats
from repro_torch.fleet.service import _dashboard_html, trace_seed
from repro_torch.kernels import _build

N_TILES = 2
W = 16          # filtration window — chunk lengths below are multiples of it
CPU = "cpu"
STAT_EXACT = ("n_lanes", "events", "degraded_lanes")


def _service(min_capacity=4, flush_every=W, backend="broadcast", **kw):
    cfg = kw.pop("cfg", SchedulerConfig(n_tiles=N_TILES))
    return FleetService(cfg, backend=backend, min_capacity=min_capacity,
                        flush_every=flush_every, device=CPU, **kw)


def _chunk(k, cap, fill=1.5, cols=None):
    c = np.full((k, cap, N_TILES), fill, np.float32)
    if cols is not None:
        c[:, :cols.shape[1], :] = cols
    return c


def _close(a, b, field, where):
    if field in EXACT_FIELDS or field in STAT_EXACT:
        assert a == b, f"{where} {field}: {a} vs {b}"
    elif field in KNIFE_FIELDS:
        np.testing.assert_allclose(a, b, err_msg=f"{where} {field}", **KNIFE)
    else:
        np.testing.assert_allclose(a, b, err_msg=f"{where} {field}", **TOL)


def assert_records_close(ref, port, where=""):
    """A reference flush record against the port's: telemetry, per-tenant
    stats, the alert events (identity exact, values ≤1e-5)."""
    for k, v in ref["telemetry"].items():
        _close(port["telemetry"][k], v, k, f"{where} telemetry")
    assert port["tenants"].keys() == ref["tenants"].keys(), where
    for name, stats in ref["tenants"].items():
        for k, v in stats.items():
            _close(port["tenants"][name][k], v, k, f"{where} {name}")
    key = lambda a: (a["flush"], a["step"], a["tenant"], a["kind"],
                     a["event"])
    assert [key(a) for a in port["alerts"]] == [key(a) for a in ref["alerts"]]
    for a, b in zip(port["alerts"], ref["alerts"]):
        np.testing.assert_allclose(a["value"], b["value"], **TOL)
        assert a["limit"] == b["limit"]
    assert port["active"] == ref["active"] and port["capacity"] == \
        ref["capacity"], where
    assert port["surgery"] == ref["surgery"], where


# ------------------------------------------------------ parity, the whole plane
@pytest.mark.parametrize("backend", ["broadcast", "fused", "vmap"])
def test_service_matches_reference_across_grow_and_shrink(backend):
    """Attach → grow 4 → 8 → canary → a threshold edit → detach → shrink
    8 → 4, the same chunks into both services: every flush record agrees,
    alerts included; under vmap an attached lane restarts its own clocks."""
    kw = dict(n_tiles=N_TILES, mixed_mode=True, filtration_window=W)
    ref = JService(JConfig(**kw), backend=backend, min_capacity=4,
                   flush_every=W)
    port = FleetService(SchedulerConfig(**kw), backend=backend,
                        min_capacity=4, flush_every=W, device=CPU)
    rng = np.random.default_rng(0)
    for k in range(6):
        for s in (ref, port):
            if k == 0:
                s.attach("p0", "acme")
                s.attach("p1", "acme")
                s.set_thresholds("acme", t_crit_c=70.0)
            elif k == 2:
                for i in range(2, 6):
                    s.attach(f"p{i}", "zeta", "training")
            elif k == 3:
                s.canary(0.5)
                s.set_thresholds("zeta", at_risk_limit=0.05)
            elif k == 4:
                for i in range(5):
                    s.detach(f"p{i}")
        cap = ref.registry.capacity
        assert port.registry.capacity == cap
        chunk = rng.uniform(0.9, 2.7, (W, cap, N_TILES)).astype(np.float32)
        assert_records_close(ref.tick(chunk=chunk), port.tick(chunk=chunk),
                             f"{backend} flush {k}")
    np.testing.assert_array_equal(np_(port.state.events),
                                  np_(ref.state.events))
    np.testing.assert_allclose(np_(port.state.thermal),
                               np_(ref.state.thermal), **TOL)
    np.testing.assert_array_equal(np_(port.state.step), np_(ref.state.step))
    np.testing.assert_array_equal(np_(port.state.filtration.ptr),
                                  np_(ref.state.filtration.ptr))
    if backend == "vmap":
        # p5 (attached before flush 2, kept through the shrink) counts its
        # own steps from its attach: flushes 2 to 5
        clocks = np_(port.state.step)
        assert clocks[port.registry.lane("p5")] == 4 * W, clocks


def test_vmap_lane_restarts_its_clocks_on_attach():
    """The vmap layout's mid-flight attach: the fresh lane's step and ptr
    restart at zero while the running lanes keep theirs — as the
    reference's vmapped lanes — and the traces agree lane for lane."""
    kw = dict(n_tiles=N_TILES, filtration_window=W, mode="reactive_poll")
    ref = JService(JConfig(**kw), backend="vmap", flush_every=W + 3)
    port = FleetService(SchedulerConfig(**kw), backend="vmap",
                        flush_every=W + 3, device=CPU)
    rng = np.random.default_rng(4)
    for k in range(3):
        for s in (ref, port):
            s.attach(f"p{k}", "acme")
        chunk = rng.uniform(0.9, 2.7, (W + 3, 4, N_TILES)).astype(np.float32)
        assert_records_close(ref.tick(chunk=chunk), port.tick(chunk=chunk),
                             f"vmap flush {k}")
    steps = np_(port.state.step)
    np.testing.assert_array_equal(steps, np_(ref.state.step))
    np.testing.assert_array_equal(np_(port.state.filtration.ptr),
                                  np_(ref.state.filtration.ptr))
    lanes = [port.registry.lane(f"p{k}") for k in range(3)]
    assert [int(steps[l]) for l in lanes] == [3 * (W + 3), 2 * (W + 3),
                                              W + 3]
    np.testing.assert_allclose(np_(port.state.thermal),
                               np_(ref.state.thermal), **TOL)


def test_tenant_window_stats_match_reference():
    """The per-tenant segment reductions and alarm levels on random traces,
    a dump segment for free lanes, empty slots and a degraded plane."""
    rng = np.random.default_rng(2)
    t, cap, m = 24, 8, 4
    temps = rng.uniform(40, 100, (t, cap, N_TILES)).astype(np.float32)
    freqs = rng.uniform(0.05, 1, (t, cap, N_TILES)).astype(np.float32)
    ev0 = rng.integers(0, 5, cap).astype(np.int32)
    ev1 = ev0 + rng.integers(0, 3, cap).astype(np.int32)
    active = np.array([1, 1, 0, 1, 1, 1, 0, 1], bool)
    ids = np.array([0, 2, 4, 2, 0, 1, 4, 2], np.int32)
    deg = rng.uniform(size=cap) > 0.5
    th = {"t_crit_c": np.array([90, 99, 95, np.inf], np.float32),
          "at_risk_limit": np.array([0.1, 0.5, np.inf, np.inf], np.float32),
          "drift_budget_nm": np.array([1.0, 9.0, 2.0, np.inf], np.float32),
          "degraded_limit": np.array([0, 1, 0, np.inf], np.float32)}
    args = (0.9, 0.042)
    js, ja = j_stats(jnp.asarray(temps), jnp.asarray(freqs),
                     jnp.asarray(ev0), jnp.asarray(ev1), jnp.asarray(active),
                     jnp.asarray(ids), m, *args,
                     {k: jnp.asarray(v) for k, v in th.items()},
                     degraded=jnp.asarray(deg))
    t_ = torch.from_numpy
    ps, pa = tenant_window_stats(t_(temps), t_(freqs), t_(ev0), t_(ev1),
                                 t_(active), t_(ids), m, *args,
                                 {k: t_(v) for k, v in th.items()},
                                 degraded=t_(deg))
    for f in js._fields:
        a, b = np_(getattr(ps, f)), np.asarray(getattr(js, f))
        assert a.dtype == b.dtype, f
        if f in STAT_EXACT:
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            np.testing.assert_allclose(a, b, err_msg=f, **TOL)
    for k in ja:
        np.testing.assert_array_equal(np_(pa[k]), np.asarray(ja[k]),
                                      err_msg=k)


# --------------------------------------------------------------- membership
def test_attach_across_growth_matches_fixed_capacity_fleet():
    """Attach → tick → attach past the bucket boundary → tick reproduces a
    fleet that ran at the final capacity the whole time."""
    rng = np.random.default_rng(0)
    cols1 = rng.uniform(0.9, 2.7, (2 * W, 2, N_TILES)).astype(np.float32)
    cols2 = rng.uniform(0.9, 2.7, (2 * W, 6, N_TILES)).astype(np.float32)
    a = _service(min_capacity=4)          # grows 4 -> 8 on the 5th attach
    b = _service(min_capacity=8)          # capacity 8 from the start
    for svc in (a, b):
        svc.attach("p0", "acme")
        svc.attach("p1", "acme")
    ra1 = a.tick(_chunk(2 * W, 4, cols=cols1))
    rb1 = b.tick(_chunk(2 * W, 8, cols=cols1))
    for svc in (a, b):
        for i in range(2, 6):
            svc.attach(f"p{i}", "zeta")
    assert a.registry.capacity == 8 and b.registry.capacity == 8
    ra2 = a.tick(_chunk(2 * W, 8, cols=cols2))
    rb2 = b.tick(_chunk(2 * W, 8, cols=cols2))
    for ra, rb in ((ra1, rb1), (ra2, rb2)):
        assert ([i for i, v in enumerate(ra["active"]) if v]
                == [i for i, v in enumerate(rb["active"]) if v])
        for k, v in ra["telemetry"].items():
            np.testing.assert_allclose(v, rb["telemetry"][k], err_msg=k,
                                       **TOL)
    for f in ("thermal", "freq", "events"):
        assert torch.equal(getattr(a.state, f)[:6], getattr(b.state, f)[:6])
    assert torch.equal(a.state.filtration.buf[:6],
                       b.state.filtration.buf[:6])
    assert int(a.state.step) == int(b.state.step)


def test_detach_shrinks_and_reattach_reuses_lanes():
    svc = _service()
    for i in range(6):
        svc.attach(f"p{i}")
    assert svc.registry.capacity == 8
    for i in range(5):
        svc.detach(f"p{i}")
    assert svc.registry.capacity == 4        # shrank back
    assert svc.registry.n_active == 1
    r = svc.attach("fresh")
    assert r["capacity"] == 4 and 0 <= r["lane"] < 4
    assert svc.tick() is not None


# ----------------------------------------------- no builds, one copy a tick
class _HostReads:
    """Counts reads of tensor values by the host while active — the calls
    that copy a CUDA tensor to the host (``.cpu()``, ``.item()``,
    ``.tolist()``, ``float()``, ``int()``; ``.numpy()`` refuses a CUDA
    tensor, so it cannot hide one).  The shared 0-dim int32 clocks live on
    the host and are not counted; nor is ``bool(t)``, which `fma_f32`'s
    plain version takes on CPU tensors only (its card path is one kernel
    launch).  On the card, chip_smoke.py Phase J counts the synchronizing
    calls themselves (PyTorch's sync debug mode)."""

    METHODS = ("cpu", "item", "tolist", "__float__", "__int__")

    def __init__(self):
        self.count = 0
        self.on = False
        self._saved = {}

    def __enter__(self):
        for name in self.METHODS:
            orig = getattr(torch.Tensor, name)
            self._saved[name] = orig

            def wrapped(t, *a, _orig=orig, **k):
                if self.on and not (t.ndim == 0 and t.dtype == torch.int32):
                    self.count += 1
                return _orig(t, *a, **k)
            setattr(torch.Tensor, name, wrapped)
        return self

    def __exit__(self, *exc):
        for name, orig in self._saved.items():
            setattr(torch.Tensor, name, orig)

    def measure(self, fn):
        self.count, self.on = 0, True
        try:
            out = fn()
        finally:
            self.on = False
        return out, self.count


def test_no_kernel_builds_and_one_host_copy_per_tick_after_warmup():
    """The port's form of the reference's zero-recompile gate: after
    `warmup`, attach → tick → detach → re-attach across bucket boundaries,
    threshold edits and canary shifts build and load no kernel library,
    and each tick reads tensor values on the host exactly once (its single
    packed copy); the surgery reads none."""
    cfg = SchedulerConfig(n_tiles=N_TILES, mixed_mode=True)
    svc = _service(cfg=cfg, backend="fused")
    svc.warmup(max_packages=16)
    counts = dict(_build.COUNTS)
    ticks = 0
    with _HostReads() as reads:
        def tick():
            nonlocal ticks
            syncs = svc.host_syncs
            rec, n = reads.measure(svc.tick)
            ticks += 1
            assert n == 1 and svc.host_syncs == syncs + 1, n
            return rec

        def surgery(fn):
            _, n = reads.measure(fn)
            assert n == 0, n

        for i in range(6):                   # 4 -> 8 growth
            surgery(lambda: svc.attach(
                f"p{i}", tenant="acme" if i % 2 else "zeta",
                kind="training" if i % 3 else "inference"))
        tick()
        surgery(lambda: svc.set_thresholds("acme", t_crit_c=75.0))
        surgery(lambda: svc.canary(0.5))
        tick()
        for i in range(6):                   # 8 -> 4 shrink
            surgery(lambda: svc.detach(f"p{i}"))
        for i in range(10):                  # 4 -> 8 -> 16 growth
            surgery(lambda: svc.attach(f"q{i}"))
        tick()
        for i in range(9):                   # shrink again
            surgery(lambda: svc.detach(f"q{i}"))
        tick()
    assert _build.COUNTS == counts
    assert svc.host_syncs == ticks == 4


# ------------------------------------------------------------------- alerts
def test_alert_fires_once_per_crossing_with_tail_flush():
    """Edge-latched alerts: hot→hot→cool→cool→hot(tail) gives one
    ``fired`` per rising edge and one ``cleared`` on the falling edge —
    the same events as the reference's service on the same chunks."""
    port = _service()
    ref = JService(JConfig(n_tiles=N_TILES), min_capacity=4, flush_every=W)
    events = []
    for s in (port, ref):
        s.attach("p0", tenant="acme")
        s.set_thresholds("acme", t_crit_c=70.0)
    for k, fill in ((2 * W, 2.7), (2 * W, 2.7), (2 * W, 0.9), (2 * W, 0.9),
                    (W + 4, 2.7)):
        c = _chunk(k, 4, fill=fill)
        rec, want = port.tick(c), ref.tick(c)
        assert_records_close(want, rec, f"fill {fill}")
        events.append([a["event"] for a in rec["alerts"]
                       if a["kind"] == "t_crit"])
    assert events == [["fired"], [], [], ["cleared"], ["fired"]]


def test_alerts_scoped_to_tenant():
    svc = _service()
    svc.attach("hotpkg", tenant="acme")
    svc.attach("coolpkg", tenant="zeta")
    svc.set_thresholds("acme", t_crit_c=70.0)
    cols = np.full((2 * W, 2, N_TILES), 0.9, np.float32)
    cols[:, 0, :] = 2.7                       # lane 0 == hotpkg runs hot
    rec = svc.tick(_chunk(2 * W, 4, fill=1.0, cols=cols))
    assert {a["tenant"] for a in rec["alerts"]} == {"acme"}


class _Flaky:
    """Local endpoint failing the first ``fail_n`` POSTs with 500."""

    def __init__(self, fail_n):
        import http.server
        outer = self
        self.hits, self.bodies = 0, []

        class H(http.server.BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def do_POST(self):      # noqa: N802 — http.server API
                outer.hits += 1
                body = self.rfile.read(int(self.headers["Content-Length"]))
                if outer.hits <= fail_n:
                    self.send_error(500, "flaky")
                    return
                outer.bodies.append(json.loads(body))
                self.send_response(200)
                self.send_header("Content-Length", "0")
                self.end_headers()

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}/hook"

    def close(self):
        self.server.shutdown()
        self.thread.join(timeout=5)


@pytest.mark.parametrize("fail_n,delivered", [(2, True), (10 ** 9, False)])
def test_webhook_sink_bounded_retries(fail_n, delivered):
    """Two 500s then success: delivered after two backed-off retries; an
    endpoint that never recovers: bounded attempts, capped backoff, the
    event dropped — and nothing raised into the serving loop."""
    flaky = _Flaky(fail_n)
    try:
        naps = []
        sink = WebhookSink(flaky.url, retries=3, backoff_s=0.1,
                           max_backoff_s=0.25, sleep=naps.append)
        ev = {"flush": 1, "tenant": "acme", "kind": "t_crit",
              "value": 71.0, "limit": 70.0}
        sink.emit(ev)
        if delivered:
            assert sink.delivered == [ev] and sink.dropped == []
            assert flaky.hits == 3 and len(sink.errors) == 2
            assert naps == [0.1, 0.2]
        else:
            assert sink.dropped == [ev] and sink.delivered == []
            assert flaky.hits == 4 and len(sink.errors) == 4
            assert naps == [0.1, 0.2, 0.25]
    finally:
        flaky.close()
    with pytest.raises(ValueError):
        WebhookSink("http://x", retries=-1)


# ------------------------------------------------------------------- replay
def test_replay_reproduces_recorded_telemetry(tmp_path):
    svc = _service()
    svc.attach("p0", kind="inference")
    svc.attach("p1", kind="training")
    recs = [svc.tick() for _ in range(3)]
    path = tmp_path / "stream.jsonl"
    svc.log.dump_jsonl(str(path))
    replayed = svc.replay(str(path))
    assert len(replayed) == 3
    for orig, rep in zip(recs, replayed):
        for k, v in orig["telemetry"].items():
            np.testing.assert_allclose(rep["telemetry"][k], v, err_msg=k,
                                       **TOL)


def test_replay_across_capacity_transitions_both_ways(tmp_path):
    """A recording spanning grow and shrink replays through the port; the
    port's JSONL replays through the reference and the reference's through
    the port, to the same telemetry (the chunk crosses as a list)."""
    port = _service()
    ref = JService(JConfig(n_tiles=N_TILES), min_capacity=4, flush_every=W)
    rng = np.random.default_rng(9)
    recs = []

    def step(*ops):
        for s in (port, ref):
            for op in ops:
                op(s)
        c = rng.uniform(0.9, 2.7, (W, port.registry.capacity, N_TILES)
                        ).astype(np.float32)
        recs.append(port.tick(c))
        ref.tick(c)

    step(lambda s: s.attach("p0"))
    step(*(lambda s, i=i: s.attach(f"p{i}") for i in range(1, 6)))
    step(*(lambda s, i=i: s.detach(f"p{i}") for i in range(5)))
    step()
    assert [r["capacity"] for r in recs] == [4, 8, 4, 4]
    port.log.dump_jsonl(str(tmp_path / "port.jsonl"))
    ref.log.dump_jsonl(str(tmp_path / "ref.jsonl"))
    for got in (port.replay(str(tmp_path / "port.jsonl")),
                port.replay(str(tmp_path / "ref.jsonl")),
                ref.replay(str(tmp_path / "port.jsonl"))):
        assert len(got) == len(recs)
        for orig, rep in zip(recs, got):
            for k, v in orig["telemetry"].items():
                _close(rep["telemetry"][k], v, k, "replay")


@pytest.mark.parametrize("lanes", [(0, 1, 2, 3), (0, 2, 5, 7)])
def test_masked_telemetry_matches_dense_fleet(lanes):
    eng = FleetEngine(SchedulerConfig(n_tiles=N_TILES), device=CPU)
    rng = np.random.default_rng(3)
    cols = rng.uniform(0.9, 2.7, (2 * W, 4, N_TILES)).astype(np.float32)
    chunk = np.full((2 * W, 8, N_TILES), 1.0, np.float32)
    chunk[:, list(lanes), :] = cols
    active = np.zeros(8, bool)
    active[list(lanes)] = True
    _, masked = eng.run_block(eng.init(8), chunk, active=active)
    _, dense = eng.run_block(eng.init(4), cols)
    md, dd = masked.as_dict(), dense.as_dict()
    for k, v in dd.items():
        np.testing.assert_allclose(md[k], v, err_msg=k, **TOL)


# ------------------------------------------------------------------- ingest
def test_ingest_routes_posted_chunk_onto_tenant_lanes():
    svc = _service()
    svc.attach("a0", tenant="acme")
    svc.attach("a1", tenant="acme")
    svc.attach("z0", tenant="zeta")
    lanes = {p: svc.registry.lane(p) for p in ("a0", "a1", "z0")}
    posted = np.linspace(0.9, 2.7, W * N_TILES, dtype=np.float32
                         ).reshape(W, N_TILES)
    out = svc.ingest("acme", posted)
    assert out["accepted"] and out["queued"] == 1
    assert out["lookahead_ms"] == pytest.approx(W * svc.cfg.step_ms)
    rec = svc.tick()
    assert rec["ingest_fed"] == ["acme"]
    rho = np.asarray(rec["rho"], np.float32)
    for pkg in ("a0", "a1"):
        np.testing.assert_allclose(rho[:, lanes[pkg], :], posted, **TOL)
    assert not np.allclose(rho[:, lanes["z0"], :], posted)
    rec2 = svc.tick()
    assert rec2["ingest_fed"] == []
    assert not np.allclose(np.asarray(rec2["rho"])[:, lanes["a0"], :],
                           posted)


def test_ingest_validation_and_backpressure():
    svc = _service(feed_capacity=2)
    svc.attach("p0", tenant="acme")
    with pytest.raises(ValueError, match="unknown tenant"):
        svc.ingest("ghost", np.ones((W, N_TILES), np.float32))
    with pytest.raises(ValueError, match="one flush window"):
        svc.ingest("acme", np.ones((W + 1, N_TILES), np.float32))
    with pytest.raises(ValueError, match="finite and non-negative"):
        svc.ingest("acme", np.full((W, N_TILES), -1.0, np.float32))
    assert svc.ingest("acme", np.ones(W, np.float32))["accepted"]
    assert svc.ingest("acme", np.ones(W, np.float32))["queued"] == 2
    refused = svc.ingest("acme", np.ones(W, np.float32))
    assert refused["accepted"] is False and refused["queued"] == 2
    svc.tick()
    assert svc.ingest("acme", np.ones(W, np.float32))["accepted"]


def test_synthetic_streams_independent_of_membership():
    """A package's synthetic chunk depends on (seed, its key, the flush)
    only: attaching another package leaves it unchanged, and the seed
    derivation is the documented one."""
    a, b = _service(seed=3), _service(seed=3)
    a.attach("p0", kind="vision")
    b.attach("p0", kind="vision")
    b.attach("p1", kind="batch")
    ra, rb = a.tick(), b.tick()
    lane = a.registry.lane("p0")
    np.testing.assert_array_equal(ra["rho"][:, lane],
                                  rb["rho"][:, b.registry.lane("p0")])
    assert trace_seed(3, 0) != trace_seed(3, 1) != trace_seed(4, 0)
    assert 0 <= trace_seed(10 ** 6, 10 ** 6) < 2 ** 56


# ----------------------------------------------------------------- profiles
def _profiled(**kw):
    cfg = SchedulerConfig(n_tiles=N_TILES, mixed_mode=True,
                          heterogeneous=True, filtration_window=W)
    return _service(cfg=cfg, **kw)


def test_profiles_nodes_modes_and_validation():
    from repro_torch.core import nodebank
    svc = _profiled()
    svc.attach("a", tenant="acme", node="n3", mode="reactive_poll")
    svc.attach("b", tenant="acme")
    d = svc.registry.describe()["packages"]
    assert (d["a"]["node"], d["a"]["mode"]) == ("n3", "reactive_poll")
    assert (d["b"]["node"], d["b"]["mode"]) == ("base", "v24")
    la, lb = svc.registry.lane("a"), svc.registry.lane("b")
    mask = np_(svc.state.ctrl_mode)
    assert mask[la] and not mask[lb]
    rows = nodebank.fleet_package_params(svc.engine.sched, ["n3", "base"])
    assert torch.equal(svc.state.pkg.decay[la], rows.decay[0])
    assert torch.equal(svc.state.pkg.gain[lb], rows.gain[1])
    assert svc.set_mode("a", "v24")["mode"] == "v24"
    assert not np_(svc.state.ctrl_mode).any()
    with pytest.raises(ValueError, match="unknown node"):
        svc.attach("x", node="n999")
    with pytest.raises(ValueError, match="profile mode"):
        svc.attach("x", mode="bogus")
    with pytest.raises(ValueError, match="plant group"):
        svc.attach("x", plant="grid")
    plain = _service()
    with pytest.raises(ValueError, match="heterogeneous"):
        plain.attach("x", node="n5")
    with pytest.raises(ValueError, match="mixed_mode"):
        plain.attach("x", mode="reactive_poll")
    with pytest.raises(ValueError, match="mixed_mode"):
        plain.canary(0.5)
    assert plain.registry.n_active == 0


def test_canary_pins_change_flush_behaviour():
    def run(frac):
        svc = _profiled(seed=7)
        for i in range(4):
            svc.attach(f"p{i}")
        svc.canary(frac)
        hot = np.full((W, 4, N_TILES), 2.0, np.float32)
        return [svc.tick(chunk=hot)["telemetry"]["freq_mean"]
                for _ in range(4)]
    assert run(0.0) != run(1.0)


# ---------------------------------------------------------------------- HTTP
def test_http_surface_round_trip():
    svc = _profiled(flush_every=8, feed_capacity=1)
    server, thread = serve_http(svc, port=0)
    base = f"http://127.0.0.1:{server.server_address[1]}"

    def get(path):
        with urllib.request.urlopen(base + path, timeout=10) as r:
            raw = r.read()
        return raw.decode() if path.startswith("/dashboard") \
            else json.loads(raw)

    def post(path, payload):
        req = urllib.request.Request(
            base + path, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=10) as r:
            return json.loads(r.read())

    try:
        assert get("/healthz")["ok"] is True
        assert post("/attach", {"package": "p0", "tenant": "acme",
                                "node": "n7"})["capacity"] == 4
        out = post("/attach", {"package": "p1", "tenant": "acme",
                               "mode": "reactive_poll"})
        assert out["mode"] == "reactive_poll"
        post("/thresholds", {"tenant": "acme", "t_crit_c": 68.0})
        svc.tick(_chunk(8, 4, fill=2.7))     # hot flush -> alert
        snap = get("/telemetry?last=5")
        assert snap["n_active"] == 2 and len(snap["records"]) == 1
        assert "rho" not in snap["records"][0]
        assert get("/fleet")["tenants"]["acme"]["packages"] == ["p0", "p1"]
        assert any(a["kind"] == "t_crit" for a in get("/alerts")["alerts"])
        assert post("/canary", {"reactive_frac": 1.0})["pinned_reactive"] \
            == 2
        assert post("/mode", {"package": "p1", "mode": "v24"})["mode"] \
            == "v24"
        html = get("/dashboard")
        for word in ("lane profiles", "n7", "reactive_poll", "acme"):
            assert word in html
        chunk = [[1.2] * N_TILES] * 8
        r = post("/ingest", {"tenant": "acme", "chunk": chunk})
        assert r["accepted"] is True and r["queued"] == 1
        with pytest.raises(urllib.error.HTTPError) as ei:
            post("/ingest", {"tenant": "acme", "chunk": chunk})
        assert ei.value.code == 429
        with pytest.raises(urllib.error.HTTPError) as ei:
            post("/ingest", {"tenant": "ghost", "chunk": chunk})
        assert ei.value.code == 400
        assert svc.tick()["ingest_fed"] == ["acme"]
        with pytest.raises(urllib.error.HTTPError) as ei:
            post("/attach", {"package": "p0"})     # already attached
        assert ei.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as ei:
            post("/thresholds", {"tenant": "acme", "nope": 1.0})
        assert ei.value.code == 400
        assert post("/detach", {"package": "p0"})["plan"] in ("none",
                                                              "shrink")
        post("/shutdown", {})
        assert svc.shutting_down
    finally:
        server.shutdown()
        thread.join(timeout=5)
    assert "lane profiles" in _dashboard_html(svc)


# --------------------------------------------------------------- snapshots
def test_reference_snapshot_restores_into_the_port(tmp_path):
    """A snapshot directory the JAX service wrote (its arrays in the
    reference's leaf order, its bookkeeping in the manifest, ops journaled
    after it) restores into the port, and the two continue on the same
    chunks to the same records and state."""
    kw = dict(n_tiles=N_TILES, mixed_mode=True, filtration_window=W)
    ref = JService(JConfig(**kw), min_capacity=4, flush_every=W,
                   snapshot_dir=str(tmp_path))
    rng = np.random.default_rng(5)
    chunk = lambda cap: rng.uniform(0.9, 2.7, (W, cap, N_TILES)
                                    ).astype(np.float32)
    for i in range(3):
        ref.attach(f"p{i}", "acme" if i else "zeta")
    ref.set_thresholds("acme", t_crit_c=75.0)
    ref.canary(0.34)
    ref.tick(chunk(4))
    ref.tick(chunk(4))
    ref.save_snapshot(blocking=True)
    ref.attach("p3", "zeta")                  # journaled after the snapshot
    port = FleetService.restore(str(tmp_path), device=CPU)
    assert port.flushes == ref.flushes == 2 and port.registry.n_active == 4
    assert port.registry.describe() == ref.registry.describe()
    for k in range(3):
        if k == 1:
            for s in (ref, port):
                s.attach(f"q{k}", "acme")    # grow 4 -> 8
        c = chunk(ref.registry.capacity)
        assert_records_close(ref.tick(c), port.tick(c), f"resumed {k}")
    for f in ("thermal", "freq"):
        np.testing.assert_allclose(np_(getattr(port.state, f)),
                                   np_(getattr(ref.state, f)), **TOL)
    for f in ("events", "ctrl_mode", "throttled"):
        np.testing.assert_array_equal(np_(getattr(port.state, f)),
                                      np_(getattr(ref.state, f)))


def test_profiles_and_canary_survive_restore(tmp_path):
    svc = _profiled(seed=3, snapshot_dir=str(tmp_path), snapshot_every=0)
    svc.warmup(8)
    svc.attach("a", node="n5", mode="reactive_poll")
    svc.attach("b")
    svc.tick()
    svc.save_snapshot(blocking=True)
    svc.attach("c", node="n7")
    svc.canary(1.0)
    svc.tick()
    svc.set_mode("b", "v24")
    want = {p: (d["node"], d["mode"])
            for p, d in svc.registry.describe()["packages"].items()}
    want_mask = np_(svc.state.ctrl_mode).copy()
    r = FleetService.restore(str(tmp_path), device=CPU)
    got = {p: (d["node"], d["mode"])
           for p, d in r.registry.describe()["packages"].items()}
    assert got == want
    np.testing.assert_array_equal(np_(r.state.ctrl_mode), want_mask)


# ------------------------------------------------ kill-and-restore (SIGKILL)
FLUSH_EVERY, TOTAL, KILL_AFTER, GROW_AT, SEED = 50, 36, 18, 8, 5

_CHILD = """
import sys
import numpy as np
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.fleet.service import FleetService

cfg = SchedulerConfig(n_tiles=2, mode="v24", filtration_window=16,
                      degraded_fallback=True, stale_limit_steps=4,
                      recover_steps=8)
svc = FleetService(cfg, flush_every={fe}, seed={seed}, device="cpu",
                   snapshot_dir=sys.argv[1], snapshot_every=5)
svc.warmup(8)
for i in range(4):
    svc.attach(f"pkg{{i}}", tenant="acme")
while svc.flushes < {total}:
    if svc.flushes == {grow}:
        svc.attach("pkg4", tenant="acme")
        svc.attach("pkg5", tenant="acme")
    while len(svc._feeds.get("acme", ())) < 2:
        nxt = svc.flushes + len(svc._feeds.get("acme", ()))
        rng = np.random.default_rng(1000 + nxt)
        svc.ingest("acme", rng.uniform(0.9, 2.7, ({fe}, 2)))
    svc.tick()
    print(f"flush {{svc.flushes}}", flush=True)
"""


def _drive(svc, until):
    """The victim's schedule: 4 packages, two more at GROW_AT (4 -> 8),
    the tenant's feed topped up to two queued windows before every flush
    (the next window's index read off the queue depth, so a restored
    service whose journal re-offered the lost posts never double-feeds)."""
    while svc.flushes < until:
        if svc.flushes == GROW_AT and "pkg4" not in svc.registry.packages:
            svc.attach("pkg4", tenant="acme")
            svc.attach("pkg5", tenant="acme")
        while len(svc._feeds.get("acme", ())) < 2:
            nxt = svc.flushes + len(svc._feeds.get("acme", ()))
            rng = np.random.default_rng(1000 + nxt)
            assert svc.ingest("acme", rng.uniform(
                0.9, 2.7, (FLUSH_EVERY, 2)))["accepted"]
        assert svc.tick()["ingest_fed"] == ["acme"]


def test_sigkill_recovery_with_queued_ingest_matches_oracle(tmp_path):
    """A victim process dies by SIGKILL mid-stream (no final snapshot) with
    posted chunks queued; restoring from its last periodic snapshot and
    journal resumes ≤1e-5 from an uninterrupted oracle, the queued chunk
    back in place, past a capacity transition, with no kernel library
    built or loaded after the restore's warmup."""
    cfg = SchedulerConfig(n_tiles=2, mode="v24", filtration_window=16,
                          degraded_fallback=True, stale_limit_steps=4,
                          recover_steps=8)
    snap, driver = tmp_path / "snaps", tmp_path / "driver.py"
    driver.write_text(_CHILD.format(fe=FLUSH_EVERY, seed=SEED, total=TOTAL,
                                    grow=GROW_AT))
    env = dict(os.environ)
    src = str(pathlib.Path(__file__).resolve().parents[1] / "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen([sys.executable, str(driver), str(snap)],
                            stdout=subprocess.PIPE, text=True, env=env)
    try:
        for line in proc.stdout:
            if int(line.split()[1]) >= KILL_AFTER:
                proc.send_signal(signal.SIGKILL)
                break
        else:
            raise AssertionError(f"victim exited early (rc={proc.wait()})")
    finally:
        proc.kill()
        proc.wait()

    oracle = FleetService(cfg, flush_every=FLUSH_EVERY, seed=SEED,
                          device=CPU)
    for i in range(4):
        oracle.attach(f"pkg{i}", tenant="acme")
    _drive(oracle, TOTAL)

    svc = FleetService.restore(str(snap), device=CPU)
    assert GROW_AT < svc.flushes <= KILL_AFTER + 5, svc.flushes
    assert svc.registry.n_active == 6 and svc.registry.capacity == 8
    assert len(svc._feeds["acme"]) >= 1
    counts = dict(_build.COUNTS)
    _drive(svc, TOTAL)
    assert _build.COUNTS == counts
    assert svc.flushes == oracle.flushes == TOTAL
    assert svc.steps == oracle.steps == TOTAL * FLUSH_EVERY
    t_svc = svc.log.rows()[-1]["telemetry"]
    for k, v in oracle.log.rows()[-1]["telemetry"].items():
        np.testing.assert_allclose(t_svc[k], v, err_msg=k, **TOL)
    for f in ("freq", "thermal", "events", "rho_last", "stale", "degraded"):
        np.testing.assert_allclose(np_(getattr(svc.state, f)).astype(float),
                                   np_(getattr(oracle.state, f)).astype(
                                       float), err_msg=f, **TOL)
