"""PyTorch port, the fleet across processes (`repro_torch.distributed.
multihost`, `fleet/distributed_ingest.py`, the mesh backends' multi-process
branches, `serve --distributed`).

Each group test spawns a real process group through the port's own
`multihost.run_process_group`: N fresh interpreters that import only
`repro_torch`, gloo over a local coordinator, two CPU partitions a rank
(``local_devices=2``).  The sizes are the reference's
(tests/test_fleet_distributed.py): N = 16, 4 tiles, T = 600, K = 100,
burn-in 50.  The oracle is the reference's single-device ``vmap`` engine
run in this process — the reference's own multi-process tests fail on this
tree (ROADMAP queue 3) — with the reference's bounds: event counts exact,
``freq_min`` / ``at_risk_frac`` within 1e-3, the rest within 1e-5, on the
"uniform" trace family.  On the reference test's "swell" trace, which parks
the fleet on the throttle boundary, every one-process backend of the port
already differs from the reference past 1e-5 (the knife edge, ROADMAP
queue 3), so there the group is held to the port's own one-process engine,
record for record and bit for bit: the mesh adds no rounding.  Inside
the workers: one host sync a flush (`FleetTelemetry.as_dict`, the port's
one device→host fetch, counted as the reference's workers count
`jax.device_get`), one collective a flush (every `torch.distributed`
collective counted), the same records on every rank, `describe()`.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core.scheduler import SchedulerConfig as JCfg
from repro.fleet import FleetEngine as JEngine
from repro.fleet import chunk_source as j_chunk_source
from repro.fleet import stream as j_stream
from repro_torch.distributed import multihost
from repro_torch.distributed.sharding import ProcessMesh, fleet_mesh
from repro_torch.fleet import LaneSpan, local_chunk_source
from repro_torch.launch import serve

jax.config.update("jax_platform_name", "cpu")

N, TILES, T, K = 16, 4, 600, 100
BURN = 50
KNIFE = {"freq_min": 1e-3, "at_risk_frac": 1e-3}
EXACT = {"events_total", "events_step", "n_packages", "degraded_count"}


def _trace(kind: str = "swell") -> np.ndarray:
    """The reference test's two trace families: "swell" parks the fleet on
    the throttle boundary; "uniform" is the one the fused kernel's gates
    use."""
    if kind == "uniform":
        rng = np.random.default_rng(5)
        return (0.9 + 1.8 * rng.random((T, N, TILES))).astype(np.float32)
    t = np.linspace(0.0, np.pi, T, dtype=np.float32)
    swell = 1.8 * (0.85 + 0.3 * np.sin(t) ** 2)
    off = 0.1 * np.cos(np.arange(N, dtype=np.float32))
    tilt = 1.0 + 0.05 * np.sin(np.arange(TILES, dtype=np.float32))
    tr = swell[:, None, None] + off[None, :, None]
    return np.clip(tr * tilt[None, None, :], 0.9, 2.7).astype(np.float32)


# counts every collective of the group (the flush's all_reduce and any
# other) and every host fetch of a record, around the calls it wraps
_COUNTERS = r"""
import torch.distributed as dist
from repro_torch.fleet.engine import FleetTelemetry
COUNT = {"collectives": 0, "syncs": 0}
def _counting(fn, key):
    def wrapped(*a, **k):
        COUNT[key] += 1
        return fn(*a, **k)
    return wrapped
for _name in ("all_reduce", "all_gather", "all_gather_object", "broadcast",
              "reduce_scatter", "all_to_all", "barrier", "reduce",
              "gather", "scatter", "send", "recv"):
    if hasattr(dist, _name):
        setattr(dist, _name, _counting(getattr(dist, _name), "collectives"))
FleetTelemetry.as_dict = _counting(FleetTelemetry.as_dict, "syncs")
def counted(fn):
    before = dict(COUNT)
    out = fn()
    return out, {k: COUNT[k] - before[k] for k in COUNT}
"""

_WORKER = r"""
from repro_torch.distributed import multihost
topo = multihost.bootstrap_from_env()
import json
import numpy as np
import torch
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.distributed import sharding
from repro_torch.fleet import (FleetEngine, chunk_source, distributed_stream,
                               local_chunk_source, local_lanes)
""" + _COUNTERS + r"""
BACKEND = "%(backend)s"
N, TILES, T, K, BURN = %(n)d, %(tiles)d, %(t)d, %(k)d, %(burn)d
assert topo.num_processes == %(procs)d, topo

cfg = SchedulerConfig(n_tiles=TILES, mode="v24")
eng = FleetEngine(cfg, backend=BACKEND, device="cpu")
state = eng.init(N)

# the partitioning is real: the mesh spans every rank, and this rank's
# state holds only its own two partitions
mesh = eng.backend_impl.mesh
assert multihost.spans_processes(mesh) and mesh.size == 2 * topo.num_processes
assert len(state.freq.parts) == 2 and state.freq.shape[0] == N
try:
    sharding.gather(state)
except ValueError:
    pass
else:
    raise AssertionError("a state across processes gathered locally")
lanes = local_lanes(eng)
assert lanes.n == N // topo.num_processes, lanes

trace = (0.9 + 1.8 * np.random.default_rng(5).random(
    (T, N, TILES))).astype(np.float32)
t = np.linspace(0.0, np.pi, T, dtype=np.float32)
swell = 1.8 * (0.85 + 0.3 * np.sin(t) ** 2)
off = 0.1 * np.cos(np.arange(N, dtype=np.float32))
tilt = 1.0 + 0.05 * np.sin(np.arange(TILES, dtype=np.float32))
swell = np.clip((swell[:, None, None] + off[None, :, None])
                * tilt[None, None, :], 0.9, 2.7).astype(np.float32)

# ---- dense stream of this rank's slabs, syncs and collectives counted
(state, flushed, stats), n_dense = counted(lambda: distributed_stream(
    eng, state, local_chunk_source(chunk_source(trace, K), lanes)))
n_flush = -(-T // K)
assert stats.flushes == stats.host_syncs == n_flush, stats
assert n_dense == {"collectives": n_flush, "syncs": n_flush}, n_dense
out = {"describe": eng.backend_impl.describe(), "flushed": flushed,
       "freq": eng.assemble(state).freq.tolist()}
# ---- the knife-edge trace, global chunks cut to this rank's span
(_, out["swell"], _), n_swell = counted(lambda: distributed_stream(
    eng, eng.init(N), chunk_source(swell, K), global_chunks=True))
assert n_swell == n_dense, n_swell

if %(full)d:
    # ---- masked stream: the GLOBAL mask on every rank
    mask = np.ones(N, bool)
    mask[1] = False
    st2 = eng.init(N)
    (st2, masked, _), n_masked = counted(lambda: distributed_stream(
        eng, st2, chunk_source(trace, K), global_chunks=True, active=mask))
    assert n_masked["collectives"] == n_flush, n_masked
    # ---- the per-lane survey over this rank's slab, assembled once
    st3 = eng.init(N)
    (st3, survey), n_survey = counted(lambda: eng.run_survey(
        st3, trace[:, lanes.lo:lanes.hi, :], burn_in=BURN))
    assert n_survey == {"collectives": 1, "syncs": 0}, n_survey
    # ---- run and step: one collective a call, never one a step
    st4 = eng.init(N)
    (st4, per_step), n_run = counted(lambda: eng.run(st4, trace[:5]))
    (_, _, one), n_step = counted(lambda: eng.step(st4, trace[5]))
    assert n_run["collectives"] == n_step["collectives"] == 1, (n_run,
                                                                 n_step)
    out.update(masked=masked,
               peak=survey.peak_t_c.tolist(),
               exceed=survey.exceed_frac.tolist(),
               fmean=survey.freq_mean.tolist(),
               run={k: v.tolist() for k, v in per_step._asdict().items()},
               step={k: v.tolist() for k, v in one._asdict().items()})
print("RESULT " + json.dumps(out))
"""


def _results(outs: list[str]) -> list[dict]:
    res = [json.loads(line[len("RESULT "):]) for o in outs
           for line in o.splitlines() if line.startswith("RESULT ")]
    assert len(res) == len(outs), outs
    return res


def _run_group(backend: str, procs: int, full: bool = True) -> dict:
    code = _WORKER % {"backend": backend, "procs": procs, "n": N,
                      "tiles": TILES, "t": T, "k": K, "burn": BURN,
                      "full": int(full)}
    res = _results(multihost.run_process_group(code, procs, local_devices=2,
                                               timeout=240))
    for r in res[1:]:                    # the same records on every rank
        assert r == res[0]
    return res[0]


def _oracle(active=None, trace: str = "uniform"):
    eng = JEngine(JCfg(n_tiles=TILES, mode="v24"), backend="vmap")
    state = eng.init(N)
    state, flushed, _ = j_stream(eng, state, j_chunk_source(_trace(trace), K),
                                 active=active)
    return state, flushed


def _check_records(dist: list[dict], ref: list[dict]) -> None:
    assert len(dist) == len(ref) == -(-T // K)
    for a, b in zip(dist, ref):
        for k, rv in b.items():
            dv = a[k]
            if k in EXACT:
                assert dv == rv, (k, dv, rv)
            elif k in KNIFE:
                assert dv == pytest.approx(rv, abs=KNIFE[k]), (k, dv, rv)
            else:
                assert dv == pytest.approx(rv, rel=1e-5, abs=1e-5), \
                    (k, dv, rv)


def _one_process(backend: str, kind: str) -> list[dict]:
    """The port's one-process engine's records on a trace family."""
    from repro_torch.core.scheduler import SchedulerConfig
    from repro_torch.fleet import FleetEngine, chunk_source, stream

    eng = FleetEngine(SchedulerConfig(n_tiles=TILES, mode="v24"),
                      backend=backend, device="cpu")
    return stream(eng, eng.init(N), chunk_source(_trace(kind), K))[1]


@pytest.mark.parametrize("procs", [2, 4])
def test_distributed_sharded_matches_single_device_reference(procs):
    """2- and 4-rank groups reproduce the reference's single-device engine:
    flush records, masked records, the per-lane survey, `run` / `step` and
    the final state — one host sync and one collective a flush on every
    rank; on the knife-edge trace, the port's one-process records exactly."""
    res = _run_group("sharded", procs)
    assert res["describe"] == f"sharded[{2 * procs}dev/{procs}proc]"
    assert res["swell"] == _one_process("broadcast", "swell")
    state, ref = _oracle()
    _check_records(res["flushed"], ref)
    np.testing.assert_allclose(res["freq"], np.asarray(state.freq),
                               rtol=1e-5, atol=1e-5)
    mask = np.ones(N, bool)
    mask[1] = False
    _check_records(res["masked"], _oracle(active=mask)[1])

    eng = JEngine(JCfg(n_tiles=TILES, mode="v24"), backend="vmap")
    st, sv = eng.run_survey(eng.init(N), _trace("uniform"), burn_in=BURN)
    np.testing.assert_allclose(res["peak"], np.asarray(sv.peak_t_c),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(res["exceed"], np.asarray(sv.exceed_frac),
                               atol=1e-5)
    np.testing.assert_allclose(res["fmean"], np.asarray(sv.freq_mean),
                               rtol=1e-5, atol=1e-5)

    # run's per-step records and one step after it, against the reference
    st, per_step = eng.run(eng.init(N), _trace("uniform")[:5])
    st, _, one = eng.step(st, _trace("uniform")[5])
    for got, want in ((res["run"], per_step), (res["step"], one)):
        for k, v in want._asdict().items():
            tol = dict(atol=1e-3) if k in KNIFE else dict(rtol=1e-5,
                                                           atol=1e-5)
            np.testing.assert_allclose(got[k], np.asarray(v), err_msg=k,
                                       **({} if k in EXACT else tol))


def test_distributed_sharded_fused_matches_single_device_reference():
    """`fleet_step` on each rank's partitions (its plain version here), 2
    ranks, against the reference on the uniform trace family the kernel's
    gates use, and equal to the port's one-process `fused` on the knife
    edge."""
    res = _run_group("sharded_fused", 2, full=False)
    assert res["describe"] == "sharded_fused[4dev/2proc,blk=plain]"
    assert res["swell"] == _one_process("fused", "swell")
    state, ref = _oracle()
    _check_records(res["flushed"], ref)
    np.testing.assert_allclose(res["freq"], np.asarray(state.freq),
                               rtol=1e-5, atol=1e-5)


def test_multiprocess_rejects_degraded_mesh_and_foreign_chunks():
    """In a group an indivisible fleet and a partial device budget raise
    (a shrunken mesh would leave a rank out of the collectives), and so
    does a chunk that is neither global nor this rank's span, or one put
    before `init`."""
    code = r"""
from repro_torch.distributed import multihost
topo = multihost.bootstrap_from_env()
import numpy as np
import pytest
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.fleet import FleetEngine
cfg = SchedulerConfig(n_tiles=2)
eng = FleetEngine(cfg, backend="sharded", device="cpu")
with pytest.raises(RuntimeError, match="init"):
    eng.backend_impl.put_trace(np.ones((3, 8, 2), np.float32))
with pytest.raises(ValueError, match="multi-process"):
    eng.init(7)                  # 7 lanes over 4 global devices
with pytest.raises(ValueError, match="global devices"):
    FleetEngine(cfg, backend="sharded", device="cpu", devices=2).init(8)
eng.init(8)
lo, hi = multihost.local_lane_range(8, eng.backend_impl.mesh)
assert (lo, hi) == (4 * topo.process_id, 4 * topo.process_id + 4)
with pytest.raises(ValueError, match="neither the global fleet size 8 "
                                     "nor this process's local span 4"):
    eng.backend_impl.put_trace(np.ones((3, 6, 2), np.float32))
for n in (8, 4):                 # a global chunk and this rank's slab
    x = eng.backend_impl.put_trace(np.ones((3, n, 2), np.float32))
    assert x.shape == (3, 8, 2) and x.spans() == [(lo, lo + 2),
                                                  (lo + 2, hi)]
print("RESULT {}")
"""
    _results(multihost.run_process_group(code, 2, local_devices=2,
                                         timeout=240))


def test_serve_distributed_matches_one_process_stream():
    """``serve --distributed --stream`` through the CLI on 2 ranks gives
    one-process ``serve --stream``'s records, and rank 0 alone prints the
    flush lines."""
    argv = ["--stream", "--fleet", "16", "--waves", "3", "--gen", "20",
            "--device", "cpu", "--seed", "3"]
    code = r"""
import json, os
from repro_torch.launch import serve
res = serve.main(%r + ["--fleet-backend", "sharded_fused", "--distributed",
                       "--coordinator", os.environ["REPRO_COORDINATOR"],
                       "--num-processes", os.environ["REPRO_NUM_PROCESSES"],
                       "--process-id", os.environ["REPRO_PROCESS_ID"]])
print("RESULT " + json.dumps({"stream": res["stream"],
                              "syncs": res["host_syncs"]}))
""" % (argv,)
    outs = multihost.run_process_group(code, 2, timeout=240)
    res = _results(outs)
    want = serve.main(argv + ["--fleet-backend", "fused"])
    for r in res:
        assert r["stream"] == want["stream"] and r["syncs"] == 3
    assert "[distributed] process 1/2 (1 local / 2 global devices)" in outs[1]
    assert "[stream] flush 3" in outs[0] and "[stream] flush" not in outs[1]
    assert "sharded_fused[2dev/2proc,blk=plain]" in outs[0]


def test_local_lane_range_single_process():
    """The span helper: a one-process mesh owns every lane; the errors
    (indivisible size, a rank owning no device, non-contiguous partitions)
    on stand-in meshes, as the reference's test fakes them."""
    from types import SimpleNamespace

    mesh = fleet_mesh(None, [torch.device("cpu")] * 2)
    assert multihost.local_lane_range(16, mesh) == (0, 16)
    pm = ProcessMesh(mesh, owners=[0, 0, 1, 1], rank=1)
    assert multihost.local_lane_range(16, pm) == (8, 16)
    assert multihost.spans_processes(pm)
    assert not multihost.spans_processes(mesh)
    assert pm != mesh and pm == ProcessMesh(mesh, [0, 0, 1, 1], 1)

    def fake(owners, rank=0):
        return SimpleNamespace(owners=owners, rank=rank)

    with pytest.raises(ValueError, match="must divide"):
        multihost.local_lane_range(5, fake([0, 0]))
    with pytest.raises(ValueError, match="owns no devices"):
        multihost.local_lane_range(4, fake([1, 1]))
    with pytest.raises(ValueError, match="not contiguous"):
        multihost.local_lane_range(3, fake([0, 1, 0]))
    with pytest.raises(ValueError, match="contiguous run"):
        ProcessMesh(mesh, owners=[0, 1, 0], rank=0)
    topo = multihost.topology()
    assert (topo.process_id, topo.num_processes) == (0, 1)
    assert not multihost.is_multiprocess()


def test_local_chunk_source_slices_lanes():
    chunks = [np.arange(2 * 8 * 3, dtype=np.float32).reshape(2, 8, 3) + i
              for i in range(3)]
    span = LaneSpan(2, 5)
    out = list(local_chunk_source(iter(chunks), span))
    assert span.n == 3 and all(o.shape == (2, 3, 3) for o in out)
    np.testing.assert_array_equal(out[1], chunks[1][:, 2:5, :])


def test_run_process_group_reports_every_rank_of_a_failed_group():
    """One rank failing ends the group at once (the other would wait on a
    collective), and the error carries every rank's output."""
    code = r"""
import os, sys, time
from repro_torch.distributed import multihost
multihost.bootstrap_from_env()
print("rank", os.environ["REPRO_PROCESS_ID"], "up", flush=True)
import torch, torch.distributed as dist
dist.barrier()                             # both ranks have printed
if os.environ["REPRO_PROCESS_ID"] == "1":
    sys.exit(3)
dist.all_reduce(torch.zeros(1))            # waits for rank 1 forever
"""
    with pytest.raises(RuntimeError, match="a rank failed") as exc:
        multihost.run_process_group(code, 2, timeout=120)
    msg = str(exc.value)
    assert "rank 1 (rc=3)" in msg and "rank 0 up" in msg
