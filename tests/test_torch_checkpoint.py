"""PyTorch port, checkpoints and the fault-tolerance pieces
(`repro_torch.checkpoint`, `repro_torch.distributed.fault_tolerance`): the
gates of tests/test_checkpoint.py (atomicity, async save, GC, preemption,
heartbeat — ``test_training_resume_equivalence`` waits for the port's
training step), and the on-disk layout shared with the reference: a
checkpoint either package writes, the other restores leaf for leaf.
"""
import json
import os
import shutil
import signal
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_parity import np_

from repro.checkpoint import CheckpointManager as JManager
from repro.core.scheduler import SchedulerConfig as JConfig
from repro.fleet import FleetEngine as JEngine
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.manager import tree_leaves
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.distributed import Heartbeat, PreemptionGuard
from repro_torch.fleet import FleetEngine


@pytest.fixture
def tmp_ckpt(tmp_path):
    return str(tmp_path / "ckpt")


def _state():
    return {"w": torch.arange(12.0).reshape(3, 4),
            "nested": {"b": torch.ones(5, dtype=torch.bfloat16)},
            "step": torch.tensor(7)}


def test_roundtrip(tmp_ckpt):
    cm = CheckpointManager(tmp_ckpt)
    st = _state()
    cm.save(3, st, blocking=True)
    out, step = cm.restore_latest(st)
    assert step == 3
    for a, b in zip(tree_leaves(st), tree_leaves(out)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_async_save_then_wait(tmp_ckpt):
    cm = CheckpointManager(tmp_ckpt)
    st = _state()
    cm.save(1, st)
    st["w"].add_(100.0)            # the next tick may update state in place
    cm.wait()
    out, step = cm.restore_latest(_state())
    assert step == 1
    assert torch.equal(out["w"], torch.arange(12.0).reshape(3, 4))


def test_atomicity_incomplete_ignored(tmp_ckpt):
    cm = CheckpointManager(tmp_ckpt)
    cm.save(1, _state(), blocking=True)
    os.makedirs(os.path.join(tmp_ckpt, "step_00000002.tmp"))
    bad = os.path.join(tmp_ckpt, "step_00000003")
    shutil.copytree(os.path.join(tmp_ckpt, "step_00000001"), bad)
    with open(os.path.join(bad, "manifest.json")) as f:
        man = json.load(f)
    man["complete"] = False
    with open(os.path.join(bad, "manifest.json"), "w") as f:
        json.dump(man, f)
    assert cm.steps() == [1]


def test_gc_keep_n(tmp_ckpt):
    cm = CheckpointManager(tmp_ckpt, keep_n=2)
    for s in range(5):
        cm.save(s, _state(), blocking=True)
    assert cm.steps() == [3, 4]


def test_restore_refuses_another_structure(tmp_ckpt):
    cm = CheckpointManager(tmp_ckpt)
    cm.save(1, _state(), blocking=True, extra={"note": "x"})
    assert cm.manifest(1)["extra"] == {"note": "x"}
    with pytest.raises(ValueError, match="leaves"):
        cm.restore(1, {"w": torch.zeros(3, 4)})
    with pytest.raises(ValueError, match="shape"):
        cm.restore(1, {**_state(), "w": torch.zeros(4, 3)})


def _states(**kw):
    """One fleet state with every plane (pkg, latch, fallback, pins) from
    each package, equal leaf for leaf."""
    cfg = dict(n_tiles=3, mode="v24", heterogeneous=True,
               degraded_fallback=True, mixed_mode=True, **kw)
    n = 5
    je = JEngine(JConfig(**cfg))
    te = FleetEngine(SchedulerConfig(**cfg), device="cpu")
    rng = np.random.default_rng(0)
    tr = rng.uniform(0.9, 2.7, (21, n, 3)).astype(np.float32)
    js, _ = je.run_chunked(je.init(n), jnp.asarray(tr), 8)
    ts, _ = te.run_chunked(te.init(n), tr, 8)
    return jax.device_get(js), ts


@pytest.mark.parametrize("impl", ["incremental", "ring"])
def test_leaf_order_is_the_references(impl):
    js, ts = _states(filtration_impl=impl)
    jl, tl = jax.tree_util.tree_leaves(js), tree_leaves(ts)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert np.shape(a) == tuple(b.shape)
        assert np.asarray(a).dtype == np_(b).dtype


def test_reference_checkpoint_restores_into_the_port_and_back(tmp_path):
    """The JAX manager's files restore into a port state template (host
    clocks stay on the host), and the port's into a reference template."""
    js, ts = _states()
    JManager(str(tmp_path / "ref")).save(21, js, blocking=True)
    got = CheckpointManager(str(tmp_path / "ref")).restore(21, ts)
    for a, b in zip(jax.tree_util.tree_leaves(js), tree_leaves(got)):
        np.testing.assert_array_equal(np_(b), np.asarray(a))
    assert got.step.device.type == "cpu" and got.step.ndim == 0
    CheckpointManager(str(tmp_path / "port")).save(21, ts, blocking=True)
    back = JManager(str(tmp_path / "port")).restore(21, js)
    for a, b in zip(tree_leaves(ts), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(b), np_(a))


def test_preemption_guard():
    g = PreemptionGuard(signals=(signal.SIGUSR1,))
    assert not g.should_exit
    os.kill(os.getpid(), signal.SIGUSR1)
    time.sleep(0.05)
    assert g.should_exit
    g.restore()


def test_heartbeat_stall_detection():
    hb = Heartbeat(timeout_s=0.2)
    hb.beat()
    time.sleep(0.6)
    assert hb.stalled
    hb.close()
