"""PyTorch port: the training slice on the CPU against the JAX reference.

  * the data pipeline (`repro_torch.data`) is the reference's byte for
    byte, and `adamw_update` / `cosine_schedule` / `global_norm` match
    `repro.optim.adamw`;
  * the train step (`repro_torch.launch.steps.make_train_step`) matches
    `repro.launch.steps.make_train_step` from the same state (carried over
    with `convert.train_state_from_numpy`) and batches, for reduced
    Gemma-2B, Mixtral, DeepSeek-V2, musicgen (stub embeddings), RWKV6 and
    Zamba2 — see `test_torch_train_parity.py` (one file per ~minute);
  * microbatched gradients equal full-batch ones, the loss falls over 12
    steps, the driver resumes from its checkpoints, and a checkpoint the
    JAX trainer wrote resumes in the port (and the other way round).

Tolerances are stated at each assertion.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_parity import lm_batch

import jax
import jax.numpy as jnp

from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLMData as JSyntheticLMData
from repro.launch import steps as JS
from repro.launch import train as jtrain
from repro.optim import adamw as jadamw

from repro_torch import convert
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.manager import tree_leaves
from repro_torch.configs import get_arch, reduced
from repro_torch.data import DataConfig, SyntheticLMData
from repro_torch.kernels import ops
from repro_torch.launch import steps as S
from repro_torch.launch import train
from repro_torch.optim import adamw


# ------------------------------------------------------------------ data --
@pytest.mark.parametrize("arch", ["gemma-2b", "musicgen-large"])
def test_data_pipeline_is_the_references_byte_for_byte(arch):
    """Token batches, and a stub frontend's f32 embeddings, equal."""
    dc = dict(batch=3, seq_len=40, seed=7)
    ref = JSyntheticLMData(jreduced(jget_arch(arch)), JDataConfig(**dc))
    port = SyntheticLMData(reduced(get_arch(arch)), DataConfig(**dc))
    try:
        for _ in range(3):
            want, got = ref.next(), port.next()
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].dtype == want[k].dtype, k
                assert got[k].tobytes() == want[k].tobytes(), k
        w = np.array([0.5, 0.2, 0.2, 0.1])
        ref.set_balance(w)
        port.set_balance(w)
        np.testing.assert_array_equal(port.microbatch_split(4),
                                      ref.microbatch_split(4))
    finally:
        ref.close()
        port.close()


# ----------------------------------------------------------------- adamw --
def _tree(rng, scale=1.0):
    return {"a": (scale * rng.standard_normal((5, 7))).astype(np.float32),
            "b": {"c": (scale * rng.standard_normal((3,))).astype(np.float32),
                  "d": (scale * rng.standard_normal((2, 2))).astype(
                      np.float32)}}


def _torch_tree(t):
    if isinstance(t, dict):
        return {k: _torch_tree(v) for k, v in t.items()}
    return torch.tensor(np.asarray(t))


def test_adamw_update_matches_the_reference():
    """Five updates through warm-up and decay, the clip active (gradients
    ×5): grad_norm and lr within 1e-6 relative, params and moments within
    1e-5 relative or 1e-7 absolute (f32 rounding: XLA may contract a
    moment's multiply and add into one FMA; the port updates in place)."""
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    kw = dict(warmup_steps=2, total_steps=6, lr=1e-2)
    jcfg, tcfg = jadamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
    jp = jax.tree.map(jnp.asarray, p0)
    js = jadamw.adamw_init(jp)
    tp = _torch_tree(p0)
    ts = adamw.adamw_init(tp)
    for _ in range(5):
        g = _tree(rng, scale=5.0)
        jp, js, jm = jadamw.adamw_update(jax.tree.map(jnp.asarray, g), js,
                                         jp, jcfg)
        tp, ts, tm = adamw.adamw_update(_torch_tree(g), ts, tp, tcfg)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-6)
        assert int(ts.count) == int(js.count)
        for want, got in ((jp, tp), (js.m, ts.m), (js.v, ts.v)):
            for a, b in zip(jax.tree.leaves(want), tree_leaves(got)):
                np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                           rtol=1e-5, atol=1e-7)


def test_cosine_schedule_and_global_norm_match_the_reference():
    cfg = dict(warmup_steps=10, total_steps=50, min_lr_frac=0.2)
    for step in (0, 1, 9, 10, 11, 30, 50, 80):
        np.testing.assert_allclose(
            float(adamw.cosine_schedule(adamw.AdamWConfig(**cfg),
                                        torch.tensor(step))),
            float(jadamw.cosine_schedule(jadamw.AdamWConfig(**cfg),
                                         jnp.asarray(step))), rtol=1e-6)
    t = _tree(np.random.default_rng(1))
    np.testing.assert_allclose(
        float(adamw.global_norm(_torch_tree(t))),
        float(jadamw.global_norm(jax.tree.map(jnp.asarray, t))), rtol=1e-6)


def test_adamw_keeps_the_parameter_dtype():
    """bf16 parameters are updated in place in bf16, moments in f32."""
    p = {"w": torch.randn(4, 4).to(torch.bfloat16)}
    st = adamw.adamw_init(p)
    ptr = p["w"].data_ptr()
    p2, st2, _ = adamw.adamw_update({"w": torch.randn(4, 4).to(
        torch.bfloat16)}, st, p)
    assert p2["w"].dtype == torch.bfloat16 and p2["w"].data_ptr() == ptr
    assert st2.m["w"].dtype == torch.float32 and int(st2.count) == 1


# ------------------------------------------------------------ train step --
def _port(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_microbatched_gradients_equal_full_batch_gradients():
    """n_microbatches = 2 (f32 accumulation, averaged) against one batch:
    the same loss, grad norm and updated parameters within 1e-6 (the two
    sums differ in order only)."""
    cfg = reduced(get_arch("gemma-2b"))
    rng = np.random.default_rng(3)
    batch = _port(lm_batch(cfg, rng, B=4))
    out = {}
    for n in (1, 2):
        st = S.init_train_state(torch.Generator().manual_seed(0), cfg, 4)
        step = S.make_train_step(cfg, 4, n_microbatches=n, device="cpu")
        st, m = step(st, batch)
        out[n] = (st, m)
    (s1, m1), (s2, m2) = out[1], out[2]
    for k in ("loss", "nll", "grad_norm"):
        np.testing.assert_allclose(float(m2[k]), float(m1[k]), rtol=1e-6)
    for a, b in zip(tree_leaves(s1.params), tree_leaves(s2.params)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-6)


def test_microbatched_step_matches_the_references():
    """The port's n_microbatches = 2 against the reference's scan."""
    jcfg, cfg = jreduced(jget_arch("gemma-2b")), reduced(get_arch("gemma-2b"))
    rng = np.random.default_rng(4)
    batch = lm_batch(cfg, rng, B=4)
    js = JS.init_train_state(jax.random.PRNGKey(0), jcfg, 4)
    ts = convert.train_state_from_numpy(cfg, jax.device_get(js), "cpu")
    js, jm = jax.jit(JS.make_train_step(jcfg, 4, n_microbatches=2))(
        js, jax.tree.map(jnp.asarray, batch))
    ts, tm = S.make_train_step(cfg, 4, n_microbatches=2, device="cpu")(
        ts, _port(batch))
    for k in ("loss", "nll", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5)
    for a, b in zip(jax.tree.leaves(js.params), tree_leaves(ts.params)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=2e-6)


def _twelve_steps(cfg, state, opt_cfg=None):
    data = SyntheticLMData(cfg, DataConfig(batch=4, seq_len=64, seed=1))
    step = S.make_train_step(cfg, 4, opt_cfg=opt_cfg, device="cpu")
    losses, temps = [], []
    try:
        for _ in range(12):
            b = data.next()
            state, m = step(state, {"tokens": torch.from_numpy(b["tokens"]),
                                    "labels": torch.from_numpy(b["labels"]),
                                    "rho": torch.full((4,), 1.8)})
            losses.append(float(m["loss"]))
            temps.append(float(m["thermal_temp_max"]))
    finally:
        data.close()
    return state, losses, temps


def test_loss_falls_over_12_steps_as_in_the_reference():
    """tests/test_system.py::test_training_reduces_loss on the port, from
    the reference's initial state (carried over with `convert`): the same
    12 losses within 1e-5 and the reference's conditions."""
    jcfg = jreduced(jget_arch("gemma-2b"), n_layers=2)
    cfg = reduced(get_arch("gemma-2b"), n_layers=2)
    js = JS.init_train_state(jax.random.PRNGKey(0), jcfg, n_tiles=4)
    jstep = jax.jit(JS.make_train_step(jcfg, 4))
    data = JSyntheticLMData(jcfg, JDataConfig(batch=4, seq_len=64, seed=1))
    ref_state, want = js, []
    try:
        for _ in range(12):
            b = data.next()
            ref_state, m = jstep(ref_state, {
                "tokens": jnp.asarray(b["tokens"]),
                "labels": jnp.asarray(b["labels"]),
                "rho": jnp.full((4,), 1.8)})
            want.append(float(m["loss"]))
    finally:
        data.close()
    state, losses, temps = _twelve_steps(
        cfg, convert.train_state_from_numpy(cfg, jax.device_get(js), "cpu"))
    np.testing.assert_allclose(losses, want, rtol=1e-5)
    assert losses[-1] < losses[0]
    assert max(temps) < 85.0
    assert int(state.sched.events) == 0


def test_loss_falls_over_12_steps_from_the_ports_own_init():
    """From the port's own random draw the default 100-step warm-up keeps
    12 steps' losses within the batches' spread, so this run warms up in
    one step (lr 3e-4): the loss falls by more than 1 nat."""
    cfg = reduced(get_arch("gemma-2b"), n_layers=2)
    state = S.init_train_state(torch.Generator().manual_seed(0), cfg, 4)
    state, losses, temps = _twelve_steps(
        cfg, state, adamw.AdamWConfig(warmup_steps=1))
    assert losses[-1] < losses[0] - 1.0
    assert max(temps) < 85.0
    assert int(state.sched.events) == 0


def test_cpu_gradient_flows_through_the_plain_ssd():
    """On the CPU the ssd wrapper's plain version is differentiated by
    autograd (on a card `SsdFunction` launches the kernels)."""
    rng = np.random.default_rng(5)
    d = torch.tensor(rng.uniform(0.8, 0.99, (1, 16, 2, 4)).astype(
        np.float32), requires_grad=True)
    b, c = (torch.tensor(0.2 * rng.standard_normal((1, 16, 2, 4)).astype(
        np.float32), requires_grad=True) for _ in range(2))
    x = torch.tensor(rng.standard_normal((1, 16, 2, 8)).astype(np.float32),
                     requires_grad=True)
    y, _ = ops.ssd(d, b, x, c, chunk=8)
    y.square().sum().backward()
    assert all(t.grad is not None and bool(torch.isfinite(t.grad).all())
               for t in (d, b, x, c))


# ---------------------------------------------------------------- driver --
ARGV = ["--device", "cpu", "--arch", "gemma-2b", "--reduced", "--batch", "2",
        "--seq", "32", "--n-tiles", "4", "--log-every", "0"]


def test_train_driver_resumes_from_its_checkpoints(tmp_path):
    first = train.main(ARGV + ["--steps", "4", "--ckpt-every", "2",
                               "--ckpt-dir", str(tmp_path)])
    assert first["start"] == 0 and len(first["losses"]) == 4
    assert CheckpointManager(str(tmp_path)).steps() == [2, 3]
    second = train.main(ARGV + ["--steps", "6", "--ckpt-every", "2",
                                "--ckpt-dir", str(tmp_path)])
    assert second["start"] == 4 and len(second["losses"]) == 2
    assert np.isfinite(second["losses"]).all()
    assert int(second["state"].step) == 6
    assert CheckpointManager(str(tmp_path)).steps() == [3, 4, 5]


def test_train_driver_trains_ssd_families():
    """The driver refuses no family (the refusal table is gone): reduced
    RWKV6 and Zamba2 train 3 steps on the CPU with finite losses, through
    `SsdFunction` on the plain versions."""
    assert not hasattr(train, "_NOT_PORTED")
    for arch in ("rwkv6-1.6b", "zamba2-7b"):
        res = train.main(["--device", "cpu", "--arch", arch, "--reduced",
                          "--batch", "2", "--seq", "32", "--n-tiles", "4",
                          "--log-every", "0", "--steps", "3"])
        assert len(res["losses"]) == 3, arch
        assert np.isfinite(res["losses"]).all(), arch


def test_a_jax_checkpoint_resumes_in_the_port(tmp_path):
    """The reference trainer's checkpoint restores into the port's train
    state leaf for leaf and bit for bit, and the port's driver resumes
    from it; a port checkpoint restores into the reference's state."""
    jargv = ["--arch", "gemma-2b", "--reduced", "--batch", "2", "--seq",
             "32", "--n-tiles", "4", "--log-every", "0", "--steps", "2",
             "--ckpt-dir", str(tmp_path / "jax")]
    jstate = jtrain.main(jargv)
    cfg = reduced(get_arch("gemma-2b"))
    template = S.init_train_state(torch.Generator().manual_seed(9), cfg, 4)
    got, at = CheckpointManager(str(tmp_path / "jax")).restore_latest(
        template)
    assert at == 1
    want = convert.train_state_from_numpy(cfg, jax.device_get(jstate),
                                          "cpu")
    assert len(tree_leaves(got)) == len(tree_leaves(want))
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    res = train.main(ARGV + ["--steps", "3", "--ckpt-dir",
                             str(tmp_path / "jax")])
    assert res["start"] == 2 and np.isfinite(res["losses"]).all()

    # the other way: the port's state (after its step) into the reference
    CheckpointManager(str(tmp_path / "port")).save(7, res["state"],
                                                   blocking=True)
    back, _ = JaxCheckpointManager(str(tmp_path / "port")).restore_latest(
        jstate)
    mine = convert.train_state_to_numpy(res["state"])
    assert len(jax.tree.leaves(back)) == len(tree_leaves(mine))
    for a, b in zip(jax.tree.leaves(back), tree_leaves(mine)):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_train_state_round_trips_through_numpy():
    cfg = reduced(get_arch("mixtral-8x7b"))
    st = S.init_train_state(torch.Generator().manual_seed(1), cfg, 4)
    back = convert.train_state_from_numpy(cfg, convert.train_state_to_numpy(
        st), "cpu")
    for a, b in zip(tree_leaves(st), tree_leaves(back)):
        assert torch.equal(a, b)
