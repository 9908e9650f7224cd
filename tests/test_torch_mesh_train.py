"""PyTorch port: training on a (pod, data, model) mesh of gloo CPU ranks.

One process group of eight ranks (`multihost.run_process_group`, one
thread a rank) runs every case in turn; the tests below read what the
ranks wrote.  The ranks import only `repro_torch`.

  * (a) granite-3-2b reduced (f32) on a 2×4 (data, model) mesh, three
    steps of `make_train_step` on a train state restored from a checkpoint
    straight onto the mesh (`restore(..., shardings=)` by
    `train_state_specs`): the loss falls, as in the reference's
    `test_small_mesh_train_step_compiles_and_runs`; the step-1 gradients
    within 1e-4 of each leaf's largest magnitude of the port's one-device
    gradients (its f32 training gate); the three losses within 1e-5
    relative of the port's one-device step and 1e-4 of the reference's
    `make_train_step`, both from the same numpy state and batch; no
    collective gathers a logits slice (the LM head runs vocab-parallel).
  * (b) mixtral-8x7b reduced on 2×2×2 (pod, data, model), EP (4 experts
    over 2) and FSDP (``tp_attention=False``): one step held as in (a),
    and `CommDebugMode` counts all-reduces.
  * (c) rwkv6-1.6b reduced on a 2×2 mesh of ranks 0–3, its heads over
    "model" through the ssd wrapper's local route: one step held as (a);
    and granite again, one step of two microbatches (each slice pinned to
    the DP axes), held as (a).
  * (d) `compressed_allreduce` on a 4×2 mesh over "data": the reference
    test's draw meets its bounds (error ≤ scale, residual ≤ scale / 2);
    differing per-rank gradients come back within one quantum of the
    exact mean and equal on every rank of an axis group; against the
    reference's function, run in a subprocess with eight host devices as
    its own test does, the quantised values are equal except where
    gl / scale sits within an ulp of a half.
  * (e) a checkpoint saved under 4×2 restores under 2×2 on ranks 0–3
    (`shardings=`), equal, on the new mesh; a blocking save, and `wait`
    after an async one, return on every rank with the step on disk, and
    only the mesh's first rank ever holds a leaf whole.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.launch import steps as JS

from repro_torch import convert
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_arch, reduced
from repro_torch.distributed import multihost
from repro_torch.launch import steps as S

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
N_TILES = 4
SMALL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
             d_ff=128, vocab_size=256)
CASES = {
    # a vocabulary of 320: its shard, 80 a rank, matches no other dim
    "granite": dict(arch="granite-3-2b", kw=dict(SMALL, vocab_size=320),
                    mesh=(2, 4, 0), tp=True, steps=3, B=4, S=32),
    "mixtral": dict(arch="mixtral-8x7b",
                    kw=dict(SMALL, n_experts=4, top_k=2, moe_d_ff=64,
                            window=32),
                    mesh=(2, 2, 2), tp=False, steps=1, B=8, S=32),
    "rwkv6": dict(arch="rwkv6-1.6b", kw=dict(n_layers=2, vocab_size=256),
                  mesh=(2, 2, 0), tp=True, steps=1, B=4, S=32),
    # gradient accumulation: two microbatches, each pinned to "data"
    "granite_mb": dict(arch="granite-3-2b", kw=SMALL, mesh=(2, 4, 0),
                       tp=True, steps=1, B=8, S=32, mb=2),
}

WORKER = r"""
import json, os, contextlib, collections
import numpy as np
import torch
torch.set_num_threads(1)
from repro_torch.distributed import multihost
multihost.bootstrap_from_env()
import torch.distributed as dist
from torch.distributed.tensor.debug import CommDebugMode
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ShapeConfig, get_arch, reduced
from repro_torch.distributed import sharding as shd
from repro_torch.launch import mesh as M, steps as S
from repro_torch.optim import compression as C

rank = dist.get_rank()
OUT = os.environ["MESH_OUT"]
CASES = json.loads(os.environ["MESH_CASES"])
N_TILES = int(os.environ["MESH_TILES"])


# the local input shape of every all-gather, where DTensor calls it
import functools
import torch.distributed._functional_collectives as funcol
GATHERS, RECORD = [], [False]


def recorded(fn):
    @functools.wraps(fn)
    def wrapped(t, *a, **k):
        if RECORD[0]:
            GATHERS.append(list(t.shape))
        return fn(t, *a, **k)
    return wrapped


for attr in dir(funcol):
    if attr.startswith("all_gather") and callable(getattr(funcol, attr)):
        setattr(funcol, attr, recorded(getattr(funcol, attr)))


def train_case(name, c):
    data, model, pod = c["mesh"]
    mesh = M.make_test_mesh(data=data, model=model, pod=pod,
                            device_type="cpu")
    if mesh.get_coordinate() is None:            # outside a sub-mesh
        return None
    cfg = reduced(get_arch(c["arch"]), **c["kw"])
    template = S.init_train_state(torch.Generator().manual_seed(1), cfg,
                                  N_TILES)
    specs = S.train_state_specs(cfg, template, mesh, tp_attention=c["tp"])
    state, step0 = CheckpointManager(os.path.join(OUT, name)).restore_latest(
        template, shardings=shd.to_shardings(mesh, specs))
    assert step0 == 0
    batch = {k: torch.from_numpy(v) for k, v in
             np.load(os.path.join(OUT, name + "_batch.npz")).items()}
    shape = ShapeConfig(name, c["S"], c["B"], "train")
    batch = shd.distribute(batch, mesh, S.batch_shardings(cfg, shape, mesh))
    out = {}
    with shd.axis_env(mesh, tp_activations=c["tp"]):
        _, _, grads = S.loss_and_grads(state.params, cfg, batch["tokens"],
                                       batch["labels"])
        out["grads"] = [g.full_tensor() for g in grads]
        out["placed"] = sum(any(p.is_shard() for p in g.placements)
                            for g in grads)
        train_step = S.make_train_step(cfg, N_TILES, device="cpu",
                                       n_microbatches=c.get("mb", 1))
        comm = CommDebugMode()
        GATHERS.clear()
        losses = []
        for i in range(c["steps"]):
            RECORD[0] = i == 0
            with (comm if i == 0 else contextlib.nullcontext()):
                state, m = train_step(state, batch)
            RECORD[0] = False
            losses.append(float(shd.full(m["loss"])))
    out["losses"] = losses
    out["comm"] = {str(k): v for k, v in comm.get_comm_counts().items()}
    out["gathers"] = list(GATHERS)
    out["step"] = int(shd.full(state.step))
    return out


res = {}
for name, c in CASES.items():
    r = train_case(name, c)
    if r is not None:
        res[name] = r

# (d) the error-feedback all-reduce over "data" of a 4x2 mesh
mesh = M.make_test_mesh(data=4, model=2, device_type="cpu")
d = np.load(os.path.join(OUT, "compress.npz"))
g = torch.from_numpy(d["g"])
mean, st = C.compressed_allreduce(g, C.compress_grads_init(g), mesh, "data")
gr = torch.from_numpy(d["g_ranks"][rank])
mean2, st2 = C.compressed_allreduce({"w": gr}, C.compress_grads_init(
    {"w": gr}), mesh, "data")
res["compress"] = {"mean": mean, "error": st.error, "mean2": mean2["w"],
                   "error2": st2.error["w"],
                   "group": mesh.get_coordinate()[1],
                   "bytes": C.allreduce_bytes(g)}

# (e) save under 4x2, restore under 2x2 on ranks 0-3
w = torch.arange(64.0).reshape(8, 8)
wa = shd.distribute(w, mesh, shd.P("data", "model"))
cm = CheckpointManager(os.path.join(OUT, "elastic"))
cm.save(1, {"w": wa}, blocking=True)
seen = [cm.steps()]            # at once, on every rank: no barrier here
cm.save(2, {"w": wa * 2})
cm.wait()
seen.append(cm.steps())
from repro_torch.checkpoint.manager import _gather_to_first
whole = _gather_to_first(wa)
res["saved"] = {"seen": seen, "whole": whole}
mesh_b = M.make_test_mesh(data=2, model=2, device_type="cpu")
if mesh_b.get_coordinate() is not None:
    got, step = cm.restore_latest(
        {"w": w}, shardings={"w": shd.NamedSharding(mesh_b,
                                                    shd.P("data", "model"))})
    res["elastic"] = {"step": step, "full": got["w"].full_tensor(),
                      "local": list(got["w"].to_local().shape),
                      "mesh": list(got["w"].device_mesh.shape),
                      "placements": [str(p) for p in got["w"].placements]}
torch.save(res, os.path.join(OUT, f"rank{rank}.pt"))
dist.barrier()
print("RANK DONE", rank)
"""

REF_COMPRESS = """
import numpy as np, jax, jax.numpy as jnp
from repro.launch.mesh import make_test_mesh
from repro.optim import compress_grads_init, compressed_allreduce
mesh = make_test_mesh(data=4, model=2)
g = jnp.asarray(np.load({path!r})["g"])
with mesh:
    mean, st = compressed_allreduce(g, compress_grads_init(g), mesh,
                                    axis="data")
np.savez({out!r}, mean=np.asarray(mean),
         error=np.asarray(jax.tree.leaves(st.error)[0]))
"""


def _batch(cfg, c, rng):
    toks = rng.integers(2, cfg.vocab_size, (c["B"], c["S"] + 1)).astype(
        np.int32)
    return {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy(),
            "rho": np.full((N_TILES,), 1.9, np.float32)}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Write each case's state and batch, run the group, and compute the
    one-device port's and the reference's numbers beside it."""
    out = str(tmp_path_factory.mktemp("mesh"))
    rng = np.random.default_rng(0)
    one, ref = {}, {}
    for name, c in CASES.items():
        jcfg = jreduced(jget_arch(c["arch"]), **c["kw"])
        cfg = reduced(get_arch(c["arch"]), **c["kw"])
        js = JS.init_train_state(jax.random.PRNGKey(0), jcfg, N_TILES)
        ts = convert.train_state_from_numpy(cfg, jax.device_get(js), "cpu")
        CheckpointManager(os.path.join(out, name)).save(0, ts, blocking=True)
        batch = _batch(cfg, c, rng)
        np.savez(os.path.join(out, name + "_batch.npz"), **batch)
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        _, _, grads = S.loss_and_grads(ts.params, cfg, tb["tokens"],
                                       tb["labels"])
        mb = c.get("mb", 1)
        step = S.make_train_step(cfg, N_TILES, device="cpu",
                                 n_microbatches=mb)
        jstep = jax.jit(JS.make_train_step(jcfg, N_TILES, n_microbatches=mb))
        losses, jlosses = [], []
        for _ in range(c["steps"]):
            ts, m = step(ts, tb)
            js, jm = jstep(js, jax.tree.map(jnp.asarray, batch))
            losses.append(float(m["loss"]))
            jlosses.append(float(jm["loss"]))
        one[name] = {"grads": grads, "losses": losses}
        ref[name] = jlosses
    g = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (64, 32)))
    g_ranks = np.random.default_rng(7).standard_normal((8, 16, 24)).astype(
        np.float32) * np.arange(1, 9, dtype=np.float32)[:, None, None]
    np.savez(os.path.join(out, "compress.npz"), g=g, g_ranks=g_ranks)
    env = {"MESH_OUT": out, "MESH_CASES": json.dumps(CASES),
           "MESH_TILES": str(N_TILES), "OMP_NUM_THREADS": "1"}
    multihost.run_process_group(WORKER, 8, timeout=600, env=env)
    ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
             for r in range(8)]
    sub = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(REF_COMPRESS.format(
            path=os.path.join(out, "compress.npz"),
            out=os.path.join(out, "ref_compress.npz")))],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
                 XLA_FLAGS="--xla_force_host_platform_device_count=8"))
    assert sub.returncode == 0, sub.stderr[-3000:]
    ref_c = dict(np.load(os.path.join(out, "ref_compress.npz")))
    return {"one": one, "ref": ref, "ranks": ranks, "g": g,
            "g_ranks": g_ranks, "ref_compress": ref_c}


def _grads_close(got, want, bound=1e-4):
    assert len(got) == len(want)
    worst = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        r = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        assert r <= bound, f"gradient leaf {i} {list(b.shape)}: {r:.3e}"
        worst = max(worst, r)
    return worst


@pytest.mark.parametrize("name", sorted(CASES))
def test_mesh_step_matches_one_device_and_reference(run, name):
    """Each case's step-1 gradients and its losses against the port's
    one-device step and the reference's, on every rank of its mesh."""
    c = CASES[name]
    ranks = [r[name] for r in run["ranks"] if name in r]
    n = int(np.prod([x for x in c["mesh"] if x]))
    assert len(ranks) == n
    for r in ranks:
        assert r["step"] == c["steps"]
        assert r["losses"] == ranks[0]["losses"]
        _grads_close(r["grads"], run["one"][name]["grads"])
        np.testing.assert_allclose(r["losses"], run["one"][name]["losses"],
                                   rtol=1e-5, atol=0)
        np.testing.assert_allclose(r["losses"], run["ref"][name],
                                   rtol=1e-4, atol=0)
    assert ranks[0]["placed"] > 0          # some gradients stay sharded


def test_granite_loss_falls_on_the_mesh(run):
    losses = run["ranks"][0]["granite"]["losses"]
    assert len(losses) == 3 and losses[-1] < losses[0], losses


def test_lm_head_never_gathers_a_logits_slice(run):
    """The vocabulary stays split over "model" through the loss: no
    all-gather in the granite step moves a [B/dp, S, V/model] slice."""
    c = CASES["granite"]
    data, model, _ = c["mesh"]
    slice_ = c["B"] // data * c["S"] * c["kw"]["vocab_size"] // model
    for r in run["ranks"]:
        shapes = r["granite"]["gathers"]
        assert shapes, "the step made no all-gather at all"
        for s in shapes:
            assert not (int(np.prod(s)) >= slice_
                        and c["kw"]["vocab_size"] // model in s), s


def test_ep_fsdp_mesh_all_reduces(run):
    for r in run["ranks"]:
        counts = r["mixtral"]["comm"]
        assert sum(v for k, v in counts.items() if "all_reduce" in k
                   or "allreduce" in k) >= 1, counts


def test_compressed_allreduce_meets_the_reference_bounds(run):
    """Every rank contributes the reference test's draw: the mean is the
    dequantised g within one quantum, the residual within half of one."""
    g = torch.from_numpy(run["g"].copy())
    scale = float(g.abs().max() / 127.0)
    for r in run["ranks"]:
        c = r["compress"]
        assert float((c["mean"] - g).abs().max()) <= scale
        assert float(c["error"].abs().max()) <= scale / 2 + 1e-9
        assert c["bytes"] == 4 + 4 * g.numel()       # int32: f32's bytes


def test_compressed_allreduce_of_differing_gradients(run):
    """Differing per-rank gradients: within one quantum of the exact mean
    of each "data" group, the same on every rank of the group."""
    ranks = run["ranks"]
    for grp in (0, 1):
        members = [i for i, r in enumerate(ranks)
                   if r["compress"]["group"] == grp]
        assert len(members) == 4
        gs = torch.from_numpy(run["g_ranks"][members])
        exact = gs.mean(0)
        scale = float(gs.abs().amax(dim=(1, 2)).max() / 127.0)
        first = ranks[members[0]]["compress"]["mean2"]
        for i in members:
            got = ranks[i]["compress"]["mean2"]
            assert torch.equal(got, first)
            assert float((got - exact).abs().max()) <= scale
            err = ranks[i]["compress"]["error2"]
            assert float(err.abs().max()) <= scale / 2 + 1e-9


def test_compressed_allreduce_matches_the_reference(run):
    """The quantised values equal the reference's (its function in a
    process of eight host devices), except where gl / scale sits within
    an ulp of a half (the two round-to-even calls then see it on either
    side)."""
    g = run["g"]
    c = run["ranks"][0]["compress"]
    err, ref_err = c["error"].numpy(), run["ref_compress"]["error"]
    scale = np.float32(np.maximum(np.abs(g).max(), np.float32(1e-12))
                       / np.float32(127.0))
    differ = np.abs(err - ref_err) > scale / 4
    x = (g / scale).astype(np.float32)
    frac = np.abs(x - np.trunc(x))
    assert np.all(np.abs(frac[differ] - 0.5)
                  <= 2 * np.spacing(np.abs(x[differ])))
    same = ~differ
    np.testing.assert_allclose(c["mean"].numpy()[same],
                               run["ref_compress"]["mean"][same], rtol=1e-6,
                               atol=1e-7)


def test_checkpoint_saved_on_4x2_restores_on_2x2(run):
    w = torch.arange(64.0).reshape(8, 8)
    for i, r in enumerate(run["ranks"]):
        assert r["saved"]["seen"] == [[1], [1, 2]], (i, r["saved"])
        whole = r["saved"]["whole"]
        assert (torch.equal(whole, w) if i == 0 else whole is None), i
        if i >= 4:
            assert "elastic" not in r
            continue
        e = r["elastic"]
        assert e["step"] == 2 and torch.equal(e["full"], 2 * w)
        assert e["mesh"] == [2, 2] and e["local"] == [4, 4]
        assert e["placements"] == ["S(0)", "S(1)"]
