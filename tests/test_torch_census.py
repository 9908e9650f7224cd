"""PyTorch port: the collective census (`launch/hlo_census.py`), the
kernels' shape rules, and prefill / decode on a mesh.

  * The census of a reduced train step on a fake (2, 2) mesh counts by
    kind what ``CommDebugMode`` counts; rank 0's census of the same step
    on a real group of four gloo CPU ranks equals the fake one exactly, in
    counts and bytes.
  * Each shape rule (the kernels' ``torch.library`` fake kernels, and
    `fma_f32`'s) gives the shapes, dtypes and strides the plain version
    gives on real CPU tensors; ``torch.library.opcheck`` passes its schema
    and fake-tensor checks on every kernel op.
  * Prefill, then one decode step, of reduced models with every cache
    kind — GQA, MQA with the int8 cache, the SWA ring (the prompt past the
    window), MLA's latent cache, Mamba2 (with the hybrid's KV) and RWKV6 —
    on the four ranks as a (data 2, model 2) mesh: logits and caches
    within 1e-5 of the one-device port (an int8 entry within one quantum;
    each decode from the one-device prefill cache), logits within 1e-4 of
    the reference's (its decode from the same cache).

The process groups and the reference's computations run in subprocesses,
all started together.
"""
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode

import repro_torch
from repro_torch.distributed import multihost
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssm_scan as sm

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
TRAIN_KW = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
                d_ff=128, vocab_size=256)
TRAIN_SHAPE = (4, 32)                      # batch, seq
# cache kind: (arch, config changes, prompt length); every prompt fits a
# 96-slot cache, the SWA one runs past its 64-token window
CACHES = {
    "gqa": ("granite-3-2b", {}, 64),
    "mqa_int8": ("gemma-2b", {"kv_cache_dtype": "int8"}, 64),
    "swa_ring": ("mixtral-8x7b", {}, 80),
    "mla": ("deepseek-v2-236b", {}, 64),
    "mamba2": ("zamba2-7b", {"n_layers": 3}, 64),
    "rwkv6": ("rwkv6-1.6b", {}, 64),
}
B, MAX_SEQ = 2, 96

COMMON = r"""
import json, os
import numpy as np
import torch
torch.set_num_threads(1)
from repro_torch.configs import ShapeConfig, get_arch, reduced
from repro_torch.distributed import sharding as shd
from repro_torch.launch import hlo_census as HC
from repro_torch.launch import steps as S

cfg = reduced(get_arch("granite-3-2b"), **%(kw)r)
B, T = %(shape)r
SHAPE = ShapeConfig("census", T, B, "train")
"""

# the step on fake tensors over a fake group of four, under the census and
# CommDebugMode at once
FAKE = COMMON + r"""
from torch.distributed.tensor.debug import CommDebugMode
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_test_mesh
with D.fake_group(4):
    mesh = make_test_mesh(2, 2, device_type="cpu")
    cell = D.build_cell(cfg, SHAPE, mesh, n_tiles=4, device="cpu")
    with shd.axis_env(mesh), HC.Census() as census, CommDebugMode() as comm:
        cell.step(*cell.args)
res = census.result()
print("RESULT " + json.dumps({
    "counts": res["counts"], "by_kind": res["by_kind"],
    "comm": {str(k): v for k, v in comm.get_comm_counts().items()}}))
"""

# the same step on real tensors over four gloo ranks; then prefill and
# decode for every cache kind, on the mesh and on one device
REAL = r"""
from repro_torch.distributed import multihost
multihost.bootstrap_from_env()
""" + COMMON + r"""
import torch.distributed as dist
from repro_torch.launch import mesh as M
from repro_torch.models import transformer as tf
rank = dist.get_rank()
mesh = M.make_test_mesh(2, 2, device_type="cpu")
state = S.init_train_state(torch.Generator().manual_seed(0), cfg, 4)
g = np.random.default_rng(5)
ids = lambda: torch.from_numpy(g.integers(2, cfg.vocab_size, (B, T),
                                          dtype=np.int32))
batch = {"tokens": ids(), "labels": ids(), "rho": torch.full((4,), 1.9)}
state = shd.distribute(state, mesh, S.train_state_specs(cfg, state, mesh))
batch = shd.distribute(batch, mesh, S.batch_shardings(cfg, SHAPE, mesh))
step = S.make_train_step(cfg, 4, device="cpu")
with shd.axis_env(mesh), HC.Census() as census:
    step(state, batch)
res = {"census": {k: census.result()[k] for k in ("counts", "by_kind")}}


def copy(cache):
    return {k: v.clone() for k, v in cache.items()}


def gap(a, b, quantized=False):
    # the largest |a - b| of a leaf over max(1, max |b|) (a cache leaf is
    # a sum of terms of its largest magnitude), or, of the int8 leaves,
    # the largest difference in quanta
    a = shd.full(a)
    if isinstance(a, dict):
        return max([0.0] + [gap(a[k], b[k], quantized) for k in b
                            if (b[k].dtype == torch.int8) == quantized])
    d = float((a.double() - b.double()).abs().max())
    return d if quantized else d / max(1.0, float(b.double().abs().max()))


for name, (arch, kw, P) in %(caches)r.items():
    ccfg = reduced(get_arch(arch), **kw)
    params = tf.init_params(torch.Generator().manual_seed(1), ccfg)
    g = np.random.default_rng(2)
    toks = torch.from_numpy(g.integers(2, ccfg.vocab_size, (%(B)d, P)))
    nxt = torch.from_numpy(g.integers(2, ccfg.vocab_size, (%(B)d,)))
    last0, cache0, _ = tf.prefill(params, ccfg, toks, %(max)d)
    pre0 = copy(cache0)
    logit0, cache0 = tf.decode_step(params, ccfg, cache0, nxt, P)
    dp = shd.distribute(params, mesh, shd.param_specs(ccfg, params, mesh))
    dt = shd.distribute(toks, mesh, shd.batch_spec(mesh, 2, %(B)d))
    dn = shd.distribute(nxt, mesh, shd.batch_spec(mesh, 1, %(B)d))
    with shd.axis_env(mesh):
        last1, cache1, _ = tf.prefill(dp, ccfg, dt, %(max)d)
        specs = shd.cache_specs(ccfg, cache1, mesh)
        placed = all(tuple(cache1[k].placements) == tuple(
            shd.placements(mesh, specs[k])) for k in cache1)
        pre = {"prefill_logits": gap(last1, last0),
               "prefill_cache": gap(copy(cache1), pre0),
               "prefill_quanta": gap(copy(cache1), pre0, True)}
        # decode from the one-device prefill cache, placed as the mesh's
        # (an int8 entry of the mesh's own may be a quantum away)
        cache1 = shd.distribute(copy(pre0), mesh, specs)
        logit1, cache1 = tf.decode_step(dp, ccfg, cache1, dn, P)
        res[name] = dict(pre, placed=placed,
                         decode_logits=gap(logit1, logit0),
                         decode_cache=gap(copy(cache1), cache0),
                         decode_quanta=gap(copy(cache1), cache0, True),
                         int8=str(cache1[next(iter(cache1))].dtype),
                         logits=[shd.full(last1).tolist(),
                                 shd.full(logit1).tolist()])
if rank == 0:
    print("RESULT " + json.dumps(res))
"""


# the reference's prefill and decode logits for some cache kinds, its
# decode from the port's one-device prefill cache (the port's draws)
REF = r"""
import json
import numpy as np
import torch
torch.set_num_threads(1)
import jax
import jax.numpy as jnp
from repro.configs import get_arch as ref_arch
from repro.configs import reduced as ref_reduced
from repro.models import transformer as rtf
from repro_torch.configs import get_arch, reduced
from repro_torch.models import transformer as tf
res = {}
for name, (arch, kw, P) in %(caches)r.items():
    cfg = reduced(get_arch(arch), **kw)
    rcfg = ref_reduced(ref_arch(arch), **kw)
    params = tf.init_params(torch.Generator().manual_seed(1), cfg)
    rp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), params)
    g = np.random.default_rng(2)
    toks = g.integers(2, cfg.vocab_size, (%(B)d, P))
    nxt = g.integers(2, cfg.vocab_size, (%(B)d,))
    _, cache, _ = tf.prefill(params, cfg, torch.from_numpy(toks), %(max)d)
    cache = {k: jnp.asarray(v.numpy()) for k, v in cache.items()}
    toks, nxt = jnp.asarray(toks, jnp.int32), jnp.asarray(nxt, jnp.int32)
    res[name] = [np.asarray(rtf.prefill(rp, rcfg, toks, %(max)d)[0]).tolist(),
                 np.asarray(rtf.decode_step(rp, rcfg, cache, nxt, P)[0])
                 .tolist()]
print("RESULT " + json.dumps(res))
"""
# the reference's kinds in two processes, the Mamba2 hybrid's (the
# slowest) with RWKV6's
REF_GROUPS = (("mamba2", "rwkv6"), ("gqa", "mqa_int8", "swa_ring", "mla"))


def _start(code: str) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    return subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _fake_census() -> subprocess.Popen:
    return _start(FAKE % dict(kw=TRAIN_KW, shape=TRAIN_SHAPE))


def _communicate(proc: subprocess.Popen) -> dict:
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-4000:]
    return _result(out)


def _result(text: str) -> dict:
    lines = [ln for ln in text.splitlines() if ln.startswith("RESULT ")]
    assert lines, text[-4000:]
    return json.loads(lines[-1][len("RESULT "):])


@pytest.fixture(scope="module")
def runs():
    """The fake census, the gloo group and the reference run together,
    each in processes of its own.  The reference decodes from the port's
    one-device prefill cache (made from the same draws the ranks make): an
    int8 cache computed by other roundings may hold other quanta."""
    fake = _fake_census()
    refs = [_start(REF % dict(caches={k: CACHES[k] for k in group}, B=B,
                              max=MAX_SEQ)) for group in REF_GROUPS]
    box = {}

    def group():
        box["outs"] = multihost.run_process_group(
            REAL % dict(kw=TRAIN_KW, shape=TRAIN_SHAPE, B=B, max=MAX_SEQ,
                        caches=CACHES), 4, timeout=600,
            env={"OMP_NUM_THREADS": "1"})

    th = threading.Thread(target=group)
    th.start()
    fake, *refs = [_communicate(p) for p in [fake, *refs]]
    th.join()
    assert "outs" in box, "the gloo group failed"
    return {"fake": fake, "real": _result(box["outs"][0]),
            "ref": {k: [np.asarray(x, np.float32) for x in v]
                    for r in refs for k, v in r.items()}}


# ----------------------------------------------------------------- census --
_KINDS = (("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
          ("all_gather", "all-gather"), ("allgather", "all-gather"),
          ("reduce_scatter", "reduce-scatter"),
          ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"))


def test_census_counts_what_comm_debug_mode_counts(runs):
    fake = runs["fake"]
    want = {}
    for op, n in fake["comm"].items():
        kind = next(k for tag, k in _KINDS if tag in op.split(".")[-1])
        want[kind] = want.get(kind, 0) + n
    assert fake["counts"] == want
    assert fake["counts"].get("all-reduce", 0) > 0


def test_census_on_a_real_group_equals_the_fake_one(runs):
    real, fake = runs["real"]["census"], runs["fake"]
    assert real["counts"] == fake["counts"]
    assert real["by_kind"] == fake["by_kind"]


def test_nested_collective_counts_once():
    """A collective dispatched inside another (a c10d op inside a
    functional one, as a card's gloo mesh routes the all-gather) counts
    as the outer one only."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.launch import hlo_census as HC

    c = HC.Census()
    ops = torch.ops
    fn = ops._c10d_functional.all_reduce.default
    assert HC.collective_kind(fn) == "all-reduce"
    assert HC.collective_kind(ops.c10d.allreduce_.default) == "all-reduce"
    assert HC.collective_kind(ops.aten.mm.default) is None
    assert issubclass(HC.Census, TorchDispatchMode)
    with c:
        torch.ones(3) + 1
    assert c.result()["counts"] == {} and c.result()["op_kinds"]


# ---------------------------------------------------------- shape rules --
def _meta(x):
    xs = x if isinstance(x, (tuple, list)) else (x,)
    return [None if t is None else (tuple(t.shape), t.dtype, t.stride())
            for t in xs]


def _rule_vs_plain(fn, *args, **kwargs):
    """``fn`` on real CPU tensors (the plain version) and on fake copies
    (the shape rule): the outputs' shapes, dtypes and strides."""
    real = fn(*args, **kwargs)
    with FakeTensorMode() as mode:
        fake = fn(*(mode.from_tensor(a) if torch.is_tensor(a) else a
                    for a in args), **{k: mode.from_tensor(v)
                                       if torch.is_tensor(v) else v
                                       for k, v in kwargs.items()})
    return _meta(real), _meta(fake)


def _flash_args(dtype, d=32, dv=32):
    g = torch.Generator().manual_seed(3)
    r = lambda *s: torch.randn(s, generator=g).to(dtype)
    return r(2, 40, 4, d), r(2, 40, 2, d), r(2, 40, 2, dv), r(2, 40, 4, dv)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_shape_rules_match_the_plain_version(dtype):
    q, k, v, do = _flash_args(dtype, 48, 32)
    got, want = _rule_vs_plain(fa.flash_attention, q, k, v, window=16)
    assert got == want
    got, want = _rule_vs_plain(fa.flash_attention_stats, q, k, v)
    assert got == want
    out, o, m, l = fa.flash_attention_stats(q, k, v)
    got, want = _rule_vs_plain(fa.flash_attention_backward, q, k, v, o, m,
                               l, do)
    assert got == want
    for op, args in (
            (torch.ops.repro_torch.flash_attention,
             (q, k, v, True, 0, 0, 0.125)),
            (torch.ops.repro_torch.flash_attention_stats,
             (q, k, v, True, 16, 3, 0.125)),
            (torch.ops.repro_torch.flash_attention_backward,
             (q, k, v, o, m, l, do, True, 0, 0, 0.125))):
        torch.library.opcheck(op, args,
                              test_utils=("test_schema", "test_faketensor"))


@pytest.mark.parametrize("u,h0", [(False, False), (True, True)])
def test_ssd_shape_rules_match_the_plain_version(u, h0):
    g = torch.Generator().manual_seed(4)
    B, T, H, N, P = 2, 64, 3, 8, 16
    d = 0.6 + 0.4 * torch.rand(B, T, H, N, generator=g)
    b, c = (torch.randn(B, T, H, N, generator=g) for _ in range(2))
    x = torch.randn(B, T, H, P, generator=g).to(torch.bfloat16)
    uu = torch.randn(H, N, generator=g) if u else None
    hh = torch.randn(B, H, N, P, generator=g) if h0 else None
    kw = dict(u=uu, h0=hh, chunk=32, include_current=not u)
    got, want = _rule_vs_plain(sm.ssd, d, b, x, c, **kw)
    assert got == want
    got, want = _rule_vs_plain(sm.ssd_states, d, b, x, c, **kw)
    assert got == want
    y, hT, hs = sm.ssd_states(d, b, x, c, **kw)
    dy = torch.randn(B, T, H, P, generator=g).to(torch.bfloat16)
    got, want = _rule_vs_plain(sm.ssd_backward, d, b, x, c, uu, hh, hs, dy,
                               hT, chunk=32, include_current=not u)
    assert got == want
    inc = not u
    for op, args in ((torch.ops.repro_torch.ssd,
                      (d, b, x, c, uu, hh, 32, inc)),
                     (torch.ops.repro_torch.ssd_states,
                      (d, b, x, c, uu, hh, 32, inc)),
                     (torch.ops.repro_torch.ssd_backward,
                      (d, b, x, c, uu, hh, hs, dy, hT, 32, inc))):
        torch.library.opcheck(op, args,
                              test_utils=("test_schema", "test_faketensor"))


def test_fma_shape_rule_matches_the_plain_version():
    g = torch.Generator().manual_seed(5)
    a, b = torch.rand(7, 1, generator=g), torch.rand(1, 5, generator=g)
    c = torch.rand(5, generator=g)
    for args in ((a, b, c), (0.5, b, 2.0), (a, b, 1.0)):
        got, want = _rule_vs_plain(repro_torch.fma_f32, *args)
        assert got == want


def _kernel_entries():
    """Each kernel entry once on real CPU tensors: the outputs."""
    q, k, v, do = _flash_args(torch.float32)
    _, o, m, l = fa.flash_attention_stats(q, k, v)
    g = torch.Generator().manual_seed(6)
    d = 0.6 + 0.4 * torch.rand(1, 32, 2, 4, generator=g)
    b, c, x = (torch.randn(1, 32, 2, 4, generator=g) for _ in range(3))
    y, hT, hs = sm.ssd_states(d, b, x, c, chunk=16)
    return [fa.flash_attention(q, k, v), *fa.flash_attention_stats(q, k, v),
            *fa.flash_attention_backward(q, k, v, o, m, l, do),
            *sm.ssd(d, b, x, c, chunk=16),
            *sm.ssd_states(d, b, x, c, chunk=16),
            *[t for t in sm.ssd_backward(d, b, x, c, None, None, hs, x, hT,
                                         chunk=16) if t is not None]]


def test_real_tensors_skip_the_dispatcher(monkeypatch):
    """With no dispatch mode active a real tensor calls each kernel's
    implementation itself, never its op; under a mode (here the census)
    every entry goes through its op, with the same outputs."""
    from repro_torch.launch import hlo_census as HC

    with HC.Census() as census:
        via_op = _kernel_entries()
    assert set(census.result()["kernels"]) == {
        f"repro_torch.{n}" for n in (
            "flash_attention", "flash_attention_stats",
            "flash_attention_backward", "ssd", "ssd_states",
            "ssd_backward")}

    def refuse(*args):
        raise AssertionError("a real tensor reached the dispatcher")
    for mod, name in ((fa, "_flash_op"), (fa, "_flash_stats_op"),
                      (fa, "_flash_bwd_op"), (sm, "_ssd_op"),
                      (sm, "_ssd_states_op"), (sm, "_ssd_bwd_op")):
        monkeypatch.setattr(mod, name, refuse)
    direct = _kernel_entries()
    assert len(direct) == len(via_op)
    assert all(torch.equal(a, b) for a, b in zip(direct, via_op))


def test_flop_formulas_count_the_kernels():
    """``FlopCounterMode`` counts each kernel op by its cost function."""
    from torch.utils.flop_counter import FlopCounterMode

    q, k, v, do = _flash_args(torch.float32)
    with FlopCounterMode(display=False) as fc:
        fa.flash_attention(q, k, v)
    assert fc.get_total_flops() == fa.flash_attention_cost(q, k, v)["ops"]
    for causal, window, off in ((True, 0, 0), (False, 7, 3), (True, 5, 11)):
        qpos = off + torch.arange(40)
        want = int(fa.keep_mask(qpos, torch.arange(40), causal,
                                window).sum())
        assert fa.kept_pairs(40, 40, causal=causal, window=window,
                             q_offset=off) == want


# ------------------------------------------------- prefill / decode mesh --
@pytest.mark.parametrize("kind", sorted(CACHES))
def test_prefill_and_decode_on_a_mesh_match_one_device(runs, kind):
    """Logits and float cache leaves within 1e-5 of max(1, the leaf's
    largest magnitude); an int8 leaf within one quantum (its value is
    rounded from keys the mesh computes in another summation order, so an
    entry at a rounding boundary may land one quantum away)."""
    r = runs["real"][kind]
    assert r["placed"], "the prefill cache is not placed by cache_specs"
    for key in ("prefill_logits", "prefill_cache", "decode_logits",
                "decode_cache"):
        assert r[key] <= 1e-5, (kind, key, r[key])
    assert r["prefill_quanta"] <= 1 and r["decode_quanta"] <= 1
    if kind == "mqa_int8":
        assert r["int8"] == "torch.int8"


@pytest.mark.parametrize("kind", sorted(CACHES))
def test_mesh_logits_match_the_reference(runs, kind):
    got = runs["real"][kind]["logits"]
    for a, b in zip(got, runs["ref"][kind]):
        np.testing.assert_allclose(np.asarray(a, np.float32), b, atol=1e-4,
                                   rtol=0)
