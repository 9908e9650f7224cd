"""PyTorch port: the gradient of the chunked SSD (`repro_torch.kernels.
ssm_scan`) and the fleet engine's per-package loop.

`ssd_backward_reference` (the chunk formulas the backward kernel
``csrc/ssd_bwd.cu`` is held to on the card) against ``jax.vjp`` of the
reference's `repro.kernels.ref.chunked_ssd` and against autograd of the
port's plain `ssd_reference`, from the same numpy inputs: each gradient
leaf within 1e-4 of its largest magnitude (f32; the same sums in other
orders, and dd's pairwise-cancelling reverse sum).  The cases: the Mamba2
and RWKV6 decay regimes, the bonus ``u`` with ``include_current=False``,
an ``h0`` and a ``dhT``, a T that halves the chunk, P = 128, and mixed
f32 / bf16 inputs.  Then `SsdFunction` on the CPU (autograd's gradient,
None where an input is None or needs none) and `fleet.engine.
sequential_step` against the reference's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.core.scheduler import SchedulerConfig as JSchedulerConfig
from repro.core.scheduler import ThermalScheduler as JThermalScheduler
from repro.fleet.engine import sequential_step as jsequential_step
from repro.kernels import ref as jref

from torch_parity import TOL, np_, trace

from repro_torch.core.scheduler import SchedulerConfig, ThermalScheduler
from repro_torch.fleet.engine import sequential_step
from repro_torch.kernels import ssm_scan as sm

LEAF_TOL = 1e-4
NAMES = ("dd", "db", "dx", "dc", "du", "dh0")

# (B, T, H, N, P, decay low, decay high, include_current, u, h0, dhT, chunk)
CASES = {
    "mamba2 regime": (2, 128, 2, 64, 64, 0.55, 0.99, True, False, False,
                      False, 64),
    "rwkv6 regime, u": (1, 256, 2, 32, 64, 0.8, 0.999, False, True, False,
                        False, 64),
    "h0 and dhT": (2, 128, 2, 16, 32, 0.7, 0.99, False, True, True, True,
                   64),
    "T halves the chunk": (1, 96, 2, 16, 64, 0.8, 0.999, True, False, True,
                           True, 64),
    "P = 128": (1, 64, 2, 64, 128, 0.55, 0.99, True, False, True, True, 32),
}


def _inputs(B, T, H, N, P, lo, hi, use_u, use_h0, use_dhT, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    d = rng.uniform(lo, hi, (B, T, H, N)).astype(np.float32)
    return dict(d=d, b=0.2 * f(B, T, H, N), x=f(B, T, H, P),
                c=0.2 * f(B, T, H, N), u=0.1 * f(H, N) if use_u else None,
                h0=f(B, H, N, P) if use_h0 else None, dy=f(B, T, H, P),
                dhT=f(B, H, N, P) if use_dhT else None)


def _t(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(a).to(dtype)


def _plain(arrs, chunk, inc, dtypes=None):
    """ssd_backward_reference on torch copies of ``arrs`` (d, b, x, c in
    ``dtypes``, dy in x's)."""
    dt = dtypes or dict.fromkeys("dbxc", torch.float32)
    d, b, x, c = (_t(arrs[k], dt[k]) for k in "dbxc")
    u, h0, dhT = _t(arrs["u"]), _t(arrs["h0"]), _t(arrs["dhT"])
    dy = _t(arrs["dy"], dt["x"])
    ck = sm.chunk_for(d.shape[1], chunk)
    _, _, hs = sm.ssd_reference(d, b, x, c, u=u, h0=h0, chunk=ck,
                                include_current=inc, states=True)
    return sm.ssd_backward(d, b, x, c, u, h0, hs, dy, dhT, chunk=ck,
                           include_current=inc)


def _jax_grads(arrs, chunk, inc):
    """jax.vjp of ref.chunked_ssd, with (dy, dhT) as the cotangents."""
    keys = [k for k in ("d", "b", "x", "c", "u", "h0")
            if arrs[k] is not None]
    ck = sm.chunk_for(arrs["d"].shape[1], chunk)

    def f(*leaves):
        kw = dict(zip(keys, leaves))
        return jref.chunked_ssd(kw["d"], kw["b"], kw["x"], kw["c"],
                                u=kw.get("u"), h0=kw.get("h0"), chunk=ck,
                                include_current=inc)
    (y, hT), vjp = jax.vjp(f, *(jnp.asarray(arrs[k]) for k in keys))
    dhT = (jnp.zeros_like(hT) if arrs["dhT"] is None
           else jnp.asarray(arrs["dhT"]))
    grads = dict(zip(keys, vjp((jnp.asarray(arrs["dy"]), dhT))))
    return [grads.get(k) for k in ("d", "b", "x", "c", "u", "h0")]


def _autograd(arrs, chunk, inc):
    """torch.autograd of the plain forward `ssd_reference`."""
    leaves = {k: (None if arrs[k] is None
                  else torch.from_numpy(arrs[k]).requires_grad_())
              for k in ("d", "b", "x", "c", "u", "h0")}
    ck = sm.chunk_for(arrs["d"].shape[1], chunk)
    y, hT = sm.ssd_reference(leaves["d"], leaves["b"], leaves["x"],
                             leaves["c"], u=leaves["u"], h0=leaves["h0"],
                             chunk=ck, include_current=inc)
    outs, cots = [y], [_t(arrs["dy"])]
    if arrs["dhT"] is not None:
        outs.append(hT)
        cots.append(_t(arrs["dhT"]))
    live = [v for v in leaves.values() if v is not None]
    got = iter(torch.autograd.grad(outs, live, cots))
    return [None if v is None else next(got) for v in leaves.values()]


def _assert_leaves(got, want, where):
    for name, a, w in zip(NAMES, got, want):
        if w is None:
            assert a is None, (where, name)
            continue
        w = np_(w).astype(np.float32)
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(np_(a.float()), w, rtol=0,
                                   atol=LEAF_TOL * scale,
                                   err_msg=f"{where}: {name}")


@pytest.mark.parametrize("case", list(CASES))
def test_plain_backward_matches_jax_and_autograd(case):
    B, T, H, N, P, lo, hi, inc, use_u, use_h0, use_dhT, chunk = CASES[case]
    arrs = _inputs(B, T, H, N, P, lo, hi, use_u, use_h0, use_dhT)
    got = _plain(arrs, chunk, inc)
    if not use_u:
        assert got[4] is None
    if not use_h0:      # dh0 exists either way; jax has no leaf to match
        got = (*got[:5], None)
    _assert_leaves(got, _jax_grads(arrs, chunk, inc), f"{case} vs jax")
    _assert_leaves(got, _autograd(arrs, chunk, inc), f"{case} vs autograd")


@pytest.mark.parametrize("regime", ["mamba2", "rwkv6"])
def test_plain_backward_mixed_dtypes(regime):
    """Mamba2 at bf16 passes f32 d, b with bf16 c, x (and dy); RWKV6 f32 d
    with bf16 k, v, r.  Each gradient comes back in its input's dtype and
    is the f32 gradient of the bf16-rounded inputs rounded once, which is
    within 1e-4 of jax's and autograd's on those values."""
    bf, f32 = torch.bfloat16, torch.float32
    if regime == "mamba2":
        arrs = _inputs(2, 128, 2, 64, 64, 0.55, 0.99, False, False, False)
        dt, inc, chunk = dict(d=f32, b=f32, x=bf, c=bf), True, 64
    else:
        arrs = _inputs(1, 128, 2, 64, 64, 0.8, 0.999, True, False, True)
        dt, inc, chunk = dict(d=f32, b=bf, x=bf, c=bf), False, 64
    rounded = dict(arrs)
    for k in ("d", "b", "x", "c"):
        rounded[k] = _t(arrs[k], dt[k]).float().numpy()
    rounded["dy"] = _t(arrs["dy"], dt["x"]).float().numpy()
    got = _plain(arrs, chunk, inc, dt)
    exact = _plain(rounded, chunk, inc)
    for name, k, a, w in zip(NAMES, "dbxc", got, exact):
        assert a.dtype == dt[k], name
        assert torch.equal(a, w.to(dt[k])), name
    exact = (*exact[:5], None)
    _assert_leaves(exact, _jax_grads(rounded, chunk, inc), f"{regime} jax")
    _assert_leaves(exact, _autograd(rounded, chunk, inc), f"{regime} torch")


def _leaf(a, grad=True):
    return None if a is None else torch.from_numpy(a).requires_grad_(grad)


def test_ssd_function_gives_autograds_gradient(monkeypatch):
    """`ssd` under grad goes through `SsdFunction` on the CPU (its forward
    keeps the states, its backward is one `ssd_backward` call): the same
    gradients as autograd of `ssd_reference`; inputs that are None or
    need no grad get None."""
    arrs = _inputs(1, 128, 2, 16, 32, 0.8, 0.999, True, False, False)
    calls = {"states": 0, "backward": 0}
    states, backward = sm.ssd_states, sm.ssd_backward

    def count(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped
    monkeypatch.setattr(sm, "ssd_states", count("states", states))
    monkeypatch.setattr(sm, "ssd_backward", count("backward", backward))
    d, x, c, u = (_leaf(arrs[k]) for k in "dxcu")
    b = _leaf(arrs["b"], grad=False)
    y, hT = sm.ssd(d, b, x, c, u=u, h0=None, include_current=False)
    assert y.grad_fn is not None and calls == {"states": 1, "backward": 0}
    (y * _t(arrs["dy"])).sum().backward()
    assert calls == {"states": 1, "backward": 1}
    assert b.grad is None
    want = _autograd(dict(arrs, h0=None, dhT=None), 64, False)
    for name, got, w in zip(NAMES, (d.grad, None, x.grad, c.grad, u.grad),
                            want):
        if name == "db":
            continue
        scale = float(w.abs().max())
        assert float((got - w).abs().max()) <= LEAF_TOL * scale, name


def test_ssd_function_takes_either_output_alone():
    """Autograd hands SsdFunction None for an output the loss does not
    read: a loss of hT alone (dy counts as zeros) and of y alone (no dhT)
    both give autograd's gradient."""
    arrs = _inputs(1, 64, 2, 16, 16, 0.8, 0.999, True, True, True)
    for use_y in (True, False):
        leaves = [_leaf(arrs[k]) for k in ("d", "b", "x", "c", "u", "h0")]
        y, hT = sm.ssd(*leaves[:4], u=leaves[4], h0=leaves[5],
                       include_current=True)
        loss = ((y * _t(arrs["dy"])).sum() if use_y
                else (hT * _t(arrs["dhT"])).sum())
        got = torch.autograd.grad(loss, leaves)
        # c and u reach only y: a loss of hT alone leaves them unused in
        # the plain forward's graph (None there), zeros here
        ref = [_leaf(arrs[k]) for k in ("d", "b", "x", "c", "u", "h0")]
        y2, hT2 = sm.ssd_reference(*ref[:4], u=ref[4], h0=ref[5],
                                   include_current=True)
        loss2 = ((y2 * _t(arrs["dy"])).sum() if use_y
                 else (hT2 * _t(arrs["dhT"])).sum())
        want = torch.autograd.grad(loss2, ref, allow_unused=True)
        for name, a, w in zip(NAMES, got, want):
            w = torch.zeros_like(a) if w is None else w
            scale = max(float(w.abs().max()), 1e-30)
            assert float((a - w).abs().max()) <= LEAF_TOL * scale, \
                (use_y, name)


def test_ssd_without_grad_takes_the_plain_forward(monkeypatch):
    """No input requires grad, or grad mode is off: `ssd` does not go
    through SsdFunction and keeps no states."""
    arrs = _inputs(1, 64, 2, 16, 16, 0.8, 0.999, False, False, False)
    monkeypatch.setattr(sm, "ssd_states", None)
    d, b, x, c = (_t(arrs[k]) for k in "dbxc")
    y, _ = sm.ssd(d, b, x, c)
    assert y.grad_fn is None
    with torch.no_grad():
        y, _ = sm.ssd(d.requires_grad_(), b, x, c)
    assert y.grad_fn is None


@pytest.mark.parametrize("include_current", [True, False])
def test_backward_cost_counts_the_states_and_both_passes(include_current):
    """The masked C × C products count only the entries the mask keeps."""
    B, T, H, N, P = 8, 1024, 112, 64, 64
    f32 = lambda *s: torch.empty(s, dtype=torch.float32, device="meta")
    bf = lambda *s: torch.empty(s, dtype=torch.bfloat16, device="meta")
    cost = sm.ssd_backward_cost(f32(B, T, H, N), f32(B, T, H, N),
                                bf(B, T, H, P), bf(B, T, H, N),
                                include_current=include_current)
    ins = 2 * (4 + 4 + 2 + 2) * B * T * H * N + 2 * B * T * H * P
    states = (T // 64 + 1) * B * H * N * P * 4
    assert cost["bytes"] == ins + states
    kept = 64 * 65 // 2 if include_current else 64 * 63 // 2
    per_chunk = (2 * kept * (3 * N + 2 * P) + 8 * 64 * N * P
                 + 2 * N * P + 30 * 64 * N)
    assert cost["ops"] == B * H * (T // 64) * per_chunk


@pytest.mark.parametrize("mode", ["v24", "reactive", "off"])
def test_sequential_step_matches_the_reference(mode):
    """The per-package loop the reference's fleet tests verify against
    (tests/test_fleet.py): the same states, fed the same trace, give the
    same outputs (1e-5) and event counts."""
    n, tiles, steps = 3, 4, 10
    sched = ThermalScheduler(SchedulerConfig(n_tiles=tiles, mode=mode),
                             device="cpu")
    jsched = JThermalScheduler(JSchedulerConfig(n_tiles=tiles, mode=mode))
    seq = [sched.init() for _ in range(n)]
    jseq = [jsched.init() for _ in range(n)]
    rho = trace(steps, n, tiles, seed=4)
    for t in range(steps):
        seq, outs = sequential_step(sched, seq, torch.from_numpy(rho[t]))
        jseq, jouts = jsequential_step(jsched, jseq, jnp.asarray(rho[t]))
        assert len(outs) == len(jouts) == n
        for field in ("freq", "temp_c", "hint_w", "balance"):
            got = np.stack([np_(getattr(o, field)) for o in outs])
            want = np.stack([np_(getattr(o, field)) for o in jouts])
            np.testing.assert_allclose(got, want, err_msg=f"{field}@{t}",
                                       **TOL)
    assert [int(s.events) for s in seq] == [int(s.events) for s in jseq]
