"""PyTorch port: the train step against the JAX reference's, family by family.

`repro_torch.launch.steps.make_train_step` (f32 reduced configs, the
plain kernel versions on the CPU, remat on) from the state of
`repro.launch.steps.init_train_state`, carried over with
`convert.train_state_from_numpy`, on the same numpy batches as the
reference's jitted step: reduced Gemma-2B (dense, MQA), Mixtral (MoE,
sliding window), DeepSeek-V2 (MLA, shared experts), musicgen (stub
embeddings), RWKV6 (ssm) and Zamba2 (hybrid).  After steps 1 and 3:

  * loss, nll and the MoE aux loss within 1e-5 relative (f32 rounding of
    the same sums in another order);
  * grad_norm within 1e-4 relative (an f32 sum over every gradient);
  * lr and the scheduler's outputs (temperature, frequency, η, at-risk
    tiles) within 1e-6 relative — computed the same way on both sides;
  * the parameters: no element off by more than twice the summed
    learning rates, and the difference of the two updates since the
    initial state within 1e-2 of the reference update's norm (L2 over
    every leaf) — AdamW's m / √v turns a last-ulp difference in a
    near-zero gradient element into up to a whole update of either sign,
    so the gradients themselves are held tighter, in
    `test_torch_train_grads.py`.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_parity import lm_batch

import jax
import jax.numpy as jnp

from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.launch import steps as JS

from repro_torch import convert
from repro_torch.checkpoint.manager import tree_leaves
from repro_torch.configs import get_arch, reduced
from repro_torch.launch import steps as S

N_TILES = 4
TOL = {"loss": 1e-5, "nll": 1e-5, "moe_aux": 1e-5, "grad_norm": 1e-4,
       "lr": 1e-6, "thermal_temp_max": 1e-6, "thermal_freq_min": 1e-6,
       "thermal_eta": 1e-6, "thermal_at_risk": 1e-6}


@pytest.mark.parametrize("arch", ["gemma-2b", "mixtral-8x7b",
                                  "deepseek-v2-236b", "musicgen-large",
                                  "rwkv6-1.6b", "zamba2-7b"])
def test_train_step_matches_the_reference(arch):
    jcfg, cfg = jreduced(jget_arch(arch)), reduced(get_arch(arch))
    js = JS.init_train_state(jax.random.PRNGKey(0), jcfg, N_TILES)
    ts = convert.train_state_from_numpy(cfg, jax.device_get(js), "cpu")
    jstep = jax.jit(JS.make_train_step(jcfg, N_TILES))
    tstep = S.make_train_step(cfg, N_TILES, device="cpu")
    p0 = [np.asarray(a) for a in jax.tree.leaves(jax.device_get(js.params))]
    lr_sum = 0.0
    rng = np.random.default_rng(0)
    for i in range(1, 4):
        batch = lm_batch(cfg, rng, n_tiles=N_TILES)
        js, jm = jstep(js, jax.tree.map(jnp.asarray, batch))
        ts, tm = tstep(ts, {k: torch.from_numpy(v)
                            for k, v in batch.items()})
        lr_sum += float(jm["lr"])
        if i not in (1, 3):
            continue
        assert sorted(tm) == sorted(jm)
        for k, tol in TOL.items():
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=tol,
                                       atol=1e-30, err_msg=f"{k} step {i}")
        assert int(ts.step) == int(js.step) == i
        assert int(ts.opt.count) == int(js.opt.count) == i
        want = jax.tree.leaves(jax.device_get(js.params))
        got = tree_leaves(ts.params)
        assert len(got) == len(want)
        num = den = 0.0
        for a, b, a0 in zip(want, got, p0):
            du_ref, du = a - a0, b.numpy() - a0
            np.testing.assert_allclose(b.numpy(), a, rtol=0,
                                       atol=2 * lr_sum,
                                       err_msg=f"params step {i}")
            num += float(np.sum((du - du_ref) ** 2))
            den += float(np.sum(du_ref ** 2))
        assert np.sqrt(num / den) <= 1e-2, \
            f"step {i}: updates differ by {np.sqrt(num / den):.2e}"

