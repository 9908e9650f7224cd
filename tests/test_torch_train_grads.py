"""PyTorch port: the training gradients against the JAX reference's.

`repro_torch.launch.steps.loss_and_grads` (the port's `loss_fn` with
remat per block and the chunked LM head, differentiated by autograd
through `FlashAttention` and, on the CPU, the plain ssd) against
``jax.value_and_grad`` of `repro.models.transformer.loss_fn` with remat,
from the same parameters (`convert.params_from_numpy`) and batch, for
reduced Gemma-2B, Mixtral, DeepSeek-V2, musicgen, RWKV6 and Zamba2: the
loss and the MoE aux loss within 1e-5 relative, each gradient leaf within
1e-4 of its largest magnitude (f32; the same sums in other orders).
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
from repro.models import transformer as jtf

from repro_torch import convert
from repro_torch.configs import get_arch, reduced
from repro_torch.launch import steps as S


@pytest.mark.parametrize("arch", ["gemma-2b", "mixtral-8x7b",
                                  "deepseek-v2-236b", "musicgen-large",
                                  "rwkv6-1.6b", "zamba2-7b"])
def test_gradients_match_the_reference(arch):
    jcfg, cfg = jreduced(jget_arch(arch)), reduced(get_arch(arch))
    js = JS.init_train_state(jax.random.PRNGKey(1), jcfg, 4)
    params = convert.params_from_numpy(cfg, jax.device_get(js.params), "cpu")
    batch = lm_batch(cfg, np.random.default_rng(1))
    tokens, labels = batch["tokens"], batch["labels"]
    (jloss, jaux), jg = jax.jit(
        jax.value_and_grad(lambda p, t, l: jtf.loss_fn(
            p, jcfg, t, l, remat=True), has_aux=True))(
        js.params, jnp.asarray(tokens), jnp.asarray(labels))
    loss, aux, grads = S.loss_and_grads(params, cfg, torch.from_numpy(tokens),
                                        torch.from_numpy(labels))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(aux["moe_aux"]), float(jaux["moe_aux"]),
                               rtol=1e-5, atol=1e-30)
    want = jax.tree.leaves(jg)
    assert len(grads) == len(want)
    for a, b in zip(want, grads):
        a = np.asarray(a)
        scale = max(float(np.abs(a).max()), 1e-30)
        np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=1e-4 * scale)
