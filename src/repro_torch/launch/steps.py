"""Step functions: the train step with its state, and the serving steps.

Port of `repro.launch.steps`.  PyTorch runs eagerly, so these are the
plain functions the reference hands to ``jax.jit``.  The V24 thermal
scheduler is a member of the train state and advances inside the train
step, as in the reference.  Tokens may be integer ids or a stub frontend's
embeddings (train and prefill [B, S, D], decode [B, D]).

The mesh and dry-run pieces of the reference (``train_state_specs``,
``input_specs``, ``batch_shardings``) wait for the multi-GPU and XLA
tooling steps (ROADMAP queue 1 steps 9 and 11).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch.profiler import record_function

from repro_torch.checkpoint.manager import tree_leaves, tree_unflatten
from repro_torch.configs.base import ArchConfig
from repro_torch.core.scheduler import (SchedulerConfig, SchedulerState,
                                        ThermalScheduler)
from repro_torch.models import transformer as tf
from repro_torch.optim.adamw import (AdamWConfig, AdamWState, adamw_init,
                                     adamw_update)


# ============================================================ train state ==
class TrainState(NamedTuple):
    params: Any
    opt: AdamWState
    sched: SchedulerState
    step: torch.Tensor           # 0-dim int32, on the host


def make_scheduler(n_tiles: int, device=None) -> ThermalScheduler:
    return ThermalScheduler(SchedulerConfig(n_tiles=n_tiles, mode="v24",
                                            two_pole=True, use_coupling=True),
                            device=device)


def init_train_state(gen: torch.Generator, cfg: ArchConfig,
                     n_tiles: int = 1) -> TrainState:
    """Random parameters drawn on ``gen.device``, zero AdamW moments, a
    fresh scheduler on the same device, step 0."""
    params = tf.init_params(gen, cfg)
    return TrainState(params=params, opt=adamw_init(params),
                      sched=make_scheduler(n_tiles, gen.device).init(),
                      step=torch.zeros((), dtype=torch.int32))


# ============================================================= train step ==
def loss_and_grads(params, cfg: ArchConfig, tokens, labels, *,
                   remat: bool = True):
    """(loss, {"nll", "moe_aux"}, grads): `transformer.loss_fn` and its
    gradient with respect to each parameter leaf, the leaves in
    `tree_leaves` order (a leaf the loss does not read gets zeros, as
    ``jax.grad`` gives it).  The gradient is taken with respect to views
    of the parameters that require grad, so ``params`` need not."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    loss, metrics = tf.loss_fn(tree_unflatten(params, leaves), cfg, tokens,
                               labels, remat=remat)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(cfg: ArchConfig, n_tiles: int,
                    opt_cfg: AdamWConfig | None = None,
                    remat: bool = True, n_microbatches: int = 1,
                    device=None):
    """(state, batch) → (new state, metrics), as the reference's step.

    ``batch``: "tokens" [B, S] (or stub embeddings [B, S, D]), "labels"
    [B, S] and "rho" [n_tiles], on the parameters' device.  The gradient
    comes from `loss_and_grads`; the AdamW update then writes the
    parameters and moments in place (`optim.adamw`).  The two stages run
    inside ``torch.profiler.record_function`` ranges ("loss_and_grads",
    "adamw_update"), so a profile attributes device time to each.  With
    ``n_microbatches`` > 1 the batch runs in B / n consecutive slices and
    the gradients are accumulated in f32 and averaged before one update,
    as the reference's scan does.  ``device`` is the scheduler's (the
    parameters' device).
    """
    sched = make_scheduler(n_tiles, device)

    def grads_of(params, tokens, labels):
        with record_function("loss_and_grads"):
            return loss_and_grads(params, cfg, tokens, labels, remat=remat)

    def train_step(state: TrainState, batch):
        tokens, labels = batch["tokens"], batch["labels"]
        if n_microbatches == 1:
            loss, metrics, grads = grads_of(state.params, tokens, labels)
        else:
            mb = tokens.shape[0] // n_microbatches
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for p in tree_leaves(state.params)]
            losses, nlls, auxs = [], [], []
            for i in range(n_microbatches):
                rows = slice(i * mb, (i + 1) * mb)
                loss_i, m_i, g_i = grads_of(state.params, tokens[rows],
                                            labels[rows])
                for a, g in zip(acc, g_i):
                    a.add_(g.float())
                del g_i
                losses.append(loss_i)
                nlls.append(m_i["nll"])
                auxs.append(m_i["moe_aux"])
            grads = [a.div_(n_microbatches) for a in acc]
            loss = torch.stack(losses).mean()
            metrics = {"nll": torch.stack(nlls).mean(),
                       "moe_aux": torch.stack(auxs).mean()}
        with record_function("adamw_update"):
            params, opt, opt_m = adamw_update(
                tree_unflatten(state.params, grads), state.opt,
                state.params, opt_cfg)
        del grads
        sst, sout = sched.update(state.sched, batch["rho"])
        new = TrainState(params=params, opt=opt, sched=sst,
                         step=state.step + 1)
        return new, {
            "loss": loss, "nll": metrics["nll"],
            "moe_aux": metrics["moe_aux"],
            "grad_norm": opt_m["grad_norm"], "lr": opt_m["lr"],
            "thermal_temp_max": sout.temp_c.max(),
            "thermal_freq_min": sout.freq.min(),
            "thermal_eta": sout.eta,
            "thermal_at_risk": sout.at_risk.sum(),
        }

    return train_step


# ======================================================= prefill / decode ==
def make_prefill_step(cfg: ArchConfig, max_seq: int):
    """(params, tokens [B, S] or embeds [B, S, D]) → (last-token logits
    [B, V], cache)."""
    def prefill_step(params, tokens):
        last, cache, _ = tf.prefill(params, cfg, tokens, max_seq)
        return last, cache
    return prefill_step


def make_decode_step(cfg: ArchConfig):
    """(params, cache, token [B] or embed [B, D], pos) → (logits [B, V],
    cache), the cache updated in place."""
    def decode_step(params, cache, token, pos: int):
        return tf.decode_step(params, cfg, cache, token, pos)
    return decode_step
