"""Step functions (train, prefill, decode), their specs on a mesh and
stand-ins for every input.

Port of `repro.launch.steps`.  PyTorch runs eagerly, so these are the
plain functions the reference hands to ``jax.jit``.  The V24 thermal
scheduler is a member of the train state and advances inside the train
step, as in the reference.  Tokens may be integer ids or a stub frontend's
embeddings (train and prefill [B, S, D], decode [B, D]).

On a mesh: `train_state_specs` and `batch_shardings` give the specs,
`sharding.distribute` places a state and a batch by them, and
`make_train_step`'s step runs unchanged on the placed (DTensor) state
under `sharding.axis_env` — the counterpart of jitting it with
``in_shardings``.  `input_specs` gives fake tensors (shapes and dtypes, no
memory), the counterpart of the reference's ``ShapeDtypeStruct``s.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch.profiler import record_function

from repro_torch.checkpoint.manager import tree_leaves, tree_unflatten
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.scheduler import (SchedulerConfig, SchedulerState,
                                        ThermalScheduler)
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import P, constrain
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


def train_state_specs(cfg: ArchConfig, state: TrainState, mesh, *,
                      tp_attention: bool = True) -> TrainState:
    """Specs of a train state: the parameters' (`sharding.param_specs`;
    ``tp_attention=False`` the EP-only mode), the AdamW moments inherit
    them, the scheduler, the step and AdamW's count are replicated."""
    pspecs = sharding.param_specs(cfg, state.params, mesh,
                                  tp_attention=tp_attention)
    return TrainState(
        params=pspecs,
        opt=sharding.state_specs(cfg, state.opt, pspecs),
        sched=sharding.map_with_path(lambda _, x: P(), state.sched),
        step=P(),
    )


# ============================================================= train step ==
def loss_and_grads(params, cfg: ArchConfig, tokens, labels, *,
                   remat: bool = True):
    """(loss, {"nll", "moe_aux"}, grads): `transformer.loss_fn` and its
    gradient with respect to each parameter leaf, the leaves in
    `tree_leaves` order (a leaf the loss does not read gets zeros, as
    ``jax.grad`` gives it).  The gradient is taken with respect to views
    of the parameters that require grad, so ``params`` need not.  On a
    mesh each gradient comes back placed as its parameter (a partial sum
    over the batch's axes reduced, or reduced and scattered)."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    loss, metrics = tf.loss_fn(tree_unflatten(params, leaves), cfg, tokens,
                               labels, remat=remat)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    grads = [g.redistribute(p.device_mesh, p.placements)
             if sharding.is_distributed(g) and g.placements != p.placements
             else g for p, g in zip(leaves, grads)]
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
    as the reference's scan does, each slice pinned to the batch's axes
    on a mesh.  ``device`` is the scheduler's (the parameters' device).
    On a mesh (a state placed by `train_state_specs`, the batch by
    `batch_shardings`, the step called under `sharding.axis_env`) the
    scheduler, which every rank holds whole, steps on its local values
    (`sharding.on_local`).
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
            acc = [torch.zeros_like(p, dtype=torch.float32,
                                    memory_format=torch.contiguous_format)
                   for p in tree_leaves(state.params)]
            losses, nlls, auxs = [], [], []
            for i in range(n_microbatches):
                rows = slice(i * mb, (i + 1) * mb)
                t, lab = tokens[rows], labels[rows]
                t = constrain(t, ("dp",) + (None,) * (t.ndim - 1))
                lab = constrain(lab, ("dp",) + (None,) * (lab.ndim - 1))
                loss_i, m_i, g_i = grads_of(state.params, t, lab)
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
        sst, sout = sharding.on_local(sched.update, state.sched,
                                      batch["rho"])
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
    cache), the cache updated in place.  ``pos`` is the token's absolute
    position, a Python int (the slot it writes and the mask depend on it),
    as `input_specs` gives it."""
    def decode_step(params, cache, token, pos: int):
        return tf.decode_step(params, cfg, cache, token, pos)
    return decode_step


# ============================================================ input specs ==
def _fake_mode():
    """The active ``FakeTensorMode`` (its tensors mix with the caller's),
    else a new one."""
    import contextlib

    from torch._guards import detect_fake_mode
    from torch._subclasses.fake_tensor import FakeTensorMode

    return (contextlib.nullcontext() if detect_fake_mode() is not None
            else FakeTensorMode())


def _fake(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype)


def input_specs(cfg: ArchConfig, shape: ShapeConfig, n_tiles: int = 256
                ) -> dict[str, Any]:
    """Stand-ins for every model input of the cell's step: fake tensors
    (`torch._subclasses.fake_tensor.FakeTensorMode`; shapes and dtypes, no
    memory), as the reference's ``ShapeDtypeStruct``s.

    A decode cell's cache (the carried state of its step) comes from
    `transformer.init_cache` under the fake mode, and its ``pos`` is a
    Python int, as `make_decode_step` takes it: the cache's last position,
    S − 1, so the step reads a full cache (the reference's is a traced
    int32 scalar).  Stub-frontend archs (vlm / audio) take precomputed
    embeddings.  Under an active ``FakeTensorMode`` the tensors are that
    mode's.
    """
    B, S = shape.global_batch, shape.seq_len
    stub = cfg.frontend != "token"
    emb = getattr(torch, cfg.dtype)
    with _fake_mode():
        if shape.kind in ("train", "prefill"):
            tok = (_fake((B, S, cfg.d_model), emb) if stub
                   else _fake((B, S), torch.int32))
            if shape.kind == "prefill":
                return {"tokens": tok}
            return {"tokens": tok, "labels": _fake((B, S), torch.int32),
                    "rho": _fake((n_tiles,), torch.float32)}
        tok = (_fake((B, cfg.d_model), emb) if stub
               else _fake((B,), torch.int32))
        return {"cache": tf.init_cache(cfg, B, S), "token": tok,
                "pos": S - 1}


def batch_shardings(cfg: ArchConfig, shape: ShapeConfig, mesh) -> dict:
    """Specs of the cell's inputs (the keys of `input_specs`)."""
    stub = cfg.frontend != "token"
    B = shape.global_batch
    if shape.kind == "train":
        return {"tokens": sharding.batch_spec(mesh, 3 if stub else 2, B),
                "labels": sharding.batch_spec(mesh, 2, B),
                "rho": P()}
    if shape.kind == "prefill":
        return {"tokens": sharding.batch_spec(mesh, 3 if stub else 2, B)}
    cache = input_specs(cfg, shape)["cache"]
    return {"cache": sharding.cache_specs(cfg, cache, mesh),
            "token": sharding.batch_spec(mesh, 2 if stub else 1, B),
            "pos": P()}
