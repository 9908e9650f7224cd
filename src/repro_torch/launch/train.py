"""End-to-end training driver.

    python -m repro_torch.launch.train --arch gemma-2b --batch 8 --seq 1024
    python -m repro_torch.launch.train --device cpu --arch gemma-2b \\
        --reduced --steps 20 --batch 4 --seq 64 --ckpt-dir /tmp/ckpt

Port of `repro.launch.train`: config → model → the prefetched synthetic
data pipeline → AdamW train step with the V24 thermal scheduler in the
train state → asynchronous atomic checkpoints with auto-resume
(`checkpoint.CheckpointManager`, the reference's on-disk layout) →
preemption guard → heartbeat → telemetry (loss, junction temperature,
frequency, at-risk tiles, grad norm per step).

It runs on the card unless given ``--device cpu`` (the plain versions of
the kernels: the tests' path), and raises without one.  On the card every
attention goes through the flash kernels, forward and backward; the
``ssd`` kernel has no backward yet, so the ssm (RWKV6) and hybrid
(Zamba2) families are refused there (ROADMAP queue 1 step 10.5b).  Each
step's metrics come to the host in one copy; the driver prints the loss,
the warm step time (host clock after a synchronize; the first step, which
builds the kernels, is not counted), tokens per second and the peak
device memory, and returns them with the final state.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_arch, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.density import rho_v24
from repro_torch.core.telemetry import TelemetryLog
from repro_torch.data import DataConfig, SyntheticLMData
from repro_torch.distributed.fault_tolerance import Heartbeat, PreemptionGuard
from repro_torch.launch import steps as S

# families whose training needs a kernel the card does not have yet
_NOT_PORTED = {"ssm": "10.5b", "hybrid": "10.5b"}
_LOGGED = ("loss", "nll", "grad_norm", "thermal_temp_max",
           "thermal_freq_min", "thermal_at_risk")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--n-tiles", type=int, default=8)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--telemetry-out", default="")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap.parse_args(argv)


def _to_device(batch: dict, dev: torch.device) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in batch.items()}


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if dev.type == "cuda" and cfg.family in _NOT_PORTED:
        raise SystemExit(f"repro_torch.launch.train: training the "
                         f"{cfg.family} family on the card needs the ssd "
                         f"backward kernel, not ported yet: ROADMAP queue "
                         f"1 step {_NOT_PORTED[cfg.family]}")
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    rho = rho_v24(cfg, shape)

    data = SyntheticLMData(cfg, DataConfig(batch=args.batch,
                                           seq_len=args.seq, seed=args.seed))
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    state = S.init_train_state(gen, cfg, args.n_tiles)
    step_fn = S.make_train_step(cfg, args.n_tiles, device=dev)

    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    if ckpt:
        restored, at = ckpt.restore_latest(state)
        if restored is not None:
            state, start = restored, at + 1
            print(f"[train] resumed from step {at}")

    guard = PreemptionGuard()
    hb = Heartbeat(timeout_s=600)
    tele = TelemetryLog()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    t0 = time.perf_counter()
    tokens_done, step_ms, losses = 0, [], []
    step = start - 1
    for step in range(start, args.steps):
        batch = data.next()
        # per-tile density: the arch/shape ρ modulated by the realised
        # batch (document mix) — the ρv24(t) signal of paper §4.2
        mod = 1.0 + 0.05 * (np.mean(batch["labels"] != 1) - 0.5)
        inputs = _to_device(batch, dev)
        inputs["rho"] = torch.full((args.n_tiles,), rho * mod,
                                   dtype=torch.float32, device=dev)
        ts = time.perf_counter()
        state, metrics = step_fn(state, inputs)
        host = torch.stack([metrics[k].float() for k in _LOGGED]).cpu()
        step_ms.append((time.perf_counter() - ts) * 1e3)
        m = dict(zip(_LOGGED, host.tolist()))
        hb.beat()
        tokens_done += args.batch * args.seq
        losses.append(m["loss"])
        tele.record(step, loss=m["loss"], nll=m["nll"],
                    temp_c=m["thermal_temp_max"],
                    freq=m["thermal_freq_min"],
                    at_risk=m["thermal_at_risk"], grad_norm=m["grad_norm"])
        data.set_balance(np.full(args.n_tiles, 1.0 / args.n_tiles))

        if args.log_every and step % args.log_every == 0:
            el = time.perf_counter() - t0
            print(f"[train] step {step} loss {m['loss']:.4f} "
                  f"step {step_ms[-1]:.1f} ms "
                  f"tok/s {tokens_done / max(el, 1e-9):,.0f} "
                  f"Tmax {m['thermal_temp_max']:.1f}C "
                  f"fmin {m['thermal_freq_min']:.3f}")
        if ckpt and args.ckpt_every and step and step % args.ckpt_every == 0:
            ckpt.save(step, state)
        if guard.should_exit:
            print("[train] preemption signal — final checkpoint")
            if ckpt:
                ckpt.save(step, state, blocking=True)
            break
    else:
        if ckpt and args.steps > start:
            ckpt.save(args.steps - 1, state, blocking=True)

    if ckpt:
        ckpt.wait()
    data.close()
    hb.close()
    guard.restore()
    if args.telemetry_out:
        tele.dump_jsonl(args.telemetry_out)
    el = time.perf_counter() - t0
    warm = step_ms[1:] or step_ms
    warm_ms = float(np.median(warm)) if warm else float("nan")
    tok_s = args.batch * args.seq / (warm_ms / 1e3) if warm else 0.0
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)
    print(f"[train] done: {len(step_ms)} steps from {start}, loss "
          f"{losses[-1] if losses else float('nan'):.4f}, warm step "
          f"{warm_ms:.1f} ms (median), {tok_s:,.0f} tok/s, "
          f"{tokens_done / max(el, 1e-9):,.0f} tok/s overall, peak device "
          f"memory " + ("not measured (cpu)" if peak is None
                        else f"{peak / 2**30:.2f} GiB")
          + f", thermal events {int(state.sched.events)}")
    return {"state": state, "start": start, "last_step": step,
            "losses": losses, "step_ms": step_ms, "warm_step_ms": warm_ms,
            "tok_s": tok_s, "peak_bytes": peak, "device": str(dev)}


if __name__ == "__main__":
    main()
