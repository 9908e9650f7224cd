"""Train a ~100M-parameter LM with the PyTorch port for a few hundred steps.

    PYTHONPATH=src python examples/torch_train_100m.py [--steps 300]
    PYTHONPATH=src python examples/torch_train_100m.py --device cpu --steps 20

The port's counterpart of examples/train_100m.py: the same granite-family
decoder (12 layers × d 640 × ff 2,560, 10 heads on 5 KV heads of 64, 32k
vocabulary, ≈ 95M parameters) in f32, with the same stack — prefetched
data pipeline, AdamW with the cosine schedule, the V24 thermal scheduler
in the train state, asynchronous checkpoints with auto-resume, the
preemption guard, telemetry.  On a card every attention runs the
CUDA-core flash kernels (f32), forward and backward.  Prints the loss
every 25 steps and returns (first loss, last loss).
"""
import argparse
import dataclasses
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.core.telemetry import TelemetryLog
from repro_torch.data import DataConfig, SyntheticLMData
from repro_torch.distributed.fault_tolerance import PreemptionGuard
from repro_torch.launch import steps as S


def config():
    return dataclasses.replace(
        get_arch("granite-3-2b"), name="granite-100m", n_layers=12,
        d_model=640, n_heads=10, n_kv_heads=5, head_dim=64, d_ff=2560,
        vocab_size=32_768, dtype="float32")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_torch_100m_ckpt")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = config()
    print(f"[100m] {cfg.name}: {cfg.param_count() / 1e6:.0f}M params on "
          f"{dev}")
    data = SyntheticLMData(cfg, DataConfig(batch=args.batch,
                                           seq_len=args.seq, seed=0))
    state = S.init_train_state(torch.Generator(device=dev).manual_seed(0),
                               cfg, n_tiles=8)
    step_fn = S.make_train_step(cfg, 8, device=dev)
    ckpt = CheckpointManager(args.ckpt_dir, keep_n=2)
    tele = TelemetryLog()
    guard = PreemptionGuard()

    restored, at = ckpt.restore_latest(state)
    start = 0
    if restored is not None:
        state, start = restored, at + 1
        print(f"[100m] resumed from step {at}")

    rho = torch.full((8,), 1.9, device=dev)
    t0, toks = time.time(), 0
    for i in range(start, args.steps):
        b = data.next()
        state, m = step_fn(state, {
            "tokens": torch.from_numpy(b["tokens"]).to(dev),
            "labels": torch.from_numpy(b["labels"]).to(dev), "rho": rho})
        toks += args.batch * args.seq
        tele.record(i, loss=m["loss"], temp=m["thermal_temp_max"],
                    freq=m["thermal_freq_min"])
        if i % 25 == 0:
            print(f"[100m] step {i:4d} loss {tele.last()['loss']:.4f} "
                  f"lr {float(m['lr']):.2e} "
                  f"tok/s {toks / (time.time() - t0):,.0f} "
                  f"T {tele.last()['temp']:.1f}C")
        if i and i % 100 == 0:
            ckpt.save(i, state)
        if guard.should_exit:
            ckpt.save(i, state, blocking=True)
            print("[100m] preempted — checkpointed, exiting")
            return None
    ckpt.save(args.steps - 1, state, blocking=True)
    data.close()
    guard.restore()
    first = tele.rows()[0]["loss"] if start == 0 and len(tele) else None
    last = tele.last()["loss"] if len(tele) else None
    print(f"[100m] done. loss {first} -> {last}; "
          f"{toks / max(time.time() - t0, 1e-9):,.0f} tok/s; "
          f"thermal events {int(state.sched.events)}")
    return first, last


if __name__ == "__main__":
    main()
