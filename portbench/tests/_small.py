"""The cells shrunk to sizes a CPU test run holds: the same kind,
reference and comparison, on the program's plain PyTorch path."""
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

# a flush half the swell long: its checked first flush throttles
FLEET = dict(packages=64, flush=128, ring_chunks=2,
             swell=dict(lo=0.9, hi=2.7, period=256), trace_flushes=2)


def run(cell: str, seed: int, seconds: float = 1.0, trace: bool = False):
    from portbench import harness
    return harness.run(ROOT, cell, seed, seconds, trace, time.perf_counter(),
                       device="cpu", overrides=FLEET)


def prepared(cell: str, seed: int, seconds: float = 1.0):
    """(kind module, context) after set-up and the window."""
    from portbench import harness
    _, kind, ctx = harness.prepare(ROOT, cell, seed, seconds, False,
                                   device="cpu", overrides=FLEET)
    kind.setup(ctx)
    kind.window(ctx)
    return kind, ctx
