"""Each cell once on the card, through the command, with its comparison
(run on a machine with an NVIDIA card: ``-m cuda``)."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(cell):
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          cell, "--seed", "2147483999", "--seconds", "5",
                          "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"], r["compared"]
    assert r["device"]["platform"] == "gpu"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_card(cell):
    """At the cell's own size: the control (the reference in the nearest
    precision below the configuration's, in the program's place) exceeds
    a limit; the program, on the same run, keeps to every one."""
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA")
    from portbench import harness
    _, kind, ctx = harness.prepare(ROOT, cell, 2147483647, 5.0, False)
    kind.setup(ctx)
    kind.window(ctx)
    kind.release(ctx)
    limits = ctx.traffic["limits"]
    prog, ctrl = kind.readings(ctx), kind.readings(ctx, control=True)
    assert all(prog[k] <= lim for k, lim in limits.items()), prog
    assert any(ctrl[k] > lim for k, lim in limits.items()), ctrl
