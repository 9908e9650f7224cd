"""The control — the reference itself in the nearest precision below the
configuration's, in the program's place — comes out not correct, at a
size a test run holds; the program itself within every limit."""
import pytest

torch = pytest.importorskip("torch")

import _small  # noqa: E402


@pytest.mark.parametrize("cell,seed", [("pkg47.stream", 41),
                                       ("pkg47.stream_1k", 42)])
def test_control_fails_and_the_program_passes(cell, seed):
    kind, ctx = _small.prepared(cell, seed)
    limits = ctx.traffic["limits"]
    kind.release(ctx)
    prog = kind.readings(ctx)
    ctrl = kind.readings(ctx, control=True)
    assert all(prog[k] <= lim for k, lim in limits.items()), prog
    assert any(ctrl[k] > lim for k, lim in limits.items()), ctrl
