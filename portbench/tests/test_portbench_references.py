"""Each plain reference against the port at a size the CPU holds: the
reference is the yardstick, so it has to compute what the program is
meant to compute."""
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from portbench.reference import fleet_v24  # noqa: E402

BENCH = Path(__file__).resolve().parents[1]


def _pkg47():
    return json.loads((BENCH / "configs" / "pkg47.json").read_text())


def test_fingerprint_and_gamma_are_the_ports():
    from repro_torch.core.coupling import coupling_matrix, row_normalise
    from repro_torch.core.fingerprint import FINGERPRINT
    cfg = _pkg47()
    for k, v in cfg["fingerprint"].items():
        assert getattr(FINGERPRINT, k) == v, k
    p = fleet_v24.params(cfg["scheduler"], cfg["fingerprint"])
    assert torch.equal(p.gamma, row_normalise(coupling_matrix(47)))


@pytest.mark.parametrize("n_tiles,backend", [(47, "fused"),
                                              (47, "broadcast"),
                                              (1, "fused")])
def test_fleet_reference_matches_the_port(n_tiles, backend):
    """The plain loop against the port's window (the fused backend's plain
    version on the CPU, or the per-step engine) through a swell that
    throttles: the state bit for bit on the fused convention, and the flush
    record within float32 reduction order."""
    from repro_torch.core.scheduler import SchedulerConfig
    from repro_torch.fleet.engine import FleetEngine
    cfg = _pkg47()
    sched = dict(cfg["scheduler"], n_tiles=n_tiles)
    eng = FleetEngine(SchedulerConfig(**{k: sched[k] for k in (
        "n_tiles", "mode", "two_pole", "use_coupling", "step_ms",
        "lookahead_steps", "filtration_window", "t_safe_margin_c",
        "power_exponent", "straggler_threshold", "plant")}),
        backend=backend, device="cpu")
    n, steps = 16, 96
    rng = np.random.default_rng(0)
    swell = 0.9 + 1.8 * np.sin(np.linspace(0, np.pi, steps)) ** 2
    rho = np.clip(swell[:, None, None]
                  + 0.2 * rng.standard_normal((n, n_tiles)), 0.9, 2.7
                  ).astype(np.float32)
    p = fleet_v24.params(sched, cfg["fingerprint"])
    s = fleet_v24.init(p, n, n_tiles)
    st = eng.init(n)
    # two windows: the second starts from each side's own state
    for k in range(2):
        chunk = rho[k * 48:(k + 1) * 48]
        st, telem = eng.run_block(st, chunk)
        s, want = fleet_v24.window(p, s, torch.as_tensor(chunk))
        got = telem.as_dict()
        assert got["events_total"] == want["events_total"]
        for key in ("temp_p50_c", "temp_p99_c", "temp_max_c", "freq_mean",
                    "released_mtps", "throttled_mtps", "freq_min",
                    "at_risk_frac"):
            assert abs(got[key] - want[key]) <= 1e-6 * abs(want[key]) + 1e-7
    tol = 0 if backend == "fused" or n_tiles == 1 else 1e-5
    torch.testing.assert_close(st.thermal, s.thermal, rtol=tol, atol=tol)
    torch.testing.assert_close(st.freq, s.freq, rtol=tol, atol=tol)
    # the throttling regime is reached: the comparison covers the law
    assert want["throttled_mtps"] > 0
