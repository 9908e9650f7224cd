"""A run with its timed path broken underneath comes out not correct: each
fault a cell can have, planted in the program, with the rest of the run
(set-up, window, comparison) as the benchmark drives it on the CPU."""
import pytest

torch = pytest.importorskip("torch")

import _small  # noqa: E402


def test_fleet_sound_run_is_correct():
    assert _small.run("pkg47.stream", 21)["correct"]


def test_fleet_window_that_returns_its_state_unchanged(monkeypatch):
    from repro_torch.fleet.backends.fused import FusedBackend
    orig = FusedBackend.run_block

    def stuck(self, state, rho):
        _, temps, freqs = orig(self, state, rho)
        return state, temps, freqs

    monkeypatch.setattr(FusedBackend, "run_block", stuck)
    assert not _small.run("pkg47.stream", 22)["correct"]


def test_fleet_record_over_half_the_fleet(monkeypatch):
    from repro_torch.fleet.engine import FleetEngine
    orig = FleetEngine._traces_record

    def half(self, rho, temps, freqs, prev, ev, deg, active=None):
        h = temps.shape[1] // 2
        return orig(self, rho[:, :h], temps[:, :h], freqs[:, :h], prev, ev,
                    deg, active)

    monkeypatch.setattr(FleetEngine, "_traces_record", half)
    assert not _small.run("pkg47.stream", 23)["correct"]


def test_fleet_record_altered_where_it_is_made(monkeypatch):
    from repro_torch.fleet.engine import FleetTelemetry
    orig = FleetTelemetry.as_dict

    def altered(self):
        d = orig(self)
        d["events_total"] += 1
        return d

    monkeypatch.setattr(FleetTelemetry, "as_dict", altered)
    assert not _small.run("pkg47.stream", 24)["correct"]
