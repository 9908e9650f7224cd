"""PyTorch port: the model-serving wave loop (`repro_torch.launch.serve`
without ``--stream``) on the CPU at reduced size.

Admission is ``max(1, int(batch × freq0))`` with freq0 from one fleet-engine
step per wave; with a fleet of one (no jitter) it must equal what the
reference's `FleetEngine` gives for the same ρv24.  The reference's model
loop is not run: the models are held to it in test_torch_models.py.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as ref_arch
from repro.configs import reduced as ref_reduced
from repro.configs.base import ShapeConfig as RefShape
from repro.core.density import rho_v24 as ref_rho_v24
from repro.core.scheduler import SchedulerConfig as RefSchedulerConfig
from repro.fleet import FleetEngine as RefFleetEngine

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ssm_scan import ssd
from repro_torch.launch import serve


def _ref_admissions(arch, batch, prompt_len, gen, waves):
    cfg = ref_reduced(ref_arch(arch))
    rho = float(ref_rho_v24(cfg, RefShape("serve", prompt_len + gen, batch,
                                          "decode")))
    eng = RefFleetEngine(RefSchedulerConfig(n_tiles=1, mode="v24",
                                            step_ms=5.0),
                         backend="broadcast")
    st = eng.init(1)
    admitted = []
    for _ in range(waves):
        st, out, _ = eng.step(st, np.clip(np.full((1,), rho, np.float32),
                                           0.9, 2.7))
        admitted.append(max(1, int(batch * float(out.freq[0, 0]))))
    return admitted


@pytest.mark.parametrize("arch,batch", [
    ("zamba2-7b", 3), ("gemma-2b", 5), ("rwkv6-1.6b", 4), ("mixtral-8x7b", 3),
    ("deepseek-v2-236b", 2), ("chameleon-34b", 3), ("musicgen-large", 2)])
def test_wave_loop_admits_as_the_reference(arch, batch):
    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--fleet", "1",
            "--batch", str(batch), "--prompt-len", "16", "--gen", "3",
            "--waves", "3"]
    before = (flash_attention.launches, ssd.launches)
    res = serve.main(argv)
    assert (flash_attention.launches, ssd.launches) == before   # CPU: plain
    assert res["admitted"] == _ref_admissions(arch, batch, 16, 3, 3)
    assert set(res) == {"p50", "p99", "admitted", "prefill_ms"}
    assert len(res["prefill_ms"]) == 3
    assert math.isfinite(res["p50"]) and res["p99"] >= res["p50"] > 0


def test_wave_loop_fleet_telemetry(capsys):
    res = serve.main(["--arch", "gemma-2b", "--reduced", "--device", "cpu",
                      "--fleet", "16", "--batch", "2", "--prompt-len", "8",
                      "--gen", "2", "--waves", "2", "--seed", "3"])
    assert len(res["fleet"]) == 2
    assert all(np.isfinite(v) for d in res["fleet"] for v in d.values())
    out = capsys.readouterr().out
    assert "[fleet] wave 1: n=16" in out and "[serve] done:" in out
