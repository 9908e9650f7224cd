"""PyTorch port, packaging rules: the port and chip_smoke.py import neither
JAX nor the JAX package, and chip_smoke.py refuses to run without a card or
outside a checkout."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))


def _imported_modules(path: Path) -> set[str]:
    mods = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.add(node.module)
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            mods.add(node.args[0].value)
    return mods


@pytest.mark.parametrize("path", PORT_FILES + [
    ROOT / "chip_smoke.py", ROOT / "examples" / "torch_multi_tile_sim.py",
    ROOT / "scripts" / "kernel_ab.py",
    ROOT / "scripts" / "phase_ab.py",
    ROOT / "scripts" / "thermal_conv_limits.py",
    ROOT / "scripts" / "ssd_train_limits.py",
    ROOT / "scripts" / "flash_variants.py",
    ROOT / "scripts" / "ssd_bwd_code_size.py",
    ROOT / "scripts" / "collective_probe.py",
    ROOT / "scripts" / "train_loss_bits.py",
    ROOT / "examples" / "torch_broadcast_step.py",
    ROOT / "examples" / "torch_train_100m.py",
    ROOT / "examples" / "torch_fleet_sim.py",
    ROOT / "examples" / "torch_thermal_dashboard.py",
    ROOT / "examples" / "torch_quickstart.py",
    ROOT / "examples" / "torch_serve_batched.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_reference(path):
    bad = sorted(m for m in _imported_modules(path)
                 if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


KERNEL_MODULES = sorted(p for p in (ROOT / "src" / "repro_torch" / "kernels"
                                    ).glob("*.py") if p.name != "ops.py")


@pytest.mark.parametrize("path", KERNEL_MODULES, ids=lambda p: p.name)
def test_kernel_modules_know_nothing_of_the_mesh(path):
    """The kernel modules take plain tensors: the mesh's local route lives
    in the dispatcher (`kernels/ops.py`) and `distributed/sharding.py`."""
    mods = _imported_modules(path)
    assert not any(m.startswith(("repro_torch.distributed",
                                 "torch.distributed")) for m in mods), mods


def test_port_has_every_module_of_the_slice():
    names = {str(p.relative_to(ROOT / "src" / "repro_torch"))
             for p in PORT_FILES}
    for mod in ("core/fingerprint.py", "core/density.py", "core/coupling.py",
                "core/thermal.py", "core/pdu_gate.py", "core/plant.py",
                "core/scheduler.py", "configs/base.py",
                "kernels/fleet_step.py", "kernels/_build.py",
                "fleet/backends/base.py", "fleet/backends/broadcast.py",
                "fleet/backends/fused.py", "fleet/engine.py",
                "fleet/ingest.py", "launch/serve.py", "convert.py",
                "kernels/thermal_conv.py", "kernels/ops.py",
                "core/workload.py", "core/dvfs.py", "core/cpo.py",
                "core/hbm.py", "core/serdes.py", "core/dataset90k.py",
                "core/telemetry.py", "kernels/flash_attention.py",
                "kernels/ssm_scan.py", "kernels/ref.py", "models/layers.py",
                "models/attention.py", "models/ssm.py",
                "models/transformer.py", "launch/steps.py",
                "core/montecarlo.py", "core/guardband.py",
                "core/nodebank.py", "fleet/faults.py",
                "fleet/backends/vmap.py", "fleet/groups.py",
                "fleet/registry.py", "fleet/alerts.py", "fleet/service.py",
                "checkpoint/__init__.py", "checkpoint/manager.py",
                "distributed/__init__.py",
                "distributed/fault_tolerance.py", "optim/__init__.py",
                "optim/adamw.py", "data/__init__.py", "data/pipeline.py",
                "launch/train.py", "distributed/sharding.py",
                "fleet/backends/sharded.py",
                "fleet/backends/sharded_fused.py", "launch/mesh.py",
                "optim/compression.py"):
        assert mod in names, mod
    for src in ("fleet_step.cu", "thermal_conv.cu", "grid_conv.cu",
                "flash_attention.cu", "flash_attention_tc.cu", "ssd.cu",
                "fma_f32.cu", "flash_attention_bwd.cu",
                "flash_attention_bwd_tc.cu", "ssd_bwd.cu"):
        assert (ROOT / "src" / "repro_torch" / "kernels" / "csrc"
                / src).is_file(), src


def _run(cwd: Path) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, str(cwd / "chip_smoke.py")],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=120)


def test_chip_smoke_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("needs a host without CUDA")
    r = _run(ROOT)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "cuda" in (r.stdout + r.stderr).lower()


def test_chip_smoke_refuses_outside_a_checkout(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run(tmp_path)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_kernel_sources_use_pow_not_cbrt():
    """The law's 1/exponent power is pow, as in the reference (a cube-root
    special form rounds differently)."""
    for src in (ROOT / "src" / "repro_torch" / "kernels" / "csrc").glob("*.cu"):
        assert "cbrt" not in src.read_text().replace("never cbrt", ""), src


CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
# the sources allowed tensor-core instructions: the bf16 flash attention
# kernels, forward and backward (wgmma on bf16 operands), whose f32 twins
# (flash_attention.cu, flash_attention_bwd.cu) and every other kernel but
# the one below keep their products in f32 on the CUDA cores
TENSOR_CORE_SOURCES = ("flash_attention_tc.cu", "flash_attention_bwd_tc.cu")
# the split-precision tensor-core source: the ssd backward's f32 products
# as three TF32 products each (3×TF32, mma.sync), the only source allowed
# TF32
SPLIT_TF32_SOURCES = ("ssd_bwd.cu",)


@pytest.mark.parametrize("src", sorted(CSRC.glob("*.cu")),
                         ids=lambda p: p.name)
def test_kernel_sources_use_no_library_or_tensor_core_product(src):
    """No kernel calls a library (cuBLAS, cuDNN).  The bf16 flash sources
    issue wgmma products, as they must; the ssd backward issues TF32
    mma.sync products in the 3×TF32 split its header states, as it must;
    only it may name TF32.  Every other source computes in f32 on the CUDA
    cores: no wmma, mma.sync or wgmma."""
    text = src.read_text().lower().replace("no tf32", "")
    banned = ["cublas", "cudnn"]
    if src.name not in SPLIT_TF32_SOURCES:
        banned.append("tf32")
    if src.name not in TENSOR_CORE_SOURCES + SPLIT_TF32_SOURCES:
        banned += ["wmma", "mma.sync", "wgmma"]
    for word in banned:
        assert word not in text, (src.name, word)
    if src.name in TENSOR_CORE_SOURCES:
        assert "wgmma.mma_async" in text, src.name
    if src.name in SPLIT_TF32_SOURCES:
        assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in text
        assert "3×tf32" in text, src.name


def test_every_port_module_imports_first():
    """Each module of the port can be the first one a program imports: one
    interpreter enters them in turn, with ``repro_torch`` dropped from
    ``sys.modules`` before each, so an import cycle that only some orders
    survive shows."""
    src = ROOT / "src"
    mods = sorted(".".join(p.relative_to(src).with_suffix("").parts)
                  .removesuffix(".__init__") for p in PORT_FILES)
    script = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    for k in [k for k in sys.modules\n"
        "              if k == 'repro_torch' or k.startswith('repro_torch.')]:\n"
        "        del sys.modules[k]\n"
        "    try:\n"
        "        importlib.import_module(m)\n"
        "    except Exception as e:\n"
        "        print(m, type(e).__name__, e)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(src)
    r = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout == "", r.stdout
