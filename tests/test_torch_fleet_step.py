"""PyTorch port, `fleet_step`: the plain version against the JAX Pallas kernel
(interpret mode) on the CPU, and the wrapper's contract.  The CUDA kernel
itself is held against the plain version in tests/test_torch_cuda.py."""
import ctypes
import dataclasses
import re
import types
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import numpy as np

from torch_parity import TOL, np_

from repro.core.scheduler import SchedulerConfig as JCfg
from repro.core.scheduler import ThermalScheduler as JSched
from repro.fleet.backends.fused import FusedBackend as JFused
from repro.kernels.fleet_step import fleet_step as j_fleet_step

from repro_torch.core.pdu_gate import exact_stats
from repro_torch.kernels import _build
from repro_torch.kernels import fleet_step as tfs

jax.config.update("jax_platform_name", "cpu")

MODES = ["v24", "reactive", "reactive_poll", "off"]
# (tiles, packages, T): T spans at least two W = 16 windows plus a partial
SHAPES = [(4, 16, 40), (4, 200, 36), (47, 8, 34)]


def _case(mode, nt, n, t, seed=0):
    """Reference params + the same numpy inputs for both kernels."""
    sched = JSched(JCfg(n_tiles=nt, mode=mode))
    jparams = JFused(sched).params
    w, np_poles = jparams.window, jparams.n_poles
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.array(a, np.float32)          # owned, C-ordered
    buf0 = f32(rng.uniform(0.9, 2.7, (w, nt, n)))
    inputs = dict(
        rho=f32(rng.uniform(0.9, 2.7, (t, nt, n))),
        buf0=buf0,
        th0=f32(rng.uniform(5.0, 25.0, (np_poles, nt, n))),
        stats0=f32(torch.stack(exact_stats(torch.from_numpy(buf0), 0,
                                           axis=0)).numpy()),
        freq0=f32(rng.uniform(0.5, 1.0, (nt, n))),
        ev0=np.zeros((1, n), np.float32),
        gamma=None if sched.gamma is None else f32(sched.gamma),
    )
    thr0 = (f32(rng.integers(0, 2, (nt, n))) if mode == "reactive_poll"
            else None)
    ported = {f.name for f in dataclasses.fields(tfs.FleetStepParams)}
    tparams = tfs.FleetStepParams(**{
        k: v for k, v in dataclasses.asdict(jparams).items() if k in ported})
    return jparams, tparams, inputs, thr0


def _torch_inputs(inputs, device="cpu"):
    return {k: None if v is None else torch.from_numpy(v).to(device)
            for k, v in inputs.items()}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("nt,n,t", SHAPES)
def test_plain_fleet_step_matches_pallas_kernel(mode, nt, n, t):
    """Plain version vs the reference kernel in interpret mode: traces and
    state within 1e-5, events and the reactive_poll latch exact."""
    jparams, tparams, inputs, thr0 = _case(mode, nt, n, t)
    ref = j_fleet_step(*inputs.values(), jparams, thr0=thr0, step0=7,
                       interpret=True)
    out = tfs.fleet_step_reference(
        *_torch_inputs(inputs).values(), tparams,
        thr0=None if thr0 is None else torch.from_numpy(thr0), step0=7)
    names = ("temps", "freqs", "buf", "th")
    for name, a, b in zip(names, out[:4], ref[:4]):
        np.testing.assert_allclose(np_(a), np.asarray(b), err_msg=name, **TOL)
    np.testing.assert_array_equal(np_(out[4]), np.asarray(ref[4]))
    if thr0 is None:
        assert out[5] is None and ref[5] is None
    else:
        np.testing.assert_array_equal(np_(out[5]), np.asarray(ref[5]))
    assert out[6] is None


def test_fleet_step_on_cpu_is_the_plain_version_and_launches_nothing():
    _, tparams, inputs, _ = _case("v24", 4, 12, 20)
    before = tfs.fleet_step.launches
    a = tfs.fleet_step(*_torch_inputs(inputs).values(), tparams)
    b = tfs.fleet_step_reference(*_torch_inputs(inputs).values(), tparams)
    assert tfs.fleet_step.launches == before
    for x, y in zip(a, b):
        assert (x is None and y is None) or torch.equal(x, y)


def test_fleet_step_wrapper_validates_inputs():
    _, tparams, inputs, _ = _case("v24", 4, 12, 20)
    t = _torch_inputs(inputs)
    bad = dict(t, rho=t["rho"].double())
    with pytest.raises(TypeError, match="float32"):
        tfs.fleet_step(*bad.values(), tparams)
    bad = dict(t, freq0=t["freq0"][:, :5])
    with pytest.raises(ValueError, match="freq0"):
        tfs.fleet_step(*bad.values(), tparams)
    bad = dict(t, buf0=t["buf0"].transpose(1, 2).contiguous()
               .transpose(1, 2))
    with pytest.raises(ValueError, match="contiguous"):
        tfs.fleet_step(*bad.values(), tparams)
    with pytest.raises(ValueError, match="thr0"):
        tfs.fleet_step(*t.values(), tparams, thr0=t["freq0"])
    with pytest.raises(ValueError, match="empty"):
        tfs.fleet_step(*dict(t, rho=t["rho"][:0]).values(), tparams)


@pytest.mark.parametrize("kw", [dict(het=True), dict(fb0=True),
                                dict(mode0=True)])
def test_fleet_step_unported_planes_raise(kw):
    _, tparams, inputs, _ = _case("v24", 4, 8, 4)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 step 5"):
        tfs.fleet_step(*_torch_inputs(inputs).values(), tparams, **kw)


def test_consts_struct_mirrors_cuda_source():
    """The ctypes struct and `struct FleetStepConsts` in csrc/fleet_step.cu
    list the same fields in the same order (all 4-byte, no padding)."""
    src = (_build.CSRC / "fleet_step.cu").read_text()
    body = re.search(r"struct FleetStepConsts \{(.*?)\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names = []
    for decl in body.split(";"):
        decl = decl.strip()
        if not decl:
            continue
        for name in decl.split(None, 1)[1].split(","):
            names.append(re.sub(r"\[.*\]", "", name).strip())
    assert names == [f for f, _ in tfs._Consts._fields_]
    n_fields = sum(getattr(ty, "_length_", 1) for _, ty in tfs._Consts._fields_)
    assert ctypes.sizeof(tfs._Consts) == 4 * n_fields


def test_build_is_keyed_by_source_and_needs_nvcc(monkeypatch):
    path = _build.library_path("fleet_step")
    assert path.parent == _build.BUILD_DIR
    assert _build.BUILD_DIR == (Path(__file__).resolve().parents[1]
                                / "build" / "repro_torch")
    assert path.name.startswith("fleet_step-") and path.suffix == ".so"
    assert "-fmad=false" in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert not any("fast_math" in f for f in _build.NVCC_FLAGS)
    monkeypatch.setenv("PATH", "")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


def test_installed_package_builds_into_user_cache(monkeypatch, tmp_path):
    """Outside a checkout the library goes to the per-user cache, never
    beside the installed package."""
    site = tmp_path / "lib" / "python3" / "site-packages"
    monkeypatch.setattr(_build, "__file__",
                        str(site / "repro_torch" / "kernels" / "_build.py"))
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    assert _build._build_dir() == tmp_path / "cache" / "repro_torch" / "build"


def test_resource_usage_reads_the_ptxas_report(monkeypatch, tmp_path):
    """The build keeps nvcc's -Xptxas -v report beside the library, and
    `resource_usage` reads each kernel's registers and spills from it."""
    assert ("-Xptxas", "-v") == _build.NVCC_FLAGS[-2:]
    lib = tmp_path / "fleet_step-0.so"
    lib.write_bytes(b"")
    lib.with_suffix(".log").write_text(
        "ptxas info    : 0 bytes gmem\n"
        "ptxas info    : Compiling entry function '_Z1kILi2ELb1EEv' for "
        "'sm_90a'\n"
        "ptxas info    : Function properties for _Z1kILi2ELb1EEv\n"
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads\n"
        "ptxas info    : Used 74 registers, used 1 barriers\n"
        "ptxas info    : Compiling entry function '_Z1kILi1ELb0EEv' for "
        "'sm_90a'\n"
        "ptxas info    : Used 40 registers\n")
    monkeypatch.setattr(_build, "build", lambda name: lib)
    assert _build.resource_usage("fleet_step") == {
        "_Z1kILi2ELb1EEv": {"registers": 74, "spill_stores": 8,
                            "spill_loads": 4},
        "_Z1kILi1ELb0EEv": {"registers": 40, "spill_stores": 0,
                            "spill_loads": 0}}


def test_failed_build_raises_with_the_compiler_output(monkeypatch, tmp_path):
    """A source nvcc refuses raises with nvcc's output and leaves no library
    (nor its temporary file) in the build directory."""
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "run", lambda cmd, **kw:
                        types.SimpleNamespace(returncode=1,
                                              stdout="error: boom"))
    with pytest.raises(RuntimeError, match="nvcc failed for k.cu:\nerror: boom"):
        _build.compile_source(tmp_path / "k.cu", tmp_path / "k.so")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc failed for fleet_step.cu"):
        _build.build("fleet_step")
    assert list((tmp_path / "build").iterdir()) == []


def test_loaded_from_swaps_the_library_within_the_block(monkeypatch,
                                                         tmp_path):
    """Inside `loaded_from`, `load` (and so the kernel's wrapper) gives the
    other build; after the block, raised out of or not, the checkout's."""
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: ("lib", path))
    monkeypatch.setattr(_build, "_LOADED", {"grid_conv": "checkout's"})
    other = tmp_path / "grid_conv.so"
    with _build.loaded_from("grid_conv", other):
        assert _build.load("grid_conv") == ("lib", str(other))
    assert _build.load("grid_conv") == "checkout's"
    with pytest.raises(KeyError):
        with _build.loaded_from("fleet_step", other):
            raise KeyError("in the block")
    assert "fleet_step" not in _build._LOADED
