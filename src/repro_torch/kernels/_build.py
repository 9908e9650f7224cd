"""Build the port's CUDA kernel at first use and bind it with ctypes.

``csrc/<name>.cu`` exports a plain C interface and compiles with one
``nvcc`` call into ``<name>-<hash>.so``; the hash covers the source and the
flags, so an edited kernel rebuilds and an unchanged one loads from disk.
The compiler's report (``-Xptxas -v``: registers, spills and stack of each
kernel) is kept beside the library as ``<name>-<hash>.log`` and read back by
`resource_usage`.
The library goes to ``build/repro_torch/`` of the checkout (git-ignored)
when the package runs from one, else to a per-user cache
(``$XDG_CACHE_HOME`` or ``~/.cache``, under ``repro_torch/``).  Nothing here
runs when a module is imported — the CPU-only test environment has no
``nvcc``.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"


def _build_dir() -> Path:
    """``build/repro_torch`` of the checkout (src/ layout), else a per-user
    cache: an installed package never writes beside site-packages."""
    root = Path(__file__).resolve().parents[3]
    if (root / "pyproject.toml").is_file() and (root / "src" / "repro_torch"
                                                 ).is_dir():
        return root / "build" / "repro_torch"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "repro_torch" / "build"


BUILD_DIR = _build_dir()

# sm_90a: Hopper with its arch-specific instructions.  No --use_fast_math:
# the kernels are held to the reference within 1e-5 with exact event counts.
# -fmad=false: each elementwise multiply and add rounds on its own, as the
# plain PyTorch version's separate ops do; the kernel writes fmaf exactly
# where the plain version fuses (repro_torch.fma_f32).  -Xptxas -v: the
# resource report `resource_usage` reads.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas", "-v")

_LOADED: dict[str, ctypes.CDLL] = {}
# nvcc builds and library loads since the process started: the resident
# service's gate (after its warmup, no tick, surgery or restore builds or
# loads a kernel library) reads these
COUNTS = {"builds": 0, "loads": 0}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", "") + "/bin/nvcc",
                 shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "build from source at first use")


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def compile_source(src: Path, out: Path) -> str:
    """``src`` compiled with `NVCC_FLAGS` into the library ``out``; returns
    the compiler's report (``-Xptxas -v``).  Raises with the compiler's
    output if the build fails."""
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(out), str(src)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src.name}:\n{proc.stdout}")
    return proc.stdout


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already on disk.

    Raises with the compiler's output if the build fails.  The library is
    written to a temporary name and renamed into place, so concurrent
    builders never load a half-written file; the compiler's report goes to
    the library's ``.log`` first.
    """
    out = library_path(name)
    if out.exists() and out.with_suffix(".log").exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    COUNTS["builds"] += 1
    try:
        report = compile_source(CSRC / f"{name}.cu", Path(tmp))
    except RuntimeError:
        os.unlink(tmp)
        raise
    out.with_suffix(".log").write_text(report)
    os.replace(tmp, out)
    return out


def resource_usage(name: str) -> dict[str, dict[str, int]]:
    """Registers and spill bytes of each kernel in ``<name>``'s library, by
    mangled kernel name, from the compiler's ``-Xptxas -v`` report (the
    library is built first if needed)."""
    text = build(name).with_suffix(".log").read_text()
    usage: dict[str, dict[str, int]] = {}
    kernel = None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            kernel = m.group(1)
            usage[kernel] = {"registers": 0, "spill_stores": 0,
                             "spill_loads": 0}
            continue
        if kernel is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            usage[kernel]["spill_stores"] = int(m.group(1))
            usage[kernel]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            usage[kernel]["registers"] = int(m.group(1))
    return usage


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built if needed and loaded once."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = _LOADED[name] = ctypes.CDLL(str(build(name)))
        COUNTS["loads"] += 1
    return lib


@contextlib.contextmanager
def loaded_from(name: str, path: Path):
    """Within the block, `load(name)` — and so the kernel's wrapper — gives
    the library at ``path``, another build of ``csrc/<name>.cu``'s C
    interface (`compile_source`), instead of the checkout's."""
    saved = _LOADED.get(name)
    _LOADED[name] = ctypes.CDLL(str(path))
    try:
        yield
    finally:
        if saved is None:
            _LOADED.pop(name, None)
        else:
            _LOADED[name] = saved
