"""What the benchmark may import, how its manifest is written, and that a
cell is found from files alone."""
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _modules_after(code: str) -> set[str]:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, check=True,
        env={"PYTHONPATH": f"{ROOT / 'src'}:{ROOT}", "PATH": "/usr/bin:/bin"})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_references_import_nothing_of_the_program():
    found = _modules_after(
        "import portbench.reference.fleet_v24, portbench.counts.fleet_step")
    assert not found & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


def test_a_run_loads_no_jax_and_the_names_compare_whole():
    """Everything a run loads, on the CPU path: the port (whose name begins
    with the JAX package's) and no module of the JAX stack or package."""
    code = ("import sys\nsys.path[:0] = ['portbench/tests']\n"
            "import _small\n_small.run('pkg47.stream', 3, 0.5)")
    found = _modules_after(code)
    assert "repro_torch" in found
    assert not found & {"repro", "jax", "jaxlib", "flax"}


def test_the_check_names_the_jax_package_and_not_the_port(monkeypatch):
    from portbench.harness import forbidden_modules
    monkeypatch.setitem(sys.modules, "repro_torch.fleet", sys)
    assert "repro_torch" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core.scheduler", sys)
    assert "repro" in forbidden_modules()


def test_the_manifest_keeps_to_its_alphabet():
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    names = [c["name"] for c in b["configs"]] + \
        [w["name"] for w in b["workloads"]] + \
        [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in b["workloads"]]:
        assert NAME.match(n), n
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for w in b["workloads"]:
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert len(w["why"]) <= 200
    for m in b["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file(), m["name"]
        assert any(e["name"] == m["moves"] for e in b["end_to_end"])
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])


def test_a_cell_is_found_from_files_alone(tmp_path):
    """A traffic file and a manifest entry dropped into a copy of the
    benchmark make a new cell, with no other file edited."""
    dst = tmp_path / "repo"
    shutil.copytree(BENCH, dst / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (dst / "src").symlink_to(ROOT / "src")
    traffic = json.loads((BENCH / "traffic" / "stream.json").read_text())
    traffic.update(packages=32, flush=16, trace_flushes=2,
                   swell=dict(lo=1.0, hi=2.5, period=128))
    (dst / "portbench" / "traffic" / "stream_small.json").write_text(
        json.dumps(traffic))
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    b["workloads"].append(dict(name="pkg47.stream_small", config="pkg47",
                               traffic="stream_small", chips=1, why="test"))
    for m in b["end_to_end"] + b["per_layer"]:
        if "pkg47.stream" in m.get("workloads", []):
            m["workloads"].append("pkg47.stream_small")
    (dst / "BENCHMARK.json").write_text(json.dumps(b))
    code = ("import sys, time, json\nfrom pathlib import Path\n"
            "from portbench import harness\n"
            "r = harness.run(Path('.'), 'pkg47.stream_small', 4, 0.5, False, "
            "time.perf_counter(), device='cpu')\nprint(json.dumps(r))")
    out = subprocess.run([sys.executable, "-c", code], cwd=dst,
                         capture_output=True, text=True, check=True,
                         env={"PYTHONPATH": f"{dst / 'src'}:{dst}",
                              "PATH": "/usr/bin:/bin"})
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["metrics"]["pkg_steps_per_s"]["value"] > 0


def test_no_card_no_result():
    """Without a card the command exits non-zero and prints no result."""
    pytest.importorskip("torch")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "pkg47.stream", "--seed", "3", "--seconds", "1"],
                         cwd=ROOT, capture_output=True, text=True,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_without_the_program_no_result(tmp_path):
    """A directory holding only the manifest and the benchmark's files
    cannot produce a result."""
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "pkg47.stream", "--seed", "3", "--seconds", "1"],
                         cwd=tmp_path, capture_output=True, text=True,
                         env={"PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
