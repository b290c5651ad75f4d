"""Each driver runs a tiny cell on the CPU through the port's plain route,
and the harness's command refuses what it must refuse."""

from __future__ import annotations

import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import pytest

from benchmark import harness
from benchmark.tests import tiny

REQUIRED = {"correct", "attempted", "failed", "metrics", "device"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.scratch(tmp_path_factory.mktemp("bench"))


def last_line(result: dict) -> dict:
    buf = io.StringIO()
    with redirect_stdout(buf):
        harness.report(result)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
@pytest.mark.parametrize("trace", [0, 1])
def test_driver_runs_tiny_cell(root, cell, trace):
    out = last_line(harness.execute(root, cell, 2 ** 31 + 11, 0.6,
                                    bool(trace), "cpu"))
    extra = {"checks"} | ({"breakdown"} if trace else set())
    assert set(out) == REQUIRED | extra
    assert list(out)[-1] == "checks"
    assert out["correct"] is True
    assert out["attempted"] >= 1 and out["failed"] == 0
    spec = json.loads((root / "BENCHMARK.json").read_text())
    if trace:
        want = {m["name"] for m in spec["per_layer"]
                if cell in m.get("workloads", [])}
        assert set(out["metrics"]) <= want
        assert "busy_s" in out["device"] and "window_s" in out["device"]
    else:
        want = {m["name"] for m in spec["end_to_end"]
                if cell in m.get("workloads", [cell])}
        assert set(out["metrics"]) == want
        assert all(v["value"] > 0 for v in out["metrics"].values())
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}


def run_cli(*args, cwd=tiny.REPO, env=None):
    return subprocess.run([sys.executable, "-m", "benchmark.run", *args],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=120, env=env)


def test_unknown_workload_fails():
    p = run_cli("--workload", "no-such-cell", "--seed", "1", "--seconds",
                "1")
    assert p.returncode != 0
    assert "no-such-cell" in p.stderr
    assert not p.stdout.strip()


def test_no_card_fails_without_falling_back():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    p = run_cli("--workload", "srnnpt-gen-b128", "--seed", "1",
                "--seconds", "1")
    assert p.returncode != 0
    assert "CUDA" in p.stderr
    assert not p.stdout.strip()


def test_alone_in_a_directory_fails(tmp_path):
    """Only BENCHMARK.json and the benchmark's folder: no program to run."""
    import shutil
    shutil.copytree(tiny.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(tiny.REPO / "BENCHMARK.json", tmp_path)
    code = ("import sys; sys.path[:0] = ['.']; "
            "from benchmark import harness; "
            "harness.execute('.', 'srnnpt-gen-b128', 1, 0.1, False, 'cpu')")
    env = dict(os.environ, PYTHONPATH="")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120, env=env)
    assert p.returncode != 0
    assert "samplernn_pase_tpu_torch" in p.stderr
    assert not p.stdout.strip()


def _import_check(modules: list[str], banned: tuple) -> str:
    return (
        "import importlib, sys\n"
        f"sys.path.insert(0, {str(tiny.REPO)!r})\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "from benchmark import harness\n"
        "from pathlib import Path\n"
        "for f in sorted(Path(harness.HERE, 'metrics').glob('*.py')):\n"
        "    harness.load_module(f, 'm_' + f.stem.replace('.', '_'))\n"
        "for f in sorted(Path(harness.HERE, 'drivers').glob('*.py')):\n"
        "    harness.load_module(f, 'd_' + f.stem)\n"
        f"bad = sorted({{m.split('.')[0] for m in sys.modules}} & "
        f"set({banned!r}))\n"
        "print(','.join(bad))\n")


def test_no_jax_in_harness_drivers_and_reference():
    mods = ["benchmark.harness", "benchmark.run", "benchmark.control",
            "benchmark.generator", "benchmark.weights", "benchmark.flops",
            "benchmark.readers", "benchmark.reference.samplernn",
            "benchmark.reference.check", "benchmark.reference.train",
            "samplernn_pase_tpu_torch.generate",
            "samplernn_pase_tpu_torch.serve",
            "samplernn_pase_tpu_torch.train.trainer",
            "samplernn_pase_tpu_torch.data.dataset"]
    p = subprocess.run([sys.executable, "-c", _import_check(
        mods, harness.FORBIDDEN)], capture_output=True, text=True,
        timeout=120, cwd="/")
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == ""


def test_reference_loads_nothing_of_the_port():
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(tiny.REPO)!r})\n"
        "import benchmark.reference.samplernn, benchmark.reference.check\n"
        "import benchmark.reference.train, benchmark.reference.philox\n"
        "import benchmark.reference.mulaw\n"
        "top = {m.split('.')[0] for m in sys.modules}\n"
        "print(sorted(top & {'jax', 'jaxlib', 'flax', 'samplernn_pase_tpu',"
        " 'samplernn_pase_tpu_torch'}))\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd="/")
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"


def test_forbidden_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "samplernn_pase_tpu_torch_x", sys)
    assert "samplernn_pase_tpu_torch_x" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax"]


def test_cell_files_exist_for_every_entry():
    spec = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
    for w in spec["workloads"]:
        cell = harness.Cell(tiny.REPO, w["name"])
        assert (cell.dir / "drivers"
                / f"{cell.traffic['driver']}.py").is_file()
        assert cell.end_to_end and cell.per_layer
    for m in spec["per_layer"]:
        assert Path(tiny.BENCH, "metrics", f"{m['name']}.py").is_file()
