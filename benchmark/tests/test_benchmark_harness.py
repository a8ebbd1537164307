"""The harness on the CPU: the contract's shape of BENCHMARK.json, cells added
from files alone, the isolation from JAX and the JAX package, and a run that
drives each driver end to end at a tiny size."""

from __future__ import annotations

import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from bench_tiny import ROOT, bench, execute, tree

from benchmark.core import isolation, program, spec

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_top_level_names_are_compared_whole():
    names = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "condmdi_tpu.ops",
             "condmdi_tpu_torch", "condmdi_tpu_torch.ops.resblock", "jaxtyping", "flaxen"]
    assert isolation.forbidden_modules(names) == ["condmdi_tpu", "flax", "jax", "jaxlib"]
    assert isolation.forbidden_modules(["condmdi_tpu_torch.models", "torch", "numpy"]) == []


def _imports(path: Path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_reference_imports_nothing_of_the_program_or_jax():
    bad = {"jax", "jaxlib", "flax", "condmdi_tpu", "condmdi_tpu_torch"}
    for path in sorted((ROOT / "benchmark" / "reference").glob("*.py")):
        assert not (_imports(path) & bad), path
    code = ("import sys; sys.path.insert(0, %r); import benchmark.reference.unet, "
            "benchmark.reference.mdm, benchmark.reference.train, benchmark.reference.diffusion; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & %r))" % (str(ROOT), bad))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_no_source_of_the_harness_imports_jax():
    bad = {"jax", "jaxlib", "flax", "condmdi_tpu"}
    for path in sorted((ROOT / "benchmark").rglob("*.py")):
        assert not (_imports(path) & bad), path


def test_a_run_loads_no_jax(tmp_path):
    """A whole run of a tiny cell in a fresh process: nothing it imported has the
    top-level name jax, jaxlib, flax or condmdi_tpu."""
    root = tree(tmp_path)
    code = (
        "import sys; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
        "from bench_tiny import execute\n"
        "from benchmark.core.isolation import forbidden_modules\n"
        "r = execute(__import__('pathlib').Path(%r), 'tiny.serve_kf')\n"
        "print(r['correct'], forbidden_modules())\n"
    ) % (str(ROOT), str(ROOT / "benchmark" / "tests"), str(root))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env={"JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin",
                                           "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "True []"


def test_benchmark_json_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"][:2] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("benchmark/")
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and m["better"] in ("lower", "higher")
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file()
    names = [w["name"] for w in BENCH["workloads"]]
    assert len(set(names)) == len(names)
    for w in BENCH["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4) and len(w["why"]) <= 200
        cell = spec.load_cell(BENCH, w["name"])
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer, w["name"]
        for m in cell.per_layer:
            assert m["moves"] in reported, (w["name"], m["name"])
        spec.driver(cell.traffic["driver"])
        reference = program.reference_module(cell.config)
        assert callable(reference.Model) and callable(reference.forward_flops)


def test_an_unknown_reference_is_refused():
    """A configuration names its reference module; one that does not exist stops the
    run instead of being counted or checked as another model."""
    from benchmark.counts import models

    with pytest.raises(ModuleNotFoundError):
        models.forward({"reference": "no_such_model"}, 1, 1)
    with pytest.raises(ModuleNotFoundError):
        program.reference_module({"reference": "no_such_model"})


def test_a_cell_comes_from_new_files_alone(tmp_path):
    """The tiny cells are new configuration and traffic files and new entries:
    every file of the committed benchmark is the same, byte for byte, and the
    run finds them by name."""
    root = tree(tmp_path)
    for path in (ROOT / "benchmark").rglob("*"):
        if path.is_file() and "__pycache__" not in path.parts:
            assert (root / path.relative_to(ROOT / "benchmark")).read_bytes() == path.read_bytes()
    result = execute(root, "tiny.serve_kf")
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"latency_p90_s", "setup_s"}
    assert result["attempted"] == 6 and result["failed"] == 0


@pytest.mark.parametrize("cell", ["tiny.serve_text", "tiny.offline", "tiny.train"])
def test_each_driver_runs_a_tiny_cell_correctly(tmp_path, cell):
    result = execute(tree(tmp_path), cell)
    assert result["correct"], result["checks"]
    e2e = {m["name"] for m in bench()["end_to_end"] if cell in m.get("workloads", [cell])}
    assert set(result["metrics"]) == e2e
    assert all(v["value"] > 0 for v in result["metrics"].values())
