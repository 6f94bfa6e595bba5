"""The import guard: nothing the benchmark runs loads JAX or the JAX
package (top-level module names compared whole), and the reference imports
nothing of the port; the harness refuses to run without a card."""

import ast
import json
import shutil
import subprocess
import sys

import pytest

from benchmark import run
from benchmark.tests.helpers import ROOT

JAX_SIDE = {"jax", "jaxlib", "flax", "tissue_image_processing_tpu"}
PORT = "tissue_image_processing_tpu_torch"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def test_forbidden_names_are_compared_whole():
    assert run.forbidden_modules(["jax.numpy", "numpy"]) == ["jax"]
    assert run.forbidden_modules(["tissue_image_processing_tpu.ops"]) == [
        "tissue_image_processing_tpu"]
    assert run.forbidden_modules([f"{PORT}.core.pipeline", "flaxen"]) == []


@pytest.mark.parametrize("path", sorted((ROOT / "benchmark").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_file_imports_the_jax_side(path):
    found = set(_imports(path))
    assert not found & JAX_SIDE, found
    if "reference" in path.parts:
        assert PORT not in found


def test_the_benchmark_reads_none_of_the_jax_benchmark_files():
    for path in (ROOT / "benchmark").rglob("*.py"):
        if "tests" in path.parts:
            continue
        text = path.read_text()
        for name in ("bench.py", "chip_smoke", "BENCH_", "MULTICHIP_",
                     "BASELINE"):
            assert name not in text, (path, name)


def test_a_run_loads_nothing_of_the_jax_side():
    code = ("import benchmark.run as r, benchmark.programs.movie_pipeline, "
            "benchmark.reference.pipeline, benchmark.readings; "
            f"import {PORT}.core.pipeline, {PORT}.models.predictor; "
            "print(r.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_no_card_no_result(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = run.main(["--workload", "ws_raw_2000", "--seed", "1", "--seconds",
                   "1", "--trace", "0"])
    assert rc != 0
    assert "{" not in capsys.readouterr().out


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cmd = json.loads((ROOT / "BENCHMARK.json").read_text())["command"]
    out = subprocess.run(cmd + ["--workload", "ws_raw_2000", "--seed", "1",
                                "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True)
    assert out.returncode != 0
    assert not out.stdout.strip().splitlines()[-1:] or \
        not out.stdout.strip().splitlines()[-1].startswith("{")
