"""The import check compares whole top-level names, the reference imports
nothing of the program, and a run needs the card."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

from perfbench import importcheck

PERFBENCH = Path(__file__).resolve().parent.parent
CHECKOUT = PERFBENCH.parent


def test_whole_top_level_names():
    assert importcheck.forbidden(["flowgen_torch", "flowgen_torch.ops.scene",
                                  "jaxtyping", "flaxen", "perfbench"]) == []
    assert importcheck.forbidden(["flowgen.x", "jax", "jaxlib.xla_client",
                                  "flax.linen", "flowgen"]) == [
        "flax.linen", "flowgen", "flowgen.x", "jax", "jaxlib.xla_client"]


def test_reference_sources_import_nothing_of_the_program():
    for path in (PERFBENCH / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] in ("torch", "numpy", "math", "typing",
                                           "dataclasses", "enum",
                                           "__future__"), (path.name, n)


def test_reference_loads_nothing_of_the_program_in_a_fresh_process():
    code = ("import sys; import perfbench.reference as r; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'flowgen_torch', 'flowgen', 'jax', 'jaxlib', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=CHECKOUT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _run(cwd, env=None, timeout=300):
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "chairs_m7.trainer",
         "--seed", "2147483999", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=timeout,
        env=env)


def test_run_fails_without_a_card_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _run(CHECKOUT, env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "torch.cuda.is_available() is false" in out.stderr


def test_run_fails_with_the_benchmark_files_alone(tmp_path):
    shutil.copytree(PERFBENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(CHECKOUT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    assert bench["paths"] == ["perfbench"]
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "No module named 'flowgen_torch'" in out.stderr
