"""No process of the benchmark loads JAX or the JAX package, the references
load nothing of the program, and a run without a card fails at once."""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark.harness import cells, guard

ROOT = cells.ROOT


def test_guard_compares_top_level_names_whole():
    assert guard.forbidden_loaded({"gf2bv_tpu_torch": 1, "gf2bv_tpu_torch.ops": 1}) == []
    assert guard.forbidden_loaded({"gf2bv_tpu.ops.x": 1, "numpy": 1}) == ["gf2bv_tpu"]
    assert guard.forbidden_loaded({"jaxlib.xla_client": 1, "jax": 1, "flax": 1}) == [
        "flax", "jax", "jaxlib"]
    assert guard.forbidden_loaded({"jax_foo": 1, "jaxlibs": 1}) == []


def _python(code: str, **env) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300, env={**os.environ, **env})


def test_the_harness_and_the_program_load_no_jax():
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from benchmark.harness import cells, core, guard\n"
        "b = cells.load_benchmark()\n"
        "cs = [cells.resolve(b, w['name']) for w in b['workloads']]\n"
        "import gf2bv_tpu_torch, gf2bv_tpu_torch.crypto.mt_torch, gf2bv_tpu_torch.crypto.sfmt\n"
        "import gf2bv_tpu_torch.core.capture, gf2bv_tpu_torch.utils.profiling\n"
        "print(guard.forbidden_loaded())\n"
    )
    res = _python(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "[]"


def test_the_references_load_nothing_of_the_program():
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from benchmark.harness import cells\n"
        "for name in ('mt19937', 'sfmt19937'):\n"
        "    cells.load_module('reference', name)\n"
        "print(sorted({m.split('.')[0] for m in sys.modules if m.startswith('gf2bv')}))\n"
    )
    res = _python(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("path", sorted((cells.BENCH_DIR / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_are_plain(path):
    allowed = {"__future__", "dataclasses", "random", "numpy", "math", "typing"}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert n.split(".")[0] in allowed, f"{path.name} imports {n}"


def _no_result(stdout: str) -> bool:
    for line in stdout.strip().splitlines()[-1:]:
        try:
            return not isinstance(json.loads(line), dict)
        except ValueError:
            return True
    return True


def test_run_without_a_card_fails_at_once():
    res = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "mt19937_bs32.single624",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0
    assert _no_result(res.stdout)
    assert "CUDA device" in res.stderr


@pytest.mark.cuda
def test_run_with_only_the_benchmark_files_fails(tmp_path):
    """On the card: a checkout of BENCHMARK.json and benchmark/ alone has no
    program to run, and the run fails with no result."""
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "mt19937_bs32.single624",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and _no_result(res.stdout)
