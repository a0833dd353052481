"""The run refuses a machine without the card, and nothing of the benchmark
loads JAX, flax or the JAX package; the reference loads nothing of the port."""
import ast
import subprocess
import sys

import pytest
from conftest import ROOT

from perf_bench import harness

FILES = sorted(p for p in harness.HERE.rglob("*.py") if "__pycache__" not in p.parts)


def test_run_without_a_card_prints_nothing_and_fails():
    out = subprocess.run([sys.executable, "perf_bench/run.py", "--workload", "cs_train",
                          "--seed", "3", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def _top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(harness.HERE)))
def test_no_module_imports_jax(path):
    assert not _top_level_imports(path) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("name", ["reference", "costs", "spec", "traffic_law"])
def test_the_yardstick_imports_nothing_of_the_port(name):
    path = harness.HERE / f"{name}.py"
    assert "autoregressive_diffusion_tpu_torch" not in _top_level_imports(path)
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); import perf_bench.{name}; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    loaded = out.stdout
    assert out.returncode == 0, out.stderr
    assert "autoregressive_diffusion_tpu" not in loaded


def test_forbidden_names_compare_whole():
    before = dict(sys.modules)
    try:
        sys.modules["jaxlike_pkg"] = sys
        sys.modules["autoregressive_diffusion_tpu_torch_x"] = sys
        assert "jax" not in harness.forbidden_modules()
        sys.modules["flax.core"] = sys
        assert "flax" in harness.forbidden_modules()
    finally:
        for k in set(sys.modules) - set(before):
            del sys.modules[k]
