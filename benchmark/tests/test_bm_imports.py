"""What the benchmark may import: nothing of JAX or the JAX package
anywhere under `benchmark/`, and nothing of the port in the reference."""

from __future__ import annotations

import ast
import subprocess
import sys

import pytest

from benchmark.run import FORBIDDEN, ROOT
from benchmark.tests._tiny import BENCH

SOURCES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)
REFERENCE = sorted((BENCH / "reference").glob("*.py"))


def imported_tops(path) -> set:
    """Top-level names of every module ``path`` imports (whole names)."""
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_or_jax_package(path):
    assert not imported_tops(path) & set(FORBIDDEN)


def test_whole_name_is_compared():
    # the port's name begins with the JAX package's and must not match it
    assert "depthg_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "depthg_tpu" in FORBIDDEN


@pytest.mark.parametrize("path", REFERENCE, ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "depthg_tpu_torch" not in imported_tops(path)


def test_reference_loads_no_port_module():
    code = ("import sys, benchmark.reference.eval, benchmark.reference.train, "
            "benchmark.reference.control; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'depthg_tpu_torch', 'depthg_tpu', 'jax', 'jaxlib', 'flax', 'optax', 'orbax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True).stdout.strip()
    assert out == "[]"


def test_a_run_loads_nothing_forbidden_on_the_cpu_path():
    """The drivers and the port they import load no JAX module."""
    code = ("import sys, benchmark.run as r; "
            "r.load_module(r.BENCH_DIR / 'drivers' / 'eval.py', 'd1'); "
            "r.load_module(r.BENCH_DIR / 'drivers' / 'train.py', 'd2'); "
            "import depthg_tpu_torch.inference, depthg_tpu_torch.train.step; "
            "print(r.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, check=True).stdout.strip()
    assert out == "[]"
