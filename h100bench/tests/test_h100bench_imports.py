"""What the benchmark runs imports no JAX and no JAX package, compared by
whole top-level module names, and the reference imports nothing of the
program."""
from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "tgt_tpu"}


def _top_imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(*dirs):
    return sorted(p for d in dirs for p in Path(d).rglob("*.py")
                  if "tests" not in p.relative_to(ROOT).parts[1:])


@pytest.mark.parametrize("package", ["h100bench", "tgt_torch"])
def test_no_jax_in_sources(package):
    for path in _sources(ROOT / package):
        bad = FORBIDDEN & set(_top_imports(path))
        assert not bad, f"{path} imports {bad}"


def test_reference_imports_nothing_of_the_program():
    for path in _sources(HERE / "reference", HERE / "yardstick"):
        assert "tgt_torch" not in set(_top_imports(path)), path


def test_a_run_loads_no_jax():
    """A tiny CPU run of both cells, then the process's modules."""
    code = ("import sys; from h100bench.tests import tiny; "
            "tiny.run(tiny.TRAIN, seconds=0.5); tiny.run(tiny.SERVE, "
            "seconds=0.5); from h100bench import harness; "
            "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
