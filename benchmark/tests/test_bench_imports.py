"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program.  Names are compared whole by
their top level: dddpm_tpu_torch begins with dddpm_tpu."""
from __future__ import annotations

import ast
from pathlib import Path

import pytest

from benchmark.harness.spec import HERE

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "dddpm_tpu"}
MODULES = sorted(p for p in HERE.rglob("*.py"))


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_and_a_reference_of_its_own(path):
    names = top_level_imports(path)
    assert not names & FORBIDDEN, names & FORBIDDEN
    if "reference" in path.relative_to(HERE).parts:
        assert "dddpm_tpu_torch" not in names


def test_the_comparison_is_by_whole_names():
    assert "dddpm_tpu_torch".split(".")[0] not in FORBIDDEN
