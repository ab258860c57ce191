"""The port stands alone: no module of dddpm_tpu_torch, and not
chip_smoke.py, imports JAX, its libraries or the JAX package.  Checked
on the source's syntax tree (the interpreter may import jax at start-up,
so sys.modules cannot tell).  convert_jax_checkpoint.py at the repo root
is outside this check on purpose: it reads the JAX package's orbax
checkpoints, so it must import the JAX package; it is the one file of
the port that does, and the package never imports it."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "dddpm_tpu"}
FILES = sorted((ROOT / "dddpm_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_files_exist():
    assert len(FILES) > 15 and all(p.exists() for p in FILES)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"
