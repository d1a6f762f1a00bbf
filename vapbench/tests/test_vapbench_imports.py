"""Nothing of the benchmark imports JAX or the JAX package, compared by
whole top-level names (so the port, whose name begins with the JAX
package's, passes), and the reference imports nothing of the port."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "voiceactivityprojection_tpu"}
PORT = "voiceactivityprojection_tpu_torch"


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value)


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=[str(p.relative_to(BENCH)) for p in SOURCES])
def test_no_module_imports_jax_or_the_jax_package(path):
    bad = sorted({m for m in _imports(path) if m.split(".")[0] in FORBIDDEN})
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")))
def test_the_reference_imports_nothing_of_the_port(path):
    bad = sorted({m for m in _imports(path) if m.split(".")[0] == PORT})
    assert not bad, f"{path} imports {bad}"


def test_the_check_compares_whole_top_level_names():
    names = ["voiceactivityprojection_tpu_torch.models.vap", "voiceactivityprojection_tpu.ops", "jax.numpy", "jaxtyping"]
    assert [n for n in names if n.split(".")[0] in FORBIDDEN] == ["voiceactivityprojection_tpu.ops", "jax.numpy"]
