"""Nothing under portbench/ imports JAX or the JAX package, and the
references import nothing of the program; top-level names are compared
whole (the port's name starts with the JAX package's)."""
import ast
from pathlib import Path

import pytest

from portbench import harness

_HERE = Path(harness.__file__).resolve().parent


def _top_imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


SOURCES = sorted(_HERE.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(_HERE)))
def test_no_jax_nor_the_jax_package(path):
    assert not _top_imports(path) & harness.FORBIDDEN


@pytest.mark.parametrize("path", sorted((_HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not _top_imports(path) & {"repro_torch", "repro", "jax"}


@pytest.mark.parametrize("loaded,found", [
    (["repro_torch", "repro_torch.core", "torch"], []),
    (["repro", "repro.core"], ["repro"]),
    (["jax.numpy", "jaxlib", "flax"], ["flax", "jax", "jaxlib"]),
    (["jaxtyping", "reprolib", "flaxen"], []),
])
def test_forbidden_compares_whole_names(monkeypatch, loaded, found):
    import sys
    fake = {name: object() for name in loaded}
    monkeypatch.setattr(sys, "modules", fake)
    assert harness.forbidden_loaded() == found
