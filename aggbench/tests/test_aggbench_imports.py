"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program. Names are compared by whole
top-level name: ``sda_tpu_torch`` is the program, ``sda_tpu`` the JAX
package."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
SOURCES = sorted(HERE.rglob("*.py"))


def _top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _local_imports(path: Path) -> set:
    """The benchmark's own modules that ``path`` imports."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.ImportFrom):
            if node.level == 1:
                base = node.module or ""
                out |= ({f"{base}"} if base else
                        {a.name for a in node.names})
            elif node.module and node.module.split(".")[0] == "aggbench":
                parts = node.module.split(".")[1:]
                out |= ({parts[0]} if parts else {a.name for a in node.names})
    return out


def test_sources_are_found():
    names = {p.name for p in SOURCES}
    assert {"run.py", "reference.py", "inputs.py", "traceparse.py",
            "bounds.py", "cell.py"} <= names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_module_imports_jax_or_the_jax_package(path):
    found = _top_level_imports(path) & {"jax", "jaxlib", "flax", "sda_tpu"}
    assert not found, f"{path} imports {found}"


def test_reference_imports_nothing_of_the_program():
    seen, todo = set(), ["reference"]
    while todo:
        name = todo.pop()
        if name in seen:
            continue
        seen.add(name)
        path = HERE / f"{name}.py"
        assert "sda_tpu_torch" not in _top_level_imports(path), path
        todo += sorted(_local_imports(path))
    assert seen == {"reference", "inputs"}
