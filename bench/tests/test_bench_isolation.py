"""No file of the benchmark imports JAX or the JAX package, and the plain
references import nothing of the program: each import's top-level name is
compared whole (the port's name begins with the JAX package's)."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported(path: Path) -> set:
    """Top-level names of every module `path` imports, at any depth of its
    code (functions included); a relative import of a sibling is ".", one
    from further up names the benchmark."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module.split(".")[0] if not node.level
                      else "." if node.level == 1 else "bench")
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


FILES = sorted(BENCH.rglob("*.py"))


def test_files_found():
    assert any(f.name == "run.py" for f in FILES)
    assert any(f.parent.name == "reference" for f in FILES)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize(
    "path", sorted((BENCH / "reference").glob("*.py")),
    ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "repro_torch" not in imported(path)
    assert "bench" not in imported(path)       # nor the harness that runs it


def test_the_scan_sees_a_forbidden_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("def f():\n    import jax.numpy as jnp\n"
                 "from repro.models import x\nimport repro_torch\n")
    assert imported(f) == {"jax", "repro", "repro_torch"}
