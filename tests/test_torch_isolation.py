"""The port stands alone: no file of src/repro_torch/ nor chip_smoke.py
imports jax or anything of the JAX package, and its entry points default to
the card."""
import ast
import inspect
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_repro_import(path):
    assert path.exists()
    bad = {r for r in _imported_roots(path)
           if r in ("jax", "jaxlib", "flax", "repro")}
    assert not bad, f"{path} imports {bad}"


def test_entry_points_default_to_cuda():
    from repro_torch.launch import serve, train
    from repro_torch.models import mamba2, model, rwkv, transformer, zamba
    from repro_torch.runtime import serve_step, train_step  # noqa: F401
    assert serve.parse_args([]).device == "cuda"
    assert serve.parse_args([]).reduced is True
    assert serve.parse_args(["--no-reduced"]).reduced is False
    assert train.parse_args([]).device == "cuda"
    assert train.parse_args(["--no-reduced"]).reduced is False
    for fn in (model.Model.init, model.Model.init_cache, transformer.init_lm,
               transformer.init_cache, rwkv.init_lm, rwkv.init_state,
               zamba.init_lm, mamba2.init_mamba, train_step.init_train_state):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
