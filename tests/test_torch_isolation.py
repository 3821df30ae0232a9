"""The port stands alone: no file of src/repro_torch/ nor chip_smoke.py nor
chip_flash_ab.py imports jax or anything of the JAX package, nor yaml (the card's machine may
not have it: pmake reads its files with its own reader), and its entry
points default to the card.  No string of the port names a module of the
JAX package, and a worker process the port spawns loads neither it nor
jax."""
import ast
import inspect
import os
import re
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py", ROOT / "chip_flash_ab.py"]


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


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_yaml_import(path):
    assert "yaml" not in set(_imported_roots(path)), f"{path} imports yaml"


def test_the_checkpoint_module_is_covered():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert {"src/repro_torch/checkpoint/__init__.py",
            "src/repro_torch/checkpoint/ckpt.py"} <= names


def test_the_front_door_modules_are_covered():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    port = "src/repro_torch/"
    assert {port + m for m in (
        "client/__init__.py", "client/client.py", "client/futures.py",
        "core/dwork/sharded.py", "core/engine/__init__.py",
        "core/engine/backends.py", "core/engine/executor.py",
        "core/engine/faults.py", "core/engine/journal.py",
        "core/engine/model.py", "core/engine/tracing.py",
        "core/engine/comm/__init__.py", "core/engine/comm/core.py",
        "core/engine/comm/serialize.py", "core/engine/comm/proc.py",
        "core/engine/comm/worker.py", "core/serving/__init__.py",
        "core/serving/frontend.py")} <= names


def test_the_scheduler_modules_are_covered():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    port = "src/repro_torch/"
    assert {port + m for m in (
        "core/pmake/__init__.py", "core/pmake/rules.py",
        "core/pmake/graph.py", "core/pmake/scheduler.py",
        "core/mpi_list/__init__.py", "core/mpi_list/context.py",
        "core/mpi_list/mesh_ops.py", "core/dwork/pool.py",
        "runtime/elastic.py", "launch/campaign.py",
        "data/pipeline.py")} <= names


def test_the_distribution_modules_are_covered():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    port = "src/repro_torch/"
    assert {port + m for m in (
        "runtime/sharding.py", "launch/mesh.py", "launch/dryrun.py",
        "launch/hlo_analysis.py", "launch/hlo_debug.py",
        "kernels/cost.py", "kernels/_dist.py", "placement.py")} <= names


def test_only_the_dry_run_imports_the_fake_backend():
    users = {p.relative_to(ROOT).as_posix() for p in PORT_FILES
             if "torch.testing._internal" in p.read_text()}
    assert users == {"src/repro_torch/launch/dryrun.py"}


def test_entry_points_default_to_cuda():
    from repro_torch.launch import campaign, metg, serve, train
    from repro_torch.models import mamba2, model, rwkv, transformer, zamba
    from repro_torch.runtime import serve_step, train_step  # noqa: F401
    assert serve.parse_args([]).device == "cuda"
    assert serve.parse_args([]).workers == 1
    assert serve.parse_args([]).max_wait_ms == 20.0
    assert serve.parse_args([]).reduced is True
    assert serve.parse_args(["--no-reduced"]).reduced is False
    assert train.parse_args([]).device == "cuda"
    assert train.parse_args(["--no-reduced"]).reduced is False
    assert metg.parse_args([]).device == "cuda"
    assert campaign.parse_args([]).device == "cuda"
    for fn in (model.Model.init, model.Model.init_cache, transformer.init_lm,
               transformer.init_cache, rwkv.init_lm, rwkv.init_state,
               zamba.init_lm, zamba.init_cache, mamba2.init_mamba,
               mamba2.init_mamba_state, train_step.init_train_state):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


REPRO_MODULE = re.compile(r"(?<![\w.])repro(\.[A-Za-z_]\w*)+")


def _code_strings(path):
    """Every string literal of a file that is not a docstring, f-strings'
    literal parts included: what the code may hand to `-m`, `import_module`
    or a subprocess."""
    tree = ast.parse(path.read_text(), str(path))
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) \
                    and isinstance(first.value, ast.Constant):
                docs.add(id(first.value))
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and id(node) not in docs:
            yield node.lineno, node.value


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_string_names_a_repro_module(path):
    """A module named in a string escapes the import scan above: the proc
    transport runs `python -m <module>` in each worker, and a leftover
    `"repro.core..."` there would run the JAX package's worker under the
    port's engine."""
    bad = [(line, s) for line, s in _code_strings(path)
           if REPRO_MODULE.search(s) or s.strip() == "repro"]
    assert not bad, f"{path} names the JAX package in {bad}"


def test_the_string_scan_sees_a_worker_command(tmp_path):
    planted = tmp_path / "planted.py"
    planted.write_text('"""Docstring: repro.core is the reference."""\n'
                       'CMD = ["-m", "repro.core.engine.comm.worker"]\n'
                       'OK = "repro_torch.core.engine.comm.worker"\n')
    assert [s for _, s in _code_strings(planted)
            if REPRO_MODULE.search(s)] == ["repro.core.engine.comm.worker"]


def test_a_spawned_port_worker_loads_neither_repro_nor_jax():
    """The proc transport's worker process, spawned on the CPU, runs the
    port's worker module and has loaded neither the JAX package nor jax
    (nor torch: a task that needs it imports it)."""
    from repro_torch.client import Client

    with Client(workers=1, transport="proc", heartbeat_s=0.1) as c:
        argv0, mods, pid = c.submit(lambda: (
            sys.argv[0], sorted(m for m in ("repro", "jax", "jaxlib",
                                            "torch", "repro_torch")
                                if m in sys.modules), os.getpid())).result(
            timeout=60)
        pids = set(c.engine.worker_pids().values())
    assert pid in pids and pid != os.getpid()
    assert Path(argv0).resolve() == (ROOT / "src" / "repro_torch" / "core"
                                     / "engine" / "comm" / "worker.py")
    assert mods == ["repro_torch"]
