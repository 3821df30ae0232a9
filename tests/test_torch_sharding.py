"""The port's `runtime/sharding.py` against the JAX package's, spec for
spec, for all 10 architectures: `param_specs` on the port's meta init
against JAX's `init_abstract`, `param_specs_2d` and ZeRO-1's
`opt_state_specs` on a 16x16 stand-in mesh, `cache_specs` at decode_32k and
long_500k, `batch_specs` for every shape.  Then the reference's own checks
on the port's specs (tests/test_sharding.py, tests/test_optim_ckpt.py's
`test_zero1_spec`), and the placements `to_named` gives on a fake 16x16
mesh of 256 ranks, in a subprocess: each leaf's local shard is its global
shape divided by the named axes' sizes."""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.runtime import sharding as jsh  # noqa: E402
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, input_specs  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.runtime import sharding as sh  # noqa: E402
from repro_torch.runtime.sharding import P  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MODEL_AXIS = 16
DATA_AXIS = 16


class Mesh16:
    """The reference tests' stand-in for the 16x16 production mesh."""
    axis_names = ("data", "model")
    shape = {"data": DATA_AXIS, "model": MODEL_AXIS}


class Mesh2x16x16:
    axis_names = ("pod", "data", "model")
    shape = {"pod": 2, "data": DATA_AXIS, "model": MODEL_AXIS}


def _jax_specs(tree):
    """{path: spec as a tuple} of a JAX tree of PartitionSpecs."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda s: isinstance(s, JP))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): tuple(s) for path, s in flat}


def _port_specs(tree):
    return {"/".join(map(str, path)): tuple(s)
            for path, s in sh.tree_items(tree)}


def _params(arch):
    jp = jbuild(jget(arch)).init_abstract()
    tp = build_model(get_config(arch)).init(torch.Generator(), "meta")
    return jp, tp


@pytest.fixture(scope="module")
def trees():
    return {}


def _cached(trees, arch):
    if arch not in trees:
        trees[arch] = _params(arch)
    return trees[arch]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_the_reference(arch, trees):
    jp, tp = _cached(trees, arch)
    ours = _port_specs(sh.param_specs(tp, get_config(arch)))
    theirs = _jax_specs(jsh.param_specs(jp, jget(arch)))
    assert ours == theirs
    assert any("model" in s for s in ours.values())


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_2d_and_zero1_equal_the_reference(arch, trees):
    jp, tp = _cached(trees, arch)
    jps = jsh.param_specs(jp, jget(arch))
    tps = sh.param_specs(tp, get_config(arch))
    assert _port_specs(sh.param_specs_2d(tps, tp, Mesh16())) == \
        _jax_specs(jsh.param_specs_2d(jps, jp, Mesh16()))
    assert _port_specs(sh.opt_state_specs(tps, tp, Mesh16(), True)) == \
        _jax_specs(jsh.opt_state_specs(jps, jp, Mesh16(), True))
    assert sh.opt_state_specs(tps, tp, Mesh16(), False) is tps


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_equal_the_reference(arch):
    jm, tm = jbuild(jget(arch)), build_model(get_config(arch))
    for name in ("decode_32k", "long_500k"):
        s = SHAPES[name]
        jc = jm.init_cache(s.global_batch, s.seq_len, abstract=True)
        tc = tm.init_cache(s.global_batch, s.seq_len, device="meta")
        for mesh in (Mesh16(), Mesh2x16x16()):
            kw = dict(global_batch=s.global_batch,
                      seq_shard_kv=name == "long_500k")
            assert _port_specs(sh.cache_specs(get_config(arch), tc, mesh,
                                              **kw)) == \
                _jax_specs(jsh.cache_specs(jget(arch), jc, mesh, **kw)), \
                (name, mesh.axis_names)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_specs_equal_the_reference(arch):
    for name in SHAPES:
        for mesh in (Mesh16(), Mesh2x16x16()):
            ours = sh.batch_specs(get_config(arch), SHAPES[name], mesh)
            theirs = jsh.batch_specs(jget(arch), JSHAPES[name], mesh)
            assert {k: tuple(v) for k, v in ours.items()} == \
                {k: tuple(v) for k, v in theirs.items()}, (name,)
            assert set(ours) == set(input_specs(get_config(arch),
                                                SHAPES[name]))


def test_logical_rules_equal_the_reference():
    for mesh in (Mesh16(), Mesh2x16x16()):
        for kw in ({}, {"global_batch": 1}, {"global_batch": 256},
                   {"seq_shard_kv": True}, {"shard_params_2d": True}):
            assert sh.logical_rules(mesh, **kw) == \
                jsh.logical_rules(mesh, **kw), kw


# ------------------------------------------- the reference's own checks


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_divisible(arch, trees):
    _, tp = _cached(trees, arch)
    n_model_sharded = 0
    for (path, leaf), (_, spec) in zip(
            sh.tree_items(tp),
            sh.tree_items(sh.param_specs(tp, get_config(arch)))):
        entries = list(spec) + [None] * (len(leaf.shape) - len(spec))
        for dim, ax in enumerate(entries):
            if ax == "model":
                n_model_sharded += 1
                assert leaf.shape[dim] % MODEL_AXIS == 0, (path, leaf.shape)
    assert n_model_sharded > 0, "nothing TP-sharded"


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_divisible(arch):
    model = build_model(get_config(arch))
    for name in ("decode_32k", "long_500k"):
        s = SHAPES[name]
        cache = model.init_cache(s.global_batch, s.seq_len, device="meta")
        specs = sh.cache_specs(get_config(arch), cache, Mesh16(),
                               global_batch=s.global_batch,
                               seq_shard_kv=name == "long_500k")
        for (_, leaf), (_, spec) in zip(sh.tree_items(cache),
                                        sh.tree_items(specs)):
            entries = list(spec) + [None] * (len(leaf.shape) - len(spec))
            for dim, ax in enumerate(entries):
                if ax is None:
                    continue
                axes = ax if isinstance(ax, tuple) else (ax,)
                size = math.prod(Mesh16.shape[a] for a in axes)
                assert leaf.shape[dim] % size == 0, (name, leaf.shape, dim)


def test_effective_batch_axes():
    m = Mesh2x16x16()
    assert sh.effective_batch_axes(m, 256) == ("pod", "data")
    assert sh.effective_batch_axes(m, 32) == ("pod", "data")
    assert sh.effective_batch_axes(m, 16) == ("data",)
    assert sh.effective_batch_axes(m, 1) is None


def test_zero1_spec():
    sp = sh.zero1_spec(P(None, None, "model"), (64, 512, 1024), 16)
    assert sp == P("data", None, "model")
    # no dim divisible -> unchanged
    sp2 = sh.zero1_spec(P("model"), (100,), 16)
    assert sp2 == P("model")


def test_p_keeps_a_one_name_tuple_as_the_name():
    assert P(("data",), None) == ("data", None)
    assert P(("pod", "data")) == (("pod", "data"),)
    assert P() == ()


# ------------------------------------- placements on a fake 16x16 mesh

_PLACE = r"""
import json, math, sys
import torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.launch.dryrun import start_fake_group
from repro_torch.models.model import build_model
from repro_torch.runtime import sharding as sh

start_fake_group(256)
try:
    mesh = init_device_mesh("cpu", (16, 16), mesh_dim_names=("data", "model"))
    sizes = {"data": 16, "model": 16}
    out = {}
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        model = build_model(cfg)
        params = model.init(torch.Generator(), "meta")
        s = SHAPES["decode_32k"]
        cache = model.init_cache(s.global_batch, s.seq_len, device="meta")
        bad, n = [], 0
        for tree, specs in (
                (params, sh.param_specs(params, cfg)),
                (cache, sh.cache_specs(cfg, cache, mesh,
                                       global_batch=s.global_batch))):
            placed = sh.distribute(tree, mesh, specs)
            for (path, x), (_, spec), (_, d) in zip(
                    sh.tree_items(tree), sh.tree_items(specs),
                    sh.tree_items(placed)):
                want = list(x.shape)
                for dim, e in enumerate(spec):
                    for ax in (e if isinstance(e, tuple) else (e,)):
                        if ax:
                            want[dim] //= sizes[ax]
                n += 1
                if list(d.to_local().shape) != want or \
                        tuple(d.placements) != sh.placements(mesh, spec):
                    bad.append([list(map(str, path)), want,
                                list(d.to_local().shape)])
        out[arch] = {"leaves": n, "bad": bad}
    print(json.dumps(out))
finally:
    dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def placed():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", _PLACE], env=env, timeout=240,
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_local_shards_on_a_fake_16x16_mesh(arch, placed):
    assert placed[arch]["leaves"] > 0
    assert placed[arch]["bad"] == []
