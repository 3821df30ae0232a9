"""The port on real process groups over gloo on the CPU: checkpoints
restored onto a mesh and the DFM bridge on a mesh.

- `ckpt.restore(mesh=, spec_tree=)` onto a (2, 2) mesh of 4 processes:
  each rank's shard equals its slice of the saved array (bf16 and a leaf
  split over both axes included).
- tests/test_optim_ckpt.py::test_checkpoint_elastic_reshard's program on a
  1x1 mesh.
- The DFM bridge (`core/mpi_list/mesh_ops`) over a `data` axis of 4
  processes, on a list that does not divide evenly: every op equals the
  one-device results and numpy's.
- tests/test_mpi_list.py::test_mesh_bridge_single_device's program on a
  1x1 mesh, against numpy (the JAX side fails it on jax 0.9.0).
- Models on a (2, 2) mesh of 4 processes, params, batch and cache placed
  by `runtime.sharding`'s rules and run under `mesh_context`, against the
  same steps on plain tensors (which the model tests hold against JAX),
  in fp32: reduced gemma2 with one K/V group for two model shards (each
  shard picks the group its heads read), rwkv6, zamba2 and
  deepseek-v2-lite served (a prefill into a cache split over the
  sequence, then two decode steps whose rows write into both halves of
  it), and all four trained one step of two microbatches (the K/V
  group, WKV and SSD gradients summed over the shards that share an
  input, MoE groups, MLA, the loss over a vocab split).  Outputs,
  caches, updated params and both Adam moments are gathered and compared.

A group of several ranks lives in subprocesses, each with its timeout; a
1x1 group lives in this process and is destroyed in a `finally`."""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
dist = pytest.importorskip("torch.distributed")

from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.core.mpi_list import mesh_ops  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.placement import P, placements  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# one thread a process: the file runs four at once beside other test files
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
WORLD = 4
TIMEOUT = 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(script: str, *args, timeout: int = TIMEOUT) -> list:
    """`script` in WORLD processes over gloo; each prints one JSON line."""
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, str(r), str(WORLD), str(port),
         *map(str, args)], env=ENV, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(WORLD)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, err[-3000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outs


_PROLOGUE = r"""
import json, sys
import torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
rank, world, port = (int(v) for v in sys.argv[1:4])
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=world)
"""

_RANKS = _PROLOGUE + r"""
from repro_torch.checkpoint import ckpt
from repro_torch.core.mpi_list import mesh_ops as mo
from repro_torch.runtime.sharding import P
N = int(sys.argv[5])
out = {}
try:
    # restore onto a (2, 2) mesh
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    tmpl = {"w": torch.empty(8, 12, device="meta"),
            "b": torch.empty(6, dtype=torch.bfloat16, device="meta"),
            "s": {"x": torch.empty(3, 8, 5, device="meta")}}
    specs = {"w": P("data", "model"), "b": P("model"),
             "s": {"x": P(None, ("data", "model"), None)}}
    back = ckpt.restore(sys.argv[4], 1, tmpl, mesh=mesh, spec_tree=specs)
    out["restore"] = {
        "coord": mesh.get_coordinate(),
        "w": back["w"].to_local().tolist(),
        "b": back["b"].to_local().float().tolist(),
        "b_dtype": str(back["b"].dtype),
        "x": back["s"]["x"].to_local().tolist(),
        "placements": [str(back[k].placements) for k in ("w", "b")]}
    # the DFM bridge over a data axis of every rank
    mesh = init_device_mesh("cpu", (world, 1), mesh_dim_names=("data", "model"))
    it = mo.iterates(mesh, N)
    vals = mo.scatter(mesh, torch.linspace(-1.0, 2.0, N, dtype=torch.float64))
    dfm = {"i": it, "v": vals}
    sq = mo.dfm_map(mesh, lambda e: {"i": e["i"] * e["i"] + 1,
                                     "v": e["v"] * 2.0}, dfm)
    out["bridge"] = {
        "local_rows": it.to_local().shape[0],
        "iterates": mo.collect(it).tolist(),
        "map": {k: v.tolist() for k, v in mo.collect(sq).items()},
        "sum": {k: v.item() for k, v in mo.dfm_sum(mesh, dfm).items()},
        "reduce": mo.dfm_reduce(mesh, lambda a, b: a * 2 + b, it).item(),
        "scan_add": mo.collect(mo.dfm_scan(mesh, torch.add, it)).tolist(),
        "scan_max": mo.collect(mo.dfm_scan(
            mesh, torch.maximum, mo.scatter(mesh, torch.tensor(
                [(i * 7) % 11 for i in range(N)])))).tolist(),
        "group": mo.collect(mo.group(mesh, [i % 3 for i in range(N)],
                                     dfm))["i"].tolist(),
        "repartition": mo.collect(mo.repartition(
            mesh, torch.arange(N) * 3)).tolist(),
        "placements": str(mo.repartition(mesh, it).placements),
    }
    print(json.dumps(out))
finally:
    dist.destroy_process_group()
"""
# the models on a (2, 2) mesh against plain tensors; rank 0 compares
_MODELS = _PROLOGUE + r"""
import numpy as np
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import RunConfig, ShapeConfig, get_config
from repro_torch.models.common import (Options, mesh_context, tree_leaves,
                                       tree_map)
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import OptState, init_opt
from repro_torch.runtime.sharding import (P, batch_specs, cache_specs,
                                          distribute, logical_rules,
                                          opt_state_specs, param_specs)
from repro_torch.runtime.train_step import make_train_step
F32 = torch.float32
B, S, T = 4, 32, 48
POS = [S, 3, 20, S - 1]          # rows on both halves of the cache's split
OPTS = Options(q_block=16, kv_block=16, moe_group=16)


def full(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def diff(got, want):
    got, want = [full(x) for x in tree_leaves(got)], tree_leaves(want)
    assert len(got) == len(want)
    return {"err": max((x.double() - y.double()).abs().max().item()
                       for x, y in zip(got, want)),
            "scale": max(y.double().abs().max().item() for y in want)}


def n_split(tree):
    return sum(1 for x in tree_leaves(tree)
               if hasattr(x, "to_local") and x.to_local().numel() < x.numel())


def on_mesh(fn, *args):
    with mesh_context(mesh, logical_rules(mesh, global_batch=B)), \
            implicit_replication():
        return fn(*args)


def serve(cfg):
    model = build_model(cfg, OPTS)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32))
    steps = [(torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B,)).astype(np.int32)),
        torch.tensor(POS, dtype=torch.int32) + i) for i in range(2)]
    cache = (None if cfg.family == "ssm"      # its prefill makes its state
             else model.init_cache(B, T, dtype=F32, device="cpu"))

    def run(params, batch, cache, steps):
        logits, cache = model.forward(params, batch, mode="prefill",
                                      cache=cache, dtype=F32)
        outs = [logits]
        for tok, pos in steps:
            logits, cache = model.decode_step(params, tok, pos, cache,
                                              dtype=F32)
            outs.append(logits)
        return outs, cache

    if rank == 0:
        want = run(params, {"tokens": tokens},
                   None if cache is None else tree_map(torch.clone, cache),
                   steps)
    dec = batch_specs(cfg, ShapeConfig("c", T, B, "decode"), mesh)
    d_steps = [tuple(distribute({"tokens": t, "positions": p}, mesh,
                                dec).values()) for t, p in steps]
    if cache is not None:
        cache = distribute(cache, mesh, cache_specs(cfg, cache, mesh,
                                                    global_batch=B))
    outs, cache = on_mesh(
        run, distribute(params, mesh, param_specs(params, cfg)),
        distribute({"tokens": tokens}, mesh,
                   batch_specs(cfg, ShapeConfig("c", S, B, "prefill"), mesh)),
        cache, d_steps)
    got = [[full(o) for o in outs], tree_map(full, cache)]
    if rank:
        return None
    return {"split": {"cache": n_split(cache), "logits": n_split(outs)},
            "prefill": diff(got[0][:1], want[0][:1]),
            "decode": diff(got[0][1:], want[0][1:]),
            "cache": diff(got[1], want[1])}


class F32Model:
    # the train step's loss through the model in fp32
    def __init__(self, model):
        self.model, self.cfg = model, model.cfg

    def forward(self, params, batch, return_aux=False):
        return self.model.forward(params, batch, dtype=F32,
                                  return_aux=return_aux)


def train(cfg):
    model = build_model(cfg, OPTS)
    rc = RunConfig(microbatches=2)
    rng = np.random.default_rng(2)
    batch = {k: torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32))
        for k in ("tokens", "labels")}
    step = make_train_step(F32Model(model), rc)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    if rank == 0:
        mine = tree_map(torch.clone, params)
        want = step(mine, init_opt(mine, rc), batch)
    pspecs = param_specs(params, cfg)
    ospecs = opt_state_specs(pspecs, params, mesh, rc.zero1)
    opt = distribute(init_opt(params, rc), mesh,
                     OptState(P(), ospecs, ospecs))
    p, o, m = on_mesh(step, distribute(params, mesh, pspecs), opt,
                      distribute(batch, mesh, batch_specs(
                          cfg, ShapeConfig("c", S, B, "train"), mesh)))
    got = [tree_map(full, p), tree_map(full, o.m), tree_map(full, o.v),
           {k: full(v) for k, v in m.items()}]
    if rank:
        return None
    return {"split": {"params": n_split(p), "moments": n_split((o.m, o.v))},
            "params": diff(got[0], want[0]), "m": diff(got[1], want[1].m),
            "v": diff(got[2], want[1].v),
            "metrics": {k: [float(v), float(want[2][k])]
                        for k, v in got[3].items()}}


out = {}
try:
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    gemma = get_config("gemma2-2b").reduced().replace(n_kv_heads=1)
    deepseek = get_config("deepseek-v2-lite-16b").reduced()
    for arch, cfg in (("gemma2-2b", gemma),
                      ("rwkv6-1.6b", get_config("rwkv6-1.6b").reduced()),
                      ("zamba2-2.7b", get_config("zamba2-2.7b").reduced()),
                      ("deepseek-v2-lite-16b", deepseek)):
        out[f"{arch} serve"] = serve(cfg)
    for arch, cfg in (("gemma2-2b", gemma),
                      ("rwkv6-1.6b", get_config("rwkv6-1.6b").reduced()),
                      ("zamba2-2.7b", get_config("zamba2-2.7b").reduced()),
                      ("deepseek-v2-lite-16b", deepseek)):
        out[f"{arch} train"] = train(cfg)
    print(json.dumps(out))
finally:
    dist.destroy_process_group()
"""
N_ROWS = 30                              # 4 ranks: 8, 8, 8, 6 rows
W = np.arange(96, dtype=np.float32).reshape(8, 12)
B = torch.arange(6, dtype=torch.float32).to(torch.bfloat16) / 3
X = np.arange(120, dtype=np.float32).reshape(3, 8, 5)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both multi-rank programs in one run of WORLD gloo processes."""
    d = tmp_path_factory.mktemp("ckpt")
    ckpt.save(d, 1, {"w": torch.from_numpy(W), "b": B,
                     "s": {"x": torch.from_numpy(X)}})
    return _run_ranks(_RANKS, d, N_ROWS)


def test_restore_onto_a_2x2_mesh_of_4_processes(ranks):
    seen = set()
    for o in (r["restore"] for r in ranks):
        c0, c1 = o["coord"]
        seen.add((c0, c1))
        assert o["w"] == W[c0 * 4:(c0 + 1) * 4, c1 * 6:(c1 + 1) * 6].tolist()
        assert o["b"] == B.float()[c1 * 3:(c1 + 1) * 3].tolist()
        assert o["b_dtype"] == "torch.bfloat16"
        k = c0 * 2 + c1                     # data major, model minor
        assert o["x"] == X[:, k * 2:(k + 1) * 2].tolist()
        assert o["placements"] == ["(Shard(dim=0), Shard(dim=1))",
                                   "(Replicate(), Shard(dim=0))"]
    assert seen == {(0, 0), (0, 1), (1, 0), (1, 1)}


def _one_device(N):
    it = mesh_ops.iterates("cpu", N)
    vals = mesh_ops.scatter("cpu", torch.linspace(-1.0, 2.0, N,
                                                  dtype=torch.float64))
    dfm = {"i": it, "v": vals}
    sq = mesh_ops.dfm_map("cpu", lambda e: {"i": e["i"] * e["i"] + 1,
                                            "v": e["v"] * 2.0}, dfm)
    return {
        "iterates": mesh_ops.collect(it).tolist(),
        "map": {k: v.tolist() for k, v in mesh_ops.collect(sq).items()},
        "sum": {k: v.item() for k, v in mesh_ops.dfm_sum("cpu", dfm).items()},
        "reduce": mesh_ops.dfm_reduce("cpu", lambda a, b: a * 2 + b,
                                      it).item(),
        "scan_add": mesh_ops.collect(mesh_ops.dfm_scan("cpu", torch.add,
                                                       it)).tolist(),
        "scan_max": mesh_ops.collect(mesh_ops.dfm_scan(
            "cpu", torch.maximum, torch.tensor(
                [(i * 7) % 11 for i in range(N)]))).tolist(),
        "group": mesh_ops.collect(mesh_ops.group(
            "cpu", [i % 3 for i in range(N)], dfm))["i"].tolist(),
        "repartition": mesh_ops.collect(mesh_ops.repartition(
            "cpu", torch.arange(N) * 3)).tolist(),
    }


def test_bridge_over_a_data_axis_of_4_processes(ranks):
    N = N_ROWS
    outs = [r["bridge"] for r in ranks]
    one = _one_device(N)
    a = np.arange(N)
    for o in outs:
        assert o["placements"] == "(Shard(dim=0), Replicate())"
        for k in ("iterates", "map", "reduce", "scan_add", "scan_max",
                  "group", "repartition"):
            assert o[k] == one[k], k
        assert o["sum"]["i"] == one["sum"]["i"] == a.sum()
        assert o["sum"]["v"] == pytest.approx(one["sum"]["v"], rel=1e-12)
    assert sorted(o["local_rows"] for o in outs) == [6, 8, 8, 8]
    assert one["map"]["i"] == (a * a + 1).tolist()
    assert one["scan_add"] == np.cumsum(a).tolist()
    assert one["scan_max"] == np.maximum.accumulate(
        [(i * 7) % 11 for i in range(N)]).tolist()
    assert one["group"] == a[np.argsort(a % 3, kind="stable")].tolist()


# ------------------------------------------------------ models on a mesh

# fp32 on both sides; the readings are at most 5.3e-6 of the largest value
REL_TOL = 2e-5
SERVED = ["gemma2-2b serve", "rwkv6-1.6b serve", "zamba2-2.7b serve",
          "deepseek-v2-lite-16b serve"]
TRAINED = ["gemma2-2b train", "rwkv6-1.6b train", "zamba2-2.7b train",
           "deepseek-v2-lite-16b train"]


@pytest.fixture(scope="module")
def models():
    """Rank 0's comparisons from one run of WORLD gloo processes (45 s
    alone, 240-260 s beside the rest of the suite under `-n 6`)."""
    return _run_ranks(_MODELS, timeout=900)[0]


@pytest.mark.parametrize("case", SERVED + TRAINED)
def test_a_model_on_a_2x2_mesh_equals_it_on_plain_tensors(case, models):
    r = models[case]
    keys = ("prefill", "decode", "cache") if case in SERVED \
        else ("params", "m", "v")
    for k in keys:
        assert r[k]["err"] <= REL_TOL * r[k]["scale"], (k, r[k])
    # the mesh really splits them
    assert all(n > 0 for n in r["split"].values()), r["split"]
    if case in TRAINED:
        for k, (got, want) in r["metrics"].items():
            assert got == pytest.approx(want, rel=REL_TOL, abs=1e-9), k


# ------------------------------------------------------------ 1x1 meshes


@pytest.fixture
def host_mesh():
    assert not dist.is_initialized()
    try:
        yield make_host_mesh("cpu")
    finally:
        dist.destroy_process_group()


def test_checkpoint_elastic_reshard(tmp_path, host_mesh):
    """Restore onto a mesh (sharded placement) from a plain host save."""
    tree = {"w": torch.arange(16.0).reshape(4, 4)}
    ckpt.save(str(tmp_path), 1, tree)
    abs_tree = {"w": torch.empty(4, 4, device="meta")}
    back = ckpt.restore(str(tmp_path), 1, abs_tree, mesh=host_mesh,
                        spec_tree={"w": P(None, "model")})
    assert np.allclose(back["w"].full_tensor().numpy(), tree["w"].numpy())
    assert tuple(back["w"].placements) == placements(host_mesh,
                                                     P(None, "model"))


def test_mesh_bridge_single_device(host_mesh):
    mesh = host_mesh
    dfm = mesh_ops.iterates(mesh, 32)
    out = mesh_ops.dfm_map(mesh, lambda x: x * x, dfm)
    assert int(mesh_ops.dfm_sum(mesh, out)) == sum(i * i for i in range(32))
    sc = mesh_ops.dfm_scan(mesh, lambda a, b: a + b, dfm)
    assert int(mesh_ops.collect(sc)[-1]) == sum(range(32))
    dest = np.asarray([i % 3 for i in range(32)])
    grouped = mesh_ops.group(mesh, dest, dfm)
    assert sorted(np.asarray(mesh_ops.collect(grouped)).tolist()) == \
        list(range(32))
    assert mesh_ops.collect(grouped).tolist() == \
        np.arange(32)[np.argsort(dest, kind="stable")].tolist()
