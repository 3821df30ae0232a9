"""The port's dry run (`launch/dryrun.py`) against the JAX package's.

- `model_flops` equals the reference's for every arch x shape (the
  reference's side in a subprocess: `repro.launch.dryrun` sets XLA_FLAGS
  to 512 host devices when imported, which this process must not see).
- A reduced gemma2 prefill cell on a fake 2x2 mesh ends ok through the
  command line, and its per-device FLOPs are within 5% of the reference's
  `lower_cell` of the same reduced cell on 4 host devices, once the FLOPs
  of the masked (q, k) pairs are added: the reference's blockwise
  attention computes every pair of the blocks it does not skip (all of
  them without skip_masked_blocks), the flash kernel's count only the
  allowed pairs.  That term is worked out block by block from
  src/repro/models/attention.py:141-247.  Its per-device HBM bytes and
  collective bytes stay within a band of the reference's readings.
- Train (full remat, 2 microbatches) and decode cells of a reduced
  gemma2, rwkv6, zamba2 and deepseek-v2-lite end ok on the 2x2 mesh, with
  the reference's record keys.
- Applicable shapes equal the reference's, and `Options` carry the
  reference's knobs but skip_masked_blocks and fused_xent, which the
  record holds as the port runs.

Every process group lives in a subprocess; they run concurrently."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.configs import applicable_shapes as japplicable  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.models.common import Options as JOptions  # noqa: E402
from repro.models.transformer import _layer_windows  # noqa: E402
from repro_torch.configs import (ARCH_IDS, SHAPES, applicable_shapes,  # noqa: E402
                                 get_config)
from repro_torch.launch.dryrun import model_flops  # noqa: E402
from repro_torch.models.attention import head_padding  # noqa: E402
from repro_torch.models.common import Options  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# one thread a process: the file runs five at once beside other test files
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
           OMP_NUM_THREADS="1")
SEQ, BATCH, BLOCK = 64, 4, 32          # the reduced prefill cell
CELL_ARCHS = ["gemma2-2b", "rwkv6-1.6b", "zamba2-2.7b",
              "deepseek-v2-lite-16b"]

_REF_MODEL_FLOPS = r"""
import json
import repro.launch.dryrun as dr
from repro.configs import ARCH_IDS, SHAPES, get_config
print(json.dumps({a: {s: dr.model_flops(get_config(a), SHAPES[s])
                      for s in SHAPES} for a in ARCH_IDS}))
"""

# the reference's own lower_cell, on a (2, 2) mesh of 4 of its host
# devices, for the reduced config at the reduced shape
_REF_CELL = r"""
import json, os, sys
import numpy as np
import repro.launch.dryrun as dr
# the import asked for 512 host devices; the cell needs 4, and jax reads
# the flag when its backend first starts, below
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
from jax.sharding import Mesh
from repro.configs import RunConfig, ShapeConfig, get_config
from repro.models.common import Options
seq, batch, block = (int(v) for v in sys.argv[1:4])
cfg = get_config("gemma2-2b").reduced()
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
dr.make_production_mesh = lambda multi_pod=False: mesh
dr.get_config = lambda arch: cfg
dr.SHAPES = {"cell": ShapeConfig("cell", seq, batch, "prefill")}
rec = dr.lower_cell("gemma2-2b", "cell", False, RunConfig(),
                    Options(q_block=block, kv_block=block))
print(json.dumps(rec))
"""

_PORT_CELLS = r"""
import json, sys
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
import repro_torch.launch.dryrun as dr
from repro_torch.configs import RunConfig, ShapeConfig, get_config
from repro_torch.models.common import Options
dr.start_fake_group(4)
out = {}
try:
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    for arch in sys.argv[1:]:
        out[arch] = {}
        for name, mode, rc in (("train_4k", "train",
                                RunConfig(remat="full", microbatches=2)),
                               ("decode_32k", "decode", RunConfig())):
            try:
                rec = dr.lower_cell(
                    arch, name, False, rc,
                    Options(q_block=16, kv_block=16, remat=rc.remat,
                            moe_group=64),
                    cfg=get_config(arch).reduced(),
                    shape=ShapeConfig(name, 32, 4, mode), mesh=mesh)
            except Exception as e:
                rec = {"ok": False, "error": f"{type(e).__name__}: {e}"}
            out[arch][name] = rec
finally:
    dist.destroy_process_group()
print(json.dumps(out))
"""


def _start(args):
    return subprocess.Popen([sys.executable, *args], env=ENV,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _finish(p, timeout=240):
    out, err = p.communicate(timeout=timeout)
    assert p.returncode == 0, err[-3000:]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every subprocess of the file, started together."""
    out_dir = tmp_path_factory.mktemp("dryrun")
    procs = {
        "ref_flops": _start(["-c", _REF_MODEL_FLOPS]),
        "ref_cell": _start(["-c", _REF_CELL, str(SEQ), str(BATCH),
                            str(BLOCK)]),
        "port_cell": _start([
            "-m", "repro_torch.launch.dryrun", "--arch", "gemma2-2b",
            "--shape", "prefill_32k", "--reduced", "--mesh-shape", "2x2",
            "--seq-len", str(SEQ), "--global-batch", str(BATCH),
            "--q-block", str(BLOCK), "--kv-block", str(BLOCK),
            "--out-dir", str(out_dir)]),
        # two archs a process: fewer interpreters to start
        "cells_a": _start(["-c", _PORT_CELLS, *CELL_ARCHS[::2]]),
        "cells_b": _start(["-c", _PORT_CELLS, *CELL_ARCHS[1::2]]),
    }
    res = {}
    try:
        for k, p in procs.items():
            res[k] = _finish(p)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    rec = json.loads((out_dir / "gemma2-2b__prefill_32k__2x2.json")
                     .read_text())
    last = {k: json.loads(v.splitlines()[-1]) for k, v in res.items()
            if k != "port_cell"}             # it prints a summary
    return {"ref_flops": last["ref_flops"], "ref_cell": last["ref_cell"],
            "port_cell": rec, **last["cells_a"], **last["cells_b"]}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_equal_the_reference(arch, runs):
    for name, shape in SHAPES.items():
        assert model_flops(get_config(arch), shape) == \
            runs["ref_flops"][arch][name], name


def _masked_pair_flops(cfg, per_device_batch, per_device_heads):
    """FLOPs of the (q, k) pairs the reference's blockwise attention
    computes and its mask drops, summed over the layers: without
    skip_masked_blocks every (q block, kv block) is computed."""
    hd = cfg.resolved_head_dim
    total = 0
    for window in _layer_windows(cfg, cfg.n_layers, SEQ):
        for i0 in range(0, SEQ, BLOCK):
            for j0 in range(0, SEQ, BLOCK):
                allowed = sum(1 for s in range(i0, i0 + BLOCK)
                              for t in range(j0, j0 + BLOCK)
                              if t <= s and (window is None
                                             or s - t < window))
                total += BLOCK * BLOCK - allowed
    return 2.0 * (hd + hd) * total * per_device_batch * per_device_heads


def test_reduced_prefill_cell_is_within_5pc_of_the_reference(runs):
    rec, ref = runs["port_cell"], runs["ref_cell"]
    assert rec["ok"] is True and rec["mesh"] == "2x2" and rec["chips"] == 4
    cfg = get_config("gemma2-2b").reduced()
    hq_pad, _ = head_padding(cfg)
    term = _masked_pair_flops(cfg, BATCH // 2, hq_pad // 2)
    assert term > 0
    ours = rec["hlo_flops_per_device"] + term
    theirs = ref["hlo_flops_per_device"]
    assert abs(ours - theirs) <= 0.05 * theirs, (ours, theirs, term)
    assert rec["model_flops"] == ref["model_flops"]
    assert rec["kernels"]["flash_attention"]["calls"] == cfg.n_layers
    # the count is each device's, not the global one
    assert rec["hlo_flops"] == 4 * rec["hlo_flops_per_device"]
    assert rec["hlo_flops_per_device"] < 0.5 * rec["model_flops"]


def test_reduced_prefill_cell_bytes_near_the_reference(runs):
    """HBM bytes and collective bytes a device, against the reference's
    partitioned HLO of the same cell.  Readings (torch 2.13, jax 0.9):
    HBM 17.04e6 against 22.12e6, collectives 0.330e6 against 0.426e6
    (bf16-corrected).  The port counts fewer bytes in part because the
    flash op counts its kernel's q, k, v and output once where the
    reference's blockwise attention writes every block's scores; the rest
    of either gap is not broken down.  The band holds the port to the
    readings' side of the reference, with room for either side's
    version."""
    rec, ref = runs["port_cell"], runs["ref_cell"]
    hbm = rec["hlo_bytes_per_device"] / ref["hlo_bytes_per_device"]
    coll = (rec["collective_bytes"]["total"]
            / ref["collective_bytes"]["total_bf16_corrected"])
    assert 0.6 <= hbm <= 1.1, hbm
    assert 0.6 <= coll <= 1.1, coll
    # the all-reduces of the row-split matmuls' outputs, bf16, two a layer
    cfg = get_config("gemma2-2b").reduced()
    assert rec["collective_bytes"]["all-reduce"] == \
        2 * cfg.n_layers * (BATCH // 2) * SEQ * cfg.d_model * 2


def test_a_record_carries_the_reference_keys(runs):
    rec, ref = runs["port_cell"], runs["ref_cell"]
    assert set(ref) <= set(rec)
    assert set(ref["roofline"]) == set(rec["roofline"])
    assert set(ref["memory"]) == set(rec["memory"])
    assert rec["memory"]["temp_bytes_per_device"] is None
    assert rec["memory"]["argument_bytes_per_device"] > 0
    assert rec["collective_bytes"]["total"] > 0
    # the reference's two knobs, as the port runs: masked tiles skipped,
    # no fused cross-entropy
    assert rec["opts"]["skip_masked_blocks"] is True
    assert rec["opts"]["fused_xent"] is False


@pytest.mark.parametrize("arch", CELL_ARCHS)
@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_train_and_decode_cells_end_ok(arch, shape, runs):
    rec = runs[arch][shape]
    assert rec["ok"] is True, rec.get("error")
    assert rec["hlo_flops_per_device"] > 0 and rec["chips"] == 4
    assert rec["roofline"]["bottleneck"] in ("compute", "memory",
                                             "collective")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_applicable_shapes_equal_the_reference(arch):
    assert applicable_shapes(get_config(arch)) == japplicable(jget(arch))


def test_options_carry_the_reference_knobs():
    """The reference's knobs, less skip_masked_blocks and fused_xent, which
    would change nothing in the port."""
    kw = dict(q_block=64, kv_block=32, mla_absorb=True, remat="full",
              moe_group=128, probs_bf16=True)
    ours, theirs = Options(**kw), JOptions(**kw)

    def knobs(o):
        return {k: v for k, v in vars(o).items()
                if k not in ("skip_masked_blocks", "fused_xent")}
    assert vars(ours) == knobs(theirs)
    assert vars(ours.replace(q_block=8)) == knobs(theirs.replace(q_block=8))
