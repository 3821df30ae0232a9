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
  the reference's record keys; gemma2's and zamba2's HBM bytes and
  collective bytes a device stay within a band of the reference's
  `lower_cell` of the same cells (BANDS).
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
# one thread a process: the file runs seven at once beside other test files
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
           OMP_NUM_THREADS="1")
SEQ, BATCH, BLOCK = 64, 4, 32          # the reduced prefill cell
CELL_ARCHS = ["gemma2-2b", "rwkv6-1.6b", "zamba2-2.7b",
              "deepseek-v2-lite-16b"]
BAND_ARCHS = ["gemma2-2b", "zamba2-2.7b"]
SHAPE_OF = {"train": "train_4k", "decode": "decode_32k"}

_REF_MODEL_FLOPS = r"""
import json
import repro.launch.dryrun as dr
from repro.configs import ARCH_IDS, SHAPES, get_config
print(json.dumps({a: {s: dr.model_flops(get_config(a), SHAPES[s])
                      for s in SHAPES} for a in ARCH_IDS}))
"""

# the reference's own lower_cell, on a (2, 2) mesh of 4 of its host
# devices, for the reduced config at the reduced shape, in each mode named
# (train: full remat and 2 microbatches, as _PORT_CELLS); each record also
# holds its collectives' bytes by (kind, output type), largest first, from
# the partitioned HLO the record counted
_REF_CELLS = r"""
import json, os, sys
import numpy as np
import repro.launch.dryrun as dr
# the import asked for 512 host devices; the cell needs 4, and jax reads
# the flag when its backend first starts, below
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
from jax.sharding import Mesh
import repro.launch.hlo_analysis as ha
from repro.configs import RunConfig, ShapeConfig, get_config
from repro.launch.hlo_debug import multipliers
from repro.models.common import Options
hlo = {}
analyze = dr.analyze
dr.analyze = lambda text: hlo.update(text=text) or analyze(text)


def by_type(text):
    comps, entry = ha.parse_module(text)
    mult, _ = multipliers(comps, entry)
    rows = {}
    for name, comp in comps.items():
        for ins in comp.instrs:
            kind = next((k for k in ha.COLLECTIVES
                         if ins.opcode in (k, k + "-start")), None)
            if kind and mult.get(name):
                key = f"{kind} {ins.type}"
                rows[key] = rows.get(key, 0.0) + mult[name] * \
                    ha.shape_bytes(ins.type)
    return sorted(rows.items(), key=lambda kv: -kv[1])


arch = sys.argv[1]
seq, batch, block = (int(v) for v in sys.argv[2:5])
cfg = get_config(arch).reduced()
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
dr.make_production_mesh = lambda multi_pod=False: mesh
dr.get_config = lambda a: cfg
out = {}
for mode in sys.argv[5:]:
    dr.SHAPES = {"cell": ShapeConfig("cell", seq, batch, mode)}
    rc = (RunConfig(remat="full", microbatches=2) if mode == "train"
          else RunConfig())
    out[mode] = {"record": dr.lower_cell(arch, "cell", False, rc, Options(
        q_block=block, kv_block=block, remat=rc.remat, moe_group=64)),
        "collectives_by_type": by_type(hlo["text"])}
print(json.dumps(out))
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
        "ref_cell": _start(["-c", _REF_CELLS, "gemma2-2b", str(SEQ),
                            str(BATCH), str(BLOCK), "prefill"]),
        # the train and decode cells of the archs held to a band
        **{f"ref_{arch}": _start(["-c", _REF_CELLS, arch, "32", "4", "16",
                                  "train", "decode"])
           for arch in BAND_ARCHS},
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
    return {"ref_flops": last["ref_flops"],
            "ref_cell": last["ref_cell"]["prefill"]["record"],
            "port_cell": rec, **last["cells_a"], **last["cells_b"],
            "ref": {arch: {SHAPE_OF[m]: r for m, r in
                           last[f"ref_{arch}"].items()}
                    for arch in BAND_ARCHS}}


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
    HBM 16.38e6 against 22.12e6, collectives 0.330e6 against 0.426e6
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


# (arch, shape): the band of HBM bytes and of collective bytes a device,
# port over reference (collectives against its total_bf16_corrected), the
# prefill cell's 0.6-1.1 where the port reaches it, else within 10 % of
# the reading (readings: torch 2.13, jax 0.9)
BANDS = {
    # HBM 1.364: eager ops, each reading and writing its operands, where
    # XLA fuses; AdamW's elementwise steps alone (adamw.adamw_update,
    # 3.22e7 bytes, 26 % of the port's) make up the 3.28e7 bytes of the
    # gap; held on both sides within 10 % of the reading; collectives
    # 0.877
    ("gemma2-2b", "train_4k"): ((1.23, 1.50), (0.6, 1.1)),
    # HBM 0.713; collectives 0.0499: the reference all-gathers wk and wv
    # (f32[128,128], 262,144 of its 277,280 bytes) to write the new
    # token's K/V into the sequence-split cache, where the port gathers
    # the token's k and v themselves (common.forward, 4,096 bytes)
    ("gemma2-2b", "decode_32k"): ((0.6, 1.1), (0.045, 0.055)),
    # HBM 0.685, collectives 0.898
    ("zamba2-2.7b", "train_4k"): ((0.6, 1.1), (0.6, 1.1)),
    # HBM 0.718, collectives 0.901
    ("zamba2-2.7b", "decode_32k"): ((0.6, 1.1), (0.6, 1.1)),
}


@pytest.mark.parametrize(("arch", "shape"), list(BANDS))
def test_train_and_decode_cell_bytes_near_the_reference(arch, shape, runs):
    """HBM bytes and collective bytes a device of a reduced train cell
    (full remat, 2 microbatches) and decode cell on the (2, 2) mesh,
    against the reference's partitioned HLO of the same cell, within
    BANDS.  The train step's gradients are reduce-scattered once into the
    optimizer state's ZeRO-1 shards (`optim.adamw._as_moment`); zamba2's
    fused in_proj output and its conv's output are each gathered once
    before they are split (`models.mamba2.mamba_forward`); DTensor's
    all-to-all is counted as a card mesh runs it (`launch.dryrun`)."""
    rec, ref = runs[arch][shape], runs["ref"][arch][shape]["record"]
    assert rec["ok"] is True, rec.get("error")
    hbm = rec["hlo_bytes_per_device"] / ref["hlo_bytes_per_device"]
    coll = (rec["collective_bytes"]["total"]
            / ref["collective_bytes"]["total_bf16_corrected"])
    (h0, h1), (c0, c1) = BANDS[arch, shape]
    assert h0 <= hbm <= h1, hbm
    assert c0 <= coll <= c1, coll


def test_gemma2_decode_gap_is_the_reference_gathering_wk_and_wv(runs):
    """Why gemma2-2b x decode_32k's collectives are 0.05 x the reference's:
    to write the new token's K/V into the sequence-split cache, the
    reference all-gathers wk and wv, fp32 (d_model, K/V heads x head dim),
    in every layer, where the port gathers the token's k and v, bf16 (B,
    1, K/V heads, head dim).  Without those weight gathers the reference
    moves about what the port moves (reading 0.913)."""
    cfg = get_config("gemma2-2b").reduced()
    cell = runs["ref"]["gemma2-2b"]["decode_32k"]
    ref = cell["record"]
    w = f"all-gather f32[{cfg.d_model},{cfg.n_kv_heads * cfg.head_dim}]"
    weights = sum(b for key, b in cell["collectives_by_type"]
                  if key.startswith(w + "{"))
    assert weights == cfg.n_layers * 2 * cfg.d_model * cfg.n_kv_heads \
        * cfg.head_dim * 4
    rest = ref["collective_bytes"]["total_bf16_corrected"] - weights
    ours = runs["gemma2-2b"]["decode_32k"]["collective_bytes"]["total"]
    assert 0.6 <= ours / rest <= 1.1, (ours, rest)


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
