"""The Mamba2 layer's zero padding on split DTensors: a (2, 2) mesh of 4
gloo processes on the CPU, against the same calls on plain tensors in
fp32.

`models.mamba2._conv` pads the sequence with W - 1 zero rows in front
when it has no ring (prefill and training), and `mamba_forward` pads it
to a multiple of the chunk before the SSD.  Both go through
`models.common.zero_pad`, which pads each shard on its own: DTensor's own
rule for the pad raised an IndexError in its redistribution on torch
2.11, in the dry run's zamba2 prefill and train cells.  This torch runs
either way, so these tests pin the values of the padded paths;
chip_smoke.py's dry-run cells pin the torch version of the card's
machine.

- `_conv` without a ring and with one, on an input split over the batch
  (data) and the channels (model): outputs, rings and the gradients of
  the input, the weights and the bias.
- `mamba_forward` of reduced zamba2's first layer at 21 tokens (a chunk
  of 16 and a padded one), its params placed by `runtime.sharding`'s
  specs, the input split over the batch: the prefill path's output,
  final SSM state and conv ring; the training path's output and the
  gradients of the input and of every param.
- `zero_pad` refuses to pad a dimension that a mesh dim splits."""
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("torch.distributed")

from test_torch_distributed import _PROLOGUE, _run_ranks  # noqa: E402

_SCRIPT = _PROLOGUE + r"""
import numpy as np
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import get_config
from repro_torch.models import mamba2
from repro_torch.models.common import layer_params, mesh_context, zero_pad
from repro_torch.models.model import build_model
from repro_torch.runtime.sharding import logical_rules, param_specs
from repro_torch.placement import P, placements

B, S = 4, 21


def full(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def rel(got, want):
    got, want = full(got).double(), want.double()
    return ((got - want).abs().max()
            / want.abs().max().clamp(min=1.0)).item()


def split(x, *pl):
    return distribute_tensor(x, mesh, list(pl), src_data_rank=None)


def grads(fn, ins):
    # fn's outputs and the gradients of `ins` under a seeded cotangent
    ins = [x.detach().requires_grad_() for x in ins]
    outs = fn(*ins)
    gen = np.random.default_rng(9)
    loss = sum((full(o) * torch.from_numpy(gen.standard_normal(
        o.shape).astype(np.float32))).sum() for o in outs)
    loss.backward()
    return [o.detach() for o in outs], [x.grad for x in ins]


def compare(name, fn, plain_ins, dist_ins):
    want, want_g = grads(fn, plain_ins)
    got, got_g = grads(fn, dist_ins)
    out[name] = {"outputs": [rel(g, w) for g, w in zip(got, want)],
                 "grads": [rel(g, w) for g, w in zip(got_g, want_g)],
                 "split": [sum(p.is_shard() for p in x.placements)
                           for x in dist_ins]}


out = {}
try:
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    cfg = get_config("zamba2-2.7b").reduced()
    _, _, _, _, W, C, _ = mamba2.dims(cfg)
    rng = np.random.default_rng(0)
    f32 = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.standard_normal(shape).astype(np.float32))
    x, w, b, ring = f32(B, S, C), f32(W, C), f32(C), f32(B, W - 1, C)
    xs = split(x, Shard(0), Shard(2))
    ws, bs = split(w, Replicate(), Shard(1)), split(b, Replicate(), Shard(0))
    compare("conv", lambda x, w, b: mamba2._conv(x, w, b), [x, w, b],
            [xs, ws, bs])
    compare("conv ring",
            lambda x, w, b, r: mamba2._conv(x, w, b, conv_state=r),
            [x, w, b, ring], [xs, ws, bs, split(ring, Shard(0), Shard(2))])

    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    layer = layer_params(params["mamba"], 0)
    specs = {k: P(*s[1:])
             for k, s in param_specs(params, cfg)["mamba"].items()}
    keys = sorted(layer)
    h = f32(B, S, cfg.d_model)

    def train(x, *leaves):       # the training path: no state out
        return mamba2.mamba_forward(dict(zip(keys, leaves)), x, cfg),

    def serve(x, *leaves):       # the prefill path, with its cache
        with torch.no_grad():
            y, cache = mamba2.mamba_forward(dict(zip(keys, leaves)), x, cfg,
                                            return_cache=True)
        return y, cache["ssm"], cache["conv"]

    def on_mesh(fn):
        def run(*args):
            with mesh_context(mesh, logical_rules(mesh, global_batch=B)), \
                    implicit_replication():
                return fn(*args)
        return run

    plain = [h] + [layer[k] for k in keys]
    placed = [split(h, Shard(0), Replicate())] + [
        split(layer[k], *placements(mesh, specs[k])) for k in keys]
    want, want_g = grads(train, plain)
    got, got_g = grads(on_mesh(train), placed)
    out["mamba_forward"] = {
        "outputs": [rel(g, w) for g, w in zip(
            on_mesh(serve)(*placed), serve(*plain))],
        "grads": [rel(g, w) for g, w in zip(got + got_g, want + want_g)],
        "split_params": sum(p.is_shard() for k in keys
                            for p in placements(mesh, specs[k]))}
    try:
        zero_pad(xs, (0, 0, 0, 0, 1, 0))
        out["refused"] = False
    except ValueError:
        out["refused"] = True
    print(json.dumps(out))
finally:
    dist.destroy_process_group()
"""

# fp32 on both sides; the mesh's outputs differ from the plain tensors'
# only in the order of the sums its shards split (in_proj's and
# out_proj's products, the gathered gradients), a few ulps of the largest
# value; a wrong pad shifts the conv window by a row, off by O(1)
TOL = 1e-5


@pytest.fixture(scope="module")
def ranks():
    return _run_ranks(_SCRIPT)


@pytest.mark.parametrize("case", ["conv", "conv ring", "mamba_forward"])
def test_padded_paths_on_a_2x2_mesh_equal_plain_tensors(case, ranks):
    rec = ranks[0][case]
    assert max(rec["outputs"]) < TOL, rec
    assert max(rec["grads"]) < TOL, rec
    if case == "mamba_forward":
        assert rec["split_params"] > 0
    else:
        assert rec["split"][0] == 2          # the input split on both axes


def test_zero_pad_refuses_a_split_dim(ranks):
    assert ranks[0]["refused"] is True
