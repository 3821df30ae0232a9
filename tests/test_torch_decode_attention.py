"""Port parity: decode attention (one new token against a GQA cache) against
the JAX version, with windows and softcap, fp32.  Tolerance 2e-5.  Then the
op's wiring on the CPU: the plain version on CPU and meta tensors, the cost
count, the kernels' names and the launch plan (the kernel itself is held
against the plain version on the card, test_torch_decode_attention_cuda.py)."""
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import attention as jattn  # noqa: E402
from repro_torch.kernels import cost  # noqa: E402
from repro_torch.kernels.decode_attention import kernel as da_kernel  # noqa: E402
from repro_torch.kernels.decode_attention import ops as da_ops  # noqa: E402
from repro_torch.kernels.decode_attention import ref as da_ref  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402

TOL = 2e-5


@pytest.mark.parametrize("window,cap", [(None, 0.0), (None, 50.0), (7, 50.0),
                                        (30, 0.0)])
def test_decode_attention_matches_jax(window, cap):
    rng = np.random.default_rng(0)
    B, T, G, hq, hd = 3, 40, 4, 16, 32
    q = rng.standard_normal((B, 1, hq, hd)).astype(np.float32)
    kc = rng.standard_normal((B, T, G, hd)).astype(np.float32)
    vc = rng.standard_normal((B, T, G, hd)).astype(np.float32)
    pos = np.array([0, 17, 39], np.int32)
    out = attn.decode_attention(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        torch.from_numpy(pos).long(), window=window, logit_softcap=cap,
        scale=0.125)
    ref = jattn.decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(pos),
        window=window, logit_softcap=cap, scale=0.125)
    assert float(np.max(np.abs(out.numpy() - np.asarray(ref)))) < TOL


CSRC = Path(da_ops.__file__).resolve().parents[2] / "csrc"

# (B, Hq_pad, G, hd) of every dense config's decode: deepseek-7b,
# gemma2-2b, qwen2-vl-2b, qwen2.5-32b, deepseek-67b / arctic-480b, zamba2,
# whisper's decoder; and a reduced config's single group (M_pad 16)
SERVED = [(32, 32, 128), (16, 4, 256), (16, 2, 128), (48, 8, 128),
          (64, 8, 128), (32, 32, 80), (16, 8, 64), (16, 1, 32)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window,cap", [(None, 0.0), (4096, 50.0), (7, 0.0)])
def test_op_on_cpu_is_the_plain_version(dtype, window, cap):
    """On CPU tensors the op is the plain version, bit for bit, and
    launches nothing."""
    rng = np.random.default_rng(1)
    dt = getattr(torch, dtype)
    B, T, G, hq, hd = 2, 33, 2, 8, 32
    q = torch.from_numpy(rng.standard_normal((B, 1, hq, hd))).to(dt)
    kc = torch.from_numpy(rng.standard_normal((B, T, G, hd))).to(dt)
    vc = torch.from_numpy(rng.standard_normal((B, T, G, hd))).to(dt)
    pos = torch.tensor([0, T - 1])
    before = da_ops.decode_attention.launches
    kw = dict(window=window, logit_softcap=cap, scale=hd ** -0.5)
    out = attn.decode_attention(q, kc, vc, pos, **kw)
    assert attn.decode_attention is da_ops.decode_attention
    assert torch.equal(out, da_ref.decode_attention_ref(q, kc, vc, pos, **kw))
    assert out.dtype == dt and out.shape == (B, 1, hq, hd)
    assert da_ops.decode_attention.launches == before


def test_op_on_meta_gives_the_shape():
    q = torch.empty((8, 1, 32, 128), dtype=torch.bfloat16, device="meta")
    kc = torch.empty((8, 4097, 32, 128), dtype=torch.bfloat16, device="meta")
    pos = torch.empty((8,), dtype=torch.long, device="meta")
    out = da_ops.decode_attention(q, kc, kc, pos, scale=128 ** -0.5)
    assert out.shape == (8, 1, 32, 128) and out.dtype == torch.bfloat16


def test_cost_at_the_cells_shape():
    """deepseek-7b's decode at batch 8 against 4097 positions, bf16: K and
    V are 8 x 4097 x 32 x 128 x 2 bytes each (537 MB together a layer), q
    and the output 8 x 32 x 128 x 2 bytes each; 2 x 128 FLOPs for q.k and
    as many for p.v per head and key."""
    c = cost.decode_attention(8, 4097, 32, 32, 128, itemsize=2)
    kv = 2 * (8 * 4097 * 32 * 128 * 2)
    assert kv == 537_001_984
    assert c.nbytes == kv + 2 * (8 * 32 * 128 * 2)
    assert c.flops == 2 * 2 * 128 * 8 * 32 * 4097
    # the bound at 3.35 TB/s: 0.160 ms a layer
    assert abs(c.nbytes / 3.35e12 * 1e3 - 0.1604) < 1e-4
    # a window caps the keys a row reaches
    w = cost.decode_attention(1, 8192, 16, 4, 256, itemsize=2, window=4096)
    assert w.nbytes == 2 * (2 * 4096 * 4 * 256 + 2 * 16 * 256)


def test_kernel_names_are_not_flashs():
    """Every kernel of csrc/decode_attention.cu is named decode_attn_*, and
    none contains the names the flash roofline reader sums
    (bench/metrics/flash_roofline.serve.py), so that it reads flash alone."""
    src = (CSRC / "decode_attention.cu").read_text()
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                       r"(\w+)\s*\(", src)
    assert sorted(names) == ["decode_attn_out", "decode_attn_pv",
                             "decode_attn_scores"]
    for name in names:
        assert "flash_fwd_tc" not in name
        assert "flash_fwd_cuda_cores" not in name
    for other in CSRC.glob("*.cu"):
        if other.name != "decode_attention.cu":
            assert "decode_attn_" not in other.read_text()


@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("hq,g,hd", SERVED)
def test_plan_covers_the_keys_and_fills_the_card(b, hq, g, hd):
    """The grid at every served decode shape: the rows a block hold the
    group's heads (in slices past 8), the chunks cover the 4097 keys with
    no chunk past them, and the grid reaches TARGET_BLOCKS unless the
    chunk is at its floor of 32 keys; the scratch is ~1 % of the cache's
    bytes at the cell's shape."""
    T, m = 4097, hq // g
    p = da_kernel.plan(b, g, m, T)
    assert p.rows in da_kernel.ROWS and p.rows * p.slices >= m
    assert p.rows * (p.slices - 1) < m
    assert p.chunk * p.chunks >= T > p.chunk * (p.chunks - 1)
    assert da_kernel.MIN_CHUNK <= p.chunk <= da_kernel.MAX_CHUNK
    assert (p.blocks(b, g) >= da_kernel.TARGET_BLOCKS
            or p.chunk == da_kernel.MIN_CHUNK)
    assert hd in da_kernel.HEAD_DIMS
    if (b, hq, g, hd) == (8, 32, 32, 128):
        assert p == da_kernel.Plan(1, 1, 512, 9)
        scratch = 4 * da_kernel.scratch_floats(b, hq, T, hd, p)
        assert scratch < 0.012 * cost.decode_attention(
            b, T, hq, g, hd, itemsize=2).nbytes


_SHARDED = r"""
import numpy as np
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.kernels.decode_attention import ops, ref

mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
B, T, hd = 4, 37, 16
gen = np.random.default_rng(3)


def draw(*shape, dt):
    return torch.from_numpy(gen.standard_normal(shape)).to(dt)


def split(x, *pl):
    return distribute_tensor(x, mesh, list(pl), src_data_rank=None)


out = {}
try:
    # (case, heads, groups, dtype, q's placement over `model`): q whole
    # over the heads as the model places it, the cache's groups split; q
    # split, one group for two shards; both split
    for name, hq, g, dt, q_pl in (
            ("groups", 8, 4, torch.float32, Replicate()),
            ("one_group", 8, 1, torch.float32, Shard(2)),
            ("bf16", 8, 4, torch.bfloat16, Shard(2))):
        q = draw(B, 1, hq, hd, dt=dt)
        kc, vc = draw(B, T, g, hd, dt=dt), draw(B, T, g, hd, dt=dt)
        pos = torch.tensor([0, 17, T - 1, 30])
        kw = dict(window=20, logit_softcap=30.0, scale=hd ** -0.5)
        want = ref.decode_attention_ref(q, kc, vc, pos, **kw)
        kv_pl = (Shard(0), Shard(2) if g % 2 == 0 else Replicate())
        got = ops._sharded(split(q, Shard(0), q_pl),
                           split(kc, *kv_pl), split(vc, *kv_pl), pos, kw)
        out[name] = {
            "split": [p.dim if p.is_shard() else None
                      for p in got.placements],
            "err": float((got.full_tensor().double()
                          - want.double()).abs().max()),
            "scale": float(want.double().abs().max())}
    try:
        ops._sharded(split(q, Shard(0), Replicate()),
                     split(kc, Shard(0), Shard(1)),
                     split(vc, Shard(0), Shard(1)), pos, kw)
        out["seq_split"] = "ran"
    except ValueError as e:
        out["seq_split"] = str(e)
finally:
    dist.destroy_process_group()
print(json.dumps(out))
"""


def test_sharded_op_runs_shard_by_shard():
    """The op's path for DTensors on the card, `_sharded`, on a (2, 2) mesh
    of 4 gloo processes, where each shard takes the plain version: the
    batch split over `data`, the heads and their K/V groups over `model`
    (and one group for two head shards, each shard picking it); the
    output equals the plain version on whole tensors, split as q is.  A
    cache split over its sequence raises: the kernel reduces over it."""
    from test_torch_distributed import _PROLOGUE, _run_ranks
    for r in _run_ranks(_PROLOGUE + _SHARDED):
        for name in ("groups", "one_group", "bf16"):
            assert r[name]["split"] == [0, 2], r[name]
            assert r[name]["err"] <= 1e-6 * r[name]["scale"], (name, r)
        assert "on mesh dim 1" in r["seq_split"], r["seq_split"]
