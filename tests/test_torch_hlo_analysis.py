"""The port's `launch/hlo_analysis.py` (per-device op counting beneath
DTensor) against the reference's tests/test_hlo_analysis.py: a matmul's
exact FLOPs, a loop of 8 matmuls counting 8 times one, slice writes
counting slices and not the buffer, and `roofline_terms` equal to the
reference's.  On a fake 2x2 mesh (in a subprocess): a column/row-split MLP
counts each device's FLOPs, not the global ones (DTensor's sharding
propagation runs each op again at global shapes on FakeTensors, which the
count leaves out), and an all-reduce counts its output's bytes.  Each
kernel op under `analyze` counts exactly its `kernels/cost.py` figure, on
meta and on the CPU; the closed-form pair count equals the loop."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch import hlo_analysis as jha  # noqa: E402
from repro_torch.kernels import cost  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.mamba2_ssd.ops import ssd  # noqa: E402
from repro_torch.kernels.rwkv6_scan.ops import wkv6  # noqa: E402
from repro_torch.kernels.tiled_matmul.ops import tiled_matmul  # noqa: E402
from repro_torch.launch.hlo_analysis import (Counter, analyze,  # noqa: E402
                                             roofline_terms)

ROOT = Path(__file__).resolve().parents[1]
DEVICES = ["cpu", "meta"]


@pytest.mark.parametrize("device", DEVICES)
def test_dot_flops_value(device):
    a = torch.ones(128, 64, device=device)
    b = torch.ones(64, 32, device=device)
    assert analyze(lambda: a @ b)["flops"] == 2 * 128 * 64 * 32


@pytest.mark.parametrize("device", DEVICES)
def test_loop_of_8_matmuls_counts_8_times_one(device):
    x = torch.ones(256, 256, device=device)
    w = torch.ones(8, 256, 256, device=device)

    def loop(x, w):
        for i in range(8):
            x = x @ w[i]
        return x

    f1 = analyze(lambda: x @ w[0])["flops"]
    f8 = analyze(loop, x, w)["flops"]
    assert f1 > 0 and f8 == 8 * f1
    assert analyze(loop, x, w)["trip_counts"] == {}


@pytest.mark.parametrize("device", DEVICES)
def test_slice_writes_count_the_slice_not_the_buffer(device):
    x = torch.ones(64, 1024, device=device)

    def stack(c):
        ys = torch.empty((32, 64, 1024), device=device)
        for i in range(32):
            c = c * 1.0001
            ys[i] = c
        return ys

    hbm = analyze(stack, x)["hbm_bytes"]
    buf = 32 * 64 * 1024 * 4
    assert buf <= hbm < 12 * buf, (hbm, buf)


def test_views_count_nothing_and_gathers_the_rows_they_take():
    table = torch.ones(1000, 16)
    idx = torch.tensor([1, 5, 7])
    assert analyze(lambda: table.view(16, 1000).T[2:])["hbm_bytes"] == 0
    rows = 2 * 3 * 16 * 4 + 3 * 8
    assert analyze(lambda: table[idx])["hbm_bytes"] == rows
    assert analyze(torch.nn.functional.embedding, idx, table)[
        "hbm_bytes"] == rows


def test_index_put_counts_the_rows_written():
    cache = torch.zeros(4, 100, 8)
    rows, pos = torch.arange(4), torch.tensor([3, 9, 0, 99])
    new = torch.ones(4, 8)

    def write():
        cache[rows, pos] = new

    assert analyze(write)["hbm_bytes"] == 2 * 4 * 8 * 4 + 2 * 4 * 8


def test_roofline_terms_equal_the_reference():
    rng = np.random.default_rng(0)
    for _ in range(20):
        f, b, c = (float(v) for v in rng.uniform(0, 1e15, 3))
        n = int(rng.integers(1, 513))
        kw = dict(peak_flops=float(rng.uniform(1e12, 1e15)),
                  hbm_bw=float(rng.uniform(1e11, 1e13)),
                  ici_bw=float(rng.uniform(1e9, 1e12)))
        assert roofline_terms(f, b, c, n, **kw) == \
            jha.roofline_terms(f, b, c, n, **kw)


def test_report_keys():
    rep = analyze(lambda: torch.ones(3) + 1)
    assert set(rep) >= {"flops", "hbm_bytes", "collectives", "trip_counts"}
    assert rep["collectives"] == {"total": 0, "total_bf16_corrected": 0}


# --------------------------------------------------- the kernel ops


def _flash(device, window, causal, t):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 40, 4, 16, generator=g).to(device)
    k = torch.randn(2, t, 2, 16, generator=g).to(device)
    v = torch.randn(2, t, 2, 8, generator=g).to(device)
    fn = lambda: flash_attention(q, k, v, causal=causal, window=window,  # noqa: E731
                                 scale=0.25, q_block=16, kv_block=16)
    want = cost.flash_attention(2, 40, 4, 2, 16, window=window, itemsize=4,
                                hd_v=8, t=t, causal=causal)
    return fn, want


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("window,causal,t", [(None, True, 40), (7, True, 40),
                                             (None, False, 24),
                                             (9, False, 56)])
def test_flash_counts_its_cost(device, window, causal, t):
    fn, want = _flash(device, window, causal, t)
    rep = analyze(fn)
    assert (rep["flops"], rep["hbm_bytes"]) == (want.flops, want.nbytes)
    assert rep["kernels"] == {"flash_attention": {
        "calls": 1, "flops": want.flops, "bytes": want.nbytes}}


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("with_state", [False, True])
def test_wkv6_counts_its_cost(device, with_state):
    g = torch.Generator().manual_seed(0)
    r, k, v = (torch.randn(2, 32, 2, 8, generator=g).to(device)
               for _ in range(3))
    logw = -torch.rand(2, 32, 2, 8, generator=g).to(device)
    u = torch.randn(2, 8, generator=g).to(device)
    s0 = torch.randn(2, 2, 8, 8, generator=g).to(device) if with_state \
        else None
    rep = analyze(wkv6, r, k, v, logw, u, chunk=16, initial_state=s0)
    want = cost.wkv6(2, 32, 2, 8, 16, with_state)
    assert (rep["flops"], rep["hbm_bytes"]) == (want.flops, want.nbytes)


def _ssd_in(device, g):
    xdt = torch.randn(2, 32, 4, 8, generator=g).to(device)
    dA = -torch.rand(2, 32, 4, generator=g).to(device)
    B_ = torch.randn(2, 32, 1, 16, generator=g).to(device)
    C_ = torch.randn(2, 32, 1, 16, generator=g).to(device)
    return xdt, dA, B_, C_


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("state", [False, True])
def test_ssd_counts_its_cost(device, state):
    g = torch.Generator().manual_seed(0)
    ins = _ssd_in(device, g)
    s0 = torch.randn(2, 4, 8, 16, generator=g).to(device) if state else None
    rep = analyze(ssd, *ins, chunk=16, initial_state=s0, return_state=state)
    want = cost.ssd(2, 32, 4, 8, 16, 16, 4, state, state)
    assert (rep["flops"], rep["hbm_bytes"]) == (want.flops, want.nbytes)


@pytest.mark.parametrize("device", DEVICES)
def test_ssd_backward_counts_its_cost(device):
    g = torch.Generator().manual_seed(0)
    ins = [t.requires_grad_() for t in _ssd_in(device, g)]
    y = ssd(*ins, chunk=16)
    dy = torch.ones_like(y)
    rep = analyze(torch.autograd.grad, y, ins, dy)
    want = cost.ssd_bwd(2, 32, 4, 8, 16, 16, 4)
    assert rep["kernels"] == {"mamba2_ssd_bwd": {
        "calls": 1, "flops": want.flops, "bytes": want.nbytes}}


@pytest.mark.parametrize("device", DEVICES)
def test_tiled_matmul_counts_its_cost(device):
    a = torch.ones(64, 48, device=device)
    b = torch.ones(64, 40, device=device)
    rep = analyze(tiled_matmul, a, b)
    want = cost.tiled_matmul(64, 48, 40, 4)
    assert (rep["flops"], rep["hbm_bytes"]) == (want.flops, want.nbytes)


def test_counter_suspends_only_inside_a_kernel_op():
    q = torch.ones(1, 8, 2, 4)
    with Counter() as c:
        flash_attention(q, q, q, scale=1.0)
        torch.ones(4, 4) @ torch.ones(4, 4)
    assert c.flops == cost.flash_attention(1, 8, 2, 2, 4, itemsize=4).flops \
        + 2 * 4 * 4 * 4
    assert cost._active is None


def _pairs_loop(s, t, window, causal):
    return sum(max(0, (min(i, t - 1) if causal else t - 1)
                   - (max(0, i - window + 1) if window else 0) + 1)
               for i in range(s))


def test_pairs_closed_form_equals_the_loop():
    for s in (1, 5, 64, 100):
        for t in (1, 5, 64, 130):
            for window in (None, 1, 3, 16, 200):
                for causal in (True, False):
                    assert cost._pairs(s, t, window, causal) == \
                        _pairs_loop(s, t, window, causal), \
                        (s, t, window, causal)


# ------------------------------------------- per device on a fake mesh

_MESH = r"""
import json
import torch, torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.launch.dryrun import (_alltoall_as_on_a_card_mesh,
                                      start_fake_group)
from repro_torch.launch.hlo_analysis import analyze

start_fake_group(4)
try:
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    B, D, F = 64, 256, 512
    x = distribute_tensor(torch.empty(B, D, device="meta"), mesh,
                          [Shard(0), Replicate()])
    w1 = distribute_tensor(torch.empty(D, F, device="meta"), mesh,
                           [Replicate(), Shard(1)])
    w2 = distribute_tensor(torch.empty(F, D, device="meta"), mesh,
                           [Replicate(), Shard(0)])
    mlp = analyze(lambda: (torch.relu(x @ w1) @ w2).redistribute(
        mesh, [Shard(0), Replicate()]))
    t = torch.empty(32, 8, device="meta")
    ar = analyze(lambda: funcol.all_reduce(t, "sum", (mesh, 1)))
    y = distribute_tensor(torch.empty(64, 32, device="meta"), mesh,
                          [Shard(0), Replicate()])
    with _alltoall_as_on_a_card_mesh():
        a2a = analyze(lambda: y.redistribute(mesh, [Shard(1), Replicate()]))
    print(json.dumps({"mlp": mlp, "ar": ar, "a2a": a2a}))
finally:
    dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def on_mesh():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", _MESH], env=env, timeout=120,
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_split_mlp_counts_local_flops(on_mesh):
    B, D, F = 64, 256, 512
    local = 2 * (B // 2) * D * (F // 2) * 2          # two matmuls a device
    assert on_mesh["mlp"]["flops"] == local
    # the row-split product is Partial: reducing it is one all-reduce (or
    # reduce-scatter) of the device's (B/2, D) rows
    coll = on_mesh["mlp"]["collectives"]
    assert coll["total"] == (B // 2) * D * 4 or \
        coll.get("reduce-scatter") == (B // 4) * D * 4, coll


def test_all_reduce_counts_its_output(on_mesh):
    coll = on_mesh["ar"]["collectives"]
    assert coll["all-reduce"] == 32 * 8 * 4
    assert coll["total"] == coll["total_bf16_corrected"] == 32 * 8 * 4


def test_a_split_to_split_move_counts_as_an_all_to_all(on_mesh):
    """The dry run's patch is live: a Shard(0) -> Shard(1) move over the
    data axis is DTensor's all-to-all, its output (64, 32 / 2) fp32 a
    device, and no all-gather."""
    coll = on_mesh["a2a"]["collectives"]
    assert coll["all-to-all"] == 64 * 16 * 4, coll
    assert coll["total"] == 64 * 16 * 4 and not coll.get("all-gather"), coll


def test_a_served_prefill_counts_the_same_on_the_cpu_and_on_meta():
    """chip_smoke.py's check on the card, on the CPU: one prefill batch of
    reduced gemma2 into a preallocated cache counts the same FLOPs and
    bytes on real tensors as on meta ones (both counts come from shapes),
    the flash op recorded once a layer."""
    from repro_torch.configs import get_config
    from repro_torch.models.common import tree_map
    from repro_torch.models.model import build_model
    from repro_torch.runtime.serve_step import (init_serving_params,
                                                make_prefill_step)
    cfg = get_config("gemma2-2b").reduced()
    model = build_model(cfg)
    params = init_serving_params(model, torch.Generator().manual_seed(0),
                                 "cpu")
    step = make_prefill_step(model)
    toks = torch.randint(0, cfg.vocab_size, (1, 40),
                         generator=torch.Generator().manual_seed(1))

    def one(p, batch, dev):
        return step(p, batch, model.init_cache(1, 57, device=dev))

    def meta(tree):
        return tree_map(lambda t: torch.empty_like(t, device="meta"), tree)

    with torch.inference_mode():
        cpu = analyze(one, params, {"tokens": toks}, "cpu")
        on_meta = analyze(one, meta(params), meta({"tokens": toks}), "meta")
    assert (cpu["flops"], cpu["hbm_bytes"]) == (on_meta["flops"],
                                                on_meta["hbm_bytes"])
    assert cpu["kernels"]["flash_attention"]["calls"] == cfg.n_layers
    assert cpu["flops"] > cpu["kernels"]["flash_attention"]["flops"] > 0
