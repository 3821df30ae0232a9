"""The harness's own arithmetic, on the CPU: traffic from a seed, the
window's tokens, the frozen cost arithmetic against the program's, the
trace's busy time and gaps, and the exit without a card."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench.harness import cost, spec, traffic, weights, work  # noqa: E402
from bench.harness.trace import Trace  # noqa: E402

SEEDS = [0, 7, 2**31 + 11, 2**63 + 5, -3]


@pytest.mark.parametrize("seed", SEEDS)
def test_same_seed_same_prompts(seed):
    a, b = traffic.Prompts(seed, 32000, 64), traffic.Prompts(seed, 32000, 64)
    for c in (0, 3, 0):
        pa, pb = a.next(c), b.next(c)
        assert np.array_equal(pa, pb)
        assert pa.min() >= 0 and pa.max() < 32000


def test_seeds_and_clients_differ_in_data_not_in_shape():
    x, y = traffic.Prompts(1, 100, 8), traffic.Prompts(2, 100, 8)
    assert not np.array_equal(x.next(0), y.next(0))
    assert not np.array_equal(x.next(1), traffic.Prompts(1, 100, 8).next(0))
    assert x.next(5).shape == y.next(5).shape == (8,)


def test_serve_end_to_end_counts_the_window():
    from types import SimpleNamespace

    from bench.harness import serve
    cell = SimpleNamespace(traffic={"prompt_len": 100, "max_new": 4})
    tok = np.zeros(4, np.int64)
    reqs = [{"sub": 0.0, "done": 1.0, "ok": True, "tokens": tok},
            {"sub": 0.5, "done": 2.5, "ok": True, "tokens": tok},
            {"sub": 0.6, "done": 2.501, "ok": True, "tokens": tok},
            {"sub": 0.7, "done": 4.0, "ok": True, "tokens": tok},
            {"sub": 1.9, "done": 4.5, "ok": True, "tokens": None}]
    e = serve.end_to_end(cell, {"requests": reqs, "end": 2.0, "t0": 0.0})
    # the window closes with the batch replied at 2.5, both of its
    # requests; a later batch and a request cut by the close do not count
    assert e["tokens_per_s"] == 3 * 104 / 2.501
    assert e["attempted"] == 5 and e["failed"] == 0
    for r in reqs[1:3]:                 # answered before the nominal end:
        r["done"] -= 1.0                # the batch at 4.0 closes it
    e = serve.end_to_end(cell, {"requests": reqs, "end": 2.0, "t0": 0.0})
    assert e["tokens_per_s"] == 4 * 104 / 4.0


def test_a_reply_that_fails_or_never_comes_is_failed():
    from types import SimpleNamespace

    from bench.harness import serve
    cell = SimpleNamespace(traffic={"prompt_len": 100, "max_new": 4})
    tok = np.zeros(4, np.int64)
    reqs = [{"sub": 0.0, "done": 1.0, "ok": True, "tokens": tok},
            {"sub": 0.1, "done": 1.0, "ok": False, "tokens": None},
            {"sub": 0.2, "done": None, "ok": False, "tokens": None}]
    e = serve.end_to_end(cell, {"requests": reqs, "end": 2.0, "t0": 0.0})
    assert e["attempted"] == 3 and e["failed"] == 2


SHAPES = [(1, 4080, 32, 32, 128), (2, 2048, 32, 32, 80), (3, 100, 16, 4, 64)]


@pytest.mark.parametrize("shape", SHAPES)
def test_frozen_flash_cost_is_the_programs(shape):
    from repro_torch.kernels import cost as program
    b, s, h, g, hd = shape
    for kw in ({}, {"window": 64}, {"causal": False, "t": 77}):
        assert (cost.flash_attention(b, s, h, g, hd, itemsize=2, **kw)
                == tuple(program.flash_attention(b, s, h, g, hd, itemsize=2,
                                                 **kw)))


def test_least_times_are_bounds():
    # flash at the backlog's prefill: compute-bound, ~0.14 ms
    t = work.flash_least_s(1, 4080, 32, 32, 128)
    assert 1.0e-4 < t < 2.0e-4
    # a short call is bytes-bound
    c = cost.flash_attention(1, 16, 32, 32, 128, itemsize=2)
    assert work.flash_least_s(1, 16, 32, 32, 128) == c.nbytes / work.HBM_BYTES_S


def test_model_flops_match_the_parameter_count():
    m = spec.load("deepseek-7b.serve.backlog4k").model
    params, layers = work.layer_shape(m)
    assert layers == 30 and abs(params - 6.07e9) < 0.01e9
    f = work.prefill_flops(m, 1, 4080)
    assert 2 * params * 4080 < f < 2 * params * 4080 * 1.15
    assert work.prefill_flops(m, 8, 4080) == pytest.approx(8 * f)
    # a decode step: the matrices, the head, and q.k and p.v over the cache
    d = work.decode_flops(m, 1, 4080)
    assert d == 2 * params + 2 * 4096 * 102400 + 30 * 4 * 4096 * 4081


def test_trace_busy_and_gaps():
    ms = 1_000_000
    tr = Trace([("k1", 0, 2 * ms), ("k2", 1 * ms, 2 * ms),
                ("flash_fwd_tc<128>", 10 * ms, 1 * ms)],
               [("aten::mm", 0, 4 * ms), ("decode", 3 * ms, 9 * ms),
                ("aten::add", 5 * ms, 8 * ms)])
    assert tr.intervals() == [[0, 3 * ms], [10 * ms, 11 * ms]]
    assert tr.busy_s() == pytest.approx(4e-3)
    assert tr.kernel_seconds(["flash_fwd_tc"]) == pytest.approx(1e-3)
    gaps = tr.idle_gaps()
    assert gaps == [["aten::add", pytest.approx(7e-3)]]
    assert tr.top_ops()[0][0] in ("k1", "k2")


def test_weights_repeat_leaf_by_leaf():
    skel = {"a": torch.empty(3, 4, 5, device="meta"),
            "n": torch.empty(6, device="meta"),
            "b": torch.empty(4, 2, device="meta", dtype=torch.bfloat16)}
    rules = {"matrix": ["fan_in", 1.0, 0.0], "vector": ["normal", 1.0, 0.1]}
    w1 = weights.make(skel, rules, 2**31 + 1, "cpu")
    w2 = weights.make(skel, rules, 2**31 + 1, "cpu", only={2})
    assert w1["b"].dtype == torch.bfloat16 and w2["a"] is None
    assert torch.equal(w1["b"], w2["b"])
    assert not torch.equal(w1["a"][0], w1["a"][1])


def test_exits_without_a_card_and_prints_nothing():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run(
        [sys.executable, str(ROOT / "bench" / "run.py"), "--workload",
         "deepseek-7b.serve.backlog4k", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
        timeout=300)
    assert p.returncode != 0 and p.stdout == ""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_weights_on_the_card_repeat(card):
    skel = {"w": torch.empty(2, 64, 64, device="meta", dtype=torch.bfloat16)}
    rules = {"matrix": ["fan_in", 1.0, 0.0], "vector": ["normal", 1.0, 0.1]}
    a = weights.make(skel, rules, 5, card)
    b = weights.make(skel, rules, 5, card)
    assert torch.equal(a["w"], b["w"]) and a["w"].is_cuda
