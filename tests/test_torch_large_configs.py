"""The three largest configs at the depths chip_smoke.py serves them at on
the card (its LARGE_SERVES): qwen2.5-32b at 32 of 64 layers, deepseek-67b
at 24 of 95 and arctic-480b at 1 of 35, all at full width.

- On meta: at each depth the parameter count is the one chip_smoke.py
  checks, and the peak of `init_serving_params`, the served tree plus the
  largest leaf drawn in fp32, stays under the card's 80e9 bytes.  The
  served tree is bf16 where the model reads a leaf only through a cast,
  fp32 elsewhere.  arctic-480b at 2 layers would not fit, which is why it
  is served at 1.  The init's fp32 stack, not the card, sets these
  depths: drawn a layer at a time, the init would reach the depths of
  DEPTH_IF_DRAWN_A_LAYER_AT_A_TIME.
- On the CPU: each config, reduced, served through `launch.serve.main`
  with its depth patched in as chip_smoke.py patches it: 4 replies, and
  the reduced config's depth, min(depth, 2)."""
import importlib.util
from pathlib import Path
from unittest import mock

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.runtime.serve_step import (_cast_only_leaves,  # noqa: E402
                                            _leaves, init_serving_params)

ROOT = Path(__file__).resolve().parents[1]
CARD_BYTES = 80e9


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()
SERVES = {arch: (depth, dims, n) for arch, depth, dims, n, _ in
          CS.LARGE_SERVES}


def _init_peak(arch, depth):
    """(parameters, served tree bytes, largest fp32 leaf bytes) of `arch`
    at `depth`, counted on meta."""
    model = build_model(get_config(arch).replace(n_layers=depth))
    params = model.init(torch.Generator().manual_seed(0), "meta")
    cast = _cast_only_leaves(model)
    leaves = list(_leaves(params))
    served = sum(t.numel() * (2 if path in cast else 4)
                 for path, t in leaves)
    return (sum(t.numel() for _, t in leaves), served,
            max(t.numel() * 4 for _, t in leaves))


def test_the_depths_are_the_named_constants():
    assert {a: d for a, (d, _, _) in SERVES.items()} == {
        "qwen2.5-32b": CS.QWEN32_LAYERS, "deepseek-67b": CS.DS67_LAYERS,
        "arctic-480b": CS.ARCTIC_LAYERS}
    for arch, (depth, dims, _) in SERVES.items():
        cfg = get_config(arch)
        assert dims == (depth, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                        cfg.resolved_head_dim, cfg.vocab_size)
        assert depth < cfg.n_layers


@pytest.mark.parametrize("arch", list(SERVES))
def test_the_served_depth_fits_the_card(arch):
    depth, _, n_params = SERVES[arch]
    n, served, largest = _init_peak(arch, depth)
    assert n == n_params
    assert served + largest < CARD_BYTES, (served, largest)


def test_arctic_at_two_layers_would_not_fit():
    _, served, largest = _init_peak("arctic-480b", 2)
    assert served + largest > CARD_BYTES, (served, largest)


# the deepest each config would be served if `init_serving_params` drew a
# stacked (L, ...) leaf one layer at a time: its init then peaks at the
# served tree plus the largest fp32 leaf of one layer, held here under
# 75e9 bytes (5e9 left for the prefill); arctic's padded MoE dispatch at
# 4200 tokens needs more than that beside 2 layers (chip_smoke.py prints
# the serve's peak apart from the init's)
DEPTH_IF_DRAWN_A_LAYER_AT_A_TIME = {"qwen2.5-32b": 64, "deepseek-67b": 49,
                                    "arctic-480b": 2}


@pytest.mark.parametrize("arch", list(SERVES))
def test_the_fp32_stack_sets_the_depth_not_the_card(arch):
    """The served depth is set by the init's fp32 stack: drawn a layer at
    a time, the init would reach DEPTH_IF_DRAWN_A_LAYER_AT_A_TIME."""
    _, one, slice_ = _init_peak(arch, 1)     # at depth 1 a stack is a layer
    per_layer = _init_peak(arch, 2)[1] - one
    deepest = min(get_config(arch).n_layers,
                  int((75e9 - slice_ - one) // per_layer) + 1)
    assert deepest == DEPTH_IF_DRAWN_A_LAYER_AT_A_TIME[arch]
    assert deepest > SERVES[arch][0]


def test_a_decode_step_needs_the_chosen_experts_only():
    """chip_smoke.py's decode bound at arctic-480b's served depth: every
    served leaf, but one row of the input embedding (the head is its own
    leaf) and top_k of the E routed experts, plus the K/V cache over the
    filled positions."""
    depth, pos = SERVES["arctic-480b"][0], 4208
    cfg = get_config("arctic-480b").replace(n_layers=depth)
    model = build_model(cfg)
    params = init_serving_params(model, torch.Generator(), "meta")
    nbytes = {path: t.numel() * t.element_size()
              for path, t in CS.leaf_items(params)}
    experts = sum(nbytes[f"/blocks/mlp/{w}"] for w in ("w1", "w2", "w3"))
    cache = depth * 2 * pos * cfg.n_kv_heads * cfg.resolved_head_dim * 2
    want = (sum(nbytes.values()) - nbytes["/embed"] + cfg.d_model * 2
            - experts + experts * cfg.moe.top_k // cfg.moe.n_experts
            + cache)
    assert CS.decode_step_bytes(model, params, 1, pos) == (want, cache)
    assert want < sum(nbytes.values()) / 20


@pytest.mark.parametrize("arch", list(SERVES))
def test_served_reduced_at_the_patched_depth(arch):
    depth = SERVES[arch][0]
    full = serve.get_config
    with mock.patch.object(serve, "get_config",
                           lambda a: full(a).replace(n_layers=depth)):
        res = serve.main(["--arch", arch, "--requests", "4", "--prompt-len",
                          "8", "--max-new", "3", "--device", "cpu"])
    assert res["model"].cfg.n_layers == min(depth, 2)
    assert res["model"].cfg.d_model == 128          # reduced
    assert len(res["replies"]) == 4
    for row in res["replies"]:
        assert row.shape == (3,)
        assert 0 <= row.min() and row.max() < res["model"].cfg.vocab_size
