"""The three largest configs at the depths chip_smoke.py serves them at on
the card (its LARGE_SERVES): qwen2.5-32b whole, at all 64 layers,
deepseek-67b at 47 of 95 and arctic-480b at 1 of 35, all at full width.

- On meta: at each depth the parameter count is the one chip_smoke.py
  checks, and the peak of `init_serving_params`, the served tree plus the
  largest matrix drawn in fp32 (each stacked leaf is filled a matrix at a
  time), stays under the card's 80e9 bytes.  The served tree is bf16
  where the model reads a leaf only through a cast, fp32 elsewhere.
  arctic-480b at 2 layers would not fit beside its serve's padded MoE
  dispatch, which is why it is served at 1.  DEPTH_IF_DRAWN_A_LAYER_AT_A_TIME
  holds the depths the init allows.
- `init_serving_params` on meta, its `on_draw` hook and its draws
  watched: no fp32 tensor drawn for a stacked leaf holds more than one
  layer's slice, and the draws cover each leaf.
- On the CPU: each config, reduced, served through `launch.serve.main`
  with its depth patched in as chip_smoke.py patches it: 4 replies, and
  the reduced config's depth, min(depth, 2)."""
import importlib.util
import math
from pathlib import Path
from unittest import mock

import pytest

torch = pytest.importorskip("torch")
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.runtime import serve_step  # noqa: E402
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
    """(parameters, served tree bytes, largest fp32 matrix bytes) of
    `arch` at `depth`, counted on meta."""
    model = build_model(get_config(arch).replace(n_layers=depth))
    params = model.init(torch.Generator().manual_seed(0), "meta")
    cast = _cast_only_leaves(model)
    leaves = list(_leaves(params))
    served = sum(t.numel() * (2 if path in cast else 4)
                 for path, t in leaves)
    return (sum(t.numel() for _, t in leaves), served,
            max(math.prod(t.shape[-2:]) * 4 for _, t in leaves))


def test_the_depths_are_the_named_constants():
    assert {a: d for a, (d, _, _) in SERVES.items()} == {
        "qwen2.5-32b": CS.QWEN32_LAYERS, "deepseek-67b": CS.DS67_LAYERS,
        "arctic-480b": CS.ARCTIC_LAYERS}
    for arch, (depth, dims, _) in SERVES.items():
        cfg = get_config(arch)
        assert dims == (depth, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                        cfg.resolved_head_dim, cfg.vocab_size)
        assert depth <= cfg.n_layers
    assert SERVES["qwen2.5-32b"][0] == get_config("qwen2.5-32b").n_layers


@pytest.mark.parametrize("arch", list(SERVES))
def test_the_served_depth_fits_the_card(arch):
    depth, _, n_params = SERVES[arch]
    n, served, largest = _init_peak(arch, depth)
    assert n == n_params
    assert served + largest < CARD_BYTES, (served, largest)


# what arctic-480b's serve of 4200-token prompts holds beside its served
# tree at 1 layer, mostly the padded MoE dispatch: chip_smoke.py's
# "[c] arctic-480b served" line, the serve's 59.65 GB peak less the
# 28.17 GB tree, on an NVIDIA H100 80GB HBM3
ARCTIC_SERVE_BESIDE_TREE = 59.65e9 - 28.17e9


def test_arctic_at_two_layers_would_not_fit():
    """Its init fits at 2 layers now that no stack is drawn whole in fp32
    (a 55.4 GB tree and a 0.92 GB fp32 embedding), but the serve's padded
    dispatch beside that tree would not."""
    _, served, largest = _init_peak("arctic-480b", 2)
    assert served + largest < CARD_BYTES, (served, largest)
    assert served + ARCTIC_SERVE_BESIDE_TREE > CARD_BYTES, served


# the deepest each config's init allows: `init_serving_params` fills each
# stacked (L, ...) leaf a matrix at a time, so it peaks at the served tree
# plus the largest fp32 matrix, held here under 75e9 bytes (5e9 left for
# the prefill); arctic's padded MoE dispatch at 4200 tokens needs more than
# that beside 2 layers (chip_smoke.py prints the serve's peak apart from
# the init's)
DEPTH_IF_DRAWN_A_LAYER_AT_A_TIME = {"qwen2.5-32b": 64, "deepseek-67b": 49,
                                    "arctic-480b": 2}


@pytest.mark.parametrize("arch", list(SERVES))
def test_the_fp32_stack_sets_the_depth_not_the_card(arch):
    """The depth the init allows, filled a matrix at a time, is
    DEPTH_IF_DRAWN_A_LAYER_AT_A_TIME; chip_smoke.py serves each config at
    most that deep (qwen2.5-32b whole)."""
    _, one, slice_ = _init_peak(arch, 1)
    per_layer = _init_peak(arch, 2)[1] - one
    deepest = min(get_config(arch).n_layers,
                  int((75e9 - slice_ - one) // per_layer) + 1)
    assert deepest == DEPTH_IF_DRAWN_A_LAYER_AT_A_TIME[arch]
    assert deepest >= SERVES[arch][0]


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


class _Draws(TorchDispatchMode):
    """Records (numel, dtype) of each tensor on meta that a draw fills."""

    def __init__(self):
        super().__init__()
        self.draws = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.uniform_.default,
                    torch.ops.aten.normal_.default) \
                and args[0].device.type == "meta":
            self.draws.append((args[0].numel(), args[0].dtype))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ["qwen2.5-32b", "arctic-480b",
                                  "zamba2-2.7b"])
def test_no_fp32_draw_of_a_stacked_leaf_exceeds_a_layer(arch):
    """`init_serving_params` at full width on meta, with a spy on the
    `on_draw` hook it installs: every draw is fp32, the draws after each
    leaf is made cover it exactly, and none for a stacked (L, ...) leaf
    holds more than one layer's slice.  The drawn stacked leaves served in
    bf16 are the very tensors the hook made in bf16, never cast copies of
    an fp32 stack."""
    depth = SERVES[arch][0] if arch in SERVES else get_config(arch).n_layers
    model = build_model(get_config(arch).replace(n_layers=depth))
    made, spy = [], _Draws()
    real = serve_step.on_draw

    def on_draw(fn):
        def make(shape, device):
            made.append((fn(shape, device), len(spy.draws)))
            return made[-1][0]
        return real(make)

    with mock.patch.object(serve_step, "on_draw", on_draw), spy:
        params = init_serving_params(model, torch.Generator(), "meta")
    ends = [at for _, at in made[1:]] + [len(spy.draws)]
    stacked = 0
    for (leaf, start), end in zip(made, ends):
        draws = spy.draws[start:end]
        assert {dt for _, dt in draws} == {torch.float32}
        assert sum(n for n, _ in draws) == leaf.numel()
        if leaf.dim() > 2:
            stacked += 1
            assert max(n for n, _ in draws) <= leaf.numel() // leaf.shape[0]
    assert stacked
    ids = {id(leaf) for leaf, _ in made}
    drawn = set(serve_step._draw_paths(model).values())
    served16 = [t for path, t in _leaves(params) if path in drawn
                and t.dim() > 2 and t.dtype == torch.bfloat16]
    assert served16 and all(id(t) in ids for t in served16)
