"""zamba2 serving on the card: a reduced zamba2-2.7b (12 Mamba2 layers,
d_model 128, shared attention with 4 heads of 32 padded to 16, seeded
weights) prefilled through the SSD and flash kernels, against the same
prefill with both ops patched to their plain versions and against the
token-by-token decode, in fp32; greedy serving in bf16; and the SSD op with
the final state at (1, 130, 8, 64), N 64, through `mamba_forward`'s padded
ragged tail.

Needs an NVIDIA Hopper card and nvcc: the kernels have no CPU mode, so
these tests skip elsewhere.  Run on the card with
``PYTHONPATH=src python -m pytest -q --noconftest -m cuda
tests/test_torch_zamba_serve_cuda.py``.
This file imports no JAX, so it runs where JAX is not installed."""
from unittest import mock

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.mamba2_ssd import ops as ssd_ops  # noqa: E402
from repro_torch.models import attention, mamba2  # noqa: E402
from repro_torch.models.common import Options  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.runtime.serve_step import (greedy_generate,  # noqa: E402
                                            serving_params)

# fp32 kernel path vs plain path: the kernels' summation-order differences
# (~1e-6 relative) through 12 layers; a wrong state is off by O(1)
TOL = 1e-4
B, S = 2, 40          # two chunks of 16 and a padded tail of 8


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


def _rel(a, b):
    return (float((a.float() - b.float()).abs().max())
            / max(1.0, float(b.float().abs().max())))


def _setup():
    cfg = get_config("zamba2-2.7b").reduced()
    model = build_model(cfg, Options(q_block=16, kv_block=16))
    params = model.init(torch.Generator("cuda").manual_seed(0), "cuda")
    tokens = torch.randint(0, cfg.vocab_size, (B, S), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(1))
    return model, params, tokens


def _prefill(model, params, tokens):
    cache = model.init_cache(B, S + 2, dtype=torch.float32, device="cuda")
    with torch.inference_mode():
        return model.forward(params, {"tokens": tokens}, mode="prefill",
                             dtype=torch.float32, cache=cache)


def _same_cache(a, b, layers):
    for key in ("ssm", "conv"):
        for i in range(layers):
            err = _rel(a["mamba"][key][i], b["mamba"][key][i])
            assert err <= TOL, (key, i, err)
    for x, y in zip(a["kv"], b["kv"]):
        assert _rel(x, y) <= TOL


@pytest.mark.cuda
def test_cuda_prefill_matches_plain_path():
    """fp32: one SSD op call a layer and one flash launch a shared-block
    application; logits and every cache leaf within TOL of the plain
    path's, which launches nothing."""
    _need_card()
    model, params, tokens = _setup()
    cfg = model.cfg
    ssd_ops.ssd.launches = fa_ops.flash_attention.launches = 0
    lk, ck = _prefill(model, params, tokens)
    assert (ssd_ops.ssd.launches, fa_ops.flash_attention.launches) == \
        (cfg.n_layers, cfg.n_layers // cfg.attn_every)
    with mock.patch.object(ssd_ops, "ssd", ssd_ops.ssd_plain), \
            mock.patch.object(attention, "flash_attention",
                              fa_ref.flash_attention_blockwise):
        lp, cp = _prefill(model, params, tokens)
    assert (ssd_ops.ssd.launches, fa_ops.flash_attention.launches) == \
        (cfg.n_layers, cfg.n_layers // cfg.attn_every)
    assert bool(torch.isfinite(lk).all())
    assert _rel(lk, lp) <= TOL
    _same_cache(ck, cp, cfg.n_layers)


@pytest.mark.cuda
def test_cuda_prefill_matches_token_decode():
    """fp32: the kernel-path prefill against S decode steps from
    init_cache (plain ops, no kernel launched): last logits and the whole
    cache."""
    _need_card()
    model, params, tokens = _setup()
    lk, ck = _prefill(model, params, tokens)
    cache = model.init_cache(B, S + 2, dtype=torch.float32, device="cuda")
    ssd_ops.ssd.launches = fa_ops.flash_attention.launches = 0
    with torch.inference_mode():
        for t in range(S):
            ld, cache = model.decode_step(
                params, tokens[:, t], torch.full((B,), t, device="cuda"),
                cache, dtype=torch.float32)
    assert (ssd_ops.ssd.launches, fa_ops.flash_attention.launches) == (0, 0)
    assert _rel(lk, ld) <= TOL
    _same_cache(ck, cache, model.cfg.n_layers)


@pytest.mark.cuda
def test_cuda_greedy_generate_answers():
    """bf16 serving params: every row gets max_new tokens inside the
    vocabulary, through one prefill's kernels."""
    _need_card()
    model, params, tokens = _setup()
    cfg = model.cfg
    ssd_ops.ssd.launches = fa_ops.flash_attention.launches = 0
    out = greedy_generate(model, serving_params(model, params),
                          {"tokens": tokens}, 5, S + 6)
    assert out.shape == (B, 5)
    assert int(out.min()) >= 0 and int(out.max()) < cfg.vocab_size
    assert (ssd_ops.ssd.launches, fa_ops.flash_attention.launches) == \
        (cfg.n_layers, cfg.n_layers // cfg.attn_every)


@pytest.mark.cuda
def test_cuda_ssd_final_state_through_ragged_tail():
    """One Mamba2 layer with the full config's SSD dims (head dim 64, N 64,
    chunk 64) at d_model 256 (8 heads), S = 130: mamba_forward pads to 192
    for the kernel; its output, final SSM state and conv ring against the
    same layer through the plain SSD, in fp32."""
    _need_card()
    cfg = get_config("zamba2-2.7b").replace(d_model=256)
    _, H, _, N, _, _, _ = mamba2.dims(cfg)
    assert (H, cfg.ssm.head_dim, N, cfg.ssm.chunk) == (8, 64, 64, 64)
    gen = torch.Generator("cuda").manual_seed(2)
    p = mamba2.init_mamba(gen, cfg, 0, device="cuda")
    x = torch.randn((1, 130, 256), generator=gen, device="cuda")
    before = ssd_ops.ssd.launches
    with torch.inference_mode():
        out, st = mamba2.mamba_forward(p, x, cfg, return_cache=True)
        assert ssd_ops.ssd.launches == before + 1
        with mock.patch.object(ssd_ops, "ssd", ssd_ops.ssd_plain):
            out_p, st_p = mamba2.mamba_forward(p, x, cfg, return_cache=True)
    assert st["ssm"].shape == (1, H, 64, N)
    assert _rel(out, out_p) <= TOL
    assert _rel(st["ssm"], st_p["ssm"]) <= 1e-5
    assert torch.equal(st["conv"], st_p["conv"])
