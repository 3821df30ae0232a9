"""The CUDA flash-attention kernel against its plain version, on the card,
forward and backward.

Needs an NVIDIA Hopper card and nvcc: the kernel has no CPU mode, so these
tests skip elsewhere.  Run on the card with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_flash_attention_cuda.py``.
This file imports no JAX, so it runs where JAX is not installed."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import ops, ref  # noqa: E402


def _bf16_excess(out, exact):
    """max(|out - exact| - half a bf16 ulp of exact): how far a bf16 output
    lies beyond one round-to-nearest of the fp32 result `exact`."""
    x = exact.float()
    _, e = torch.frexp(x)
    half_ulp = torch.where(x == 0, torch.zeros_like(x),
                           torch.ldexp(torch.ones_like(x), e - 9))
    return float(((out.float() - x).abs() - half_ulp).max())


def _qkv(B, S, H, G, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, hd)).astype(np.float32),
            rng.standard_normal((B, S, G, hd)).astype(np.float32),
            rng.standard_normal((B, S, G, hd)).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_mla_head_dims_match_plain(dtype):
    """On the card: q/k head dim 192 with v head dim 128 (DeepSeek-V2's
    MLA), a ragged GQA case: the output has v's head dim and holds the
    tolerances above."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dt = getattr(torch, dtype)
    q, k, _ = _qkv(2, 203, 8, 2, 192, seed=6)
    v = np.random.default_rng(7).standard_normal((2, 203, 2, 128)).astype(
        np.float32)
    q, k, v = (torch.from_numpy(a).to("cuda", dt) for a in (q, k, v))
    for window, cap in [(None, 0.0), (50, 50.0)]:
        out = ops.flash_attention(q, k, v, window=window, logit_softcap=cap,
                                  scale=192 ** -0.5)
        assert out.shape == (2, 203, 8, 128)
        plain = ref.flash_attention_blockwise(
            q.float(), k.float(), v.float(), window=window,
            logit_softcap=cap, scale=192 ** -0.5)
        if dt == torch.float32:
            assert float((out - plain).abs().max()) < 1e-4
        else:
            assert _bf16_excess(out, plain) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [32, 64, 80, 128, 256])
def test_cuda_kernel_matches_plain(dtype, hd):
    """On the card: the kernel against the plain version, a ragged GQA case.
    fp32: max-abs error 1e-4 (summation order).  bf16: every element is the
    plain version's fp32 result rounded to nearest, within 1e-5 beyond half
    an ulp."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to("cuda", dt)
               for a in _qkv(2, 203, 8, 2, hd, seed=4))
    for window, cap in [(None, 0.0), (50, 50.0), (204, 30.0)]:
        before = ops.flash_attention.launches
        out = ops.flash_attention(q, k, v, window=window, logit_softcap=cap,
                                  scale=hd ** -0.5)
        assert ops.flash_attention.launches == before + 1
        plain = ref.flash_attention_blockwise(
            q.float(), k.float(), v.float(), window=window,
            logit_softcap=cap, scale=hd ** -0.5)
        if dt == torch.float32:
            err = float((out - plain).abs().max())
            assert err < 1e-4, err
        else:
            excess = _bf16_excess(out, plain)
            assert excess <= 1e-5, excess


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [80, 64])
def test_cuda_backward_matches_plain_autograd(hd):
    """fp32: gradients of q, k, v through the kernel op (backward: autograd
    of the recomputed blockwise version) against autograd through the plain
    blockwise version, within 1e-5 of the largest |grad|."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    kw = dict(scale=hd ** -0.5, q_block=64, kv_block=64)
    ins = [torch.from_numpy(a).cuda() for a in _qkv(2, 203, 8, 2, hd, seed=5)]
    g = torch.randn((2, 203, 8, hd), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(6))
    a = [t.clone().requires_grad_() for t in ins]
    b = [t.clone().requires_grad_() for t in ins]
    before = ops.flash_attention.launches
    (ops.flash_attention(*a, **kw) * g).sum().backward()
    assert ops.flash_attention.launches == before + 1
    (ref.flash_attention_blockwise(*b, **kw) * g).sum().backward()
    for x, y in zip(a, b):
        err = float((x.grad - y.grad).abs().max())
        assert err <= 1e-5 * max(1.0, float(y.grad.abs().max())), err


@pytest.mark.cuda
def test_cuda_zamba2_shape_bf16():
    """zamba2-2.7b's shared-block attention: (2, 1024, 32, 80) bf16, causal,
    against the plain version's fp32 result rounded once (1e-5 beyond half
    an ulp), with bf16 gradients carried back to every input."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    q, k, v = (torch.from_numpy(a).to("cuda", torch.bfloat16)
               .requires_grad_() for a in _qkv(2, 1024, 32, 32, 80, seed=7))
    out = ops.flash_attention(q, k, v, scale=80 ** -0.5, q_block=512,
                              kv_block=512)
    plain = ref.flash_attention_blockwise(
        q.detach().float(), k.detach().float(), v.detach().float(),
        scale=80 ** -0.5)
    assert _bf16_excess(out.detach(), plain) <= 1e-5
    out.float().square().sum().backward()
    for t in (q, k, v):
        assert t.grad.dtype == torch.bfloat16
        assert bool(torch.isfinite(t.grad).all())
        assert float(t.grad.abs().max()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("window", [4096, None])
def test_cuda_gemma2_shape_bf16(window):
    """gemma2-2b's prefill attention at full size: q (4, 4200, 16, 256), k/v
    (4, 4200, 4, 256) bf16, softcap 50, a local (window 4096) and a global
    layer: every element within 1e-5 beyond one rounding of the plain
    version's fp32 result."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    gen = torch.Generator("cuda").manual_seed(8)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").bfloat16()
               for shape in ((4, 4200, 16, 256), (4, 4200, 4, 256),
                             (4, 4200, 4, 256)))
    kw = dict(window=window, logit_softcap=50.0, scale=256 ** -0.5)
    before = ops.flash_attention.launches
    out = ops.flash_attention(q, k, v, **kw)
    assert ops.flash_attention.launches == before + 1
    plain = ref.flash_attention_blockwise(q.float(), k.float(), v.float(),
                                          **kw)
    assert bool(torch.isfinite(out).all())
    assert _bf16_excess(out, plain) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [32, 80, 256])
@pytest.mark.parametrize("window", [1, 16])
def test_cuda_window_inside_one_key_tile(dtype, hd, window):
    """A window narrower than a key tile (64 keys in the bf16 kernel, 32 in
    the fp32 one), so every tile the band visits is cut by its edge; window
    1 leaves each query its own key.  Tolerances as above."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to("cuda", dt)
               for a in _qkv(2, 203, 8, 2, hd, seed=9))
    kw = dict(window=window, logit_softcap=50.0, scale=hd ** -0.5)
    out = ops.flash_attention(q, k, v, **kw)
    plain = ref.flash_attention_blockwise(q.float(), k.float(), v.float(),
                                          **kw)
    if dt == torch.float32:
        assert float((out - plain).abs().max()) < 1e-4
    else:
        assert _bf16_excess(out, plain) <= 1e-5


def _qkv_t(B, S, T, H, G, hd, hd_v, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, hd)).astype(np.float32),
            rng.standard_normal((B, T, G, hd)).astype(np.float32),
            rng.standard_normal((B, T, G, hd_v)).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd,hd_v", [(64, 64), (192, 128)])
@pytest.mark.parametrize("S,T,causal,window", [
    (203, 203, False, None),     # the encoder: every key, S == T ragged
    (100, 1500, False, None),    # cross-attention: 1500 keys, not a tile
                                 # multiple
    (203, 77, False, 50),        # rows s >= 126 see no key: zeros
    (130, 300, True, None),      # causal with more keys than queries
    (300, 130, True, 40)])       # causal, fewer keys, a window
def test_cuda_non_causal_and_t_ne_s_match_plain(dtype, hd, hd_v, S, T,
                                                causal, window):
    """On the card: the causal flag (a runtime value) and a key length
    unlike the query length, a GQA case: the tolerances above, and a row
    with no allowed key gives exactly zeros."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to("cuda", dt)
               for a in _qkv_t(2, S, T, 8, 2, hd, hd_v, seed=10))
    kw = dict(causal=causal, window=window, logit_softcap=30.0,
              scale=hd ** -0.5)
    before = ops.flash_attention.launches
    out = ops.flash_attention(q, k, v, **kw)
    assert ops.flash_attention.launches == before + 1
    assert out.shape == (2, S, 8, hd_v)
    plain = ref.flash_attention_blockwise(q.float(), k.float(), v.float(),
                                          **kw)
    if dt == torch.float32:
        assert float((out - plain).abs().max()) < 1e-4
    else:
        assert _bf16_excess(out, plain) <= 1e-5
    if not causal and window is not None:
        empty = T - 1 + window
        assert empty < S and bool((out[:, empty:] == 0).all())
        assert bool((plain[:, empty:] == 0).all())


# probs_bf16: P is rounded to bf16 before P.V.  The plain version at the
# kernel's 64-key tiles (kv_block=64) keeps the kernel's running max tile
# by tile, so both round P at the same points; P's fp32 value differs only
# in its last bits (exp2f against exp, the order of the score sums), which
# moves a rare P to the neighbouring bf16 value.  One such flip moves an
# output by at most 2^-7 p_t |v_t|, <= 2^-7 max_t p_t max|v| in its row
# (the row's flip unit).  Held: every element within 1e-5 beyond one bf16
# rounding of the plain fp32 result plus one flip unit, and at most
# FLIP_SHARE of them beyond 1e-5.  A fault moves most elements: the
# kernel's output without the flag (P_hi + P_lo) must fail the check
FLIP_SHARE = 1e-3


def _probs_bf16_excess(out, q, k, v, causal, scale):
    """(worst (excess - 1e-5) / the row's flip unit, share of elements
    whose excess passes 1e-5), the excess as in _bf16_excess against the
    plain version with the flag in fp32 at the kernel's 64-key tiles."""
    exact = ref.flash_attention_blockwise(q.float(), k.float(), v,
                                          causal=causal, scale=scale,
                                          probs_bf16=True, kv_block=64)
    _, e = torch.frexp(exact)
    half_ulp = torch.where(exact == 0, torch.zeros_like(exact),
                           torch.ldexp(torch.ones_like(exact), e - 9))
    excess = (out.float() - exact).abs() - half_ulp
    s = torch.einsum("bshd,bthd->bhst", q.float(),
                     ref.expand_kv(k, q.shape[2]).float()) * scale
    if causal:
        S, T = s.shape[-2:]
        s = s.masked_fill(torch.ones(S, T, dtype=torch.bool,
                                     device=s.device).triu(1), -torch.inf)
    p_max = torch.exp(s.amax(-1) - torch.logsumexp(s, -1)).transpose(1, 2)
    unit = 2.0 ** -7 * p_max[..., None] * float(v.float().abs().max())
    return (float(((excess - 1e-5) / unit).max()),
            float((excess > 1e-5).float().mean()))


@pytest.mark.cuda
@pytest.mark.parametrize("causal,S,T", [(True, 203, 203), (False, 96, 1500)])
def test_cuda_probs_bf16_matches_plain(causal, S, T):
    """On the card, bf16: the kernel with probs_bf16 (P_lo . V skipped)
    against the plain version with the flag at its tiles, which the
    kernel's output without the flag fails; fp32 inputs ignore it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    q, k, v = (torch.from_numpy(a).to("cuda", torch.bfloat16)
               for a in _qkv_t(2, S, T, 8, 2, 64, 64, seed=11))
    kw = dict(causal=causal, scale=0.125)
    out = ops.flash_attention(q, k, v, probs_bf16=True, **kw)
    units, share = _probs_bf16_excess(out, q, k, v, **kw)
    assert units <= 1 and share <= FLIP_SHARE, (units, share)
    units, share = _probs_bf16_excess(ops.flash_attention(q, k, v, **kw),
                                      q, k, v, **kw)
    assert units > 1 or share > FLIP_SHARE, (units, share)
    f32 = [t.float() for t in (q, k, v)]
    assert torch.equal(ops.flash_attention(*f32, probs_bf16=True, **kw),
                       ops.flash_attention(*f32, **kw))


@pytest.mark.cuda
def test_cuda_non_causal_backward_matches_plain_autograd():
    """fp32 gradients through the op with causal=False at T != S (the
    recompute passes the flag) against autograd of the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    kw = dict(causal=False, scale=0.125, q_block=64, kv_block=64)
    ins = [torch.from_numpy(a).cuda()
           for a in _qkv_t(2, 75, 203, 8, 2, 64, 64, seed=12)]
    g = torch.randn((2, 75, 8, 64), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(13))
    a = [t.clone().requires_grad_() for t in ins]
    b = [t.clone().requires_grad_() for t in ins]
    (ops.flash_attention(*a, **kw) * g).sum().backward()
    (ref.flash_attention_blockwise(*b, **kw) * g).sum().backward()
    for x, y in zip(a, b):
        err = float((x.grad - y.grad).abs().max())
        assert err <= 1e-5 * max(1.0, float(y.grad.abs().max())), err
