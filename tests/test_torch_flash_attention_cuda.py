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
