"""The CUDA flash-attention kernel against its plain version, on the card.

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
@pytest.mark.parametrize("hd", [32, 64, 128, 256])
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
