"""The CUDA A^T B kernel against its plain version, on the card.

Needs an NVIDIA Hopper card and nvcc: the kernel has no CPU mode, so these
tests skip elsewhere.  Run on the card with
``PYTHONPATH=src python -m pytest -q --noconftest -m cuda
tests/test_torch_tiled_matmul_cuda.py``.
This file imports no JAX, so it runs where JAX is not installed.

Tolerances: fp32, only the order of the sums differs, and the roundings of
K terms, each at most max|a| * max|b|, add up as a random walk, so max |diff|
<= 1e-5 * sqrt(K) * max(1, max|a| * max|b|); inputs rounded to TF32 exceed
it several times over at the METG ladder's sizes.  At the JAX sweep shapes
also the sweep's 1e-4 absolute (tests/test_kernels.py:27).  bf16: the
kernel's output is the fp32 sum rounded once, so it lies within half a bf16
ulp of the plain version's fp32 result plus the fp32 bound; at the sweep
shapes also within the sweep's 0.25 absolute."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.tiled_matmul import ops, ref  # noqa: E402

SWEEP = [(256, 256, 256), (512, 256, 384), (384, 128, 512), (128, 128, 128)]
RAGGED = [(1000, 130, 70), (1, 1, 1), (17, 65, 63), (0, 5, 3), (33, 200, 1)]
LADDER = [(n, n, n) for n in (512, 1024, 2048, 4096)]   # launch.metg's, 256


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain fp32 product


def _operands(K, M, N, seed, dtype):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(dtype).cuda() for s in ((K, M), (K, N))]


def fp32_tol(k, a, b):
    if not a.numel() or not b.numel():
        return 1e-5
    return 1e-5 * math.sqrt(max(k, 1)) * max(
        1.0, float(a.abs().max()) * float(b.abs().max()))


def half_ulp_excess(out, exact):
    """max(|out - exact| - half a bf16 ulp at exact), elementwise."""
    x = exact.float()
    _, e = torch.frexp(x)
    half = torch.where(x == 0, torch.zeros_like(x),
                       torch.ldexp(torch.ones_like(x), e - 9))
    return float(((out.float() - x).abs() - half).max())


@pytest.mark.cuda
@pytest.mark.parametrize("K,M,N", SWEEP + RAGGED + LADDER)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain(K, M, N, dtype):
    _need_card()
    dt = getattr(torch, dtype)
    a, b = _operands(K, M, N, seed=K * 7 + M + N, dtype=dt)
    before = ops.tiled_matmul.launches
    out = ops.tiled_matmul(a, b)
    assert ops.tiled_matmul.launches == before + 1
    exact = ref.tiled_matmul_ref(a.float(), b.float())   # fp32 sums
    torch.cuda.synchronize()
    assert out.dtype == dt and out.shape == (M, N)
    assert bool(torch.isfinite(out).all())
    tol = fp32_tol(K, a, b)
    err = float((out.float() - exact).abs().max()) if out.numel() else 0.0
    if dtype == "float32":
        assert err <= tol, (err, tol)
        if (K, M, N) in SWEEP:
            assert err <= 1e-4, err
    else:
        assert half_ulp_excess(out, exact) <= tol
        if (K, M, N) in SWEEP:
            plain = ref.tiled_matmul_ref(a, b)
            assert float((out.float() - plain.float()).abs().max()) <= 0.25


@pytest.mark.cuda
def test_cuda_kernel_writes_out_and_counts_once():
    _need_card()
    a, b = _operands(300, 70, 90, seed=1, dtype=torch.float32)
    out = torch.full((70, 90), float("nan"), device="cuda")
    before = ops.tiled_matmul.launches
    assert ops.tiled_matmul(a, b, out=out) is out
    assert ops.tiled_matmul.launches == before + 1
    plain = ref.tiled_matmul_ref(a, b)
    assert float((out - plain).abs().max()) <= fp32_tol(300, a, b)
    with pytest.raises(ValueError):
        ops.tiled_matmul(a, b, out=torch.empty((90, 70), device="cuda"))
    assert ops.tiled_matmul.launches == before + 1


@pytest.mark.cuda
def test_cuda_kernel_refuses_autograd():
    _need_card()
    a, b = _operands(64, 64, 64, seed=2, dtype=torch.float32)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.tiled_matmul(a.requires_grad_(), b)
