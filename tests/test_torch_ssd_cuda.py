"""The CUDA chunked Mamba2 SSD kernel against its plain version, on the card,
forward and backward.

Needs an NVIDIA Hopper card and nvcc: the kernel has no CPU mode, so these
tests skip elsewhere.  Run on the card with
``PYTHONPATH=src python -m pytest -q --noconftest -m cuda
tests/test_torch_ssd_cuda.py``.
This file imports no JAX, so it runs where JAX is not installed."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.mamba2_ssd import ops, ref  # noqa: E402

TOL = 1e-5        # relative to max(1, max |plain|): fp32, summation order
GRAD_TOL = 1e-5   # the backward is the plain version's own autograd
BF16_TOL = 2 ** -8   # bf16 output: one rounding of the fp32 result


def _inputs(B, S, H, hd, N, seed, decay="sweep"):
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    dA = -np.log1p(np.exp(n(B, S, H))).astype(np.float32)
    if decay == "fast":
        dA = dA - 5.0
    elif decay == "slow":
        dA = dA * 1e-3
    return [torch.from_numpy(a).cuda() for a in
            (n(B, S, H, hd) * 0.5, dA, n(B, S, 1, N) * 0.5,
             n(B, S, 1, N) * 0.5)]


def _close(out, plain, tol=TOL):
    err = float((out.float() - plain.float()).abs().max())
    return err <= tol * max(1.0, float(plain.abs().max())), err


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,hd,N,chunk", [
    (2, 128, 8, 16, 16, 16), (2, 128, 8, 16, 16, 32),
    (1, 64, 4, 32, 8, 16), (1, 64, 4, 32, 8, 32),
    (2, 256, 4, 64, 64, 64), (1, 192, 3, 64, 64, 32)])
@pytest.mark.parametrize("decay", ["sweep", "fast", "slow"])
def test_cuda_kernel_matches_plain(B, S, H, hd, N, chunk, decay):
    """Y against ssd_chunked on the same card tensors, one launch."""
    _need_card()
    ins = _inputs(B, S, H, hd, N, seed=chunk, decay=decay)
    before = ops.ssd.launches
    y = ops.ssd(*ins, chunk=chunk)
    assert ops.ssd.launches == before + 1
    plain, _ = ref.ssd_chunked(*ins, chunk=chunk)
    torch.cuda.synchronize()
    ok, err = _close(y, plain)
    assert ok and bool(torch.isfinite(y).all()), err


@pytest.mark.cuda
def test_cuda_kernel_bf16():
    """bf16 inputs, fp32 arithmetic inside, Y in bf16: within one bf16
    rounding (2^-8 relative) of the plain fp32 result on the same values."""
    _need_card()
    ins = [t.bfloat16() for t in _inputs(2, 256, 4, 64, 64, seed=1)]
    y = ops.ssd(*ins, chunk=64)
    assert y.dtype == torch.bfloat16
    plain, _ = ref.ssd_chunked(*(t.float() for t in ins), chunk=64)
    err = (y.float() - plain).abs() - BF16_TOL * plain.abs()
    assert float(err.max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [16, 64])
def test_cuda_backward_matches_plain_autograd(chunk):
    """Gradients through the kernel op (backward: autograd of the recomputed
    chunked version) against autograd through the plain version."""
    _need_card()
    ins = _inputs(2, 256, 4, 64, 64, seed=2)
    g = torch.randn((2, 256, 4, 64), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(3))
    a = [t.clone().requires_grad_() for t in ins]
    b = [t.clone().requires_grad_() for t in ins]
    (ops.ssd(*a, chunk=chunk) * g).sum().backward()
    (ref.ssd_chunked(*b, chunk=chunk)[0] * g).sum().backward()
    for x, y in zip(a, b):
        ok, err = _close(x.grad, y.grad, GRAD_TOL)
        assert ok, err


@pytest.mark.cuda
def test_cuda_refuses_what_it_does_not_take():
    _need_card()
    ins = _inputs(1, 40, 2, 64, 64, seed=0)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ops.ssd(*ins, chunk=16)
    xdt, dA, Bc, Cc = _inputs(1, 64, 2, 64, 64, seed=0)
    with pytest.raises(ValueError, match="n_groups"):
        ops.ssd(xdt, dA, torch.cat([Bc, Bc], 2), torch.cat([Cc, Cc], 2),
                chunk=16)
