"""Port parity for C = A^T B.

The port's `tiled_matmul` on the CPU (its plain version) against the JAX
Pallas kernel in interpret mode, run as tests/test_kernels.py runs it
(bm = bn = bk = 128), at that file's four sweep shapes in fp32 and bf16, and
on ragged shapes against float64 numpy.  Inputs are drawn with numpy.

Tolerances.  fp32: only the order of the fp32 sums differs, and the
roundings of K terms, each at most max|a| * max|b|, add up as a random walk,
so each element is held to 1e-5 * sqrt(K) * max(1, max|a| * max|b|); at the
sweep shapes the JAX sweep's own 1e-4 absolute holds as well.  bf16: both sides round one
fp32 sum to bf16, so an element may differ by one bf16 ulp of the output
(plus the fp32 bound, for sums that cancel to near zero); the JAX sweep's
0.25 absolute holds as well.  The CUDA kernel is held against the same
plain version on the card (chip_smoke.py, test_torch_tiled_matmul_cuda.py).
"""
import math

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.tiled_matmul.ops import tiled_matmul as jax_tiled_matmul  # noqa: E402
from repro_torch.kernels.tiled_matmul import kernel, ops  # noqa: E402

SWEEP = [(256, 256, 256), (512, 256, 384), (384, 128, 512), (128, 128, 128)]
RAGGED = [(1000, 130, 70), (1, 1, 1), (17, 65, 63), (0, 5, 3)]
JAX_FP32_ATOL, JAX_BF16_ATOL = 1e-4, 0.25     # tests/test_kernels.py:27


def fp32_tol(k, a, b):
    return 1e-5 * math.sqrt(max(k, 1)) * max(
        1.0, float(np.abs(a).max(initial=0.0) * np.abs(b).max(initial=0.0)))


def bf16_ulp(x):
    """One bf16 ulp (8 significant bits) at |x|, elementwise."""
    _, e = np.frexp(np.abs(x).astype(np.float64))
    return np.ldexp(1.0, e - 8)


def _operands(K, M, N, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((K, M)).astype(np.float32),
            rng.standard_normal((K, N)).astype(np.float32))


@pytest.mark.parametrize("K,M,N", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_pallas_interpret(K, M, N, dtype):
    a, b = _operands(K, M, N, seed=K + M + N)
    ja, jb = (jnp.asarray(x).astype(dtype) for x in (a, b))
    ref = np.asarray(jax_tiled_matmul(ja, jb, bm=128, bn=128, bk=128)
                     .astype(jnp.float32))
    ta, tb = (torch.from_numpy(x).to(getattr(torch, dtype)) for x in (a, b))
    before = ops.tiled_matmul.launches
    out = ops.tiled_matmul(ta, tb)
    assert ops.tiled_matmul.launches == before    # the CPU takes the plain path
    assert out.dtype == ta.dtype and out.shape == (M, N)
    got = out.float().numpy()
    diff = np.abs(got - ref)
    tol = fp32_tol(K, a, b)
    if dtype == "float32":
        assert diff.max() <= min(tol, JAX_FP32_ATOL), diff.max()
    else:
        ulp = bf16_ulp(np.maximum(np.abs(got), np.abs(ref)))
        assert (diff <= ulp + tol).all(), float((diff - ulp).max())
        assert diff.max() <= JAX_BF16_ATOL


@pytest.mark.parametrize("K,M,N", RAGGED)
def test_plain_matches_float64_on_ragged_shapes(K, M, N):
    a, b = _operands(K, M, N, seed=7)
    exact = a.astype(np.float64).T @ b.astype(np.float64)
    out = ops.tiled_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert out.dtype == torch.float32 and out.shape == (M, N)
    tol = fp32_tol(K, a, b)
    assert np.abs(out.numpy() - exact).max(initial=0.0) <= tol


def test_out_buffer_is_written_and_returned():
    a, b = (torch.from_numpy(x) for x in _operands(64, 32, 48, seed=3))
    out = torch.full((32, 48), float("nan"))
    assert ops.tiled_matmul(a, b, out=out) is out
    np.testing.assert_allclose(
        out.numpy(), (a.double().T @ b.double()).numpy(),
        atol=fp32_tol(64, a.numpy(), b.numpy()), rtol=0)


@pytest.mark.parametrize("a_shape,b_shape,dtypes,err", [
    ((8, 4), (9, 4), ("float32", "float32"), ValueError),
    ((8,), (8, 4), ("float32", "float32"), ValueError),
    ((8, 0), (8, 4), ("float32", "float32"), ValueError),
    ((8, 4), (8, 4), ("float32", "bfloat16"), TypeError),
    ((8, 4), (8, 4), ("float16", "float16"), TypeError),
    ((8, 4), (8, 4), ("float32", "float32"), ValueError),   # not on a card
])
def test_launcher_refuses_what_the_kernel_does_not_take(a_shape, b_shape,
                                                        dtypes, err):
    """The checks run before any build or launch, so they hold on the CPU."""
    a = torch.zeros(a_shape, dtype=getattr(torch, dtypes[0]))
    b = torch.zeros(b_shape, dtype=getattr(torch, dtypes[1]))
    with pytest.raises(err):
        kernel.tiled_matmul_cuda(a, b)


def test_no_other_device_and_no_fallback():
    """A tensor on another device than the CPU or meta (whose plain
    version gives the shapes, for the dry run) goes to the kernel or
    raises; nothing takes the plain version there."""
    a = torch.zeros((4, 4), device="meta")
    assert ops.tiled_matmul(a, a).device.type == "meta"

    class Elsewhere:
        device = torch.device("xla")
        shape = a.shape

    with pytest.raises(ValueError, match="no kernel for device"):
        ops.tiled_matmul(Elsewhere(), Elsewhere())
