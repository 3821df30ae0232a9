"""The chunked Mamba2 SSD backward on the CPU: the port's plain backward
`ssd_chunked_bwd` (the CPU path of the `ssd` op's backward, and what the
CUDA backward kernel is held against on the card) and the op's
autograd.Function.

- `ssd_chunked_bwd` against `jax.vjp` of the JAX oracle `ssd_ref`: max |diff|
  <= 1e-4 * max(1, max |JAX|), the tolerance of the existing gradient test
  against JAX (tests/test_torch_ssd.py): two frameworks, one algorithm in
  fp32, sums in other orders.
- `ssd_chunked_bwd` against autograd through the port's `ssd_chunked`, in
  the sweep, slow and fast decays: max |diff| <= 1e-5 * max(1, max |plain|),
  the forward's own fp32 tolerance (summation order only).
- The op's Function, with the plain forward and backward, passes
  `torch.autograd.gradcheck` in fp64."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.mamba2_ssd import ops as jax_ops  # noqa: E402
from repro_torch.kernels.mamba2_ssd import ops, ref  # noqa: E402

JAX_TOL = 1e-4
TOL = 1e-5

SWEEP = [(B, S, H, hd, N, c)
         for B, S, H, hd, N in [(2, 64, 4, 16, 16), (1, 64, 4, 32, 8)]
         for c in (16, 32)]


def _inputs(B, S, H, hd, N, seed=0, decay="sweep", G=1):
    """xdt, dA, B, C as tests/test_kernels.py draws them, and a cotangent
    dY ~ N(0, 1); "slow": dA * 1e-3, "fast": dA - 5 (as chip_smoke.py)."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    dA = -np.log1p(np.exp(n(B, S, H))).astype(np.float32)
    dA = {"sweep": dA, "slow": dA * 1e-3, "fast": dA - 5.0}[decay]
    return (n(B, S, H, hd) * 0.5, dA, n(B, S, G, N) * 0.5,
            n(B, S, G, N) * 0.5, n(B, S, H, hd))


def _err(t, r):
    r = np.asarray(r, dtype=np.float64)
    err = float(np.max(np.abs(np.asarray(t.detach(), np.float64) - r)))
    return err, max(1.0, float(np.max(np.abs(r))))


@pytest.mark.parametrize("B,S,H,hd,N,chunk", SWEEP)
def test_bwd_matches_jax_vjp(B, S, H, hd, N, chunk):
    *arrs, dy = _inputs(B, S, H, hd, N, seed=chunk)
    _, vjp = jax.vjp(lambda *a: jax_ops.ssd_ref(*a, chunk=chunk)[0],
                     *map(jnp.asarray, arrs))
    jgrads = vjp(jnp.asarray(dy))
    grads = ref.ssd_chunked_bwd(*map(torch.from_numpy, arrs),
                                torch.from_numpy(dy), chunk=chunk)
    for name, g, j in zip(("dxdt", "ddA", "dB", "dC"), grads, jgrads):
        assert g.shape == j.shape and g.dtype == torch.float32
        err, scale = _err(g, j)
        assert err <= JAX_TOL * scale, (name, err, scale)


@pytest.mark.parametrize("decay", ["sweep", "slow", "fast"])
@pytest.mark.parametrize("B,S,H,hd,N,chunk", SWEEP)
def test_bwd_matches_plain_autograd(B, S, H, hd, N, chunk, decay):
    *arrs, dy = _inputs(B, S, H, hd, N, seed=chunk + 1, decay=decay)
    ins = [torch.from_numpy(a).requires_grad_() for a in arrs]
    y, _ = ref.ssd_chunked(*ins, chunk=chunk)
    auto = torch.autograd.grad(y, ins, torch.from_numpy(dy))
    grads = ref.ssd_chunked_bwd(*map(torch.from_numpy, arrs),
                                torch.from_numpy(dy), chunk=chunk)
    for name, g, a in zip(("dxdt", "ddA", "dB", "dC"), grads, auto):
        assert g.shape == a.shape
        err, scale = _err(g, a)
        assert err <= TOL * scale, (name, err, scale)


def test_bwd_groups_match_plain_autograd():
    """n_groups = 2 (the CPU op takes it; the kernel refuses it): dB and dC
    sum over each group's heads."""
    *arrs, dy = _inputs(2, 32, 4, 16, 16, seed=11, G=2)
    ins = [torch.from_numpy(a).requires_grad_() for a in arrs]
    y, _ = ref.ssd_chunked(*ins, chunk=16)
    auto = torch.autograd.grad(y, ins, torch.from_numpy(dy))
    grads = ref.ssd_chunked_bwd(*map(torch.from_numpy, arrs),
                                torch.from_numpy(dy), chunk=16)
    for g, a in zip(grads, auto):
        err, scale = _err(g, a)
        assert err <= TOL * scale, (err, scale)


def test_padded_steps_get_zero_gradients():
    """mamba_forward pads S to a multiple of the chunk and slices Y, so the
    padded steps get a zero cotangent; they add nothing, and every gradient
    at a padded step is exactly 0."""
    *arrs, dy = _inputs(1, 48, 2, 16, 16, seed=12)
    dy[:, 45:] = 0.0
    grads = ref.ssd_chunked_bwd(*map(torch.from_numpy, arrs),
                                torch.from_numpy(dy), chunk=16)
    for g in grads:
        assert bool((g[:, 45:] == 0).all())


def test_function_gradcheck_fp64():
    """The op's autograd.Function on the CPU (forward `ssd_plain`, backward
    `ssd_chunked_bwd`) against finite differences, in fp64."""
    *arrs, _ = _inputs(1, 8, 2, 3, 4, seed=8)
    ins = [torch.from_numpy(a).double().requires_grad_() for a in arrs]
    assert torch.autograd.gradcheck(lambda *a: ops.ssd(*a, chunk=4), ins,
                                     eps=1e-6, atol=1e-6)


@pytest.mark.parametrize("frozen", [0, 1, 2, 3])
def test_function_none_for_inputs_without_grad(frozen):
    """An input that needs no gradient gets None; the others equal
    `ssd_chunked_bwd`'s, and the CPU launches no kernel."""
    *arrs, dy = _inputs(2, 64, 4, 16, 16, seed=9)
    ins = [torch.from_numpy(a).requires_grad_(i != frozen)
           for i, a in enumerate(arrs)]
    before = (ops.ssd.launches, ops.ssd.bwd_launches)
    (ops.ssd(*ins, chunk=16) * torch.from_numpy(dy)).sum().backward()
    assert (ops.ssd.launches, ops.ssd.bwd_launches) == before
    want = ref.ssd_chunked_bwd(*map(torch.from_numpy, arrs),
                               torch.from_numpy(dy), chunk=16)
    for i, (t, w) in enumerate(zip(ins, want)):
        if i == frozen:
            assert t.grad is None
        else:
            assert torch.equal(t.grad, w)
