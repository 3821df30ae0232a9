"""Port parity for the chunked Mamba2 SSD scan, fp32 (fp64 for gradcheck).

The port's plain chunked version (the CPU path of the `ssd` op, and the
function the kernel's backward differentiates) against the JAX oracle
`ssd_ref` and the JAX Pallas kernel in interpret mode: max |diff| <= 1e-5 *
max(1, max |JAX|), the same algorithm in fp32, so only summation order
differs.  Against the step-by-step recurrence the tolerance is 1e-3, the
JAX kernel sweep's chunk-vs-step bound (tests/test_kernels.py).  Gradients
against `jax.grad` of `ssd_ref` within 1e-4 of the largest |grad|.  The
CUDA kernel is held against the same plain version on the card
(chip_smoke.py, tests/test_torch_ssd_cuda.py)."""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.kernels.mamba2_ssd import ops as jax_ops  # noqa: E402
from repro.models import mamba2 as jax_mamba2  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels._recompute import recompute  # noqa: E402
from repro_torch.kernels.mamba2_ssd import kernel, ops, ref  # noqa: E402
from repro_torch.models import mamba2  # noqa: E402

TOL = 1e-5
STEP_TOL = 1e-3
GRAD_TOL = 1e-4

# tests/test_kernels.py's sweep, plus zamba2's (hd, N) at a short S
SWEEP = [(B, S, H, hd, N, c)
         for B, S, H, hd, N in [(2, 128, 8, 16, 16), (1, 64, 4, 32, 8)]
         for c in (16, 32)] + [(1, 128, 2, 64, 64, 64)]


def _inputs(B, S, H, hd, N, G=1, seed=0, decay="sweep"):
    """Drawn as tests/test_kernels.py draws them, from numpy."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    xdt = n(B, S, H, hd) * 0.5
    dA = -np.log1p(np.exp(n(B, S, H))).astype(np.float32)     # -softplus
    if decay == "fast":
        dA = dA - 5.0
    return xdt, dA, n(B, S, G, N) * 0.5, n(B, S, G, N) * 0.5


def _close(t, j, tol=TOL):
    j = np.asarray(j)
    err = float(np.max(np.abs(t.detach().numpy() - j)))
    return err <= tol * max(1.0, float(np.max(np.abs(j)))), err


@pytest.mark.parametrize("B,S,H,hd,N,chunk", SWEEP)
def test_chunked_matches_jax_ref_and_pallas(B, S, H, hd, N, chunk):
    arrs = _inputs(B, S, H, hd, N)
    before = ops.ssd.launches
    y = ops.ssd(*map(torch.from_numpy, arrs), chunk=chunk)
    assert ops.ssd.launches == before          # the CPU takes the plain path
    jy, jstate = jax_ops.ssd_ref(*map(jnp.asarray, arrs), chunk=chunk)
    assert _close(y, jy)[0]
    _, state = ref.ssd_chunked(*map(torch.from_numpy, arrs), chunk=chunk)
    assert _close(state, jstate)[0]
    pallas = jax_ops.ssd(*map(jnp.asarray, arrs), chunk=chunk)
    assert _close(y, pallas)[0]


@pytest.mark.parametrize("decay", ["sweep", "fast"])
@pytest.mark.parametrize("B,S,H,hd,N", [(2, 128, 8, 16, 16), (1, 64, 4, 32, 8)])
def test_sequential_matches_jax_and_chunked(B, S, H, hd, N, decay):
    """Both port versions against JAX's step recurrence; fast decay (dA
    ~ -5, exp underflows inside a chunk) included."""
    arrs = _inputs(B, S, H, hd, N, decay=decay)
    ty, tstate = ref.ssd_sequential(*map(torch.from_numpy, arrs))
    jy, jstate = jax_ops.ssd_sequential_ref(*map(jnp.asarray, arrs))
    assert _close(ty, jy)[0] and _close(tstate, jstate)[0]
    cy, _ = ref.ssd_chunked(*map(torch.from_numpy, arrs), chunk=16)
    assert _close(cy, jy, STEP_TOL)[0]
    assert bool(torch.isfinite(cy).all())


def test_initial_state_and_groups():
    """An initial state and n_groups = 2 (the plain version covers G > 1;
    the kernel refuses it) against ssd_ref."""
    arrs = _inputs(2, 64, 4, 16, 16, G=2, seed=3)
    s0 = np.random.default_rng(4).standard_normal(
        (2, 4, 16, 16)).astype(np.float32)
    y, state = ref.ssd_chunked(*map(torch.from_numpy, arrs), chunk=16,
                               initial_state=torch.from_numpy(s0))
    jy, jstate = jax_ops.ssd_ref(*map(jnp.asarray, arrs), chunk=16,
                                 initial_state=jnp.asarray(s0))
    assert _close(y, jy)[0] and _close(state, jstate)[0]


def test_ragged_sequence_through_the_model_padding():
    """S = 45 is no multiple of the chunk (16): mamba_forward pads for the
    scan and cuts back, as the JAX layer does; one reduced zamba2 layer in
    fp32, JAX params through the bridge, within 1e-4."""
    jcfg = jax_get_config("zamba2-2.7b").reduced()
    cfg = get_config("zamba2-2.7b").reduced()
    rng = np.random.default_rng(5)
    tree = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.1 * rng.standard_normal(a.shape))
        .astype(np.float32),
        jax_mamba2.init_mamba(jax.random.PRNGKey(0), jcfg, 0))
    x = rng.standard_normal((2, 45, cfg.d_model)).astype(np.float32)
    jout = jax_mamba2.mamba_forward(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x), jcfg)
    out = mamba2.mamba_forward(bridge.from_jax(tree, "cpu"),
                               torch.from_numpy(x), cfg)
    assert out.shape == (2, 45, cfg.d_model)
    assert _close(out, jout, 1e-4)[0]


@pytest.mark.parametrize("chunk", [16, 32])
def test_gradients_match_jax(chunk):
    """d/d(xdt, dA, B, C) of sum(Y * W) against jax.grad of ssd_ref."""
    arrs = _inputs(2, 64, 4, 16, 16, seed=6)
    w = np.random.default_rng(7).standard_normal(
        (2, 64, 4, 16)).astype(np.float32)

    def jloss(*a):
        return jnp.sum(jax_ops.ssd_ref(*a, chunk=chunk)[0] * w)

    jgrads = jax.grad(jloss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, arrs))
    ins = [torch.from_numpy(a).requires_grad_() for a in arrs]
    (ops.ssd(*ins, chunk=chunk) * torch.from_numpy(w)).sum().backward()
    for t, j in zip(ins, jgrads):
        ok, err = _close(t.grad, j, GRAD_TOL)
        assert ok, err


def test_recompute_backward_gradcheck():
    """The recompute op the card's `ssd` uses (forward: kernel; backward:
    autograd of the recomputed chunked version), with the plain forward
    standing in for the kernel, passes gradcheck in fp64."""
    plain = functools.partial(ops.ssd_plain, chunk=4)
    arrs = _inputs(1, 8, 2, 3, 4, seed=8)
    ins = [torch.from_numpy(a).double().requires_grad_() for a in arrs]
    assert torch.autograd.gradcheck(
        lambda *a: recompute(plain, plain, *a), ins, eps=1e-6, atol=1e-6)


def test_function_grads_equal_plain_autograd():
    """The recompute op's gradients are autograd's through the plain version,
    in fp32 at a sweep shape, with one input not requiring grad."""
    plain = functools.partial(ops.ssd_plain, chunk=16)
    arrs = _inputs(2, 64, 4, 16, 16, seed=9)
    g = torch.from_numpy(np.random.default_rng(10).standard_normal(
        (2, 64, 4, 16)).astype(np.float32))
    a = [torch.from_numpy(x).requires_grad_(i != 1)
         for i, x in enumerate(arrs)]
    b = [torch.from_numpy(x).requires_grad_(i != 1)
         for i, x in enumerate(arrs)]
    (recompute(plain, plain, *a) * g).sum().backward()
    (ref.ssd_chunked(*b, chunk=16)[0] * g).sum().backward()
    assert a[1].grad is None
    for x, y in (p for p in zip(a, b) if p[0].requires_grad):
        assert torch.equal(x.grad, y.grad)


@pytest.mark.parametrize("case,exc,match", [
    ("ragged", ValueError, "multiple of the chunk"),
    ("groups", ValueError, "n_groups"),
    ("shape", ValueError, "head_dim, state_dim"),
    ("chunk", ValueError, "chunk 8"),
    ("dtype", TypeError, "all float32 or all bfloat16"),
    ("device", ValueError, "CUDA device"),
])
def test_launcher_refuses(case, exc, match):
    """What the kernel does not take raises before any launch."""
    S = 40 if case == "ragged" else 64
    G = 2 if case == "groups" else 1
    hd, N = (16, 8) if case == "shape" else (16, 16)
    xdt, dA, Bc, Cc = map(torch.from_numpy,
                          _inputs(1, S, 2, hd, N, G=G))
    if case == "dtype":
        dA = dA.double()
    with pytest.raises(exc, match=match):
        kernel.ssd_cuda(xdt, dA, Bc, Cc, chunk=8 if case == "chunk" else 16)


def test_op_refuses_other_devices():
    xdt, dA, Bc, Cc = (torch.from_numpy(a).to("meta")
                       for a in _inputs(1, 16, 2, 16, 16))
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.ssd(xdt, dA, Bc, Cc, chunk=16)
