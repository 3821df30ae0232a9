"""Port parity for the chunked Mamba2 SSD scan, fp32 (fp64 for gradcheck).

The port's plain chunked version (the CPU path of the `ssd` op) against
the JAX oracle `ssd_ref` and the JAX Pallas kernel in interpret mode: max
|diff| <= 1e-5 * max(1, max |JAX|), the same algorithm in fp32, so only
summation order differs.  Against the step-by-step recurrence the
tolerance is 1e-3, the JAX kernel sweep's chunk-vs-step bound
(tests/test_kernels.py).  The op's gradients (on the CPU the plain backward
`ssd_chunked_bwd`, held on its own in tests/test_torch_ssd_bwd.py) against
`jax.grad` of `ssd_ref` within 1e-4 of the largest |grad|.  The staged
plain forward `ssd_chunked_staged` (the three stages the CUDA forward runs)
against `ssd_chunked`, `ssd_ref` and the Pallas kernel, with and without an
initial state, within TOL (fp32, summation order only); its stage 2 against
the recurrence written out per element.  The op's and `mamba_forward`'s
initial state and final state against `ssd_ref` and JAX's `mamba_forward`.
The CUDA kernels are held against the same plain versions on the card
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
    elif decay == "slow":
        dA = dA * 1e-3
    return xdt, dA, n(B, S, G, N) * 0.5, n(B, S, G, N) * 0.5


def _state(B, H, hd, N, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, H, hd, N)).astype(np.float32)


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


@pytest.mark.parametrize("initial", [False, True], ids=["zero", "s0"])
@pytest.mark.parametrize("decay", ["sweep", "slow", "fast"])
@pytest.mark.parametrize("n_chunks", [1, 2, 4])
@pytest.mark.parametrize("B,S,H,hd,N,chunk", SWEEP)
def test_staged_matches_chunked(B, S, H, hd, N, chunk, n_chunks, decay,
                                initial):
    """The staged forward's Y and final state against ssd_chunked at one,
    two and four chunks (stage 2's boundary terms: S_in[0] the initial
    state, the state after the last chunk the final state)."""
    arrs = _inputs(B, n_chunks * chunk, H, hd, N, seed=chunk + n_chunks,
                   decay=decay)
    s0 = torch.from_numpy(_state(B, H, hd, N, 11)) if initial else None
    ins = [torch.from_numpy(a) for a in arrs]
    y, state = ref.ssd_chunked(*ins, chunk=chunk, initial_state=s0)
    sy, sstate = ref.ssd_chunked_staged(*ins, chunk=chunk, initial_state=s0)
    assert sy.shape == y.shape and sstate.shape == state.shape
    for got, want in ((sy, y), (sstate, state)):
        ok, err = _close(got, want.numpy())
        assert ok, err


@pytest.mark.parametrize("initial", [False, True], ids=["zero", "s0"])
@pytest.mark.parametrize("B,S,H,hd,N,chunk", SWEEP)
def test_staged_matches_jax_ref_and_pallas(B, S, H, hd, N, chunk, initial):
    """The staged forward against JAX's ssd_ref (Y and the final state),
    and, from a zero state, against the Pallas kernel in interpret mode."""
    arrs = _inputs(B, S, H, hd, N, seed=chunk + 3)
    s0 = _state(B, H, hd, N, 12) if initial else None
    y, state = ref.ssd_chunked_staged(
        *map(torch.from_numpy, arrs), chunk=chunk,
        initial_state=None if s0 is None else torch.from_numpy(s0))
    jy, jstate = jax_ops.ssd_ref(
        *map(jnp.asarray, arrs), chunk=chunk,
        initial_state=None if s0 is None else jnp.asarray(s0))
    assert _close(y, jy)[0] and _close(state, jstate)[0]
    if not initial:
        assert _close(y, jax_ops.ssd(*map(jnp.asarray, arrs), chunk=chunk))[0]


@pytest.mark.parametrize("initial", [False, True], ids=["zero", "s0"])
@pytest.mark.parametrize("n_chunks", [1, 2, 5])
def test_fwd_state_pass_matches_recurrence(n_chunks, initial):
    """Stage 2 of the forward against the recurrence written out per
    element in numpy, in the same order: S_in[c+1] = a_c S_in[c] + ds_c
    from S_in[0] = S0 (or 0), and the final state S_in[nC]."""
    rng = np.random.default_rng(n_chunks + 10)
    B, H, hd, N = 2, 3, 4, 2
    ds = rng.standard_normal((B, H, n_chunks, hd, N)).astype(np.float32)
    a = rng.uniform(0.0, 1.0, (B, H, n_chunks)).astype(np.float32)
    s0 = (rng.standard_normal((B, H, hd, N)).astype(np.float32) if initial
          else np.zeros((B, H, hd, N), np.float32))
    s_in, final = ref.ssd_fwd_state_pass(
        torch.from_numpy(ds), torch.from_numpy(a),
        torch.from_numpy(s0) if initial else None)
    want, want_final = np.zeros_like(ds), np.zeros_like(s0)
    for b in range(B):
        for h in range(H):
            for d in range(hd):
                for n in range(N):
                    s = s0[b, h, d, n]
                    for c in range(n_chunks):
                        want[b, h, c, d, n] = s
                        s = a[b, h, c] * s + ds[b, h, c, d, n]
                    want_final[b, h, d, n] = s
    np.testing.assert_array_equal(s_in.numpy(), want)
    np.testing.assert_array_equal(final.numpy(), want_final)


@pytest.mark.parametrize("B,S,H,hd,N,chunk", SWEEP)
def test_op_state_arguments_match_jax_ref(B, S, H, hd, N, chunk):
    """ops.ssd with an initial state and return_state on the CPU (the plain
    version, no launch) against JAX's ssd_ref: Y and the final state; with
    only one of the two, the same Y, or the same pair from a zero state."""
    arrs = _inputs(B, S, H, hd, N, seed=chunk + 4)
    s0 = _state(B, H, hd, N, 13)
    ins = list(map(torch.from_numpy, arrs))
    before = ops.ssd.launches
    y, state = ops.ssd(*ins, chunk=chunk, initial_state=torch.from_numpy(s0),
                       return_state=True)
    assert ops.ssd.launches == before
    jy, jstate = jax_ops.ssd_ref(*map(jnp.asarray, arrs), chunk=chunk,
                                 initial_state=jnp.asarray(s0))
    assert y.dtype == torch.float32 and state.shape == (B, H, hd, N)
    assert _close(y, jy)[0] and _close(state, jstate)[0]
    only = ops.ssd(*ins, chunk=chunk, initial_state=torch.from_numpy(s0))
    assert torch.equal(only, y)
    y0, state0 = ops.ssd(*ins, chunk=chunk, return_state=True)
    jy0, jstate0 = jax_ops.ssd_ref(*map(jnp.asarray, arrs), chunk=chunk)
    assert _close(y0, jy0)[0] and _close(state0, jstate0)[0]


@pytest.mark.parametrize("given", ["initial_state", "return_state", "both"])
def test_op_state_arguments_refuse_autograd(given):
    """With an initial state or the final state asked for, the op raises
    while autograd records through an input (the backward takes neither),
    and computes under torch.no_grad()."""
    arrs = _inputs(1, 32, 2, 16, 16, seed=14)
    kw = {}
    if given in ("initial_state", "both"):
        kw["initial_state"] = torch.from_numpy(_state(1, 2, 16, 16, 15))
    if given in ("return_state", "both"):
        kw["return_state"] = True
    ins = [torch.from_numpy(a).requires_grad_() for a in arrs]
    with pytest.raises(RuntimeError, match="no gradient"):
        ops.ssd(*ins, chunk=16, **kw)
    with torch.no_grad():
        out = ops.ssd(*ins, chunk=16, **kw)
    assert bool(torch.isfinite(out[0] if kw.get("return_state") else out)
                .all())
    s0 = kw.get("initial_state")
    if s0 is not None:
        s0.requires_grad_()
        with pytest.raises(RuntimeError, match="no gradient"):
            ops.ssd(*(t.detach() for t in ins), chunk=16, **kw)


@pytest.mark.parametrize("S", [45, 64])
def test_model_state_arguments_match_jax(S):
    """mamba_forward with an initial state and return_state against JAX's,
    one reduced zamba2 layer in fp32, JAX params through the bridge: S = 45
    (padded to 48; the padded steps leave the state as at step 45) and a
    multiple of the chunk (16); output and final state within 1e-4."""
    jcfg = jax_get_config("zamba2-2.7b").reduced()
    cfg = get_config("zamba2-2.7b").reduced()
    rng = np.random.default_rng(16)
    tree = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.1 * rng.standard_normal(a.shape))
        .astype(np.float32),
        jax_mamba2.init_mamba(jax.random.PRNGKey(0), jcfg, 0))
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    _, H, _, N, *_ = mamba2.dims(cfg)
    s0 = _state(2, H, cfg.ssm.head_dim, N, 17)
    jout, jstate = jax_mamba2.mamba_forward(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x), jcfg,
        initial_state=jnp.asarray(s0), return_state=True)
    with torch.no_grad():
        out, state = mamba2.mamba_forward(
            bridge.from_jax(tree, "cpu"), torch.from_numpy(x), cfg,
            initial_state=torch.from_numpy(s0), return_state=True)
    assert out.shape == (2, S, cfg.d_model) and state.shape == s0.shape
    assert _close(out, jout, 1e-4)[0] and _close(state, jstate, 1e-4)[0]


def test_recompute_backward_gradcheck():
    """The recompute op (the card's `flash_attention` backward: autograd of
    the recomputed plain version), here with the plain SSD forward standing
    in for both kernel and plain version, passes gradcheck in fp64."""
    plain = functools.partial(ops.ssd_plain, chunk=4)
    arrs = _inputs(1, 8, 2, 3, 4, seed=8)
    ins = [torch.from_numpy(a).double().requires_grad_() for a in arrs]
    assert torch.autograd.gradcheck(
        lambda *a: recompute(plain, plain, *a), ins, eps=1e-6, atol=1e-6)


def test_function_grads_equal_plain_autograd():
    """The recompute op's gradients (with the plain SSD forward as kernel and
    plain version) are autograd's through the plain version, in fp32 at a
    sweep shape, with one input not requiring grad."""
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


class _Elsewhere:
    """A tensor stand-in on a device with neither kernel nor plain version
    (a CPU build of torch can make no tensor on one)."""
    device = torch.device("xla")

    def __init__(self, t):
        self.shape = t.shape


def test_op_refuses_other_devices():
    """Meta takes the plain version, which gives the shapes (the dry run
    counts on it); a device that is not the CPU, the card or meta
    raises."""
    xdt, dA, Bc, Cc = (torch.from_numpy(a).to("meta")
                       for a in _inputs(1, 16, 2, 16, 16))
    y = ops.ssd(xdt, dA, Bc, Cc, chunk=16)
    assert y.device.type == "meta" and y.shape == xdt.shape
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.ssd(*map(_Elsewhere, (xdt, dA, Bc, Cc)), chunk=16)
