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
  `torch.autograd.gradcheck` in fp64.
- The staged plain backward `ssd_chunked_bwd_staged` (the three stages the
  CUDA backward runs) against `ssd_chunked_bwd` at 1, 2 and 4 chunks in
  three decays (TOL), against `jax.vjp` (JAX_TOL); its stage 2 alone
  against the recurrence written out element by element; and with the
  products that the kernel runs on the tensor cores emulated in 3xTF32
  against the fp64 autograd at a full-width head (TOL), where plain TF32
  does not hold; likewise the staged plain forward `ssd_chunked_staged`'s
  Y and final state against the fp64 plain forward."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.mamba2_ssd import ops as jax_ops  # noqa: E402
from repro_torch.kernels.mamba2_ssd import kernel, ops, ref  # noqa: E402

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


@pytest.mark.parametrize("decay", ["sweep", "slow", "fast"])
@pytest.mark.parametrize("n_chunks", [1, 2, 4])
@pytest.mark.parametrize("B,S,H,hd,N,chunk", SWEEP)
def test_staged_matches_chunked_bwd(B, S, H, hd, N, chunk, n_chunks, decay):
    """Stage 2's boundary terms (S_in[0] = 0, dS after the last chunk = 0,
    a_c the decay of chunk c itself) at one, two and four chunks."""
    *arrs, dy = _inputs(B, n_chunks * chunk, H, hd, N, seed=chunk + n_chunks,
                        decay=decay)
    ins = [torch.from_numpy(a) for a in (*arrs, dy)]
    plain = ref.ssd_chunked_bwd(*ins, chunk=chunk)
    staged = ref.ssd_chunked_bwd_staged(*ins, chunk=chunk)
    for name, g, p in zip(("dxdt", "ddA", "dB", "dC"), staged, plain):
        assert g.shape == p.shape and g.dtype == p.dtype
        err, scale = _err(g, p)
        assert err <= TOL * scale, (name, err, scale)


@pytest.mark.parametrize("B,S,H,hd,N,chunk", SWEEP)
def test_staged_matches_jax_vjp(B, S, H, hd, N, chunk):
    *arrs, dy = _inputs(B, S, H, hd, N, seed=chunk + 2)
    _, vjp = jax.vjp(lambda *a: jax_ops.ssd_ref(*a, chunk=chunk)[0],
                     *map(jnp.asarray, arrs))
    jgrads = vjp(jnp.asarray(dy))
    grads = ref.ssd_chunked_bwd_staged(*map(torch.from_numpy, arrs),
                                       torch.from_numpy(dy), chunk=chunk)
    for name, g, j in zip(("dxdt", "ddA", "dB", "dC"), grads, jgrads):
        assert g.shape == j.shape
        err, scale = _err(g, j)
        assert err <= JAX_TOL * scale, (name, err, scale)


@pytest.mark.parametrize("n_chunks", [1, 2, 5])
def test_state_pass_matches_recurrence(n_chunks):
    """Stage 2 against the two recurrences written out per element in
    numpy, in the same order: S_in[c+1] = a_c S_in[c] + dS_c from S_in[0] =
    0, dS[c-1] = a_c dS[c] + ddS_c from dS[nC-1] = 0."""
    rng = np.random.default_rng(n_chunks)
    B, H, hd, N = 2, 3, 4, 2
    ds = rng.standard_normal((B, H, n_chunks, hd, N)).astype(np.float32)
    dds = rng.standard_normal((B, H, n_chunks, hd, N)).astype(np.float32)
    a = rng.uniform(0.0, 1.0, (B, H, n_chunks)).astype(np.float32)
    s_in, d_s = ref.ssd_bwd_state_pass(*map(torch.from_numpy, (ds, dds, a)))
    want_s, want_d = np.zeros_like(ds), np.zeros_like(dds)
    for b in range(B):
        for h in range(H):
            for d in range(hd):
                for n in range(N):
                    s = np.float32(0)
                    for c in range(n_chunks):
                        want_s[b, h, c, d, n] = s
                        s = a[b, h, c] * s + ds[b, h, c, d, n]
                    s = np.float32(0)
                    for c in reversed(range(n_chunks)):
                        want_d[b, h, c, d, n] = s
                        s = a[b, h, c] * s + dds[b, h, c, d, n]
    np.testing.assert_array_equal(s_in.numpy(), want_s)
    np.testing.assert_array_equal(d_s.numpy(), want_d)
    assert not s_in[:, :, 0].any() and not d_s[:, :, -1].any()


# The products that the CUDA forward and backward run on the tensor cores
# in 3xTF32 (csrc/mamba2_ssd.cu), by the names the staged plain versions
# give them.
TC_PRODUCTS = {name for routes in (kernel.FWD_ROUTES, kernel.BWD_ROUTES)
               for name, route in routes.items() if route == "3xTF32"}


def _tf32(t):
    """fp32 rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as cvt.rna.tf32.f32 rounds."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_read(t):
    """What the tensor cores read of an fp32 value given as a TF32 operand:
    its top 19 bits (the low 13 are not read)."""
    return (t.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _emulated(split):
    """An `mm` for the staged version that computes the tensor-core
    products as the kernel does: in 3xTF32 (hi = tf32(v), lo = v - hi, of
    which the tensor cores read the top 19 bits; lo.hi + hi.lo + hi.hi in
    fp32) when `split`, else in plain TF32 (hi.hi alone); every other
    product exactly.  Records the names seen."""
    seen = set()

    def mm(a, b, name):
        seen.add(name)
        if name not in TC_PRODUCTS:
            return torch.matmul(a, b)
        ah, bh = _tf32(a), _tf32(b)
        if not split:
            return torch.matmul(ah, bh)
        return (torch.matmul(_tf32_read(a - ah), bh)
                + torch.matmul(ah, _tf32_read(b - bh)) + torch.matmul(ah, bh))

    mm.seen = seen
    return mm


def _tc_case():
    """One batch row of zamba2-2.7b's training shape with 8 of its 80
    heads, in fast decay (dA - 5, where d(dA)'s terms cancel most), and
    the fp64 autograd of the plain chunked version."""
    *arrs, dy = _inputs(1, 1024, 8, 64, 64, seed=21, decay="fast")
    ins = [torch.from_numpy(a).double().requires_grad_() for a in arrs]
    y, _ = ref.ssd_chunked(*ins, chunk=64)
    exact = torch.autograd.grad(y, ins, torch.from_numpy(dy).double())
    return arrs, dy, exact


@pytest.mark.parametrize("split", [True, False], ids=["3xtf32", "tf32"])
def test_tensor_core_products_emulated(split):
    """3xTF32 for every product the kernel runs on the tensor cores holds
    every gradient within TOL of the fp64 autograd; plain TF32 for the same
    products does not (so a kernel that dropped the lo terms fails)."""
    arrs, dy, exact = _tc_case()
    mm = _emulated(split)
    grads = ref.ssd_chunked_bwd_staged(*map(torch.from_numpy, arrs),
                                       torch.from_numpy(dy), chunk=64, mm=mm)
    assert mm.seen == set(kernel.BWD_ROUTES)
    errs = {name: _err(g, e) for name, g, e in
            zip(("dxdt", "ddA", "dB", "dC"), grads, exact)}
    worst = max(errs, key=lambda k: errs[k][0] / errs[k][1])
    print(f"{'3xTF32' if split else 'TF32'}: worst {worst} "
          f"{errs[worst][0] / errs[worst][1]:.2e} (tol {TOL:.0e})")
    held = all(err <= TOL * scale for err, scale in errs.values())
    assert held == split, errs


@pytest.mark.parametrize("decay", ["sweep", "fast"])
@pytest.mark.parametrize("split", [True, False], ids=["3xtf32", "tf32"])
def test_forward_tensor_core_products_emulated(split, decay):
    """The staged forward with every product the kernel runs on the tensor
    cores in 3xTF32 holds Y and the final state within TOL of the fp64
    plain forward, at one batch row of zamba2-2.7b's training shape with 8
    of its 80 heads and an initial state; plain TF32 for the same products
    does not."""
    *arrs, _ = _inputs(1, 1024, 8, 64, 64, seed=22, decay=decay)
    s0 = np.random.default_rng(23).standard_normal(
        (1, 8, 64, 64)).astype(np.float32)
    exact = ref.ssd_chunked(*(torch.from_numpy(a).double() for a in arrs),
                            chunk=64,
                            initial_state=torch.from_numpy(s0).double())
    mm = _emulated(split)
    got = ref.ssd_chunked_staged(*map(torch.from_numpy, arrs), chunk=64,
                                 initial_state=torch.from_numpy(s0), mm=mm)
    assert mm.seen == set(kernel.FWD_ROUTES)
    errs = {name: _err(g, e) for name, g, e in
            zip(("Y", "final_state"), got, exact)}
    print(f"{'3xTF32' if split else 'TF32'} {decay}: " + " ".join(
        f"{k} {e / sc:.2e}" for k, (e, sc) in errs.items())
        + f" (tol {TOL:.0e})")
    held = all(err <= TOL * scale for err, scale in errs.values())
    assert held == split, errs


@pytest.mark.parametrize("H,group", [(80, 4), (8, 4), (6, 2), (3, 1),
                                     (5, 1), (1, 1)])
def test_backward_head_group(H, group):
    """A backward block takes the largest of 4, 2 and 1 heads dividing H."""
    assert kernel.head_group(H) == group
