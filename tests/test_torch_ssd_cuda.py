"""The CUDA chunked Mamba2 SSD kernels against their plain versions, on the
card: the forward against `ssd_chunked` (in fp32 and in fp64, with and
without an initial state, Y and the final state), its scratch after the
scan over the chunks against the plain stages and bit for bit against the
backward's; the backward kernel against autograd through it and against
the plain backward `ssd_chunked_bwd`.

Needs an NVIDIA Hopper card and nvcc: the kernel has no CPU mode, so these
tests skip elsewhere.  Run on the card with
``PYTHONPATH=src python -m pytest -q --noconftest -m cuda
tests/test_torch_ssd_cuda.py``.
This file imports no JAX, so it runs where JAX is not installed."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.mamba2_ssd import kernel, ops, ref  # noqa: E402

TOL = 1e-5        # relative to max(1, max |plain|): fp32, summation order
# the backward kernel computes the plain backward's fp32 terms, each sum in
# a fixed order of its own: summation order only, as the forward
GRAD_TOL = 1e-5
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
    exact, _ = ref.ssd_chunked(*(t.double() for t in ins), chunk=chunk)
    torch.cuda.synchronize()
    ok, err = _close(y, plain)
    assert ok and bool(torch.isfinite(y).all()), err
    ok, err = _close(y, exact)
    assert ok, err


# The backward sweep's shapes, and one chunk (S = chunk) and head groups of
# 4, 2 and 1 (H = 3 and 5) among them
FWD_SWEEP = [
    (2, 128, 8, 16, 16, 16), (2, 128, 8, 16, 16, 32),
    (1, 64, 4, 32, 8, 16), (1, 64, 4, 32, 8, 32), (1, 64, 4, 32, 8, 64),
    (1, 192, 3, 64, 64, 32), (1, 64, 3, 64, 64, 64), (2, 128, 5, 16, 16, 32),
    (1, 32, 5, 32, 8, 32), (2, 96, 6, 16, 16, 16), (2, 256, 4, 64, 64, 64)]


def _s0(B, H, hd, N, seed):
    return torch.randn((B, H, hd, N), device="cuda",
                       generator=torch.Generator("cuda").manual_seed(seed))


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,hd,N,chunk", FWD_SWEEP)
def test_cuda_forward_initial_state(B, S, H, hd, N, chunk):
    """Y and the final state from an initial state, through the op under
    no_grad (one launch), against ssd_chunked in fp32 and in fp64 on the
    same values."""
    _need_card()
    ins = _inputs(B, S, H, hd, N, seed=chunk + hd + H)
    s0 = _s0(B, H, hd, N, S)
    before = ops.ssd.launches
    with torch.no_grad():
        y, state = ops.ssd(*ins, chunk=chunk, initial_state=s0,
                           return_state=True)
    assert ops.ssd.launches == before + 1
    plain = ref.ssd_chunked(*ins, chunk=chunk, initial_state=s0)
    exact = ref.ssd_chunked(*(t.double() for t in ins), chunk=chunk,
                            initial_state=s0.double())
    torch.cuda.synchronize()
    assert state.dtype == torch.float32 and state.shape == s0.shape
    for out, p, e in zip((y, state), plain, exact):
        assert bool(torch.isfinite(out).all())
        ok, err = _close(out, p)
        assert ok, err
        ok, err = _close(out, e)
        assert ok, err


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,hd,N,chunk", [
    (2, 256, 4, 64, 64, 64), (1, 64, 3, 32, 8, 16), (2, 128, 5, 16, 16, 32)])
def test_cuda_forward_states_match_state_pass(B, S, H, hd, N, chunk):
    """The forward's scratch after its scan over the chunks (the state
    entering each chunk) and the chunks' decays against the plain stages 1
    and 2 from an initial state; from a zero state, the same bits as the
    backward's S_in (stage 1's term and the walk are one code)."""
    _need_card()
    ins = _inputs(B, S, H, hd, N, seed=19 + H)
    s0 = _s0(B, H, hd, N, 20)
    (_, final), (states, decay) = kernel.ssd_cuda(
        *ins, chunk=chunk, initial_state=s0, return_states=True)
    ds, a = ref.ssd_fwd_chunk_state(*ins, chunk=chunk)
    want, want_final = ref.ssd_fwd_state_pass(ds, a, s0)
    torch.cuda.synchronize()
    assert states.shape == want.shape == (B, H, S // chunk, hd, N)
    for x, p in ((states, want), (decay, a), (final, want_final)):
        ok, err = _close(x, p)
        assert ok, err
    _, (zero_states, _) = kernel.ssd_cuda(*ins, chunk=chunk,
                                          return_states=True)
    g = torch.randn((B, S, H, hd), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(21))
    _, (s_in, _) = kernel.ssd_bwd_cuda(*ins, g, chunk=chunk,
                                       return_states=True)
    assert torch.equal(zero_states, s_in)


@pytest.mark.cuda
def test_cuda_forward_is_deterministic():
    """No atomics: two runs give the same Y and final state bit for bit."""
    _need_card()
    ins = _inputs(2, 256, 8, 64, 64, seed=22)
    s0 = _s0(2, 8, 64, 64, 23)
    first = kernel.ssd_cuda(*ins, chunk=64, initial_state=s0)
    again = kernel.ssd_cuda(*ins, chunk=64, initial_state=s0)
    for x, y in zip(first, again):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("given", ["initial_state", "return_state"])
def test_cuda_forward_state_arguments_refuse_autograd(given):
    """On the card too, the op raises while autograd records through an
    input and an initial state or the final state is asked for."""
    _need_card()
    ins = [t.requires_grad_() for t in _inputs(1, 64, 4, 64, 64, seed=24)]
    kw = ({"initial_state": _s0(1, 4, 64, 64, 25)}
          if given == "initial_state" else {"return_state": True})
    before = ops.ssd.launches
    with pytest.raises(RuntimeError, match="no gradient"):
        ops.ssd(*ins, chunk=64, **kw)
    assert ops.ssd.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["dtype", "shape", "device"])
def test_cuda_forward_refuses_bad_initial_state(case):
    """The launcher takes an fp32 (B, H, hd, N) initial state on the
    inputs' card, and raises on anything else before any launch."""
    _need_card()
    ins = _inputs(1, 64, 4, 64, 64, seed=26)
    s0 = _s0(1, 4, 64, 64, 27)
    s0 = {"dtype": s0.bfloat16(), "shape": s0[:, :2],
          "device": s0.cpu()}[case]
    with pytest.raises(ValueError, match="initial_state"):
        kernel.ssd_cuda(*ins, chunk=64, initial_state=s0)


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
@pytest.mark.parametrize("decay", ["sweep", "fast", "slow"])
@pytest.mark.parametrize("chunk", [16, 64])
def test_cuda_backward_matches_plain_autograd(chunk, decay):
    """Gradients through the op, whose backward is the CUDA backward kernel
    (one launch), against autograd through the plain chunked version and
    against the plain backward ssd_chunked_bwd."""
    _need_card()
    ins = _inputs(2, 256, 4, 64, 64, seed=2, decay=decay)
    g = torch.randn((2, 256, 4, 64), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(3))
    a = [t.clone().requires_grad_() for t in ins]
    b = [t.clone().requires_grad_() for t in ins]
    before = ops.ssd.bwd_launches
    (ops.ssd(*a, chunk=chunk) * g).sum().backward()
    assert ops.ssd.bwd_launches == before + 1
    (ref.ssd_chunked(*b, chunk=chunk)[0] * g).sum().backward()
    plain = ref.ssd_chunked_bwd(*ins, g, chunk=chunk)
    for x, y, p in zip(a, b, plain):
        assert x.grad.shape == y.grad.shape
        ok, err = _close(x.grad, y.grad, GRAD_TOL)
        assert ok, err
        ok, err = _close(x.grad, p, GRAD_TOL)
        assert ok, err


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,hd,N,chunk", [
    (2, 128, 8, 16, 16, 16), (2, 128, 8, 16, 16, 32),
    (1, 64, 4, 32, 8, 16), (1, 64, 4, 32, 8, 32), (1, 64, 4, 32, 8, 64),
    (1, 192, 3, 64, 64, 32), (1, 64, 3, 64, 64, 64), (2, 128, 5, 16, 16, 32),
    (1, 32, 5, 32, 8, 32), (2, 96, 6, 16, 16, 16)])
def test_cuda_backward_sweep(B, S, H, hd, N, chunk):
    """The backward kernels at every (hd, N) they take against the plain
    backward, at one chunk (S = chunk) and at head groups of 4, 2 and 1
    (H = 3 and 5), and the padded steps' zero cotangent (mamba_forward pads
    S to the chunk and slices Y) giving exactly zero gradients there."""
    _need_card()
    ins = _inputs(B, S, H, hd, N, seed=chunk + hd)
    g = torch.randn((B, S, H, hd), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(4))
    g[:, S - 5:] = 0.0
    grads = kernel.ssd_bwd_cuda(*ins, g, chunk=chunk)
    plain = ref.ssd_chunked_bwd(*ins, g, chunk=chunk)
    torch.cuda.synchronize()
    for x, p in zip(grads, plain):
        ok, err = _close(x, p, GRAD_TOL)
        assert ok and bool(torch.isfinite(x).all()), err
        assert bool((x[:, S - 5:] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,hd,N,chunk", [
    (2, 256, 4, 64, 64, 64), (1, 64, 3, 32, 8, 16), (2, 128, 5, 16, 16, 32)])
def test_cuda_backward_states_match_state_pass(B, S, H, hd, N, chunk):
    """The backward's scratch after its scan over the chunks, the state
    entering each chunk and the cotangent of the state leaving it, against
    the plain stages 1 and 2 (`ssd_bwd_chunk_state`, `ssd_bwd_state_pass`)
    on the same card tensors."""
    _need_card()
    ins = _inputs(B, S, H, hd, N, seed=9 + H)
    g = torch.randn((B, S, H, hd), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(10))
    _, states = kernel.ssd_bwd_cuda(*ins, g, chunk=chunk, return_states=True)
    plain = ref.ssd_bwd_state_pass(
        *ref.ssd_bwd_chunk_state(*ins, g, chunk=chunk))
    torch.cuda.synchronize()
    for x, p in zip(states, plain):
        assert x.shape == p.shape == (B, H, S // chunk, hd, N)
        ok, err = _close(x, p, GRAD_TOL)
        assert ok, err


@pytest.mark.cuda
def test_cuda_backward_bf16():
    """bf16 inputs and cotangent, fp32 arithmetic inside, gradients in bf16:
    within one bf16 rounding (2^-8 relative) of the plain backward's fp32
    result on the same values, plus its fp32 tolerance."""
    _need_card()
    ins = [t.bfloat16() for t in _inputs(2, 256, 4, 64, 64, seed=5)]
    g = torch.randn((2, 256, 4, 64), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(6))
    g = g.bfloat16()
    grads = kernel.ssd_bwd_cuda(*ins, g, chunk=64)
    plain = ref.ssd_chunked_bwd(*(t.float() for t in ins), g.float(),
                                chunk=64)
    for x, p in zip(grads, plain):
        assert x.dtype == torch.bfloat16
        err = (x.float() - p).abs() - BF16_TOL * p.abs()
        assert float(err.max()) <= GRAD_TOL * max(1.0, float(p.abs().max()))


@pytest.mark.cuda
def test_cuda_backward_is_deterministic():
    """No atomics: two runs give the same gradients bit for bit."""
    _need_card()
    ins = _inputs(2, 256, 8, 64, 64, seed=7)
    g = torch.randn((2, 256, 8, 64), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(8))
    first = kernel.ssd_bwd_cuda(*ins, g, chunk=64)
    again = kernel.ssd_bwd_cuda(*ins, g, chunk=64)
    for x, y in zip(first, again):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("case,exc,match", [
    ("ragged", ValueError, "multiple of the chunk"),
    ("groups", ValueError, "n_groups"),
    ("shape", ValueError, "head_dim, state_dim"),
    ("chunk", ValueError, "chunk 8"),
    ("dtype", TypeError, "all float32 or all bfloat16"),
    ("dy shape", ValueError, "dY"),
    ("device", ValueError, "CUDA device"),
])
def test_cuda_backward_refuses(case, exc, match):
    """The backward launcher refuses what the kernel does not take, with
    the forward's messages, before any launch."""
    _need_card()
    S = 40 if case == "ragged" else 64
    hd, N = (16, 8) if case == "shape" else (64, 64)
    xdt, dA, Bc, Cc = _inputs(1, S, 2, hd, N, seed=0)
    dy = torch.randn_like(xdt)
    if case == "groups":
        Bc, Cc = torch.cat([Bc, Bc], 2), torch.cat([Cc, Cc], 2)
    elif case == "dtype":
        dy = dy.bfloat16()
    elif case == "dy shape":
        dy = dy[:, :, :1]
    elif case == "device":
        dy = dy.cpu()
    with pytest.raises(exc, match=match):
        kernel.ssd_bwd_cuda(xdt, dA, Bc, Cc, dy,
                            chunk=8 if case == "chunk" else 16)


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
