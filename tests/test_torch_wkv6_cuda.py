"""The CUDA chunked-WKV kernels against their plain versions, on the card:
y and the final state against `wkv6_chunked`, the states after the scan
over the chunks (stage 2) against the staged plain version's, and two runs
the same bits.

Needs an NVIDIA Hopper card and nvcc: the kernel has no CPU mode, so these
tests skip elsewhere.  Run on the card with
``PYTHONPATH=src python -m pytest -q --noconftest -m cuda
tests/test_torch_wkv6_cuda.py``.
This file imports no JAX, so it runs where JAX is not installed."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.rwkv6_scan import kernel, ops, ref  # noqa: E402

TOL = 1e-5   # relative to max(1, max |plain|): fp32, summation order only


def _inputs(B, S, H, hd, seed):
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (n(B, S, H, hd) * 0.5, n(B, S, H, hd) * 0.5, n(B, S, H, hd),
            -np.exp(n(B, S, H, hd) * 0.5 - 1.0), n(H, hd) * 0.1)


def _close(out, plain):
    return float((out - plain).abs().max()) <= TOL * max(
        1.0, float(plain.abs().max()))


def _card_inputs(B, S, H, hd, chunk, with_state):
    r, k, v, logw, u = (torch.from_numpy(a).cuda()
                        for a in _inputs(B, S, H, hd, seed=chunk))
    s0 = (torch.randn((B, H, hd, hd), device="cuda",
                      generator=torch.Generator("cuda").manual_seed(1))
          if with_state else None)
    return (r, k, v, logw, u), s0


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,hd,chunk", [(2, 96, 4, 32, 16),
                                            (2, 96, 4, 32, 32),
                                            (1, 64, 2, 64, 32),
                                            (1, 128, 2, 64, 64),
                                            (2, 64, 3, 32, 64)])
@pytest.mark.parametrize("with_state", [False, True])
def test_cuda_kernel_matches_plain(B, S, H, hd, chunk, with_state):
    """y and the final state against wkv6_chunked on the same card tensors."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    r, k, v, logw, u = (torch.from_numpy(a).cuda()
                        for a in _inputs(B, S, H, hd, seed=chunk))
    s0 = (torch.randn((B, H, hd, hd), device="cuda",
                      generator=torch.Generator("cuda").manual_seed(1))
          if with_state else None)
    before = ops.wkv6.launches
    y, state = ops.wkv6(r, k, v, logw, u, chunk=chunk, initial_state=s0)
    assert ops.wkv6.launches == before + 1
    py, ps = ref.wkv6_chunked(r, k, v, logw, u, chunk=chunk,
                              initial_state=s0)
    torch.cuda.synchronize()
    assert _close(y, py) and _close(state, ps)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,hd,chunk", [(2, 96, 4, 32, 16),
                                            (1, 128, 2, 64, 64),
                                            (2, 256, 2, 64, 32)])
@pytest.mark.parametrize("with_state", [False, True])
def test_cuda_states_match_the_plain_stages(B, S, H, hd, chunk, with_state):
    """The scratch after stage 2, the state entering each chunk, against
    the plain stages 1 and 2 on the same card tensors."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    (r, k, v, logw, u), s0 = _card_inputs(B, S, H, hd, chunk, with_state)
    _, state, states = kernel.wkv6_cuda(r, k, v, logw, u, chunk=chunk,
                                        initial_state=s0, return_states=True)
    want, final = ref.wkv6_state_pass(
        *ref.wkv6_chunk_state(k, v, logw, chunk=chunk), s0)
    torch.cuda.synchronize()
    assert states.shape == (B, H, S // chunk, hd, hd)
    assert _close(states, want) and _close(state, final)


@pytest.mark.cuda
@pytest.mark.parametrize("with_state", [False, True])
def test_cuda_two_runs_give_the_same_bits(with_state):
    """Every sum runs in a fixed order: y and the state repeat bit for
    bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    args, s0 = _card_inputs(2, 256, 4, 64, 64, with_state)
    y1, s1 = ops.wkv6(*args, chunk=64, initial_state=s0)
    y2, s2 = ops.wkv6(*args, chunk=64, initial_state=s0)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and torch.equal(s1, s2)


@pytest.mark.cuda
def test_cuda_launcher_refuses_a_ragged_sequence():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    r, k, v, logw, u = (torch.from_numpy(a).cuda()
                        for a in _inputs(1, 40, 2, 32, seed=0))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ops.wkv6(r, k, v, logw, u, chunk=16)


@pytest.mark.cuda
def test_cuda_kernel_refuses_to_drop_a_gradient():
    """No backward yet: while autograd records through an input the kernel
    raises instead of returning a y with no gradient; without a graph it
    runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    r, k, v, logw, u = (torch.from_numpy(a).cuda()
                        for a in _inputs(1, 64, 2, 32, seed=0))
    before = ops.wkv6.launches
    with pytest.raises(RuntimeError, match="no backward"):
        ops.wkv6(r.requires_grad_(), k, v, logw, u, chunk=16)
    assert ops.wkv6.launches == before
    with torch.no_grad():
        ops.wkv6(r, k, v, logw, u, chunk=16)
    assert ops.wkv6.launches == before + 1
