"""Port parity for the chunked WKV: the plain chunked version (the CPU path
of the kernel wrapper) against the JAX oracle `wkv6_ref` and the JAX Pallas
kernel in interpret mode, fp32.  Tolerance 1e-5 relative to the larger of 1
and the reference's largest magnitude (outputs reach ~10 here): fp32 on both
sides and the same algorithm, so only summation order differs, a few ulps
of the largest terms (the card's check in chip_smoke.py is the same).
Against the step-by-step recurrence the tolerance is 1e-3, the JAX kernel
sweep's chunk-vs-step bound (tests/test_kernels.py).  The CUDA kernel is
held against the same plain version on the card (chip_smoke.py and
tests/test_torch_wkv6_cuda.py)."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.rwkv6_scan import ops as jax_ops  # noqa: E402
from repro_torch.kernels.rwkv6_scan import kernel, ops, ref  # noqa: E402

TOL = 1e-5
STEP_TOL = 1e-3


def _inputs(B, S, H, hd, seed=0):
    """Drawn as tests/test_kernels.py draws them, from numpy."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    r, k, v = n(B, S, H, hd) * 0.5, n(B, S, H, hd) * 0.5, n(B, S, H, hd)
    logw = -np.exp(n(B, S, H, hd) * 0.5 - 1.0)
    u = n(H, hd) * 0.1
    return r, k, v, logw, u


def _t(arrs):
    return [torch.from_numpy(a) for a in arrs]


def _err(t, j):
    return float(np.max(np.abs(t.numpy() - np.asarray(j))))


def _close(t, j, tol=TOL):
    """max |t - j| <= tol * max(1, max |j|)."""
    j = np.asarray(j)
    return _err(t, j) <= tol * max(1.0, float(np.max(np.abs(j))))


@pytest.mark.parametrize("B,S,H,hd,chunk",
                         [(B, S, H, hd, c)
                          for B, S, H, hd in [(2, 128, 4, 32), (1, 64, 2, 64),
                                              (1, 96, 1, 32)]
                          for c in (16, 32)] + [(1, 128, 2, 64, 64)])
def test_chunked_matches_jax_ref_and_pallas(B, S, H, hd, chunk):
    arrs = _inputs(B, S, H, hd)
    y, state = ops.wkv6(*_t(arrs), chunk=chunk)
    jy, jstate = jax_ops.wkv6_ref(*map(jnp.asarray, arrs), chunk=chunk)
    assert _close(y, jy)
    assert _close(state, jstate)
    pallas = jax_ops.wkv6(*map(jnp.asarray, arrs), chunk=chunk)
    assert _close(y, pallas)


@pytest.mark.parametrize("chunk", [16, 32, 64])
def test_chunked_matches_sequential(chunk):
    arrs = _t(_inputs(2, 128, 2, 32, seed=1))
    y, state = ref.wkv6_chunked(*arrs, chunk=chunk)
    ys, ss = ref.wkv6_sequential(*arrs)
    assert float((y - ys).abs().max()) < STEP_TOL
    assert float((state - ss).abs().max()) < STEP_TOL
    jy, js = jax_ops.wkv6_sequential_ref(*map(jnp.asarray,
                                              (a.numpy() for a in arrs)))
    assert _close(ys, jy) and _close(ss, js)


def test_initial_state():
    """A carried state: against JAX, and the sequence split in two."""
    arrs = _inputs(2, 96, 2, 32, seed=2)
    s0 = np.random.default_rng(3).standard_normal((2, 2, 32, 32)).astype(
        np.float32)
    y, state = ops.wkv6(*_t(arrs), chunk=16,
                        initial_state=torch.from_numpy(s0))
    jy, js = jax_ops.wkv6_ref(*map(jnp.asarray, arrs), chunk=16,
                              initial_state=jnp.asarray(s0))
    assert _close(y, jy) and _close(state, js)

    r, k, v, logw, u = _t(arrs)
    first = [a[:, :48] for a in (r, k, v, logw)]
    second = [a[:, 48:] for a in (r, k, v, logw)]
    y1, mid = ref.wkv6_chunked(*first, u, chunk=16,
                               initial_state=torch.from_numpy(s0))
    y2, end = ref.wkv6_chunked(*second, u, chunk=16, initial_state=mid)
    assert _close(torch.cat([y1, y2], 1), y.numpy())
    assert _close(end, state.numpy())


def test_padded_tail_keeps_the_state():
    """45 real steps padded to 48 as time_mix pads (logw = 0, k = 0): the
    final state is the state after the 45 real steps."""
    r, k, v, logw, u = _t(_inputs(2, 45, 2, 32, seed=4))
    pad = lambda a: torch.nn.functional.pad(a, (0, 0, 0, 0, 0, 3))  # noqa
    y, state = ops.wkv6(pad(r), pad(k), pad(v), pad(logw), u, chunk=16)
    ys, ss = ref.wkv6_sequential(r, k, v, logw, u)
    assert float((state - ss).abs().max()) < STEP_TOL
    assert float((y[:, :45] - ys).abs().max()) < STEP_TOL
    # the same 45 steps in chunks that divide them: same algorithm
    y15, s15 = ref.wkv6_chunked(r, k, v, logw, u, chunk=15)
    assert _close(state, s15.numpy())
    assert _close(y[:, :45], y15.numpy())


def test_cpu_tensor_takes_plain_version():
    arrs = _t(_inputs(1, 64, 2, 32, seed=5))
    before = ops.wkv6.launches
    y, state = ops.wkv6(*arrs, chunk=16)
    py, ps = ref.wkv6_chunked(*arrs, chunk=16)
    assert ops.wkv6.launches == before
    assert torch.equal(y, py) and torch.equal(state, ps)


def test_other_devices_raise():
    arrs = [a.to("meta") for a in _t(_inputs(1, 32, 1, 32))]
    with pytest.raises(ValueError, match="no kernel"):
        ops.wkv6(*arrs, chunk=16)


@pytest.mark.parametrize("case,exc,match", [
    ("ragged", ValueError, "multiple of the chunk"),
    ("head_dim", ValueError, "head_dim"),
    ("chunk", ValueError, "chunk 8"),
    ("dtype", TypeError, "float32"),
    ("shape", ValueError, "shape"),
    ("u", ValueError, r"\(H, hd\)"),
    ("state", ValueError, "initial_state"),
    ("device", ValueError, "CUDA device"),
])
def test_launcher_rejects_what_the_kernel_does_not_take(case, exc, match):
    """The launcher's checks run before anything reaches the card, so they
    hold on the CPU too; a CPU tensor is refused, never computed."""
    r, k, v, logw, u = _t(_inputs(1, 64, 2, 32))
    kw = dict(chunk=16)
    if case == "ragged":
        r, k, v, logw = (a[:, :40] for a in (r, k, v, logw))
    elif case == "head_dim":
        r, k, v, logw, u = _t(_inputs(1, 64, 2, 16))
    elif case == "chunk":
        kw["chunk"] = 8
    elif case == "dtype":
        r = r.double()
    elif case == "shape":
        k = k[:, :32]
    elif case == "u":
        u = u[:1]
    elif case == "state":
        kw["initial_state"] = torch.zeros((1, 2, 32, 16))
    with pytest.raises(exc, match=match):
        kernel.wkv6_cuda(r, k, v, logw, u, **kw)
