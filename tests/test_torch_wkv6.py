"""Port parity for the chunked WKV: the plain chunked version (the CPU path
of the kernel wrapper) against the JAX oracle `wkv6_ref` and the JAX Pallas
kernel in interpret mode, fp32.  Tolerance 1e-5 relative to the larger of 1
and the reference's largest magnitude (outputs reach ~10 here): fp32 on both
sides and the same algorithm, so only summation order differs, a few ulps
of the largest terms (the card's check in chip_smoke.py is the same).
Against the step-by-step recurrence the tolerance is 1e-3, the JAX kernel
sweep's chunk-vs-step bound (tests/test_kernels.py).  The CUDA kernel is
held against the same plain version on the card (chip_smoke.py and
tests/test_torch_wkv6_cuda.py).  The staged plain version, the card's three
stages in PyTorch, is held to the same 1e-5 against `wkv6_chunked` and the
JAX oracle, and its scan over the chunks against the state after each
prefix of the chunks."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.rwkv6_scan import ops as jax_ops  # noqa: E402
from repro_torch.kernels.rwkv6_scan import kernel, ops, ref  # noqa: E402

TOL = 1e-5
STEP_TOL = 1e-3


def _inputs(B, S, H, hd, seed=0, decay="sweep"):
    """Drawn as tests/test_kernels.py draws them, from numpy; "slow": the
    log-decay near the model's w0 init, -exp(-6) or so, as chip_smoke.py's
    slow case, so the state holds ~400 steps."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    r, k, v = n(B, S, H, hd) * 0.5, n(B, S, H, hd) * 0.5, n(B, S, H, hd)
    w = n(B, S, H, hd)
    logw = -np.exp(w * 0.5 - 1.0 if decay == "sweep" else w * 0.1 - 6.0)
    u = n(H, hd) * 0.1
    return r, k, v, logw, u


def _state(B, H, hd, seed=3):
    return np.random.default_rng(seed).standard_normal(
        (B, H, hd, hd)).astype(np.float32)


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


@pytest.mark.parametrize("decay", ["sweep", "slow"])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("chunk", [16, 32, 64])
def test_staged_matches_chunked_jax_ref_and_pallas(chunk, with_state, decay):
    """The card's three stages in PyTorch against wkv6_chunked, the JAX
    oracle and (without an initial state, which it does not take) the
    Pallas kernel in interpret mode, y and the final state."""
    arrs = _inputs(2, 128, 2, 32, seed=chunk, decay=decay)
    s0 = _state(2, 2, 32) if with_state else None
    ts0 = None if s0 is None else torch.from_numpy(s0)
    y, state = ref.wkv6_chunked_staged(*_t(arrs), chunk=chunk,
                                       initial_state=ts0)
    py, ps = ref.wkv6_chunked(*_t(arrs), chunk=chunk, initial_state=ts0)
    assert _close(y, py.numpy()) and _close(state, ps.numpy())
    jy, js = jax_ops.wkv6_ref(*map(jnp.asarray, arrs), chunk=chunk,
                              initial_state=None if s0 is None
                              else jnp.asarray(s0))
    assert _close(y, jy) and _close(state, js)
    if s0 is None:
        assert _close(y, jax_ops.wkv6(*map(jnp.asarray, arrs), chunk=chunk))


@pytest.mark.parametrize("B,S,H,hd,chunk", [(1, 48, 2, 32, 64),
                                            (2, 64, 1, 64, 64),
                                            (1, 96, 3, 64, 32)])
def test_staged_one_chunk_and_other_shapes(B, S, H, hd, chunk):
    """nC = 1 (a sequence shorter than the chunk, and one exactly a chunk
    long) and hd 64, with an initial state, against wkv6_chunked and JAX."""
    arrs = _inputs(B, S, H, hd, seed=7)
    s0 = _state(B, H, hd)
    y, state = ref.wkv6_chunked_staged(*_t(arrs), chunk=chunk,
                                       initial_state=torch.from_numpy(s0))
    py, ps = ref.wkv6_chunked(*_t(arrs), chunk=chunk,
                              initial_state=torch.from_numpy(s0))
    assert _close(y, py.numpy()) and _close(state, ps.numpy())
    jy, js = jax_ops.wkv6_ref(*map(jnp.asarray, arrs), chunk=chunk,
                              initial_state=jnp.asarray(s0))
    assert _close(y, jy) and _close(state, js)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("chunk", [16, 32])
def test_state_pass_matches_a_loop_over_the_chunks(chunk, with_state):
    """Stage 2's S_in[c], the state entering chunk c, is the final state of
    wkv6_chunked over the first c chunks (S_in[0] the initial state), and
    its last state that over all of them; the stage-1 decay is
    exp(sum of logw over the chunk)."""
    r, k, v, logw, u = _t(_inputs(2, 128, 2, 32, seed=11))
    s0 = torch.from_numpy(_state(2, 2, 32)) if with_state else None
    dS, decay = ref.wkv6_chunk_state(k, v, logw, chunk=chunk)
    nC = 128 // chunk
    assert dS.shape == (2, 2, nC, 32, 32) and decay.shape == (2, 2, nC, 32)
    want = torch.exp(logw.reshape(2, nC, chunk, 2, 32).sum(2)).transpose(1, 2)
    assert _close(decay, want.numpy())
    s_in, final = ref.wkv6_state_pass(dS, decay, s0)
    state = torch.zeros((2, 2, 32, 32)) if s0 is None else s0
    assert torch.equal(s_in[:, :, 0], state)
    for c in range(1, nC + 1):
        t = slice(0, c * chunk)
        _, state = ref.wkv6_chunked(r[:, t], k[:, t], v[:, t], logw[:, t], u,
                                    chunk=chunk, initial_state=s0)
        got = s_in[:, :, c] if c < nC else final
        assert _close(got, state.numpy()), c


def test_cpu_tensor_takes_plain_version():
    arrs = _t(_inputs(1, 64, 2, 32, seed=5))
    before = ops.wkv6.launches
    y, state = ops.wkv6(*arrs, chunk=16)
    py, ps = ref.wkv6_chunked(*arrs, chunk=16)
    assert ops.wkv6.launches == before
    assert torch.equal(y, py) and torch.equal(state, ps)


class _Elsewhere:
    """A tensor stand-in on a device with neither kernel nor plain version
    (a CPU build of torch can make no tensor on one)."""
    device = torch.device("xla")

    def __init__(self, t):
        self.shape = t.shape


def test_other_devices_raise():
    """Meta takes the plain version, which gives the shapes (the dry run
    counts on it); a device that is not the CPU, the card or meta
    raises."""
    arrs = [a.to("meta") for a in _t(_inputs(1, 32, 1, 32))]
    y, state = ops.wkv6(*arrs, chunk=16)
    assert y.device.type == state.device.type == "meta"
    assert y.shape == arrs[0].shape and state.shape == (1, 1, 32, 32)
    with pytest.raises(ValueError, match="no kernel"):
        ops.wkv6(*map(_Elsewhere, arrs), chunk=16)


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
