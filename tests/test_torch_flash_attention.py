"""Port parity: the plain flash attention (the CPU path of the kernel
wrapper) against the JAX model's blockwise attention and against the JAX
Pallas kernel in interpret mode, fp32.  Tolerance 2e-5, the JAX kernel
sweep's own (tests/test_kernels.py).  The CUDA kernel is held against the
same plain version on the card (chip_smoke.py and
tests/test_torch_flash_attention_cuda.py)."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.flash_attention import ops as jax_fa_ops  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch.kernels.flash_attention import ops, ref  # noqa: E402
from repro_torch.models.attention import expand_kv  # noqa: E402

TOL = 2e-5


def _qkv(B, S, H, G, hd, seed=0, T=None):
    rng = np.random.default_rng(seed)
    T = T or S
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, T, G, hd)).astype(np.float32)
    v = rng.standard_normal((B, T, G, hd)).astype(np.float32)
    return q, k, v


def _expand(x, H):
    return np.repeat(x, H // x.shape[2], axis=2)


@pytest.mark.parametrize("B,H,S,hd", [(2, 4, 256, 64), (1, 2, 512, 128),
                                      (2, 1, 128, 32)])
@pytest.mark.parametrize("window,cap", [(0, 0.0), (128, 0.0), (0, 50.0)])
def test_plain_matches_pallas_interpret(B, H, S, hd, window, cap):
    """The JAX kernel sweep: (B,H,S,hd) layout in the Pallas kernel."""
    q, k, v = _qkv(B, S, H, H, hd)
    scale = hd ** -0.5
    out = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), window=window or None,
                              logit_softcap=cap, scale=scale,
                              q_block=128, kv_block=128)
    t = lambda a: jnp.asarray(a).transpose(0, 2, 1, 3)  # noqa: E731
    kern = jax_fa_ops.flash_attention(t(q), t(k), t(v), window=window,
                                      logit_softcap=cap, scale=scale,
                                      bq=128, bk=128)
    ref_out = np.asarray(kern).transpose(0, 2, 1, 3)
    assert float(np.max(np.abs(out.numpy() - ref_out))) < TOL


@pytest.mark.parametrize(
    "B,S,H,G,hd,window,cap,qb,kb",
    [(2, 48, 16, 4, 32, 16, 50.0, 16, 16),     # GQA, window bites
     (1, 100, 8, 2, 64, None, 0.0, 32, 32),    # ragged S (not a block multiple)
     (2, 77, 4, 4, 32, 78, 50.0, 32, 16),      # window = S + 1 (global layer)
     (1, 64, 4, 1, 32, 5, 0.0, 64, 64)])       # one KV group, tiny window
def test_plain_matches_jax_blockwise(B, S, H, G, hd, window, cap, qb, kb):
    q, k, v = _qkv(B, S, H, G, hd, seed=1)
    scale = 0.0625
    out = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), window=window,
                              logit_softcap=cap, scale=scale,
                              q_block=qb, kv_block=kb)
    jout = jattn.flash_attention(
        jnp.asarray(q), jnp.asarray(_expand(k, H)), jnp.asarray(_expand(v, H)),
        causal=True, window=window, logit_softcap=cap, scale=scale,
        q_block=qb, kv_block=kb)
    assert float(np.max(np.abs(out.numpy() - np.asarray(jout)))) < TOL


def test_oneshot_oracle_matches_blockwise():
    q, k, v = _qkv(2, 70, 4, 4, 32, seed=2)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    blk = ref.flash_attention_blockwise(tq, tk, tv, window=20,
                                        logit_softcap=50.0, scale=0.2,
                                        q_block=32, kv_block=16)
    one = ref.flash_attention_ref(*(a.transpose(1, 2) for a in (tq, tk, tv)),
                                  window=20, logit_softcap=50.0, scale=0.2)
    assert float((blk - one.transpose(1, 2)).abs().max()) < TOL


def test_cpu_tensor_takes_plain_version():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 40, 4, 2, 32, seed=3))
    before = ops.flash_attention.launches
    out = ops.flash_attention(q, k, v, window=8, logit_softcap=50.0,
                              scale=0.1, q_block=16, kv_block=16)
    plain = ref.flash_attention_blockwise(q, k, v, window=8,
                                          logit_softcap=50.0, scale=0.1,
                                          q_block=16, kv_block=16)
    assert ops.flash_attention.launches == before
    assert torch.equal(out, plain)


def test_expand_kv_matches_jax():
    """Head h reads KV group h // (Hq/G), as the JAX layout has it."""
    k = np.random.default_rng(5).standard_normal((2, 7, 4, 8)).astype(
        np.float32)
    out = expand_kv(torch.from_numpy(k), 16)
    assert np.array_equal(out.numpy(), np.asarray(jattn.expand_kv(
        jnp.asarray(k), 16)))
