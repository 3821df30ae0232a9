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


# ---------------------------------------------------------------------------
# causal=False at T != S, probs_bf16, rows without a key, the one-shot
# oracle at T != S
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "B,S,T,H,G,hd,window,cap,qb,kb",
    [(2, 24, 100, 16, 4, 32, None, 0.0, 16, 32),   # cross-attention, GQA,
                                                   # T not a block multiple
     (1, 100, 100, 8, 8, 64, None, 0.0, 32, 32),   # the encoder, S == T
     (2, 40, 70, 4, 2, 32, 30, 50.0, 16, 16),      # window, softcap
     (1, 130, 45, 4, 1, 32, None, 0.0, 64, 16)])   # S > T, one KV group
def test_plain_non_causal_matches_jax_blockwise(B, S, T, H, G, hd, window,
                                                cap, qb, kb):
    q, k, v = _qkv(B, S, H, G, hd, seed=6, T=T)
    scale = hd ** -0.5
    out = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=False,
                              window=window, logit_softcap=cap, scale=scale,
                              q_block=qb, kv_block=kb)
    jout = jattn.flash_attention(
        jnp.asarray(q), jnp.asarray(_expand(k, H)), jnp.asarray(_expand(v, H)),
        causal=False, window=window, logit_softcap=cap, scale=scale,
        q_block=qb, kv_block=kb)
    assert out.shape == (B, S, H, hd)
    assert float(np.max(np.abs(out.numpy() - np.asarray(jout)))) < TOL


def test_plain_causal_at_t_ne_s_matches_jax_blockwise():
    """Causal with more keys than queries: query s sees keys t <= s."""
    q, k, v = _qkv(2, 30, 4, 2, 32, seed=7, T=50)
    out = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), scale=0.2, q_block=16,
                              kv_block=16)
    jout = jattn.flash_attention(
        jnp.asarray(q), jnp.asarray(_expand(k, 4)), jnp.asarray(_expand(v, 4)),
        causal=True, scale=0.2, q_block=16, kv_block=16)
    assert float(np.max(np.abs(out.numpy() - np.asarray(jout)))) < TOL


# probs_bf16 in bf16: both sides round P and the output to bf16; their fp32
# sums differ in order only, so the outputs lie within one bf16 ulp of
# |out| <= 4 (2^-6), and P rounded moves them far more than that from the
# unrounded path (held below)
BF16_TOL = 2.0 ** -6


@pytest.mark.parametrize("causal,S,T", [(True, 64, 64), (False, 24, 90)])
def test_plain_probs_bf16_matches_jax_blockwise(causal, S, T):
    q, k, v = _qkv(2, S, 8, 2, 64, seed=8, T=T)
    kw = dict(causal=causal, scale=0.125, q_block=16, kv_block=32)
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, probs_bf16=True, **kw)
    plain = ops.flash_attention(tq, tk, tv, **kw)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in
                  (q, _expand(k, 8), _expand(v, 8)))
    jout = jattn.flash_attention(jq, jk, jv, probs_bf16=True, **kw)
    assert out.dtype == torch.bfloat16
    err = float(np.max(np.abs(out.float().numpy()
                              - np.asarray(jout, np.float32))))
    assert err <= BF16_TOL, err
    assert float((out.float() - plain.float()).abs().max()) > 0
    # fp32 inputs: the rounding to V's type changes nothing
    f32 = [torch.from_numpy(a) for a in (q, k, v)]
    assert torch.equal(ops.flash_attention(*f32, probs_bf16=True, **kw),
                       ops.flash_attention(*f32, **kw))


def test_plain_row_without_a_key_gives_zeros():
    """Not causal, window 6, 10 keys: a query s sees t in (s - 6, 10), so
    rows s >= 15 see none and give zeros; the others equal the one-shot
    oracle."""
    q, k, v = _qkv(2, 24, 4, 2, 32, seed=9, T=10)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    kw = dict(causal=False, window=6, scale=0.2)
    out = ops.flash_attention(tq, tk, tv, q_block=8, kv_block=4, **kw)
    assert torch.equal(out[:, 15:], torch.zeros_like(out[:, 15:]))
    one = ref.flash_attention_ref(tq.transpose(1, 2),
                                  expand_kv(tk, 4).transpose(1, 2),
                                  expand_kv(tv, 4).transpose(1, 2),
                                  **kw).transpose(1, 2)
    assert float((out[:, :15] - one[:, :15]).abs().max()) < TOL
    assert float(out[:, :15].abs().min(dim=-1).values.max()) > 0


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 9), (False, 9)])
def test_oneshot_oracle_at_t_ne_s(causal, window):
    """flash_attention_ref at S = 40 queries and T = 56 keys (its mask is
    S x T) against the blockwise version."""
    q, k, v = _qkv(2, 40, 4, 4, 32, seed=10, T=56)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    kw = dict(causal=causal, window=window, logit_softcap=50.0, scale=0.2)
    blk = ref.flash_attention_blockwise(tq, tk, tv, q_block=16, kv_block=16,
                                        **kw)
    one = ref.flash_attention_ref(*(a.transpose(1, 2) for a in (tq, tk, tv)),
                                  **kw).transpose(1, 2)
    assert one.shape == (2, 40, 4, 32)
    assert float((blk - one).abs().max()) < TOL


def test_non_causal_gradients_match_autograd_of_the_oracle():
    """The plain version's gradients (the card's backward recomputes it)
    with causal=False at T != S against the one-shot oracle's.  Both
    compute in fp32, so they differ in summation order only: within 1e-5
    of max(1, max |oracle grad|)."""
    q, k, v = _qkv(1, 20, 4, 2, 32, seed=11, T=35)
    ins = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    g = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (1, 20, 4, 32)).astype(np.float32))
    blk = ref.flash_attention_blockwise(*ins, causal=False, scale=0.2,
                                        q_block=8, kv_block=16)
    ga = torch.autograd.grad(blk, ins, g)
    ins2 = [t.detach().clone().requires_grad_() for t in ins]
    one = ref.flash_attention_ref(ins2[0].transpose(1, 2),
                                  expand_kv(ins2[1], 4).transpose(1, 2),
                                  expand_kv(ins2[2], 4).transpose(1, 2),
                                  causal=False, scale=0.2).transpose(1, 2)
    gb = torch.autograd.grad(one, ins2, g)
    for a, b in zip(ga, gb):
        assert float((a - b).abs().max()) < 1e-5 * max(
            1.0, float(b.abs().max()))


def test_plain_runs_fp64_inputs_in_fp64():
    """fp64 inputs are computed in fp64 (the reference the card's gradient
    checks hold fp32 to): the output is fp64, and the fp32 run's output and
    gradients lie within 1e-5 of max(1, max |fp64|) of it, at q/k head dim
    48 with v head dim 32, causal=False and T != S."""
    q, k, _ = _qkv(1, 30, 4, 2, 48, seed=13, T=70)
    v = np.random.default_rng(14).standard_normal((1, 70, 2, 32)).astype(
        np.float32)
    g = torch.from_numpy(np.random.default_rng(15).standard_normal(
        (1, 30, 4, 32)).astype(np.float32))
    kw = dict(causal=False, scale=0.15, q_block=16, kv_block=32)
    outs, grads = [], []
    for dt in (torch.float64, torch.float32):
        ins = [torch.from_numpy(a).to(dt).requires_grad_() for a in (q, k, v)]
        out = ref.flash_attention_blockwise(*ins, **kw)
        assert out.dtype == dt
        outs.append(out.detach())
        grads.append(torch.autograd.grad(out, ins, g.to(dt)))
    assert float((outs[1] - outs[0]).abs().max()) < 1e-5
    for a, b in zip(grads[1], grads[0]):
        assert float((a - b).abs().max()) < 1e-5 * max(1.0,
                                                       float(b.abs().max()))
