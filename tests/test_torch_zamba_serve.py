"""Port parity for the zamba2 serving slice: zamba2-2.7b reduced (12 Mamba2
layers in 2 groups, d_model 128, 16 SSD heads of 16, state 16, conv window
4, chunk 16, shared attention with 4 heads of 32 padded to 16 and 4 KV
heads) with the JAX package's params loaded through the bridge, every leaf
with seeded noise first, so every path of the math carries weight.

JAX serves zamba2 token by token through `decode_step` from `init_cache`;
the port prefills the whole prompt at once (the chunked SSD, flash
attention) and writes the cache in place.  fp32 on both sides: the last
logits, every layer's SSM state and conv ring and the KV cache's first S
rows within 1e-4 of max(1, max |ref|), and so one decode step after the
prefill.  `_conv` and `mamba_decode` alone likewise.

bf16: the port's chunked prefill against its own token-by-token decode,
and greedy tokens against JAX's where JAX's top-2 margin exceeds 0.15, the
chunk-vs-step tolerance of tests/test_models_smoke.py, at the params that
test holds it at: JAX's init, without the noise.  With the noise, bf16
rounding alone moves the last logits of JAX's own chunked forward from its
own token-by-token decode by 0.55 at 40 tokens (the port's: 0.19-0.27),
so 0.15 there could not tell a fault from rounding; the fp32 checks above
hold the noisy params."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import mamba2 as jmamba2  # noqa: E402
from repro.models import zamba as jzamba  # noqa: E402
from repro.models.common import Options as JaxOptions  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from test_torch_serve import check_front_door  # noqa: E402
from repro_torch.models import mamba2, zamba  # noqa: E402
from repro_torch.models.common import Options  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.runtime.serve_step import (greedy_generate,  # noqa: E402
                                            serving_params)

TOL = 1e-4
MARGIN = 0.15
B, S_MAX = 2, 40      # 40: two chunks of 16 and a padded tail of 8
JOPTS = JaxOptions(q_block=16, kv_block=16)


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_get_config("zamba2-2.7b").reduced()
    cfg = get_config("zamba2-2.7b").reduced()
    assert (cfg.n_layers, cfg.d_model, cfg.ssm.head_dim, cfg.ssm.state_dim,
            cfg.ssm.conv_dim, cfg.ssm.chunk, zamba.n_groups(cfg)) == \
        (12, 128, 16, 16, 4, 16, 2)
    rng = np.random.default_rng(0)
    tree = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.1 * rng.standard_normal(a.shape))
        .astype(np.float32), jzamba.init_lm(jax.random.PRNGKey(0), jcfg))
    tokens = rng.integers(0, cfg.vocab_size, size=(B, S_MAX)).astype(np.int32)
    return (jcfg, cfg, jax.tree_util.tree_map(jnp.asarray, tree),
            bridge.from_jax(tree, "cpu"), tokens)


@pytest.fixture(scope="module")
def init_params():
    """JAX's init for the reduced config, unperturbed, as the port's
    params, and 48-token prompts (test_models_smoke.py's shape)."""
    jcfg = jax_get_config("zamba2-2.7b").reduced()
    tree = jax.tree_util.tree_map(
        np.asarray, jzamba.init_lm(jax.random.PRNGKey(0), jcfg))
    tokens = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, size=(B, 48)).astype(np.int32)
    return (jcfg, get_config("zamba2-2.7b").reduced(),
            jax.tree_util.tree_map(jnp.asarray, tree),
            bridge.from_jax(tree, "cpu"), tokens)


def _rel(a, b):
    """max |a - b| / max(1, max |b|)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b))) / max(1.0, float(np.abs(b).max()))


def _model(cfg):
    return build_model(cfg, Options(q_block=16, kv_block=16))


def _jax_token_decode(setup, S, max_len):
    """JAX's serving path in fp32: S decode_step calls from init_cache."""
    jcfg, _, jparams, _, tokens = setup
    dec = jax.jit(lambda p, t, pos, c: jzamba.decode_step(
        p, jcfg, t, pos, c, opts=JOPTS, dtype=jnp.float32))
    cache = jzamba.init_cache(jcfg, B, max_len, dtype=jnp.float32)
    for t in range(S):
        logits, cache = dec(jparams, jnp.asarray(tokens[:, t]),
                            jnp.full((B,), t, jnp.int32), cache)
    return logits, cache


def _prefill(setup, S, max_len):
    _, cfg, _, params, tokens = setup
    cache = zamba.init_cache(cfg, B, max_len, dtype=torch.float32,
                             device="cpu")
    with torch.inference_mode():
        return zamba.forward(params, cfg, torch.from_numpy(tokens[:, :S])
                             .long(), opts=Options(q_block=16, kv_block=16),
                             mode="prefill", dtype=torch.float32, cache=cache)


def _check_cache(cache, jcache, S=None):
    """Every layer's SSM state and conv ring (each layer against its own
    largest |ref|), and the K/V caches (their first S rows, or all)."""
    for key in ("ssm", "conv"):
        ours, theirs = cache["mamba"][key].numpy(), np.asarray(
            jcache["mamba"][key])
        assert ours.shape == theirs.shape, key
        for i in range(ours.shape[0]):
            assert _rel(ours[i], theirs[i]) < TOL, (key, i)
    for ours, theirs in zip(cache["kv"], jcache["kv"]):
        ours, theirs = ours.float().numpy(), np.asarray(theirs, np.float32)
        assert ours.shape == theirs.shape
        rows = slice(None) if S is None else slice(0, S)
        assert _rel(ours[:, :, rows], theirs[:, :, rows]) < TOL


@pytest.mark.parametrize("S", [1, 2, 40])
@pytest.mark.parametrize("ring", [False, True])
def test_conv_matches_jax(setup, S, ring):
    """The conv's output and its new ring: the last W-1 pre-conv rows, with
    the given ring (or zeros) in front where S < W-1."""
    _, cfg, jparams, params, _ = setup
    _, _, _, _, W, convch, _ = mamba2.dims(cfg)
    rng = np.random.default_rng(S)
    xbc = rng.standard_normal((B, S, convch)).astype(np.float32)
    st = (rng.standard_normal((B, W - 1, convch)).astype(np.float32)
          if ring else None)
    jout, jring = jmamba2._conv(
        jnp.asarray(xbc), jparams["mamba"]["conv_w"][3],
        jparams["mamba"]["conv_b"][3],
        conv_state=None if st is None else jnp.asarray(st))
    out, new = mamba2._conv(
        torch.from_numpy(xbc), params["mamba"]["conv_w"][3],
        params["mamba"]["conv_b"][3],
        conv_state=None if st is None else torch.from_numpy(st))
    assert tuple(new.shape) == jring.shape == (B, W - 1, convch)
    assert _rel(out.numpy(), jout) < TOL
    assert np.array_equal(new.numpy(), np.asarray(jring))


def test_mamba_decode_matches_jax(setup):
    """Five steps from a random state, each step's output and state."""
    jcfg, cfg, jparams, params, _ = setup
    d_inner, H, G, N, W, convch, _ = mamba2.dims(cfg)
    rng = np.random.default_rng(5)
    st = {"ssm": rng.standard_normal((B, H, cfg.ssm.head_dim, N))
          .astype(np.float32),
          "conv": rng.standard_normal((B, W - 1, convch)).astype(np.float32)}
    jst = {k: jnp.asarray(v) for k, v in st.items()}
    tst = {k: torch.from_numpy(v) for k, v in st.items()}
    jp = jax.tree_util.tree_map(lambda a: a[7], jparams["mamba"])
    tp = {k: v[7] for k, v in params["mamba"].items()}
    for _ in range(5):
        x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        jout, jst = jmamba2.mamba_decode(jp, jnp.asarray(x), jcfg, jst)
        out, tst = mamba2.mamba_decode(tp, torch.from_numpy(x), cfg, tst)
        assert _rel(out.numpy(), jout) < TOL
        for k in ("ssm", "conv"):
            assert tuple(tst[k].shape) == jst[k].shape
            assert _rel(tst[k].numpy(), jst[k]) < TOL, k


def test_init_cache_matches_jax(setup):
    """The tree, shapes and dtypes of JAX's init_cache (K/V in the given
    dtype, the Mamba2 states fp32), all zeros, on the given device."""
    jcfg, cfg, _, _, _ = setup
    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16),
                     (jnp.float32, torch.float32)):
        jc = jzamba.init_cache(jcfg, 3, 21, dtype=jdt)
        c = build_model(cfg).init_cache(3, 21, dtype=tdt, device="cpu")
        flat_j, tdef_j = jax.tree_util.tree_flatten(jc)
        flat_c, tdef_c = jax.tree_util.tree_flatten(c)
        assert tdef_j == tdef_c
        for a, b in zip(flat_c, flat_j):
            assert tuple(a.shape) == b.shape
            assert str(a.dtype)[6:] == str(b.dtype)
            assert a.device.type == "cpu" and not a.any()
    assert c["kv"][0].shape[3] == cfg.n_kv_heads        # no padded heads


@pytest.mark.parametrize("S", [40, 2])
def test_prefill_matches_jax_token_decode(setup, S):
    """The port's chunked prefill against JAX's serving path, S decode
    steps from init_cache: last logits, every layer's SSM state and conv
    ring, the KV cache's first S rows; the rows after S stay zero."""
    jlogits, jcache = _jax_token_decode(setup, S, S_MAX + 4)
    logits, cache = _prefill(setup, S, S_MAX + 4)
    assert tuple(logits.shape) == jlogits.shape
    assert _rel(logits.numpy(), jlogits) < TOL
    _check_cache(cache, jcache, S)
    assert not cache["kv"][0][:, :, S:].any()


@pytest.mark.parametrize("S", [40, 2])
def test_prefill_matches_jax_prefill_forward(setup, S):
    """Logits and the shared block's (k, v) against JAX's own
    forward(mode="prefill"); without a cache the port makes one of S rows."""
    jcfg, cfg, jparams, params, tokens = setup
    jlogits, (jk, jv), _ = jzamba.forward(
        jparams, jcfg, jnp.asarray(tokens[:, :S]), opts=JOPTS,
        mode="prefill", dtype=jnp.float32)
    with torch.inference_mode():
        logits, cache = _model(cfg).forward(
            params, {"tokens": torch.from_numpy(tokens[:, :S]).long()},
            mode="prefill", dtype=torch.float32)
    assert _rel(logits.numpy(), jlogits) < TOL
    for ours, theirs in zip(cache["kv"], (jk, jv)):
        assert tuple(ours.shape) == theirs.shape
        assert ours.dtype == torch.float32
        assert _rel(ours.numpy(), theirs) < TOL


def test_decode_step_after_prefill_matches_jax(setup):
    """One fp32 decode step after a 40-token prefill, against JAX's
    decode_step from JAX's cache: logits and the whole new cache."""
    jcfg, cfg, jparams, params, tokens = setup
    S = S_MAX
    jlogits, jcache = _jax_token_decode(setup, S, S + 4)
    logits, cache = _prefill(setup, S, S + 4)
    tok = np.argmax(np.asarray(jlogits)[:, :cfg.vocab_size], -1) \
        .astype(np.int32)
    jl2, jc2 = jzamba.decode_step(jparams, jcfg, jnp.asarray(tok),
                                  jnp.full((B,), S, jnp.int32), jcache,
                                  opts=JOPTS, dtype=jnp.float32)
    with torch.inference_mode():
        l2, c2 = zamba.decode_step(params, cfg, torch.from_numpy(tok).long(),
                                   torch.full((B,), S, dtype=torch.long),
                                   cache, dtype=torch.float32)
    assert c2 is cache                                  # written in place
    assert _rel(l2.numpy(), jl2) < TOL
    _check_cache(c2, jc2)


def test_chunked_prefill_matches_token_decode_bf16(init_params):
    """bf16: the port's chunked prefill against its own token-by-token
    decode from init_cache: last logits within JAX's chunk-vs-step 0.15,
    and every layer's SSM state and conv ring and the K/V caches within
    0.15 of max(1, max |decode's|)."""
    _, cfg, _, params, tokens = init_params
    S = tokens.shape[1]
    model = _model(cfg)
    tt = torch.from_numpy(tokens).long()
    with torch.inference_mode():
        full, pc = model.forward(params, {"tokens": tt}, mode="prefill",
                                 cache=model.init_cache(B, S, device="cpu"))
        cache = model.init_cache(B, S, device="cpu")
        for t in range(S):
            lg, cache = model.decode_step(params, tt[:, t],
                                          torch.full((B,), t), cache)
    assert float((lg.float() - full.float()).abs().max()) < MARGIN
    for key in ("ssm", "conv"):
        for i in range(cfg.n_layers):
            assert _rel(pc["mamba"][key][i].numpy(),
                        cache["mamba"][key][i].numpy()) < MARGIN, (key, i)
    for a, b in zip(pc["kv"], cache["kv"]):
        assert _rel(a.float().numpy(), b.float().numpy()) < MARGIN


def _top2_margin(logits, vocab):
    top = np.sort(np.asarray(logits, np.float32)[:, :vocab], axis=-1)
    return top[:, -1] - top[:, -2]


def test_greedy_generate_bf16_tokens(init_params):
    """bf16 greedy tokens against JAX's greedy_generate for a hybrid model
    (prefill token by token through decode_step), with the margins kept:
    each row is walked while both sides have fed the same tokens; a step
    whose margin exceeds the tolerance must agree; a near-tie may flip, and
    after a flip the two sides decode different prefixes, so the row
    stops."""
    jcfg, cfg, jparams, params, tokens = init_params
    S, max_new = 37, 6
    jmodel = jax_build_model(jcfg, JOPTS)
    dec = jax.jit(jmodel.decode_step)
    cache = jmodel.init_cache(B, S + max_new)
    for t in range(S):
        lg, cache = dec(jparams, jnp.asarray(tokens[:, t]),
                        jnp.full((B,), t, jnp.int32), cache)
    jtoks, margins = [], []
    for t in range(S, S + max_new):
        tok = jnp.argmax(lg[:, :cfg.vocab_size], -1).astype(jnp.int32)
        jtoks.append(np.asarray(tok))
        margins.append(_top2_margin(lg, cfg.vocab_size))
        if t < S + max_new - 1:
            lg, cache = dec(jparams, tok, jnp.full((B,), t, jnp.int32), cache)
    jtoks, margins = np.stack(jtoks, 1), np.stack(margins, 1)

    model = _model(cfg)
    out = greedy_generate(model, serving_params(model, params),
                          {"tokens": torch.from_numpy(tokens[:, :S]).long()},
                          max_new, S + max_new + 1).numpy()
    assert out.shape == (B, max_new)
    compared = 0
    for b in range(B):
        for t in range(max_new):
            if margins[b, t] > MARGIN:
                assert out[b, t] == jtoks[b, t], (b, t, margins[b, t])
                compared += 1
            elif out[b, t] != jtoks[b, t]:
                break
    assert compared > 0, margins


def test_serving_params_are_exact(setup):
    """bf16 serving from the cast params computes what bf16 serving from
    the fp32 params computes, to the bit: the prefill's logits and cache."""
    _, cfg, _, params, tokens = setup
    model = _model(cfg)
    tt = torch.from_numpy(tokens[:, :S_MAX]).long()
    with torch.inference_mode():
        a, ca = model.forward(params, {"tokens": tt}, mode="prefill")
        b, cb = model.forward(serving_params(model, params), {"tokens": tt},
                              mode="prefill")
    assert torch.equal(a, b)
    fa, _ = jax.tree_util.tree_flatten(ca)
    fb, _ = jax.tree_util.tree_flatten(cb)
    assert all(torch.equal(x, y) for x, y in zip(fa, fb))


def test_train_forward_rejects_decode_mode(setup):
    _, cfg, _, params, tokens = setup
    with pytest.raises(ValueError, match="mode"):
        zamba.forward(params, cfg, torch.from_numpy(tokens).long(),
                      mode="decode")


def test_serve_answers_every_request(capsys):
    argv = ["--arch", "zamba2-2.7b", "--device", "cpu", "--requests", "3",
            "--prompt-len", "20", "--max-new", "4", "--seed", "3"]
    res = serve.main(argv)
    assert "[serve] all 3 requests served" in capsys.readouterr().out
    cfg = res["model"].cfg
    assert cfg.family == "hybrid"
    check_front_door(res, argv)
    for row in res["replies"]:
        assert row.shape == (4,)
        assert row.min() >= 0 and row.max() < cfg.vocab_size
    again = serve.main(argv)
    assert all(np.array_equal(x, y)
               for x, y in zip(res["replies"], again["replies"]))
