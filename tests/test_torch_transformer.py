"""Port parity for the whole slice: gemma2-2b reduced (2 layers, one local
and one global, sliding_window 16, S = 48 so the window bites) with the JAX
package's params loaded through the bridge.

fp32 on both sides: forward logits, the prefill cache and decode_step
logits within 1e-4.  bf16 greedy tokens are compared where JAX's top-2
logit margin exceeds 0.15, the tolerance of tests/test_models_smoke.py."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.common import Options as JOptions  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.common import Options  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.runtime.serve_step import (greedy_generate,  # noqa: E402
                                            serving_params)

TOL = 1e-4
MARGIN = 0.15
B, S = 2, 48
OPTS_J, OPTS_T = JOptions(q_block=16, kv_block=16), Options(q_block=16,
                                                           kv_block=16)


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_get_config("gemma2-2b").reduced()
    cfg = get_config("gemma2-2b").reduced()
    assert cfg.n_layers == 2 and cfg.sliding_window == 16
    jparams = jtf.init_lm(jax.random.PRNGKey(0), jcfg)
    params = bridge.from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             "cpu")
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    return jcfg, cfg, jparams, params, tokens


def _maxerr(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


def test_forward_logits_fp32(setup):
    jcfg, cfg, jparams, params, tokens = setup
    jlog, _ = jtf.forward(jparams, jcfg, jnp.asarray(tokens), opts=OPTS_J,
                          dtype=jnp.float32)
    log = tf.forward(params, cfg, torch.from_numpy(tokens).long(),
                     opts=OPTS_T, dtype=torch.float32)
    assert log.shape == (B, S, cfg.padded_vocab)
    assert _maxerr(log.numpy(), jlog) < TOL


def test_prefill_cache_and_decode_fp32(setup):
    jcfg, cfg, jparams, params, tokens = setup
    jlg, jcache, _ = jtf.forward(jparams, jcfg, jnp.asarray(tokens),
                                 opts=OPTS_J, mode="prefill",
                                 dtype=jnp.float32)
    tt = torch.from_numpy(tokens).long()
    lg, cache = tf.forward(params, cfg, tt, opts=OPTS_T, mode="prefill",
                           dtype=torch.float32)
    assert _maxerr(lg.numpy(), jlg) < TOL
    for ours, theirs in zip(cache["layers"], jcache["layers"]):
        assert ours.shape == theirs.shape
        assert _maxerr(ours.numpy(), theirs) < TOL

    # decode one token against the cache, both sides fp32
    tok1 = np.argmax(np.asarray(jlg)[:, :cfg.vocab_size], -1).astype(np.int32)
    jbig = jtf.init_cache(jcfg, B, S + 8, dtype=jnp.float32)
    jbig = {"layers": tuple(c.at[:, :, :S].set(s) for c, s in
                            zip(jbig["layers"], jcache["layers"])),
            "first": ()}
    jlg2, _ = jtf.decode_step(jparams, jcfg, jnp.asarray(tok1),
                              jnp.full((B,), S, jnp.int32), jbig,
                              opts=OPTS_J, dtype=jnp.float32)
    big = tf.init_cache(cfg, B, S + 8, dtype=torch.float32, device="cpu")
    _, big = tf.forward(params, cfg, tt, opts=OPTS_T, mode="prefill",
                        dtype=torch.float32, cache=big)
    lg2, big = tf.decode_step(params, cfg, torch.from_numpy(tok1).long(),
                              torch.full((B,), S, dtype=torch.long), big,
                              opts=OPTS_T, dtype=torch.float32)
    assert _maxerr(lg2.numpy(), jlg2) < TOL
    # the new token's K/V were written in place at position S
    assert float(big["layers"][0][:, :, S].abs().sum()) > 0
    assert float(big["layers"][0][:, :, S + 1:].abs().sum()) == 0


def _top2_margin(logits, vocab):
    top = np.sort(np.asarray(logits, np.float32)[:, :vocab], axis=-1)
    return top[:, -1] - top[:, -2]


def test_greedy_generate_bf16_tokens(setup):
    jcfg, cfg, jparams, params, tokens = setup
    max_new = 6
    jmodel = jax_build_model(jcfg, OPTS_J)
    fwd = jax.jit(lambda p, b: jmodel.forward(p, b, mode="prefill"))
    dec = jax.jit(jmodel.decode_step)
    jlg, small, _ = fwd(jparams, {"tokens": jnp.asarray(tokens)})
    cache = jmodel.init_cache(B, S + max_new + 1)
    cache = {"layers": tuple(c.at[:, :, :S].set(s.astype(c.dtype)) for c, s
                             in zip(cache["layers"], small["layers"])),
             "first": ()}
    jtoks, margins = [], []
    lg = jlg
    for t in range(S, S + max_new):
        tok = jnp.argmax(lg[:, :cfg.vocab_size], -1).astype(jnp.int32)
        jtoks.append(np.asarray(tok))
        margins.append(_top2_margin(lg, cfg.vocab_size))
        if t < S + max_new - 1:
            lg, cache = dec(jparams, tok, jnp.full((B,), t, jnp.int32), cache)
    jtoks, margins = np.stack(jtoks, 1), np.stack(margins, 1)

    model = build_model(cfg, OPTS_T)
    out = greedy_generate(model, serving_params(model, params),
                          {"tokens": torch.from_numpy(tokens).long()},
                          max_new, S + max_new + 1).numpy()
    assert out.shape == (B, max_new)
    # Walk each row while both sides have fed the same tokens: a step whose
    # margin exceeds the tolerance must agree; a near-tie may flip, and after
    # a flip the two sides decode different prefixes, so the row stops.
    compared = 0
    for b in range(B):
        for t in range(max_new):
            if margins[b, t] > MARGIN:
                assert out[b, t] == jtoks[b, t], (b, t, margins[b, t])
                compared += 1
            elif out[b, t] != jtoks[b, t]:
                break
    assert compared > 0, margins
