"""Port parity for the rwkv6 slice: rwkv6-1.6b reduced (2 layers, d_model
128, 4 WKV heads of 32, chunk 16) with the JAX package's params loaded
through the bridge.  The init's constant leaves (maa, u, w0, the norms) get
seeded noise first, so every path of the math carries weight.

fp32 on both sides: forward logits, prefill logits and every state leaf,
and one decode step within 1e-4.  bf16 greedy tokens are compared where
JAX's top-2 logit margin exceeds 0.15, the chunk-vs-step tolerance of
tests/test_models_smoke.py; JAX prefills token by token through
decode_step, the port with its chunked forward."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import rwkv as jrwkv  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from test_torch_serve import check_front_door  # noqa: E402
from repro_torch.models import rwkv  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.runtime.serve_step import (greedy_generate,  # noqa: E402
                                            serving_params)

TOL = 1e-4
MARGIN = 0.15
B = 2


def _perturb(tree, rng):
    """Noise on every leaf; w0 drawn so decays span strong to slow."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, rng)
        elif k == "w0":
            out[k] = rng.uniform(-4.0, 0.0, v.shape).astype(np.float32)
        else:
            out[k] = (v + 0.1 * rng.standard_normal(v.shape)).astype(
                np.float32)
    return out


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_get_config("rwkv6-1.6b").reduced()
    cfg = get_config("rwkv6-1.6b").reduced()
    assert (cfg.n_layers, cfg.d_model, cfg.rwkv.head_dim,
            cfg.rwkv.chunk) == (2, 128, 32, 16)
    tree = jax.tree_util.tree_map(
        np.asarray, jrwkv.init_lm(jax.random.PRNGKey(0), jcfg))
    tree = _perturb(tree, np.random.default_rng(0))
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    params = bridge.from_jax(tree, "cpu")
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(B, 48)).astype(np.int32)
    return jcfg, cfg, jparams, params, tokens


def _maxerr(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


def test_bridge_carries_the_tree(setup):
    jcfg, cfg, jparams, params, _ = setup
    back = bridge.to_numpy(params)
    flat_a, tdef_a = jax.tree_util.tree_flatten(
        jax.tree_util.tree_map(np.asarray, jparams))
    flat_b, tdef_b = jax.tree_util.tree_flatten(back)
    assert tdef_a == tdef_b
    assert all(x.dtype == y.dtype and np.array_equal(x, y)
               for x, y in zip(flat_a, flat_b))
    # the port's own init makes the same tree
    ours = rwkv.init_lm(torch.Generator().manual_seed(0), cfg, "cpu")
    flat_o, tdef_o = jax.tree_util.tree_flatten(bridge.to_numpy(ours))
    assert tdef_o == tdef_a
    assert [x.shape for x in flat_o] == [x.shape for x in flat_a]


def test_forward_logits_fp32(setup):
    jcfg, cfg, jparams, params, tokens = setup
    jlog, _ = jrwkv.forward(jparams, jcfg, jnp.asarray(tokens),
                            dtype=jnp.float32)
    log = rwkv.forward(params, cfg, torch.from_numpy(tokens).long(),
                       dtype=torch.float32)
    assert log.shape == (B, 48, cfg.padded_vocab)
    assert _maxerr(log.numpy(), jlog) < TOL


def _prefill(setup, S):
    jcfg, cfg, jparams, params, tokens = setup
    jlg, jst, _ = jrwkv.forward(jparams, jcfg, jnp.asarray(tokens[:, :S]),
                                mode="prefill", dtype=jnp.float32)
    lg, st = rwkv.forward(params, cfg, torch.from_numpy(tokens[:, :S]).long(),
                          mode="prefill", dtype=torch.float32)
    return (jlg, jst), (lg, st)


@pytest.mark.parametrize("S", [48, 45])   # 45: the padded-chunk path
def test_prefill_logits_and_state_fp32(setup, S):
    (jlg, jst), (lg, st) = _prefill(setup, S)
    assert _maxerr(lg.numpy(), jlg) < TOL
    assert st.keys() == jst.keys() == {"tm_x", "S", "cm_x"}
    for key in st:
        assert tuple(st[key].shape) == jst[key].shape, key
        assert _maxerr(st[key].numpy(), jst[key]) < TOL, key


def test_decode_step_fp32(setup):
    jcfg, cfg, jparams, params, tokens = setup
    (jlg, jst), (lg, st) = _prefill(setup, 45)
    tok = np.argmax(np.asarray(jlg)[:, :cfg.vocab_size], -1).astype(np.int32)
    jlg2, jst2 = jrwkv.decode_step(jparams, jcfg, jnp.asarray(tok),
                                   jnp.full((B,), 45, jnp.int32), jst,
                                   dtype=jnp.float32)
    lg2, st2 = rwkv.decode_step(params, cfg, torch.from_numpy(tok).long(),
                                torch.full((B,), 45, dtype=torch.long), st,
                                dtype=torch.float32)
    assert _maxerr(lg2.numpy(), jlg2) < TOL
    for key in st2:
        assert _maxerr(st2[key].numpy(), jst2[key]) < TOL, key


def test_chunked_prefill_matches_token_decode(setup):
    """bf16: the port's chunked forward against its own token-by-token
    decode from init_state, within JAX's 0.15 (test_models_smoke.py)."""
    _, cfg, _, params, tokens = setup
    model = build_model(cfg)
    tt = torch.from_numpy(tokens).long()
    with torch.inference_mode():
        full = model.forward(params, {"tokens": tt})
        state = model.init_cache(B, 48, device="cpu")
        outs = []
        for t in range(48):
            lg, state = model.decode_step(params, tt[:, t],
                                          torch.full((B,), t), state)
            outs.append(lg)
    assert float((torch.stack(outs, 1).float() - full.float()).abs().max()) \
        < MARGIN


def _top2_margin(logits, vocab):
    top = np.sort(np.asarray(logits, np.float32)[:, :vocab], axis=-1)
    return top[:, -1] - top[:, -2]


def test_greedy_generate_bf16_tokens(setup):
    jcfg, cfg, jparams, params, tokens = setup
    S, max_new = 45, 6
    jmodel = jax_build_model(jcfg)
    dec = jax.jit(jmodel.decode_step)
    # JAX's greedy_generate for an ssm model, with the margins kept
    state = jmodel.init_cache(B, S + max_new)
    for t in range(S):
        lg, state = dec(jparams, jnp.asarray(tokens[:, t]),
                        jnp.full((B,), t, jnp.int32), state)
    jtoks, margins = [], []
    for t in range(S, S + max_new):
        tok = jnp.argmax(lg[:, :cfg.vocab_size], -1).astype(jnp.int32)
        jtoks.append(np.asarray(tok))
        margins.append(_top2_margin(lg, cfg.vocab_size))
        if t < S + max_new - 1:
            lg, state = dec(jparams, tok, jnp.full((B,), t, jnp.int32), state)
    jtoks, margins = np.stack(jtoks, 1), np.stack(margins, 1)

    model = build_model(cfg)
    out = greedy_generate(model, serving_params(model, params),
                          {"tokens": torch.from_numpy(tokens[:, :S]).long()},
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


RWKV_FP32 = {"ln0.s", "ln0.b", "ln1.s", "ln1.b", "ln2.s", "ln2.b",
             "ln_out.s", "ln_out.b", "tm.w0", "tm.w2", "tm.u", "tm.ln_x.s",
             "tm.ln_x.b"}
GEMMA_FP32 = {"blocks.ln1", "blocks.ln2", "blocks.pn1", "blocks.pn2",
              "final_norm"}   # the norm scales, as before the cast rule
# the norm scales and the Mamba2 layers' A_log, dt_bias and D_skip
ZAMBA_FP32 = {"mamba_ln", "mamba.A_log", "mamba.dt_bias", "mamba.D_skip",
              "mamba.norm", "shared.ln1", "shared.ln2", "final_norm"}


def _dtypes(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _dtypes(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v.dtype


@pytest.mark.parametrize("arch,fp32", [("rwkv6-1.6b", RWKV_FP32),
                                       ("gemma2-2b", GEMMA_FP32),
                                       ("zamba2-2.7b", ZAMBA_FP32)])
def test_serving_params_keep_fp32_reads(arch, fp32):
    """The leaves the model reads in fp32 stay fp32, every other leaf is
    bf16; gemma2's serving params are what they were before the rule."""
    model = build_model(get_config(arch).reduced())
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    got = dict(_dtypes(serving_params(model, params)))
    assert {k for k, d in got.items() if d == torch.float32} == fp32
    assert all(d == torch.bfloat16 for k, d in got.items() if k not in fp32)


def test_serving_params_are_exact(setup):
    """bf16 serving from the cast params computes what bf16 serving from
    the fp32 params computes, to the bit."""
    _, cfg, _, params, tokens = setup
    model = build_model(cfg)
    tt = torch.from_numpy(tokens[:, :45]).long()
    with torch.inference_mode():
        a, sa = model.forward(params, {"tokens": tt}, mode="prefill")
        b, sb = model.forward(serving_params(model, params), {"tokens": tt},
                              mode="prefill")
    assert torch.equal(a, b)
    assert all(torch.equal(sa[k], sb[k]) for k in sa)


def test_init_cache_is_the_recurrent_state(setup):
    jcfg, cfg, _, _, _ = setup
    st = build_model(cfg).init_cache(3, 99, device="cpu")
    jst = jrwkv.init_state(jcfg, 3)
    assert st.keys() == jst.keys()
    for k in st:
        assert tuple(st[k].shape) == jst[k].shape
        assert st[k].dtype == torch.float32 and not st[k].any()


def test_serve_answers_every_request(capsys):
    argv = ["--arch", "rwkv6-1.6b", "--device", "cpu", "--requests", "3",
            "--prompt-len", "20", "--max-new", "4", "--seed", "3"]
    res = serve.main(argv)
    assert "[serve] all 3 requests served" in capsys.readouterr().out
    cfg = res["model"].cfg
    assert cfg.family == "ssm"
    check_front_door(res, argv)
    for row in res["replies"]:
        assert row.shape == (4,)
        assert row.min() >= 0 and row.max() < cfg.vocab_size
    again = serve.main(argv)
    assert all(np.array_equal(x, y)
               for x, y in zip(res["replies"], again["replies"]))
