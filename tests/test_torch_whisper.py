"""Port parity for the audio family: whisper-base reduced (2 encoder and 2
decoder layers, d_model 128, 4 heads padded to 16 on 4 KV heads, 32
frames), with the JAX package's params loaded through the bridge and
seeded numpy tokens and frames.

fp32 on both sides: `sinusoid` within 1e-6; `encode`, train-mode
`forward`, prefill logits, the cache after prefill (the decoder's K/V and
the memory, against JAX's small cache spliced into its large one) and
two `decode_step`s within 1e-4; the loss and every gradient of a train
step within 1e-4 of max(1, max |JAX|).  bf16 greedy tokens are compared
where JAX's top-2 logit margin exceeds 0.15, the tolerance of
tests/test_models_smoke.py.  Then `launch.serve` and `launch.train` with
`--arch whisper-base --device cpu`."""
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import whisper as jwh  # noqa: E402
from repro.models.common import Options as JOptions  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.runtime.train_step import make_loss_fn as jax_loss_fn  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import whisper as wh  # noqa: E402
from repro_torch.models.common import Options  # noqa: E402
from repro_torch.models.model import Model, build_model  # noqa: E402
from repro_torch.runtime.serve_step import (_leaves,  # noqa: E402
                                            greedy_generate, serving_params)
from repro_torch.runtime.train_step import (make_loss_fn,  # noqa: E402
                                            value_and_grad)

TOL, SIN_TOL, MARGIN = 1e-4, 1e-6, 0.15
B, S = 2, 12
OPTS_J, OPTS_T = JOptions(q_block=8, kv_block=8), Options(q_block=8,
                                                         kv_block=8)


def _maxerr(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_get_config("whisper-base").reduced()
    cfg = get_config("whisper-base").reduced()
    assert cfg.family == "audio" and cfg.encoder.n_frames == 32
    jparams = jax.jit(lambda k: jwh.init_lm(k, jcfg))(jax.random.PRNGKey(0))
    params = bridge.from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             "cpu")
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    frames = rng.standard_normal(
        (B, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32)
    return jcfg, cfg, jparams, params, tokens, frames


def test_sinusoid_matches_jax():
    pos = np.arange(40, dtype=np.int32)
    for p in (pos, np.stack([pos, pos + 7])):
        ours = wh.sinusoid(torch.from_numpy(p), 128)
        assert ours.dtype == torch.float32
        assert _maxerr(ours.numpy(), jwh.sinusoid(jnp.asarray(p), 128)) \
            < SIN_TOL


def test_init_layout_is_jax_tree(setup):
    jcfg, cfg, jparams, params, _, _ = setup
    ours = wh.init_lm(torch.Generator().manual_seed(0), cfg, "cpu")
    assert jax.tree_util.tree_structure(
        jax.tree_util.tree_map(np.asarray, jparams)) == \
        jax.tree_util.tree_structure(bridge.to_numpy(ours))
    ours, theirs = dict(_leaves(ours)), dict(_leaves(params))
    assert set(ours) == set(theirs)
    assert all(ours[p].shape == theirs[p].shape for p in ours)
    assert build_model(cfg).cfg is cfg


def test_encode_matches_jax(setup):
    jcfg, cfg, jparams, params, _, frames = setup
    jmem = jwh.encode(jparams, jcfg, jnp.asarray(frames), opts=OPTS_J)
    mem = wh.encode(params, cfg, torch.from_numpy(frames), opts=OPTS_T)
    assert mem.shape == (B, cfg.encoder.n_frames, cfg.d_model)
    assert _maxerr(mem.numpy(), jmem) < TOL


def test_forward_train_logits_fp32(setup):
    jcfg, cfg, jparams, params, tokens, frames = setup
    jlog, _ = jax.jit(lambda p, t, f: jwh.forward(
        p, jcfg, t, encoder_frames=f, opts=OPTS_J, dtype=jnp.float32))(
        jparams, tokens, frames)
    log = wh.forward(params, cfg, torch.from_numpy(tokens).long(),
                     encoder_frames=torch.from_numpy(frames), opts=OPTS_T,
                     dtype=torch.float32)
    assert log.shape == (B, S, cfg.padded_vocab)
    assert _maxerr(log.numpy(), jlog) < TOL


def test_prefill_cache_and_decode_fp32(setup):
    """Prefill into the preallocated cache against JAX's prefill spliced
    into its own, then two decode steps on both caches."""
    jcfg, cfg, jparams, params, tokens, frames = setup
    jlg, jsmall, _ = jax.jit(lambda p, t, f: jwh.forward(
        p, jcfg, t, encoder_frames=f, opts=OPTS_J, mode="prefill",
        dtype=jnp.float32))(jparams, tokens, frames)
    jbig = jwh.init_cache(jcfg, B, S + 4, dtype=jnp.float32)
    jbig = {"kv": tuple(c.at[:, :, :S].set(s) for c, s in
                        zip(jbig["kv"], jsmall["kv"])),
            "memory": jsmall["memory"]}
    big = wh.init_cache(cfg, B, S + 4, dtype=torch.float32, device="cpu")
    tt, ft = torch.from_numpy(tokens).long(), torch.from_numpy(frames)
    lg, got = wh.forward(params, cfg, tt, encoder_frames=ft, opts=OPTS_T,
                         mode="prefill", dtype=torch.float32, cache=big)
    assert got is big
    assert _maxerr(lg.numpy(), jlg) < TOL
    for ours, theirs in zip(jax.tree_util.tree_leaves(bridge.to_numpy(big)),
                            jax.tree_util.tree_leaves(jbig)):
        assert ours.shape == theirs.shape
        assert _maxerr(ours, theirs) < TOL
    # without a cache: JAX's small cache
    _, small = wh.forward(params, cfg, tt, encoder_frames=ft, opts=OPTS_T,
                          mode="prefill", dtype=torch.float32)
    for ours, theirs in zip(
            jax.tree_util.tree_leaves(bridge.to_numpy(small)),
            jax.tree_util.tree_leaves(jsmall)):
        assert ours.shape == theirs.shape
        assert _maxerr(ours, theirs) < TOL

    jdec = jax.jit(lambda p, t, pos, c: jwh.decode_step(
        p, jcfg, t, pos, c, opts=OPTS_J, dtype=jnp.float32))
    tok = np.argmax(np.asarray(jlg)[:, :cfg.vocab_size], -1).astype(np.int32)
    for t in (S, S + 1):
        jlg2, jbig = jdec(jparams, tok, jnp.full((B,), t, jnp.int32), jbig)
        lg2, big = wh.decode_step(params, cfg, torch.from_numpy(tok).long(),
                                  torch.full((B,), t, dtype=torch.long), big,
                                  opts=OPTS_T, dtype=torch.float32)
        assert _maxerr(lg2.numpy(), jlg2) < TOL
        tok = np.argmax(np.asarray(jlg2)[:, :cfg.vocab_size],
                        -1).astype(np.int32)
    # the tokens' K/V were written in place at positions S and S + 1
    assert _maxerr(big["kv"][0].numpy(), jbig["kv"][0]) < TOL
    assert float(big["kv"][0][:, :, S + 1].abs().sum()) > 0
    assert float(big["kv"][0][:, :, S + 2:].abs().sum()) == 0


def _top2_margin(logits, vocab):
    top = np.sort(np.asarray(logits, np.float32)[:, :vocab], axis=-1)
    return top[:, -1] - top[:, -2]


def test_greedy_generate_bf16_tokens(setup):
    jcfg, cfg, jparams, params, tokens, frames = setup
    max_new = 6
    jmodel = jax_build_model(jcfg, OPTS_J)
    jb = {"tokens": jnp.asarray(tokens),
          "encoder_frames": jnp.asarray(frames, jnp.bfloat16)}
    jlg, small, _ = jax.jit(lambda p, b: jmodel.forward(
        p, b, mode="prefill"))(jparams, jb)
    cache = jmodel.init_cache(B, S + max_new + 1)
    cache = {"kv": tuple(c.at[:, :, :S].set(s.astype(c.dtype)) for c, s
                         in zip(cache["kv"], small["kv"])),
             "memory": small["memory"].astype(cache["memory"].dtype)}
    dec = jax.jit(jmodel.decode_step)
    jtoks, margins, lg = [], [], jlg
    for t in range(S, S + max_new):
        tok = jnp.argmax(lg[:, :cfg.vocab_size], -1).astype(jnp.int32)
        jtoks.append(np.asarray(tok))
        margins.append(_top2_margin(lg, cfg.vocab_size))
        if t < S + max_new - 1:
            lg, cache = dec(jparams, tok, jnp.full((B,), t, jnp.int32), cache)
    jtoks, margins = np.stack(jtoks, 1), np.stack(margins, 1)

    model = build_model(cfg, OPTS_T)
    batch = {"tokens": torch.from_numpy(tokens).long(),
             "encoder_frames": torch.from_numpy(frames).bfloat16()}
    out = greedy_generate(model, serving_params(model, params), batch,
                          max_new, S + max_new + 1).numpy()
    assert out.shape == (B, max_new)
    # Walk each row while both sides have fed the same tokens: a step whose
    # margin exceeds the tolerance must agree; a near-tie may flip, and
    # after a flip the two sides decode different prefixes, so the row
    # stops.
    compared = 0
    for b in range(B):
        for t in range(max_new):
            if margins[b, t] > MARGIN:
                assert out[b, t] == jtoks[b, t], (b, t, margins[b, t])
                compared += 1
            elif out[b, t] != jtoks[b, t]:
                break
    assert compared > 0, margins


def test_train_loss_and_gradients_fp32(setup):
    """The loss functions of both packages (make_loss_fn) on a model whose
    forward runs in fp32: loss, its parts and every gradient leaf."""
    jcfg, cfg, jparams, params, tokens, frames = setup
    jmodel = jax_build_model(jcfg, OPTS_J)
    jmodel._mod = types.SimpleNamespace(forward=lambda *a, **kw: jwh.forward(
        *a, **kw, dtype=jnp.float32))
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, 1),
             "encoder_frames": frames}
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        jax_loss_fn(jmodel), has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    model = Model(cfg, OPTS_T, types.SimpleNamespace(
        forward=lambda *a, **kw: wh.forward(*a, **{**kw,
                                                   "dtype": torch.float32})))
    (loss, aux), grads = value_and_grad(
        make_loss_fn(model), params,
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(loss) - float(jloss)) <= TOL * abs(float(jloss))
    assert float(aux["moe_aux"]) == 0.0 == float(jaux["moe_aux"])
    assert float(aux["xent"]) == pytest.approx(float(jaux["xent"]), rel=TOL)
    ours, theirs = dict(_leaves(bridge.to_numpy(grads))), dict(
        _leaves(jax.tree_util.tree_map(np.asarray, jgrads)))
    assert set(ours) == set(theirs)
    for p in ours:
        assert _maxerr(ours[p], theirs[p]) <= TOL * max(
            1.0, float(np.abs(theirs[p]).max())), p


def test_serve_on_the_cpu(capsys):
    out = serve.main(["--arch", "whisper-base", "--device", "cpu",
                      "--requests", "2", "--prompt-len", "8", "--max-new",
                      "3"])
    assert "[serve] all 2 requests served" in capsys.readouterr().out
    assert out["model"].cfg.name == "whisper-base"
    assert len(out["replies"]) == 2
    assert all(r.shape == (3,) for r in out["replies"])
    # the served params: matrices in bf16, the norms in fp32
    got = dict(_leaves(out["params"]))
    assert got[("dec", "cross_attn", "wq")].dtype == torch.bfloat16
    assert got[("embed",)].dtype == torch.bfloat16
    assert got[("enc", "ln1", "s")].dtype == torch.float32


def test_train_on_the_cpu(capsys):
    out = train.main(["--arch", "whisper-base", "--reduced", "--steps", "3",
                      "--global-batch", "2", "--seq", "16", "--device",
                      "cpu"])
    text = capsys.readouterr().out
    assert text.count("[train] step") == 3
    assert np.isfinite(out["losses"]).all()
    assert out["model"].cfg.family == "audio"
    assert all(r["moe_aux"] == 0.0 for r in out["records"])
