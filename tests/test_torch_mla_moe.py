"""Port parity for MLA and MoE: deepseek-v2-lite-16b (MLA + MoE, a dense
first layer) and arctic-480b (MoE + dense residual), reduced, with the JAX
package's params loaded through the bridge.  fp32 on both sides.

- `apply_moe`: y and the aux loss within 1e-5, at token counts and
  `moe_group` values (8, 64, 1024) that give groups of 4 to 200 tokens, and
  with a router biased toward two experts so that choices are dropped: the
  port routes every (token, choice) pair to the same expert and drops the
  same pairs as JAX (read from the arguments of the reference's dispatch).
- `mla_forward` (output and cache) and `mla_decode` (both branches)
  within 1e-5.
- The whole models: train logits, prefill logits and the full cache
  (`layers` and `first`), and one decode step's logits within 1e-4.
- The served params made leaf by leaf equal `serving_params` of the whole
  fp32 tree bit for bit, for every served family (whisper-base's too).
- `launch.serve` answers on the CPU.
- Training: the loss (cross-entropy + the router's aux loss) and every
  gradient of both models in fp32 against `jax.value_and_grad` of the
  reference's `make_loss_fn`, within 1e-4 of max(1, max |JAX|); one
  `make_train_step` step against the reference's (loss, xent, moe_aux,
  grad norm within 1e-4 relative, the params within 2 lr); the
  microbatched step reports the reference's aux (0) and mean loss."""
import types
from unittest import mock

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import mla as jmla  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.configs import RunConfig as JRunConfig  # noqa: E402
from repro.models.common import Options as JOptions  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.runtime.train_step import make_loss_fn as jax_loss_fn  # noqa: E402
from repro.runtime.train_step import (  # noqa: E402
    make_train_step as jax_train_step)
from repro.models.rope import rope_angles as jrope_angles  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import RunConfig, get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import mla, moe  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.common import Options  # noqa: E402
from repro_torch.models.model import Model, build_model  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.models.rope import rope_angles  # noqa: E402
from repro_torch.runtime.serve_step import (_leaves,  # noqa: E402
                                            init_serving_params,
                                            serving_params)
from repro_torch.runtime.train_step import (make_loss_fn,  # noqa: E402
                                            make_train_step,
                                            value_and_grad)

MOE_TOL, MLA_TOL, TOL = 1e-5, 1e-5, 1e-4
ARCHS = ["deepseek-v2-lite-16b", "arctic-480b"]
B, S = 2, 20


def _maxerr(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)



@pytest.fixture(scope="module", params=ARCHS)
def moe_setup(request):
    name = request.param
    jcfg, cfg = jax_get_config(name).reduced(), get_config(name).reduced()
    jp = _np_tree(jax.jit(lambda k: jmoe.init_moe(k, jcfg, 0))(
        jax.random.PRNGKey(3)))
    return name, jcfg, cfg, jp


def _jax_moe(jcfg, group):
    """The reference's apply_moe under jit, returning (y, aux, (idx_km,
    slot, keep)): the module's `jax` is swapped for a stand-in whose vmap
    records the arguments of each vmapped call, the first being the
    dispatch's (xg, idx_km, slot, keep)."""
    def run(p, x):
        calls = []

        def vmap(fn):
            def call(*args):
                calls.append(args)
                return jax.vmap(fn)(*args)
            return call

        shim = types.SimpleNamespace(nn=jax.nn, lax=jax.lax, vmap=vmap)
        with mock.patch.object(jmoe, "jax", shim):
            y, aux = jmoe.apply_moe(p, x, jcfg, group_size=group)
        return y, aux, calls[0][1:]
    return jax.jit(run)


def _moe_both(jcfg, cfg, jp, x, group):
    jy, jaux, (idx, slot, keep) = jax.tree_util.tree_map(
        np.asarray, _jax_moe(jcfg, group)(jp, x))
    p = bridge.from_jax(jp, "cpu")
    y, aux = moe.apply_moe(p, torch.from_numpy(x), cfg, group_size=group)
    T, D = x.shape[0] * x.shape[1], x.shape[2]
    g = moe.token_group(T, group)
    r = moe.route(p["router"], torch.from_numpy(x).reshape(T // g, g, D), cfg)
    return (jy, jaux, y, aux), (idx, slot, keep), r


@pytest.mark.parametrize("shape,group,g", [
    ((2, 20), 1024, 40), ((2, 20), 8, 8), ((1, 36), 8, 4),
    ((2, 100), 64, 8),      # 64 halves to 8, as at the served 4200 tokens
])
def test_apply_moe_matches_jax(moe_setup, shape, group, g):
    name, jcfg, cfg, jp = moe_setup
    x = np.random.default_rng(0).standard_normal(
        shape + (cfg.d_model,)).astype(np.float32)
    assert moe.token_group(shape[0] * shape[1], group) == g
    (jy, jaux, y, aux), (idx, slot, keep), r = _moe_both(jcfg, cfg, jp, x,
                                                         group)
    assert _maxerr(y.numpy(), jy) < MOE_TOL
    assert abs(float(aux) - float(jaux)) < MOE_TOL
    assert np.array_equal(r.idx.numpy(), idx)
    assert np.array_equal(r.slot.numpy(), slot)
    assert np.array_equal(r.keep.numpy(), keep)


@pytest.mark.parametrize("shape,group", [((2, 20), 64), ((2, 100), 1024),
                                         ((2, 48), 16)])
def test_apply_moe_drops_the_same_choices_as_jax(moe_setup, shape, group):
    """A router biased toward experts 0 and 1 (inputs with a positive mean,
    those columns shifted up) overflows their slots in groups of 40, 200
    and 16 tokens (8 slots an expert hold every choice of a group of 8, so
    smaller groups drop nothing): choices are dropped, and the port drops
    exactly the (token, choice) pairs JAX drops."""
    name, jcfg, cfg, jp = moe_setup
    jp = dict(jp)
    router = jp["router"].copy()
    router[:, :2] += 0.05
    jp["router"] = router
    x = (np.random.default_rng(1).standard_normal(shape + (cfg.d_model,))
         + 1.0).astype(np.float32)
    (jy, jaux, y, aux), (idx, slot, keep), r = _moe_both(jcfg, cfg, jp, x,
                                                         group)
    assert (~keep).sum() > 0, "the biased router dropped nothing"
    assert np.array_equal(r.idx.numpy(), idx)
    assert np.array_equal(r.keep.numpy(), keep)
    assert _maxerr(y.numpy(), jy) < MOE_TOL
    assert abs(float(aux) - float(jaux)) < MOE_TOL


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mla_setup():
    name = "deepseek-v2-lite-16b"
    jcfg, cfg = jax_get_config(name).reduced(), get_config(name).reduced()
    jp = _np_tree(jax.jit(lambda k: jmla.init_mla(k, jcfg, 0))(
        jax.random.PRNGKey(4)))
    x = np.random.default_rng(2).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    return jcfg, cfg, jp, bridge.from_jax(jp, "cpu"), x


def _angles(cfg, positions):
    dr, th = cfg.mla.qk_rope_head_dim, cfg.rope_theta
    return (jrope_angles(jnp.asarray(positions), dr, th),
            rope_angles(torch.from_numpy(positions), dr, th))


def test_mla_forward_and_cache_match_jax(mla_setup):
    jcfg, cfg, jp, p, x = mla_setup
    (jsin, jcos), (sin, cos) = _angles(cfg, np.arange(S))
    jout, (jckv, jkr) = jax.jit(
        lambda p, x, sin, cos: jmla.mla_forward(
            p, x, jcfg, sin, cos, q_block=8, kv_block=8,
            return_cache=True))(jp, x, jsin, jcos)
    out, (ckv, kr) = mla.mla_forward(p, torch.from_numpy(x), cfg, sin, cos,
                                     q_block=8, kv_block=8)
    assert out.shape == (B, S, cfg.d_model)
    assert ckv.shape == (B, S, cfg.mla.kv_lora_rank)
    assert kr.shape == (B, S, cfg.mla.qk_rope_head_dim)
    for ours, theirs in ((out, jout), (ckv, jckv), (kr, jkr)):
        assert _maxerr(ours.numpy(), theirs) < MLA_TOL


@pytest.mark.parametrize("absorb", [False, True])
def test_mla_decode_matches_jax(mla_setup, absorb):
    """One decode step against a cache filled to different lengths per row
    (7 and 12 tokens of a 16-slot cache): the output and the cache the step
    wrote."""
    jcfg, cfg, jp, p, x = mla_setup
    T = 16
    positions = np.array([7, 12])
    rng = np.random.default_rng(3)
    ckv = rng.standard_normal((B, T, cfg.mla.kv_lora_rank)).astype(np.float32)
    kr = rng.standard_normal((B, T, cfg.mla.qk_rope_head_dim)).astype(
        np.float32)
    xt = x[:, :1]
    (jsin, jcos), (sin, cos) = _angles(cfg, positions[:, None])
    jout, (jckv, jkr) = jax.jit(
        lambda p, x, sin, cos, cache, pos: jmla.mla_decode(
            p, x, jcfg, sin, cos, cache, pos, absorb=absorb))(
        jp, xt, jsin, jcos, (ckv, kr), positions)
    cache = (torch.from_numpy(ckv.copy()), torch.from_numpy(kr.copy()))
    out, (ckv_t, kr_t) = mla.mla_decode(
        p, torch.from_numpy(xt), cfg, sin, cos, cache,
        torch.from_numpy(positions), absorb=absorb)
    assert ckv_t is cache[0] and kr_t is cache[1]       # written in place
    assert _maxerr(out.numpy(), jout) < MLA_TOL
    assert _maxerr(ckv_t.numpy(), jckv) < MLA_TOL
    assert _maxerr(kr_t.numpy(), jkr) < MLA_TOL


def test_mla_decode_branches_agree(mla_setup):
    """The absorbed branch computes the naive branch's function."""
    jcfg, cfg, jp, p, x = mla_setup
    positions = torch.tensor([5, 9])
    sin, cos = rope_angles(positions[:, None], cfg.mla.qk_rope_head_dim,
                           cfg.rope_theta)
    rng = np.random.default_rng(4)
    outs = []
    for absorb in (False, True):
        cache = mla.init_mla_cache(cfg, B, 12, torch.float32, device="cpu")
        cache[0][:] = torch.from_numpy(rng.standard_normal(
            cache[0].shape).astype(np.float32)) if not outs else first[0]
        cache[1][:] = torch.from_numpy(rng.standard_normal(
            cache[1].shape).astype(np.float32)) if not outs else first[1]
        first = tuple(c.clone() for c in cache)
        outs.append(mla.mla_decode(p, torch.from_numpy(x[:, :1]), cfg, sin,
                                   cos, cache, positions, absorb=absorb)[0])
    assert _maxerr(outs[0].numpy(), outs[1].numpy()) < MLA_TOL


# ---------------------------------------------------------------------------
# The whole models
# ---------------------------------------------------------------------------

MB, MS = 2, 24
OPTS_J = JOptions(q_block=8, kv_block=8, moe_group=16)
OPTS_T = Options(q_block=8, kv_block=8, moe_group=16)


@pytest.fixture(scope="module", params=ARCHS)
def model_setup(request):
    name = request.param
    jcfg, cfg = jax_get_config(name).reduced(), get_config(name).reduced()
    jparams = jax.jit(lambda k: jtf.init_lm(k, jcfg))(jax.random.PRNGKey(1))
    params = bridge.from_jax(_np_tree(jparams), "cpu")
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(MB, MS)).astype(np.int32)
    return name, jcfg, cfg, jparams, params, tokens


def test_model_layout(model_setup):
    name, jcfg, cfg, jparams, params, tokens = model_setup
    n_first = 1 if name == "deepseek-v2-lite-16b" else 0
    assert len(params.get("first", ())) == n_first
    assert params["blocks"]["ln1"].shape[0] == cfg.n_layers - n_first
    assert "router" in params["blocks"]["mlp"]
    if n_first:
        assert "router" not in params["first"][0]["mlp"]
        assert params["first"][0]["mlp"]["w1"].shape == (
            cfg.d_model, cfg.moe.dense_d_ff)
        assert "wdkv" in params["blocks"]["attn"]
    assert build_model(cfg).cfg is cfg
    ours = tf.init_lm(torch.Generator().manual_seed(0), cfg, "cpu")
    assert jax.tree_util.tree_structure(
        _np_tree(jparams)) == jax.tree_util.tree_structure(
        bridge.to_numpy(ours))
    ours, theirs = dict(_leaves(ours)), dict(_leaves(params))
    assert set(ours) == set(theirs)
    assert all(ours[p].shape == theirs[p].shape for p in ours)


def test_model_forward_logits_fp32(model_setup):
    name, jcfg, cfg, jparams, params, tokens = model_setup
    jlog, _ = jax.jit(lambda p, t: jtf.forward(
        p, jcfg, t, opts=OPTS_J, dtype=jnp.float32))(jparams, tokens)
    log = tf.forward(params, cfg, torch.from_numpy(tokens).long(),
                     opts=OPTS_T, dtype=torch.float32)
    assert log.shape == (MB, MS, cfg.padded_vocab)
    assert _maxerr(log.numpy(), jlog) < TOL


def test_model_prefill_cache_and_decode_fp32(model_setup):
    name, jcfg, cfg, jparams, params, tokens = model_setup
    jlg, jcache, _ = jax.jit(lambda p, t: jtf.forward(
        p, jcfg, t, opts=OPTS_J, mode="prefill", dtype=jnp.float32))(
        jparams, tokens)
    tt = torch.from_numpy(tokens).long()
    lg, cache = tf.forward(params, cfg, tt, opts=OPTS_T, mode="prefill",
                           dtype=torch.float32)
    assert _maxerr(lg.numpy(), jlg) < TOL
    assert len(cache["first"]) == len(jcache["first"])
    for ours, theirs in zip(jax.tree_util.tree_leaves(bridge.to_numpy(cache)),
                            jax.tree_util.tree_leaves(jcache)):
        assert ours.shape == theirs.shape
        assert _maxerr(ours, theirs) < TOL

    # one decode step after the prefill, in a cache of S + 4 slots
    tok1 = np.argmax(np.asarray(jlg)[:, :cfg.vocab_size], -1).astype(np.int32)
    jinit = jtf.init_cache(jcfg, MB, MS + 4, dtype=jnp.float32)
    jbig = {"layers": tuple(c.at[:, :, :MS].set(s) for c, s in
                            zip(jinit["layers"], jcache["layers"])),
            "first": tuple(tuple(c.at[:, :MS].set(s) for c, s in zip(fc, fs))
                           for fc, fs in zip(jinit["first"],
                                             jcache["first"]))}
    jlg2, _ = jax.jit(lambda p, t, pos, c: jtf.decode_step(
        p, jcfg, t, pos, c, opts=OPTS_J, dtype=jnp.float32))(
        jparams, tok1, jnp.full((MB,), MS, jnp.int32), jbig)
    big = tf.init_cache(cfg, MB, MS + 4, dtype=torch.float32, device="cpu")
    _, big = tf.forward(params, cfg, tt, opts=OPTS_T, mode="prefill",
                        dtype=torch.float32, cache=big)
    for ours, theirs in zip(jax.tree_util.tree_leaves(bridge.to_numpy(big)),
                            jax.tree_util.tree_leaves(jbig)):
        assert ours.shape == theirs.shape
        assert _maxerr(ours, theirs) < TOL
    lg2, big = tf.decode_step(params, cfg, torch.from_numpy(tok1).long(),
                              torch.full((MB,), MS, dtype=torch.long), big,
                              opts=OPTS_T, dtype=torch.float32)
    assert _maxerr(lg2.numpy(), jlg2) < TOL


def test_model_decode_absorbed_mla():
    """Reduced deepseek-v2-lite decodes three steps from an empty cache
    through MLA's absorbed branch, against JAX's (the naive branch, the
    default, follows the prefill above)."""
    name = "deepseek-v2-lite-16b"
    jcfg, cfg = jax_get_config(name).reduced(), get_config(name).reduced()
    jparams = jax.jit(lambda k: jtf.init_lm(k, jcfg))(jax.random.PRNGKey(2))
    params = bridge.from_jax(_np_tree(jparams), "cpu")
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size,
                                               size=(MB, 10)).astype(np.int32)
    oj, ot = (OPTS_J.replace(mla_absorb=True),
              OPTS_T.replace(mla_absorb=True))
    jcache = jtf.init_cache(jcfg, MB, 12, dtype=jnp.float32)
    cache = tf.init_cache(cfg, MB, 12, dtype=torch.float32, device="cpu")
    tok = tokens[:, 0]
    jdecode = jax.jit(lambda p, t, pos, c: jtf.decode_step(
        p, jcfg, t, pos, c, opts=oj, dtype=jnp.float32))
    for t in range(3):      # three decode steps from an empty cache
        jlg, jcache = jdecode(jparams, tok, jnp.full((MB,), t, jnp.int32),
                              jcache)
        lg, cache = tf.decode_step(params, cfg, torch.from_numpy(tok).long(),
                                   torch.full((MB,), t, dtype=torch.long),
                                   cache, opts=ot, dtype=torch.float32)
        assert _maxerr(lg.numpy(), jlg) < TOL
        tok = tokens[:, t + 1]


# ---------------------------------------------------------------------------
# Serving params leaf by leaf, the driver, training
# ---------------------------------------------------------------------------

SERVED = ["gemma2-2b", "rwkv6-1.6b", "zamba2-2.7b", "deepseek-7b",
          "deepseek-v2-lite-16b", "qwen2-vl-2b", "whisper-base"]


@pytest.mark.parametrize("arch", SERVED)
def test_leaf_by_leaf_serving_params_equal_serving_params(arch):
    """init_serving_params equals serving_params of Model.init's whole fp32
    tree bit for bit: the same leaves, dtypes and values."""
    model = build_model(get_config(arch).reduced(), Options(moe_group=64))
    want = serving_params(model, model.init(
        torch.Generator().manual_seed(7), "cpu"))
    got = init_serving_params(model, torch.Generator().manual_seed(7), "cpu")
    want, got = dict(_leaves(want)), dict(_leaves(got))
    assert list(want) == list(got)
    for path, t in want.items():
        assert got[path].dtype == t.dtype, path
        assert torch.equal(got[path], t), path
    if arch == "deepseek-v2-lite-16b":
        first = {p: t for p, t in got.items() if p[0] == "first"}
        assert first and all(
            t.dtype == torch.bfloat16 for p, t in first.items()
            if p[-1] in ("wq", "wdkv", "wuk", "wuv", "wo", "w1", "w2", "w3"))
        assert got[("blocks", "mlp", "router")].dtype == torch.float32


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "arctic-480b"])
def test_serve_reduced_on_the_cpu(arch, capsys):
    out = serve.main(["--arch", arch, "--device", "cpu", "--requests", "2",
                      "--prompt-len", "16", "--max-new", "3"])
    assert "[serve] all 2 requests served" in capsys.readouterr().out
    assert out["model"].cfg.name == arch
    assert out["model"].opts.moe_group == 64
    assert len(out["replies"]) == 2
    assert all(r.shape == (3,) for r in out["replies"])


def test_build_model_takes_the_moe_and_vlm_families():
    """The three configs build at full width (no params made), and so
    does the audio family's whisper-base; a family the port lacks
    raises."""
    from repro_torch.models import whisper
    for arch in ("deepseek-v2-lite-16b", "qwen2-vl-2b", "arctic-480b"):
        assert build_model(get_config(arch)).cfg.name == arch
    model = build_model(get_config("whisper-base"))
    assert model.cfg.family == "audio" and model._mod is whisper
    with pytest.raises(NotImplementedError, match="speech"):
        build_model(get_config("gemma2-2b").replace(family="speech"))


# ---------------------------------------------------------------------------
# Training: the loss with the router's aux loss, gradients, one step
# ---------------------------------------------------------------------------

LR = 3e-4
# the first step's update against JAX's (see test_moe_train_step_matches_jax;
# measured 5.0e-05 LR where |g| >= UPD_G_MIN, 0.038 LR anywhere)
UPD_G_MIN, UPD_TOL, UPD_TOL_SMALL_G = 1e-6, 1e-3, 0.1


def _fp32_models(name):
    """Reduced `name` on both sides as models whose forward runs in fp32
    (each package's `make_loss_fn` calls the forward without a dtype), the
    JAX params, the port's copy and a seeded batch."""
    jcfg, cfg = jax_get_config(name).reduced(), get_config(name).reduced()
    jmodel = jax_build_model(jcfg, OPTS_J)
    jmodel._mod = types.SimpleNamespace(forward=lambda *a, **kw: jtf.forward(
        *a, **kw, dtype=jnp.float32))
    model = Model(cfg, OPTS_T, types.SimpleNamespace(
        forward=lambda *a, **kw: tf.forward(*a, **{**kw,
                                                   "dtype": torch.float32})))
    jparams = jax.jit(lambda k: jtf.init_lm(k, jcfg))(jax.random.PRNGKey(3))
    params = bridge.from_jax(_np_tree(jparams), "cpu")
    tokens = np.random.default_rng(3).integers(
        0, cfg.vocab_size, size=(4, 16)).astype(np.int32)
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, 1)}
    return jmodel, model, jparams, params, batch


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_loss_and_gradients_match_jax(arch):
    jmodel, model, jparams, params, batch = _fp32_models(arch)
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        jax_loss_fn(jmodel), has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    (loss, aux), grads = value_and_grad(make_loss_fn(model), params,
                                        _torch_batch(batch))
    assert float(aux["moe_aux"]) > 0
    for ours, theirs in ((loss, jloss), (aux["xent"], jaux["xent"]),
                         (aux["moe_aux"], jaux["moe_aux"])):
        assert abs(float(ours) - float(theirs)) <= TOL * abs(float(theirs))
    assert abs(float(loss) - float(aux["xent"]) - float(aux["moe_aux"])) \
        <= 1e-6 * float(loss)
    ours, theirs = dict(_leaves(bridge.to_numpy(grads))), dict(
        _leaves(_np_tree(jgrads)))
    assert set(ours) == set(theirs)
    for p in ours:
        assert _maxerr(ours[p], theirs[p]) <= TOL * max(
            1.0, float(np.abs(theirs[p]).max())), p
    # the router's gradient carries the aux loss's: without it, it moves
    (_, _), g_no_aux = value_and_grad(
        lambda p_, b_: (aux_free_loss(model, p_, b_), {}), params,
        _torch_batch(batch))
    router = ("blocks", "mlp", "router")
    assert _maxerr(dict(_leaves(bridge.to_numpy(g_no_aux)))[router],
                   ours[router]) > 0


def aux_free_loss(model, params, batch):
    from repro_torch.models.common import softmax_xent
    logits = model.forward(params, batch)
    return softmax_xent(logits, batch["labels"], model.cfg.vocab_size)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_train_step_matches_jax(arch):
    """One fp32 step of each package's make_train_step from the same
    params and batch, then the microbatched path's report."""
    jmodel, model, jparams, params, batch = _fp32_models(arch)
    jrc = JRunConfig(total_steps=10, warmup_steps=0, lr=LR)
    rc = RunConfig(total_steps=10, warmup_steps=0, lr=LR)
    jp, js, jm = jax.jit(jax_train_step(jmodel, jrc))(
        jparams, jadamw.init_opt(jparams, jrc),
        {k: jnp.asarray(v) for k, v in batch.items()})
    tp, _, tm = make_train_step(model, rc)(params, adamw.init_opt(params, rc),
                                           _torch_batch(batch))
    assert float(tm["moe_aux"]) > 0
    for key in ("loss", "xent", "moe_aux", "grad_norm"):
        assert abs(float(tm[key]) - float(jm[key])) \
            <= TOL * abs(float(jm[key])), key
    # the update each package made, tp - p0 against jp - p0.  Adam's first
    # step moves an element by lr * g / (|g| + eps) plus the decay, g the
    # clipped gradient (JAX's m / (1 - beta1)): where |g| >= UPD_G_MIN
    # (100 eps) that is well conditioned and the updates agree within
    # UPD_TOL * LR; where g is near eps the gradients' rounding moves it by
    # a fraction of lr, so there within UPD_TOL_SMALL_G * LR.  A step that
    # skipped the update is off by ~LR, one of the wrong sign by ~2 LR.
    p0 = jax.tree_util.tree_leaves(_np_tree(jparams))
    g = [np.abs(m) / (1 - jrc.beta1) for m in
         jax.tree_util.tree_leaves(_np_tree(js.m))]
    worst = worst_small = 0.0
    for t, j, p, gi in zip(jax.tree_util.tree_leaves(bridge.to_numpy(tp)),
                           jax.tree_util.tree_leaves(_np_tree(jp)), p0, g):
        d = np.abs((t - p) - (j - p))
        big = gi >= UPD_G_MIN
        worst = max(worst, float(d[big].max(initial=0.0)))
        worst_small = max(worst_small, float(d.max()))
    assert worst <= UPD_TOL * LR, worst / LR
    assert worst_small <= UPD_TOL_SMALL_G * LR, worst_small / LR

    rc2 = rc.replace(microbatches=2)
    _, _, tm2 = make_train_step(model, rc2)(
        bridge.from_jax(_np_tree(jparams), "cpu"),
        adamw.init_opt(params, rc2), _torch_batch(batch))
    _, _, jm2 = jax.jit(jax_train_step(jmodel, jrc.replace(
        microbatches=2)))(jparams, jadamw.init_opt(jparams, jrc),
                          {k: jnp.asarray(v) for k, v in batch.items()})
    assert float(tm2["moe_aux"]) == 0.0 == float(jm2["moe_aux"])
    assert float(tm2["xent"]) == float(tm2["loss"])
    assert abs(float(tm2["loss"]) - float(jm2["loss"])) \
        <= TOL * abs(float(jm2["loss"]))
