"""Port parity for the other dense configs: deepseek-7b (MHA, kv = heads),
qwen2.5-32b (GQA 40/8, whose 40 query heads pad to 48, with QKV bias) and
deepseek-67b (GQA 64/8).

Each config is cut to 2 layers and narrow widths (d_model 128, d_ff 256,
vocab 512, head dim 32) with its own head layout, rope theta and bias kept,
and the JAX package's params load through the bridge.  fp32 on both sides:
forward logits, the prefill cache and one decode step's logits within
1e-4, as tests/test_torch_transformer.py holds gemma2-2b."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import REGISTRY as JAX_REGISTRY  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.common import Options as JOptions  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import REGISTRY, get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.attention import head_padding  # noqa: E402
from repro_torch.models.common import Options  # noqa: E402

TOL = 1e-4
B, S = 2, 24
ARCHS = ["deepseek-7b", "qwen2.5-32b", "deepseek-67b"]
# each config's head layout: (query heads, KV heads, padded query heads)
HEADS = {"deepseek-7b": (32, 32, 32), "qwen2.5-32b": (40, 8, 48),
         "deepseek-67b": (64, 8, 64)}
NARROW = dict(n_layers=2, d_model=128, d_ff=256, vocab_size=512,
              head_dim=32, vocab_pad_multiple=16)
OPTS_J, OPTS_T = JOptions(q_block=8, kv_block=8), Options(q_block=8,
                                                         kv_block=8)


def test_the_registries_hold_the_same_configs():
    """The three configs equal the reference's field by field; every
    config of the port's registry is the reference's."""
    for name in ARCHS:
        ours, theirs = REGISTRY[name], JAX_REGISTRY[name]
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs), name
        assert ours.family == "dense"
    for name, cfg in REGISTRY.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(
            JAX_REGISTRY[name]), name
    assert get_config("deepseek_7b") is REGISTRY["deepseek-7b"]


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    name = request.param
    jcfg = jax_get_config(name).replace(**NARROW)
    cfg = get_config(name).replace(**NARROW)
    assert (cfg.n_heads, cfg.n_kv_heads, head_padding(cfg)[0]) == HEADS[name]
    jparams = jax.tree_util.tree_map(
        np.asarray, jtf.init_lm(jax.random.PRNGKey(1), jcfg))
    if cfg.qkv_bias:
        # the biases start at zero: make them bite
        rng = np.random.default_rng(2)
        attn = jparams["blocks"]["attn"]
        for k in ("bq", "bk", "bv"):
            attn[k] = (0.5 * rng.standard_normal(attn[k].shape)).astype(
                attn[k].dtype)
    params = bridge.from_jax(jparams, "cpu")
    jparams = jax.tree_util.tree_map(jnp.asarray, jparams)
    tokens = np.random.default_rng(1).integers(
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

    tok1 = np.argmax(np.asarray(jlg)[:, :cfg.vocab_size], -1).astype(np.int32)
    jbig = jtf.init_cache(jcfg, B, S + 4, dtype=jnp.float32)
    jbig = {"layers": tuple(c.at[:, :, :S].set(s) for c, s in
                            zip(jbig["layers"], jcache["layers"])),
            "first": ()}
    jlg2, _ = jtf.decode_step(jparams, jcfg, jnp.asarray(tok1),
                              jnp.full((B,), S, jnp.int32), jbig,
                              opts=OPTS_J, dtype=jnp.float32)
    big = tf.init_cache(cfg, B, S + 4, dtype=torch.float32, device="cpu")
    _, big = tf.forward(params, cfg, tt, opts=OPTS_T, mode="prefill",
                        dtype=torch.float32, cache=big)
    lg2, big = tf.decode_step(params, cfg, torch.from_numpy(tok1).long(),
                              torch.full((B,), S, dtype=torch.long), big,
                              opts=OPTS_T, dtype=torch.float32)
    assert _maxerr(lg2.numpy(), jlg2) < TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_reduced_on_the_cpu(arch, capsys):
    """`launch.serve --arch <config>` answers through `Client.serve` on
    the CPU at the reduced size."""
    out = serve.main(["--arch", arch, "--device", "cpu", "--requests", "2",
                      "--prompt-len", "16", "--max-new", "3"])
    assert "[serve] all 2 requests served" in capsys.readouterr().out
    assert out["model"].cfg.name == arch and out["model"].cfg.n_layers == 2
