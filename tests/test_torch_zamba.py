"""Port parity for the zamba2 training slice: zamba2-2.7b reduced (12 Mamba2
layers in 2 groups, d_model 128, 16 SSD heads of 16, state 16, chunk 16,
shared attention on 256 inputs with 4 heads of 32 padded to 16) with the
JAX package's params loaded through the bridge.  Every leaf gets seeded
noise first, so every path of the math carries weight.

fp32 on both sides.  Forward logits within 1e-4 of max(1, max |logit|).
Loss within 1e-5 relative, and every leaf's gradient within 1e-3 of
max(1, its largest |grad|): the same math in another summation order, run
through 12 perturbed layers and differentiated (the gradients differ by
~1e-4 of their largest magnitude here; a dropped term is off by O(1))."""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import zamba as jzamba  # noqa: E402
from repro.models.common import Options as JaxOptions  # noqa: E402
from repro.models.common import softmax_xent as jax_xent  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels._recompute import recompute  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.models import zamba  # noqa: E402
from repro_torch.models.common import Options, param_count, softmax_xent  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.runtime.train_step import value_and_grad  # noqa: E402

S = 40          # not a multiple of the chunk (16): the padded tail runs


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_get_config("zamba2-2.7b").reduced()
    cfg = get_config("zamba2-2.7b").reduced()
    assert (cfg.n_layers, cfg.d_model, cfg.ssm.head_dim, cfg.ssm.state_dim,
            cfg.ssm.chunk, zamba.n_groups(cfg)) == (12, 128, 16, 16, 16, 2)
    rng = np.random.default_rng(0)
    tree = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.1 * rng.standard_normal(a.shape))
        .astype(np.float32), jzamba.init_lm(jax.random.PRNGKey(0), jcfg))
    tokens = rng.integers(0, cfg.vocab_size, size=(2, S)).astype(np.int32)
    labels = np.roll(tokens, -1, 1)
    labels[0, -3:] = -1                      # masked positions
    return jcfg, cfg, tree, tokens, labels


def _jax_logits(jcfg, tree, tokens):
    logits, _ = jzamba.forward(jax.tree_util.tree_map(jnp.asarray, tree),
                               jcfg, jnp.asarray(tokens),
                               opts=JaxOptions(q_block=16, kv_block=16),
                               dtype=jnp.float32)
    return np.asarray(logits)


def _model(cfg):
    return build_model(cfg, Options(q_block=16, kv_block=16))


def test_tree_and_param_count(setup):
    """The bridge carries the JAX tree; the port's own init makes the same
    tree; full width holds 2,501,316,000 parameters (counted on the meta
    device, no storage)."""
    jcfg, cfg, tree, _, _ = setup
    back = bridge.to_numpy(bridge.from_jax(tree, "cpu"))
    flat_a, tdef_a = jax.tree_util.tree_flatten(tree)
    flat_b, tdef_b = jax.tree_util.tree_flatten(back)
    assert tdef_a == tdef_b
    assert all(np.array_equal(x, y) for x, y in zip(flat_a, flat_b))
    ours = bridge.to_numpy(zamba.init_lm(torch.Generator().manual_seed(0),
                                         cfg, "cpu"))
    flat_c, tdef_c = jax.tree_util.tree_flatten(ours)
    assert tdef_c == tdef_a
    assert [x.shape for x in flat_c] == [x.shape for x in flat_a]
    full = build_model(get_config("zamba2-2.7b"))
    assert param_count(full.init(torch.Generator(), "meta")) == 2_501_316_000


def test_forward_logits_match_jax(setup):
    jcfg, cfg, tree, tokens, _ = setup
    jl = _jax_logits(jcfg, tree, tokens)
    logits = _model(cfg).forward(bridge.from_jax(tree, "cpu"),
                                 {"tokens": torch.from_numpy(tokens)},
                                 dtype=torch.float32)
    assert logits.shape == (2, S, cfg.padded_vocab)
    err = float(np.max(np.abs(logits.detach().numpy() - jl)))
    assert err <= 1e-4 * max(1.0, float(np.abs(jl).max())), err


def test_loss_and_every_gradient_match_jax(setup):
    jcfg, cfg, tree, tokens, labels = setup

    def jloss(p):
        logits, _ = jzamba.forward(p, jcfg, jnp.asarray(tokens),
                                   opts=JaxOptions(q_block=16, kv_block=16),
                                   dtype=jnp.float32)
        return jax_xent(logits, jnp.asarray(labels), jcfg.vocab_size)

    jl, jg = jax.value_and_grad(jloss)(
        jax.tree_util.tree_map(jnp.asarray, tree))
    model = _model(cfg)

    def loss_fn(p, b):
        logits = model.forward(p, b, dtype=torch.float32)
        return softmax_xent(logits, b["labels"], cfg.vocab_size), {}

    (loss, _), grads = value_and_grad(
        loss_fn, bridge.from_jax(tree, "cpu"),
        {"tokens": torch.from_numpy(tokens),
         "labels": torch.from_numpy(labels)})
    assert abs(float(loss) - float(jl)) <= 1e-5 * abs(float(jl))
    ours, _ = jax.tree_util.tree_flatten(bridge.to_numpy(grads))
    theirs, _ = jax.tree_util.tree_flatten(jg)
    assert len(ours) == len(theirs) == 22
    for a, b in zip(ours, theirs):
        b = np.asarray(b)
        assert a.shape == b.shape
        err = float(np.max(np.abs(a - b)))
        assert err <= 1e-3 * max(1.0, float(np.abs(b).max())), err
        assert float(np.abs(a).max()) > 0


def test_serving_modes_raise_until_ported(setup):
    _, cfg, _, tokens, _ = setup
    model = _model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(NotImplementedError, match="serving zamba2"):
        model.forward(params, {"tokens": torch.from_numpy(tokens)},
                      mode="prefill")
    with pytest.raises(NotImplementedError, match="serving zamba2"):
        model.init_cache(2, 16, device="cpu")


def test_flash_function_backward_is_the_blockwise_autograd():
    """The recompute op the card's `flash_attention` uses (forward: kernel;
    backward: autograd of the recomputed blockwise version), with the plain
    forward standing in for the kernel: q/k/v gradients equal autograd
    through the blockwise version, and under inference_mode it runs with no
    graph."""
    rng = np.random.default_rng(1)
    qkv = [rng.standard_normal(s).astype(np.float32)
           for s in [(2, 37, 8, 80), (2, 37, 2, 80), (2, 37, 2, 80)]]
    plain = functools.partial(
        fa_ref.flash_attention_blockwise, window=None, logit_softcap=0.0,
        scale=80 ** -0.5, q_block=16, kv_block=16)
    g = torch.from_numpy(rng.standard_normal((2, 37, 8, 80))
                         .astype(np.float32))
    a = [torch.from_numpy(x).requires_grad_() for x in qkv]
    b = [torch.from_numpy(x).requires_grad_() for x in qkv]
    out = recompute(plain, plain, *a)
    (out * g).sum().backward()
    (plain(*b) * g).sum().backward()
    for x, y in zip(a, b):
        assert torch.equal(x.grad, y.grad)
    with torch.inference_mode():
        again = recompute(plain, plain, *(x.detach() for x in a))
    assert torch.equal(again, out.detach())
