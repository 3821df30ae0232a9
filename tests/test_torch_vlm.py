"""Port parity for M-RoPE and qwen2-vl-2b (the vlm family), reduced, with
the JAX package's params loaded through the bridge.  fp32 on both sides.

The position streams are distinct, as an image makes them: text tokens
carry one position on all three streams; the tokens of an image grid keep
the temporal stream constant and walk the height and width streams as a
raster; the text after it resumes past the largest position.

- `mrope_angles` against JAX at qwen2-vl-2b's sections (16, 24, 24) and
  head dim 128, and at the reduced (4, 6, 6) and head dim 32: within 1e-6.
- The whole model: train logits, prefill logits and cache, and one decode
  step's logits (the decode position broadcast to the 3 streams) within
  1e-4, with the streams given; without them the text positions.
- `launch.serve --arch qwen2-vl-2b --device cpu` answers every request."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.common import Options as JOptions  # noqa: E402
from repro.models.rope import mrope_angles as jmrope_angles  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.common import Options  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.rope import mrope_angles  # noqa: E402

ROPE_TOL, TOL = 1e-6, 1e-4
B, S = 2, 24
OPTS_J, OPTS_T = JOptions(q_block=8, kv_block=8), Options(q_block=8,
                                                         kv_block=8)


def image_positions(batch, text_before, grid_h, grid_w, text_after):
    """(3, batch, S) M-RoPE streams of text, one image grid, then text;
    each row's image starts one token later than the previous row's."""
    rows = []
    for b in range(batch):
        pre = text_before + b
        t = list(range(pre))
        streams = [list(t), list(t), list(t)]
        for i in range(grid_h * grid_w):
            streams[0].append(pre)
            streams[1].append(pre + i // grid_w)
            streams[2].append(pre + i % grid_w)
        nxt = max(max(s) for s in streams) + 1
        n_after = text_before + text_after - pre
        for s in streams:
            s.extend(range(nxt, nxt + n_after))
        rows.append(streams)
    return np.array(rows, np.int32).transpose(1, 0, 2)


def test_image_positions_are_distinct():
    pos = image_positions(B, 4, 4, 4, 4)
    assert pos.shape == (3, B, S)
    assert not np.array_equal(pos[0], pos[1])
    assert not np.array_equal(pos[1], pos[2])


@pytest.mark.parametrize("sections,head_dim,theta", [
    ((16, 24, 24), 128, 1e6),      # qwen2-vl-2b
    ((4, 6, 6), 32, 1e6),          # its reduced config
])
def test_mrope_angles_match_jax(sections, head_dim, theta):
    pos = image_positions(B, 4, 4, 4, 4)
    jsin, jcos = jmrope_angles(jnp.asarray(pos), sections, head_dim, theta)
    sin, cos = mrope_angles(torch.from_numpy(pos), sections, head_dim, theta)
    assert sin.shape == (B, S, head_dim // 2)
    assert np.max(np.abs(sin.numpy() - np.asarray(jsin))) <= ROPE_TOL
    assert np.max(np.abs(cos.numpy() - np.asarray(jcos))) <= ROPE_TOL


def test_mrope_angles_refuse_bad_sections():
    with pytest.raises(ValueError):
        mrope_angles(torch.zeros((3, 1, 4), dtype=torch.long), (4, 6, 5), 32,
                     1e6)


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_get_config("qwen2-vl-2b").reduced()
    cfg = get_config("qwen2-vl-2b").reduced()
    assert cfg.mrope and cfg.mrope_sections == (4, 6, 6) and cfg.qkv_bias
    jparams = jax.tree_util.tree_map(
        np.asarray, jtf.init_lm(jax.random.PRNGKey(6), jcfg))
    rng = np.random.default_rng(6)
    attn = jparams["blocks"]["attn"]
    for k in ("bq", "bk", "bv"):       # the biases start at zero
        attn[k] = (0.5 * rng.standard_normal(attn[k].shape)).astype(
            attn[k].dtype)
    params = bridge.from_jax(jparams, "cpu")
    jparams = jax.tree_util.tree_map(jnp.asarray, jparams)
    tokens = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    return jcfg, cfg, jparams, params, tokens, image_positions(B, 4, 4, 4, 4)


def _maxerr(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


@pytest.mark.parametrize("streams", [True, False])
def test_forward_logits_fp32(setup, streams):
    """Train-mode logits through the port's `Model.forward`, the image
    streams in the batch or not (text positions), against the JAX
    function given the same streams."""
    jcfg, cfg, jparams, params, tokens, pos = setup
    batch = {"tokens": torch.from_numpy(tokens).long()}
    if streams:
        batch["mrope_positions"] = torch.from_numpy(pos)
    log = build_model(cfg, OPTS_T).forward(params, batch,
                                           dtype=torch.float32)
    jlog, _ = jtf.forward(jparams, jcfg, jnp.asarray(tokens), opts=OPTS_J,
                          dtype=jnp.float32,
                          mrope_positions=jnp.asarray(pos) if streams
                          else None)
    assert log.shape == (B, S, cfg.padded_vocab)
    assert _maxerr(log.numpy(), jlog) < TOL


def test_streams_change_the_logits(setup):
    jcfg, cfg, jparams, params, tokens, pos = setup
    tt = torch.from_numpy(tokens).long()
    a = tf.forward(params, cfg, tt, opts=OPTS_T, dtype=torch.float32,
                   mrope_positions=torch.from_numpy(pos))
    b = tf.forward(params, cfg, tt, opts=OPTS_T, dtype=torch.float32)
    assert _maxerr(a.numpy(), b.numpy()) > 1e-3


def test_prefill_cache_and_decode_fp32(setup):
    jcfg, cfg, jparams, params, tokens, pos = setup
    jlg, jcache, _ = jtf.forward(jparams, jcfg, jnp.asarray(tokens),
                                 opts=OPTS_J, mode="prefill",
                                 dtype=jnp.float32,
                                 mrope_positions=jnp.asarray(pos))
    tt, tpos = torch.from_numpy(tokens).long(), torch.from_numpy(pos)
    lg, cache = tf.forward(params, cfg, tt, opts=OPTS_T, mode="prefill",
                           dtype=torch.float32, mrope_positions=tpos)
    assert _maxerr(lg.numpy(), jlg) < TOL
    assert cache["first"] == () and jcache["first"] == ()
    for ours, theirs in zip(cache["layers"], jcache["layers"]):
        assert ours.shape == theirs.shape
        assert _maxerr(ours.numpy(), theirs) < TOL

    tok1 = np.argmax(np.asarray(jlg)[:, :cfg.vocab_size], -1).astype(np.int32)
    jinit = jtf.init_cache(jcfg, B, S + 4, dtype=jnp.float32)
    jbig = {"layers": tuple(c.at[:, :, :S].set(s) for c, s in
                            zip(jinit["layers"], jcache["layers"])),
            "first": ()}
    jlg2, _ = jtf.decode_step(jparams, jcfg, jnp.asarray(tok1),
                              jnp.full((B,), S, jnp.int32), jbig,
                              opts=OPTS_J, dtype=jnp.float32)
    big = tf.init_cache(cfg, B, S + 4, dtype=torch.float32, device="cpu")
    _, big = tf.forward(params, cfg, tt, opts=OPTS_T, mode="prefill",
                        dtype=torch.float32, cache=big, mrope_positions=tpos)
    lg2, big = tf.decode_step(params, cfg, torch.from_numpy(tok1).long(),
                              torch.full((B,), S, dtype=torch.long), big,
                              opts=OPTS_T, dtype=torch.float32)
    assert _maxerr(lg2.numpy(), jlg2) < TOL


def test_serve_reduced_on_the_cpu(capsys):
    out = serve.main(["--arch", "qwen2-vl-2b", "--device", "cpu",
                      "--requests", "2", "--prompt-len", "16",
                      "--max-new", "3"])
    assert "[serve] all 2 requests served" in capsys.readouterr().out
    assert out["model"].cfg.mrope and len(out["replies"]) == 2
    assert all(r.shape == (3,) for r in out["replies"])
