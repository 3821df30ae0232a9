"""Port parity for `optim/compress.py`: int8 block quantization with error
feedback, against the JAX package's `repro.optim.compress` (which
tests/test_extensions.py tests), on seeded numpy inputs.

Bit for bit: `quantize_int8`'s q and scales, the dequantized round trip,
and three rounds of `compressed_grads` with its error feedback (the
decompressed gradients and the error state of each round), over a tree of
a dict, a tuple and sizes that are and are not multiples of BLOCK."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.optim import compress as jcompress  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.optim import compress  # noqa: E402


def _arr(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("shape,scale", [((256,), 1.0), ((3, 100), 1e-3),
                                         ((7, 5, 31), 50.0), ((1,), 2.0),
                                         ((2, 512), 1e-20)])
def test_quantize_int8_bit_for_bit(shape, scale):
    x = _arr(shape, seed=sum(shape), scale=scale)
    if x.size > 4:
        x.reshape(-1)[:4] = 0.0                  # a block with zeros
    jq, js = jcompress.quantize_int8(jnp.asarray(x))
    q, s = compress.quantize_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert q.shape == jq.shape and s.shape == js.shape
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(s.numpy(), np.asarray(js))
    assert np.array_equal(
        compress.compress_roundtrip(torch.from_numpy(x)).numpy(),
        np.asarray(jcompress.compress_roundtrip(jnp.asarray(x))))
    assert np.array_equal(
        compress.dequantize_int8(q, s, shape).numpy(),
        np.asarray(jcompress.dequantize_int8(jq, js, shape)))


def test_quantize_rounds_half_to_even():
    """127 * x / max lands on .5 exactly: both round to even."""
    x = np.zeros(256, np.float32)
    x[0], x[1], x[2] = 127.0, 0.5, 1.5
    q, _ = compress.quantize_int8(torch.from_numpy(x))
    jq, _ = jcompress.quantize_int8(jnp.asarray(x))
    assert q[0, :3].tolist() == [127, 0, 2] == np.asarray(jq)[0, :3].tolist()


def test_compressed_grads_error_feedback_bit_for_bit():
    def grads(r):
        return {"a": _arr((300,), 10 + r), "blocks": {
            "w": _arr((4, 64, 8), 20 + r, 1e-2),
            "first": (_arr((5,), 30 + r, 3.0), _arr((256,), 40 + r))}}

    jerr = err = None
    for r in range(3):
        g = grads(r)
        jout, jerr = jcompress.compressed_grads(
            jax.tree_util.tree_map(jnp.asarray, g), jerr)
        out, err = compress.compressed_grads(bridge.from_jax(g, "cpu"), err)
        for ours, theirs in ((out, jout), (err, jerr)):
            a = jax.tree_util.tree_leaves(bridge.to_numpy(ours))
            b = jax.tree_util.tree_leaves(
                jax.tree_util.tree_map(np.asarray, theirs))
            assert len(a) == len(b) == 4
            for x, y in zip(a, b):
                assert x.shape == y.shape and x.dtype == y.dtype
                assert np.array_equal(x, y)
        assert any(float(e.abs().max()) > 0
                   for e in jax.tree_util.tree_leaves(err))


def test_compressed_grads_keeps_the_gradient_dtype():
    g = {"w": torch.from_numpy(_arr((3, 100), 1)).bfloat16()}
    out, err = compress.compressed_grads(g, None)
    assert out["w"].dtype == torch.bfloat16
    assert err["w"].dtype == torch.float32
    assert torch.equal(err["w"], g["w"].float() - compress.compress_roundtrip(
        g["w"].float()))
