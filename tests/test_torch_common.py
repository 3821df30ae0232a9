"""Port parity: norms, activation, softcap, RoPE and the config copies against
the JAX package, on the CPU, fp32.  Tolerance 1e-6 (fp32 rounding of the
same formula)."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import input_specs as jax_input_specs  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import rope as jrope  # noqa: E402
from repro_torch.configs import SHAPES, get_config, input_specs  # noqa: E402
from repro_torch.models import common, rope  # noqa: E402

TOL = 1e-6


def _rand(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _err(t, j):
    return float(np.max(np.abs(t.numpy() - np.asarray(j))))


@pytest.mark.parametrize("plus_one", [False, True])
def test_rms_norm(plus_one):
    x, s = _rand((3, 5, 64)), _rand((64,), 1) * 0.1
    out = common.rms_norm(torch.from_numpy(x), torch.from_numpy(s), 1e-6,
                          plus_one=plus_one)
    ref = jcommon.rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-6,
                           plus_one=plus_one)
    assert _err(out, ref) < TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm(dtype):
    """fp32 inside, cast back: bf16 outputs agree to the bit after the cast
    of equal fp32 values; compared as fp32 within TOL."""
    x, s, b = _rand((3, 5, 64)) * 3 + 1, 1 + _rand((64,), 1) * 0.1, \
        _rand((64,), 2) * 0.1
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    out = common.layer_norm(tx, torch.from_numpy(s), torch.from_numpy(b))
    ref = jcommon.layer_norm(jx, jnp.asarray(s), jnp.asarray(b))
    assert out.dtype == tx.dtype
    assert _err(out.float(), ref.astype(jnp.float32)) < TOL


@pytest.mark.parametrize("cap", [0.0, 30.0, 50.0])
def test_gelu_tanh_and_softcap(cap):
    x = _rand((4, 257), 2) * 4
    act = common.activation("gelu")(torch.from_numpy(x))
    assert _err(act, jcommon.activation("gelu")(jnp.asarray(x))) < TOL
    sc = common.softcap(torch.from_numpy(x * 20), cap)
    assert _err(sc, jcommon.softcap(jnp.asarray(x * 20), cap)) / \
        max(cap, 1.0) < TOL


def test_rope_angles_and_apply():
    pos = np.arange(48)
    s_t, c_t = rope.rope_angles(torch.from_numpy(pos), 32, 1e4)
    s_j, c_j = jrope.rope_angles(jnp.asarray(pos), 32, 1e4)
    assert _err(s_t, s_j) < TOL and _err(c_t, c_j) < TOL
    x = _rand((2, 48, 4, 32), 3)
    out = rope.apply_rope(torch.from_numpy(x), s_t, c_t)
    ref = jrope.apply_rope(jnp.asarray(x), s_j, c_j)
    assert _err(out, ref) < TOL


@pytest.mark.parametrize("reduced", [False, True])
def test_config_copy(reduced):
    ours, theirs = get_config("gemma2-2b"), jax_get_config("gemma2-2b")
    if reduced:
        ours, theirs = ours.reduced(), theirs.reduced()
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.padded_vocab == theirs.padded_vocab
    assert ours.resolved_head_dim == theirs.resolved_head_dim


@pytest.mark.parametrize("reduced", [False, True])
def test_rwkv_config_copy(reduced):
    ours, theirs = get_config("rwkv6-1.6b"), jax_get_config("rwkv6-1.6b")
    if reduced:
        ours, theirs = ours.reduced(), theirs.reduced()
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.padded_vocab == theirs.padded_vocab


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_input_specs_are_meta_tensors(shape):
    ours = input_specs(get_config("gemma2-2b"), SHAPES[shape])
    theirs = jax_input_specs(jax_get_config("gemma2-2b"), JSHAPES[shape])
    assert ours.keys() == theirs.keys()
    for k, t in ours.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(theirs[k].shape)
        assert str(t.dtype).split(".")[-1] == str(theirs[k].dtype)
