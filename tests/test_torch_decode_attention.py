"""Port parity: decode attention (one new token against a GQA cache) against
the JAX version, with windows and softcap, fp32.  Tolerance 2e-5."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import attention as jattn  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402

TOL = 2e-5


@pytest.mark.parametrize("window,cap", [(None, 0.0), (None, 50.0), (7, 50.0),
                                        (30, 0.0)])
def test_decode_attention_matches_jax(window, cap):
    rng = np.random.default_rng(0)
    B, T, G, hq, hd = 3, 40, 4, 16, 32
    q = rng.standard_normal((B, 1, hq, hd)).astype(np.float32)
    kc = rng.standard_normal((B, T, G, hd)).astype(np.float32)
    vc = rng.standard_normal((B, T, G, hd)).astype(np.float32)
    pos = np.array([0, 17, 39], np.int32)
    out = attn.decode_attention(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        torch.from_numpy(pos).long(), window=window, logit_softcap=cap,
        scale=0.125)
    ref = jattn.decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(pos),
        window=window, logit_softcap=cap, scale=0.125)
    assert float(np.max(np.abs(out.numpy() - np.asarray(ref)))) < TOL
