"""The port's serve entry point on the CPU at reduced size, and the param bridge."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.launch import serve  # noqa: E402


def test_serve_answers_every_request(capsys):
    res = serve.main(["--device", "cpu", "--requests", "3", "--prompt-len",
                      "16", "--max-new", "4"])
    out = capsys.readouterr().out
    assert "[serve] all 3 requests served" in out
    assert "[serve] latency ms: p50=" in out and "p99=" in out
    cfg = res["model"].cfg
    assert res["batches"] == [3]
    assert len(res["replies"]) == 3
    for row in res["replies"]:
        assert row.shape == (4,)
        assert row.min() >= 0 and row.max() < cfg.vocab_size
    assert all(lat > 0 for lat in res["latency_ms"])


def test_serve_is_seeded():
    argv = ["--device", "cpu", "--requests", "2", "--prompt-len", "8",
            "--max-new", "3", "--seed", "5"]
    a, b = serve.main(argv), serve.main(argv)
    assert all(np.array_equal(x, y) for x, y in zip(a["replies"], b["replies"]))
    assert all(np.array_equal(x, y) for x, y in zip(a["prompts"], b["prompts"]))


def test_bridge_round_trip():
    cfg = jax_get_config("gemma2-2b").reduced()
    tree = jax.tree_util.tree_map(np.asarray,
                                  jtf.init_lm(jax.random.PRNGKey(1), cfg))
    tree["ints"] = (np.arange(5, dtype=np.int32), [np.zeros((2, 3))])
    back = bridge.to_numpy(bridge.from_jax(tree, "cpu"))
    flat_a, tdef_a = jax.tree_util.tree_flatten(tree)
    flat_b, tdef_b = jax.tree_util.tree_flatten(back)
    assert tdef_a == tdef_b
    for x, y in zip(flat_a, flat_b):
        assert x.dtype == y.dtype and np.array_equal(x, y)
