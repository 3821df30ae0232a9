"""The port's serve entry point on the CPU at reduced size, and the param bridge.

The driver serves through the futures client's METG-batching frontend, as
the JAX package's does: the batches it forms are held equal to those the
JAX driver forms for the same flags, and each reply to a direct
`greedy_generate` of its prompt alone."""
import contextlib
import io
import re
from unittest import mock

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch import serve as jax_serve  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.runtime.serve_step import greedy_generate  # noqa: E402


def jax_driver_batches(argv):
    """(batches, mean_batch) that the JAX package's `repro.launch.serve`
    prints for these flags.  Its generation is replaced by zeros: the
    frontend's batching never looks at the replies."""
    def zeros(model, params, batch, max_new, cache_len):
        return jnp.zeros((batch["tokens"].shape[0], max_new), jnp.int32)

    out = io.StringIO()
    with mock.patch.object(jax_serve, "greedy_generate", zeros), \
            contextlib.redirect_stdout(out):
        jax_serve.main(argv)
    m = re.search(r"batches=(\d+) mean_batch=([\d.]+)", out.getvalue())
    return int(m[1]), float(m[2])


def check_front_door(res, argv):
    """The port's driver formed the batches JAX's forms for the same flags,
    its backend ran each once, and each reply is what a direct
    `greedy_generate` of that prompt alone gives."""
    n = len(res["prompts"])
    assert res["batches"] == [1] * n             # METG target 1 at 1 worker
    jax_argv = [a for a in argv if a != "cpu" and a != "--device"]
    i = jax_argv.index("--seed") if "--seed" in jax_argv else None
    if i is not None:
        del jax_argv[i:i + 2]
    assert jax_driver_batches(jax_argv) == (len(res["batches"]),
                                            sum(res["batches"]) / n)
    st = res["backend_stats"]
    assert st["completed"] == st["created"] == len(res["batches"])
    assert st["errors"] == 0 and st["requeued"] == 0
    max_new = res["replies"][0].shape[0]
    for p, reply in zip(res["prompts"], res["replies"]):
        direct = greedy_generate(res["model"], res["params"],
                                 {"tokens": torch.from_numpy(p[None])},
                                 max_new, len(p) + max_new + 1)
        assert np.array_equal(direct[0].numpy(), reply)


def test_serve_answers_every_request(capsys):
    argv = ["--device", "cpu", "--requests", "3", "--prompt-len", "16",
            "--max-new", "4"]
    res = serve.main(argv)
    out = capsys.readouterr().out
    assert "[serve] all 3 requests served" in out
    assert "[serve] latency ms: p50=" in out and "p99=" in out
    assert "[serve] METG batch target for 1 worker(s): 1" in out
    cfg = res["model"].cfg
    check_front_door(res, argv)
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
