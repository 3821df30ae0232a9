"""Port parity for the training path: AdamW, the train step, the data
pipeline and the training entry point, against the JAX package.

- AdamW on a random fp32 tree: lr schedule, clipping and one update within
  1e-6 (fp32, the same elementwise formulas).
- One bf16 train step of reduced zamba2: loss within 1e-3 relative and grad
  norm within 2 % (JAX's own bf16 and fp32 gradient norms differ by 1.5 %
  here; bf16 rounds at other places in the two frameworks).  Updated params:
  Adam's first step moves each element by lr * (sign(g) + wd * p) for any
  |g| >> eps, so an element whose tiny gradient has the other sign in the
  other framework moves 2 * lr apart; the bound allows that and no more, and
  at most 5 % of the elements may differ by over 1e-6 (2.9 % do here).
- Six steps on one repeated batch at lr 3e-4: the loss curve follows
  JAX's within 2 % at every step.
- Microbatches 1 and 2 give the same update within the same 2 * lr bound,
  as tests/test_integration.py holds the JAX step.
- The pipeline's batches equal JAX's, array for array, for two seeds."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import RunConfig as JaxRunConfig  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.data.pipeline import Pipeline as JaxPipeline  # noqa: E402
from repro.models.common import Options as JaxOptions  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.runtime.train_step import make_train_step as jax_train_step  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import RunConfig, get_config  # noqa: E402
from repro_torch.data.pipeline import Pipeline  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models.common import Options  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime.train_step import make_train_step  # noqa: E402

LR = 3e-4


def _tree(rng, scale=1.0):
    n = lambda *s: (scale * rng.standard_normal(s)).astype(np.float32)  # noqa: E731
    return {"a": n(3, 5), "b": {"c": n(7), "d": n(2, 4, 3)}}


def _flat(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _maxdiff(a, b):
    return max(float(np.max(np.abs(x - y))) for x, y in zip(_flat(a),
                                                            _flat(b)))


def test_lr_schedule_matches_jax():
    rc = RunConfig(lr=1e-3, warmup_steps=5, total_steps=20)
    jrc = JaxRunConfig(lr=1e-3, warmup_steps=5, total_steps=20)
    ours = [float(adamw.lr_schedule(torch.tensor(s, dtype=torch.int32), rc))
            for s in range(25)]
    theirs = [float(jax_adamw.lr_schedule(jnp.int32(s), jrc))
              for s in range(25)]
    assert np.allclose(ours, theirs, rtol=1e-6, atol=1e-10)


@pytest.mark.parametrize("scale", [0.01, 10.0])
def test_clip_matches_jax(scale):
    """Below the clip norm (scale 0.01) nothing changes; above it every
    leaf is scaled by clip / norm."""
    g = _tree(np.random.default_rng(1), scale)
    jg, jn = jax_adamw.clip_by_global_norm(
        jax.tree_util.tree_map(jnp.asarray, g), 1.0)
    tg, tn = adamw.clip_by_global_norm(bridge.from_jax(g, "cpu"), 1.0)
    assert abs(float(tn) - float(jn)) <= 1e-6 * float(jn)
    assert _maxdiff(bridge.to_numpy(tg), jg) <= 1e-6


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_two_updates_match_jax(state_dtype):
    """Two updates from a zero state; the second starts from JAX's AdamW
    state loaded through the bridge (its OptState becomes the port's)."""
    rng = np.random.default_rng(2)
    p, g1, g2 = _tree(rng), _tree(rng, 0.5), _tree(rng, 0.5)
    rc = RunConfig(lr=1e-2, warmup_steps=1, total_steps=4,
                   adam_state_dtype=state_dtype)
    jrc = JaxRunConfig(lr=1e-2, warmup_steps=1, total_steps=4,
                       adam_state_dtype=state_dtype)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    jp1, js1, jm1 = jax_adamw.adamw_update(
        jax.tree_util.tree_map(jnp.asarray, g1),
        jax_adamw.init_opt(jp, jrc), jp, jrc)
    tp = bridge.from_jax(p, "cpu")
    tp1, ts1, tm1 = adamw.adamw_update(bridge.from_jax(g1, "cpu"),
                                       adamw.init_opt(tp, rc), tp, rc)
    assert _maxdiff(bridge.to_numpy(tp1), jp1) <= 1e-6
    assert abs(float(tm1["grad_norm"]) - float(jm1["grad_norm"])) <= 1e-5
    loaded = bridge.from_jax(jax.tree_util.tree_map(np.asarray, js1), "cpu",
                             types={jax_adamw.OptState: adamw.OptState})
    assert isinstance(loaded, adamw.OptState)
    assert int(loaded.count) == 1 and loaded.count.dtype == torch.int32
    jp2, js2, _ = jax_adamw.adamw_update(
        jax.tree_util.tree_map(jnp.asarray, g2), js1, jp1, jrc)
    tp2, ts2, _ = adamw.adamw_update(
        bridge.from_jax(g2, "cpu"), loaded,
        bridge.from_jax(jax.tree_util.tree_map(np.asarray, jp1), "cpu"), rc)
    assert _maxdiff(bridge.to_numpy(tp2), jp2) <= 1e-6
    for ours, theirs in ((ts2.m, js2.m), (ts2.v, js2.v)):
        assert _maxdiff(bridge.to_numpy(ours), theirs) <= 1e-6


@pytest.fixture(scope="module")
def zamba_setup():
    jcfg = jax_get_config("zamba2-2.7b").reduced()
    cfg = get_config("zamba2-2.7b").reduced()
    jmodel = jax_build_model(jcfg, JaxOptions(q_block=16, kv_block=16))
    tree = jax.tree_util.tree_map(np.asarray,
                                  jmodel.init(jax.random.PRNGKey(0)))
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(4, 32)).astype(np.int32)
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, 1)}
    return jmodel, build_model(cfg, Options(q_block=16, kv_block=16)), \
        tree, batch


def _port_step(model, tree, batch, mb):
    rc = RunConfig(total_steps=10, warmup_steps=0, microbatches=mb)
    params = bridge.from_jax(tree, "cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    return make_train_step(model, rc)(params, adamw.init_opt(params, rc), tb)


def _within_two_lr(a, b):
    """max |a - b| <= 2 lr, and the share of elements over 1e-6."""
    d = [np.abs(x - y) for x, y in zip(_flat(a), _flat(b))]
    over = sum(int((x > 1e-6).sum()) for x in d) / sum(x.size for x in d)
    return max(float(x.max()) for x in d) <= 2 * LR * (1 + 1e-3), over


def test_bf16_train_step_matches_jax(zamba_setup):
    jmodel, model, tree, batch = zamba_setup
    jrc = JaxRunConfig(total_steps=10, warmup_steps=0)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    jp1, _, jm = jax.jit(jax_train_step(jmodel, jrc))(
        jp, jax_adamw.init_opt(jp, jrc),
        {k: jnp.asarray(v) for k, v in batch.items()})
    tp1, ts1, tm = _port_step(model, tree, batch, 1)
    assert abs(float(tm["loss"]) - float(jm["loss"])) \
        <= 1e-3 * float(jm["loss"])
    assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) \
        <= 0.02 * float(jm["grad_norm"])
    assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    assert int(ts1.count) == 1
    ok, over = _within_two_lr(bridge.to_numpy(tp1), jp1)
    assert ok and over <= 0.05, over


def test_loss_curve_at_default_lr_matches_jax(zamba_setup):
    """Six bf16 steps on one repeated batch at the drivers' lr 3e-4, warmup
    0: the port's losses follow JAX's within 2 % at every step (they differ
    by <= 0.5 % here, the bf16 drift of two frameworks) and fall at every
    step, as JAX's do at this width."""
    jmodel, model, tree, batch = zamba_setup
    jrc = JaxRunConfig(total_steps=10, warmup_steps=0)
    rc = RunConfig(total_steps=10, warmup_steps=0)
    assert rc.lr == jrc.lr == LR
    jstep = jax.jit(jax_train_step(jmodel, jrc))
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    js, jb = jax_adamw.init_opt(jp, jrc), {k: jnp.asarray(v)
                                          for k, v in batch.items()}
    step = make_train_step(model, rc)
    tp = bridge.from_jax(tree, "cpu")
    ts, tb = adamw.init_opt(tp, rc), {k: torch.from_numpy(v)
                                      for k, v in batch.items()}
    ours, theirs = [], []
    for _ in range(6):
        jp, js, jm = jstep(jp, js, jb)
        tp, ts, tm = step(tp, ts, tb)
        theirs.append(float(jm["loss"]))
        ours.append(float(tm["loss"]))
    for a, b in zip(ours, theirs):
        assert abs(a - b) <= 0.02 * b, (ours, theirs)
    assert all(x > y for x, y in zip(ours, ours[1:])), ours


def test_microbatch_equivalence(zamba_setup):
    _, model, tree, batch = zamba_setup
    p1, _, m1 = _port_step(model, tree, batch, 1)
    p2, _, m2 = _port_step(model, tree, batch, 2)
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-3
    ok, over = _within_two_lr(bridge.to_numpy(p1), bridge.to_numpy(p2))
    assert ok and over <= 0.05, over


@pytest.mark.parametrize("seed", [0, 3])
def test_pipeline_batches_equal_jax(seed):
    """Six steps, enough to refill the buffer several times."""
    ours = list(Pipeline(512, 64, 4, seed=seed).batches(6))
    theirs = list(JaxPipeline(512, 64, 4, seed=seed).batches(6))
    for a, b in zip(ours, theirs):
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype
            assert np.array_equal(a[k], b[k])


def test_train_main_runs_reduced_on_cpu(capsys):
    res = train.main(["--arch", "zamba2-2.7b", "--reduced", "--steps", "3",
                      "--global-batch", "2", "--seq", "32", "--device",
                      "cpu"])
    assert len(res["losses"]) == 3 and np.isfinite(res["losses"]).all()
    assert int(res["opt_state"].count) == 3
    rec = res["records"][-1]
    for key in ("loss", "grad_norm", "step_ms", "fwd_ms", "bwd_ms", "opt_ms",
                "tokens_per_s"):
        assert np.isfinite(rec[key])
    out = capsys.readouterr().out
    assert "[train] step 3 loss" in out and "tokens/s" in out


@pytest.mark.parametrize("argv", [["--remat", "full"],
                                  ["--ckpt-dir", "ckpts"], ["--resume"]])
def test_train_main_refuses_what_is_not_ported(argv):
    with pytest.raises(NotImplementedError):
        train.main(["--arch", "zamba2-2.7b", "--reduced", "--device", "cpu",
                    *argv])


def test_train_flags_and_build_match_jax():
    from repro.launch import train as jax_train
    args = train.parse_args(["--arch", "zamba2-2.7b", "--reduced",
                             "--steps", "30", "--seq", "64"])
    assert args.device == "cuda"
    cfg, model, rc = train.build(args)
    jcfg, jmodel, jrc = jax_train.build(args)
    assert (cfg.n_layers, cfg.d_model, cfg.ssm.chunk) == (
        jcfg.n_layers, jcfg.d_model, jcfg.ssm.chunk)
    assert (model.opts.q_block, model.opts.kv_block) == (
        jmodel.opts.q_block, jmodel.opts.kv_block)
    assert (rc.warmup_steps, rc.total_steps, rc.lr) == (
        jrc.warmup_steps, jrc.total_steps, jrc.lr)
