"""Port parity for training the dense and recurrent families, reduced
gemma2-2b (2 layers, one local and one global, window 16) and reduced
rwkv6-1.6b (2 layers, WKV chunk 16), against the JAX package, with JAX's
params loaded through the bridge and seeded numpy batches of 4 x 32.

- One bf16 train step: loss within 1e-3 relative, grad norm within 2 %,
  updated params within 2 * lr with at most 5 % of the elements over 1e-6,
  the tolerances of tests/test_torch_train.py's zamba2 step (bf16 rounds at
  other places in the two frameworks).
- One fp32 forward and backward on params perturbed off JAX's init (so
  that no gradient is zero by symmetry): every gradient leaf within 1e-4 of
  JAX's, relative to max(1, max |JAX|): fp32 with the same formulas, so
  only summation order differs.
- Six bf16 steps on one repeated batch at lr 3e-4: the loss curve follows
  JAX's within 2 % at every step.
- Remat: "none", "dots" and "full" give the same fp32 loss and gradients
  within 1e-6 (the same ops, rerun); a bf16 step with "full" on both sides
  holds the step test's tolerances; rwkv6 ignores the option, as in JAX.
- The recompute op with two outputs (the WKV op's form on the card):
  gradients equal plain autograd with either output unused, also under
  both remat policies.
- Resume: the port resumes JAX's own checkpoint and follows JAX's resumed
  run within 2 %; a port resume restores params and moments bit for bit."""
import functools
import shutil
from unittest import mock

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import RunConfig as JaxRunConfig  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch import train as jax_train  # noqa: E402
from repro.models import rwkv as jrwkv  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.common import Options as JaxOptions  # noqa: E402
from repro.models.common import softmax_xent as jax_xent  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.runtime.train_step import make_train_step as jax_train_step  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.configs import RunConfig, get_config  # noqa: E402
from repro_torch.kernels._recompute import recompute  # noqa: E402
from repro_torch.kernels.rwkv6_scan.ref import wkv6_chunked  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models.common import (Options, maybe_remat,  # noqa: E402
                                       softmax_xent)
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime.train_step import (make_train_step,  # noqa: E402
                                            value_and_grad)

LR = 3e-4
ARCHS = ["gemma2-2b", "rwkv6-1.6b"]
JAX_MODULES = {"gemma2-2b": jtf, "rwkv6-1.6b": jrwkv}
FP32_GRAD_TOL = 1e-4
REMAT_TOL = 1e-6


def _flat(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _within_two_lr(a, b):
    """max |a - b| <= 2 lr, and the share of elements over 1e-6."""
    d = [np.abs(x - y) for x, y in zip(_flat(a), _flat(b))]
    over = sum(int((x > 1e-6).sum()) for x in d) / sum(x.size for x in d)
    return max(float(x.max()) for x in d) <= 2 * LR * (1 + 1e-3), over


def _setup(arch, remat="none"):
    jcfg = jax_get_config(arch).reduced()
    cfg = get_config(arch).reduced()
    jmodel = jax_build_model(jcfg, JaxOptions(q_block=16, kv_block=16,
                                              remat=remat))
    model = build_model(cfg, Options(q_block=16, kv_block=16, remat=remat))
    tree = jax.tree_util.tree_map(np.asarray,
                                  jmodel.init(jax.random.PRNGKey(0)))
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(4, 32)).astype(np.int32)
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, 1)}
    return jmodel, model, tree, batch


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    return _setup(request.param)


def _steps(jmodel, model, tree, batch, n):
    """n bf16 steps of both frameworks on one repeated batch; returns each
    side's (params, state, metrics list)."""
    jrc = JaxRunConfig(total_steps=10, warmup_steps=0)
    rc = RunConfig(total_steps=10, warmup_steps=0)
    jstep = jax.jit(jax_train_step(jmodel, jrc))
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    js, jb = jax_adamw.init_opt(jp, jrc), {k: jnp.asarray(v)
                                          for k, v in batch.items()}
    step = make_train_step(model, rc)
    tp = bridge.from_jax(tree, "cpu")
    ts, tb = adamw.init_opt(tp, rc), {k: torch.from_numpy(v)
                                      for k, v in batch.items()}
    jms, tms = [], []
    for _ in range(n):
        jp, js, jm = jstep(jp, js, jb)
        tp, ts, tm = step(tp, ts, tb)
        jms.append(jm)
        tms.append(tm)
    return (jp, js, jms), (tp, ts, tms)


def _assert_step_matches(jm, tm):
    assert abs(float(tm["loss"]) - float(jm["loss"])) \
        <= 1e-3 * float(jm["loss"])
    assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) \
        <= 0.02 * float(jm["grad_norm"])
    assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)


def test_bf16_train_step_matches_jax(setup):
    (jp, _, (jm,)), (tp, ts, (tm,)) = _steps(*setup, 1)
    _assert_step_matches(jm, tm)
    assert int(ts.count) == 1
    ok, over = _within_two_lr(bridge.to_numpy(tp), jp)
    assert ok and over <= 0.05, over


def test_loss_curve_at_default_lr_matches_jax(setup):
    (_, _, jms), (_, _, tms) = _steps(*setup, 6)
    theirs = [float(m["loss"]) for m in jms]
    ours = [float(m["loss"]) for m in tms]
    for a, b in zip(ours, theirs):
        assert abs(a - b) <= 0.02 * b, (ours, theirs)
    assert all(x > y for x, y in zip(ours, ours[1:])), ours


def _perturbed(tree, seed=3):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: (x + 0.05 * rng.standard_normal(x.shape)).astype(x.dtype),
        tree)


def _port_fp32_grads(model, tree, batch):
    cfg = model.cfg

    def loss_fn(p, b):
        logits = model.forward(p, b, dtype=torch.float32)
        return softmax_xent(logits, b["labels"], cfg.vocab_size), {}

    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    (loss, _), grads = value_and_grad(loss_fn, bridge.from_jax(tree, "cpu"),
                                      tb)
    return float(loss), grads


def test_fp32_gradients_match_jax(setup):
    jmodel, model, tree, batch = setup
    tree = _perturbed(tree)
    mod, jcfg = JAX_MODULES[model.cfg.name], jmodel.cfg

    def jloss(p):
        logits, _ = mod.forward(p, jcfg, jnp.asarray(batch["tokens"]),
                                opts=jmodel.opts, dtype=jnp.float32)
        return jax_xent(logits, jnp.asarray(batch["labels"]),
                        jcfg.vocab_size)

    jl, jg = jax.value_and_grad(jloss)(
        jax.tree_util.tree_map(jnp.asarray, tree))
    loss, grads = _port_fp32_grads(model, tree, batch)
    assert abs(loss - float(jl)) <= 1e-5 * float(jl)
    ours = bridge.to_numpy(grads)
    paths = jax.tree_util.tree_flatten_with_path(jg)[0]
    for (path, theirs), mine in zip(paths, _flat(ours)):
        err = float(np.max(np.abs(mine - np.asarray(theirs))))
        assert err <= FP32_GRAD_TOL * max(1.0, float(np.max(np.abs(
            theirs)))), (jax.tree_util.keystr(path), err)


@pytest.mark.parametrize("remat", ["dots", "full"])
def test_remat_gives_the_same_fp32_gradients(remat):
    jmodel, model, tree, batch = _setup("gemma2-2b")
    tree = _perturbed(tree)
    loss0, g0 = _port_fp32_grads(model, tree, batch)
    loss1, g1 = _port_fp32_grads(model.with_opts(remat=remat), tree, batch)
    assert abs(loss1 - loss0) <= REMAT_TOL * abs(loss0)
    for a, b in zip(_flat(bridge.to_numpy(g1)), _flat(bridge.to_numpy(g0))):
        assert float(np.max(np.abs(a - b))) <= REMAT_TOL * max(
            1.0, float(np.max(np.abs(b))))


@pytest.mark.parametrize("remat,calls", [("none", 2), ("dots", 4),
                                          ("full", 4)])
def test_remat_reruns_each_block_in_the_backward(remat, calls):
    """Reduced gemma2 has 2 blocks: under remat each runs again in the
    backward, so the remat tests above compare two real paths."""
    from repro_torch.models import transformer
    _, model, tree, batch = _setup("gemma2-2b", remat)
    real, n = transformer.apply_block, []

    def counted(*a, **kw):
        n.append(1)
        return real(*a, **kw)
    with mock.patch.object(transformer, "apply_block", counted):
        _port_fp32_grads(model, tree, batch)
    assert len(n) == calls


def test_remat_full_step_matches_jax_full():
    (jp, _, (jm,)), (tp, _, (tm,)) = _steps(*_setup("gemma2-2b", "full"), 1)
    _assert_step_matches(jm, tm)
    ok, over = _within_two_lr(bridge.to_numpy(tp), jp)
    assert ok and over <= 0.05, over


def test_rwkv6_ignores_remat_as_jax_does():
    _, model, tree, batch = _setup("rwkv6-1.6b")
    loss0, g0 = _port_fp32_grads(model, tree, batch)
    loss1, g1 = _port_fp32_grads(model.with_opts(remat="full"), tree, batch)
    assert loss0 == loss1
    for a, b in zip(_flat(bridge.to_numpy(g1)), _flat(bridge.to_numpy(g0))):
        assert np.array_equal(a, b)


def test_maybe_remat_refuses_an_unknown_policy():
    with pytest.raises(ValueError, match="remat"):
        maybe_remat(lambda x: x, "everything")
    fn = lambda x: x  # noqa: E731
    assert maybe_remat(fn, "none") is fn


def _wkv_inputs(seed=0, B=2, S=32, H=2, hd=8):
    rng = np.random.default_rng(seed)
    n = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    return [n(B, S, H, hd) * 0.5, n(B, S, H, hd) * 0.5, n(B, S, H, hd),
            -torch.exp(n(B, S, H, hd) * 0.5 - 1.0), n(H, hd) * 0.1,
            n(B, H, hd, hd)]


@pytest.mark.parametrize("remat", ["none", "dots", "full"])
@pytest.mark.parametrize("used", ["y", "state", "both"])
def test_recompute_with_two_outputs_matches_autograd(remat, used):
    """The op form the WKV takes on the card, with the plain version in the
    kernel's place: the gradient of the outputs used (an unused output gets
    no cotangent) against autograd through the plain version itself."""
    plain = functools.partial(
        lambda r, k, v, w, u, s, *, chunk: wkv6_chunked(
            r, k, v, w, u, chunk=chunk, initial_state=s), chunk=8)

    def loss(fn, ins):
        y, s = fn(*[t * 1.0 for t in ins])
        return {"y": (y * y).sum(), "state": s.sum(),
                "both": (y * y).sum() + s.sum()}[used]

    ins = _wkv_inputs()
    a = [t.clone().requires_grad_() for t in ins]
    b = [t.clone().requires_grad_() for t in ins]
    op = maybe_remat(lambda *t: loss(
        lambda *x: recompute(plain, plain, *x), t), remat)
    # r does not reach the final state: its gradient is None on both sides
    ga = torch.autograd.grad(op(*a), a, allow_unused=True)
    gb = torch.autograd.grad(loss(plain, b), b, allow_unused=True)
    assert [x is None for x in ga] == [y is None for y in gb]
    assert (ga[0] is None) == (used == "state")
    for x, y in zip(ga, gb):
        if y is not None:
            assert float((x - y).abs().max()) <= 1e-6 * max(1.0, float(
                y.abs().max()))


def test_train_build_passes_remat_as_jax():
    args = train.parse_args(["--arch", "gemma2-2b", "--reduced", "--remat",
                             "dots", "--seq", "64"])
    _, model, rc = train.build(args)
    _, jmodel, jrc = jax_train.build(args)
    assert model.opts.remat == jmodel.opts.remat == rc.remat == "dots"


CPU_ARGV = ["--reduced", "--global-batch", "2", "--seq", "32", "--device",
            "cpu"]


@pytest.mark.parametrize("extra", [[], ["--remat", "full"],
                                   ["--remat", "dots"]])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_main_runs_reduced_on_cpu(arch, extra, capsys):
    res = train.main(["--arch", arch, "--steps", "3", *CPU_ARGV, *extra])
    assert len(res["losses"]) == 3 and np.isfinite(res["losses"]).all()
    assert int(res["opt_state"].count) == 3 and res["start_step"] == 0
    out = capsys.readouterr().out
    assert "[train] step 3 loss" in out


def _spy_restore(store):
    """Wraps ckpt.restore, keeping a host copy of what it returned (the
    train step then updates it in place)."""
    real = ckpt.restore

    def spy(*a, **kw):
        tree = real(*a, **kw)
        store.append(jax.tree_util.tree_map(
            lambda t: t.detach().clone(), tree))
        return tree
    return spy


def _assert_equals_npz(tree, step_dir):
    with np.load(step_dir / "arrays.npz") as data:
        items = list(ckpt._items(tree))
        assert sorted(k for k, _ in items) == sorted(data.files)
        for key, t in items:
            assert t.numpy().tobytes() == data[key].tobytes(), key


@pytest.mark.parametrize("arch", ARCHS)
def test_resume_restores_bit_for_bit(arch, tmp_path, capsys):
    d = tmp_path / "ckpts"
    first = train.main(["--arch", arch, "--steps", "4", "--ckpt-dir",
                        str(d), "--ckpt-every", "2", *CPU_ARGV])
    assert ckpt.latest_step(d) == 4
    _assert_equals_npz({"opt": first["opt_state"],
                        "params": first["params"]}, d / "step_00000004")
    seen = []
    with mock.patch.object(train.ckpt, "restore", _spy_restore(seen)):
        res = train.main(["--arch", arch, "--steps", "6", "--ckpt-dir",
                          str(d), "--ckpt-every", "2", "--resume",
                          *CPU_ARGV])
    assert "[train] resumed from step 4" in capsys.readouterr().out
    assert res["start_step"] == 4 and len(res["losses"]) == 2
    assert np.isfinite(res["losses"]).all()
    assert int(res["opt_state"].count) == 6
    _assert_equals_npz(seen[0], d / "step_00000004")
    assert ckpt.latest_step(d) == 6


def test_resume_from_jax_checkpoint_follows_jax(tmp_path, capsys):
    """JAX trains reduced gemma2 4 steps with checkpoints; then JAX and the
    port each resume from that checkpoint (the port from a copy) to step 6,
    both on a fresh pipeline.  The port's resumed losses follow JAX's
    within 2 %."""
    jd, td = tmp_path / "jax", tmp_path / "port"
    common = ["--arch", "gemma2-2b", "--reduced", "--global-batch", "2",
              "--seq", "32", "--ckpt-every", "2"]
    jax_train.main([*common, "--steps", "4", "--ckpt-dir", str(jd)])
    shutil.copytree(jd, td)
    theirs = jax_train.main([*common, "--steps", "6", "--ckpt-dir", str(jd),
                             "--resume"])
    seen = []
    with mock.patch.object(train.ckpt, "restore", _spy_restore(seen)):
        res = train.main([*common, "--steps", "6", "--ckpt-dir", str(td),
                          "--resume", "--device", "cpu"])
    assert "[train] resumed from step 4" in capsys.readouterr().out
    _assert_equals_npz(seen[0], td / "step_00000004")
    ours = res["losses"]
    assert len(ours) == len(theirs) == 2
    for a, b in zip(ours, theirs):
        assert abs(a - b) <= 0.02 * b, (ours, theirs)
