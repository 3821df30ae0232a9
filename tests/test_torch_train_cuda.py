"""Training on the card: the WKV op's gradient, remat's launch counts and a
checkpoint of CUDA tensors, with the kernels of csrc/.

Needs an NVIDIA Hopper card and nvcc: the kernels have no CPU mode, so these
tests skip elsewhere.  Run on the card with
``PYTHONPATH=src python -m pytest -q --noconftest -m cuda
tests/test_torch_train_cuda.py``.
This file imports no JAX, so it runs where JAX is not installed."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import Pipeline  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ops as wkv_ops  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ref as wkv_ref  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models.common import Options, tree_leaves  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.runtime.train_step import (make_loss_fn,  # noqa: E402
                                            value_and_grad)

# gradients through the op vs autograd through the plain version: the
# op's backward is that autograd itself, rerun, so only the forward
# differs, and it is not read by the backward
GRAD_TOL = 1e-5
# the kernel's outputs vs the plain version's, relative to max(1, max
# |plain|): fp32, summation order only (as tests/test_torch_wkv6_cuda.py)
WKV_TOL = 1e-5


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


def _wkv_inputs(B, S, H, hd, decay):
    rng = np.random.default_rng(0)
    n = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).cuda()
    return [n(B, S, H, hd) * 0.5, n(B, S, H, hd) * 0.5, n(B, S, H, hd),
            -torch.exp(n(B, S, H, hd) * 0.5 + decay), n(H, hd) * 0.1]


@pytest.mark.cuda
@pytest.mark.parametrize("decay", [-1.0, 1.0])
def test_wkv6_op_gradient_at_rwkv6_width(decay):
    """rwkv6-1.6b's training shape (2, 1024, 32, 64), chunk 64, y used and
    the final state unused, as in training: the op's outputs under
    autograd (the kernel's) against the plain version's within WKV_TOL,
    and its gradients (the recompute of the plain version) against plain
    autograd within GRAD_TOL."""
    _card()
    ins = _wkv_inputs(2, 1024, 32, 64, decay)
    a = [t.clone().requires_grad_() for t in ins]
    b = [t.clone().requires_grad_() for t in ins]
    before = wkv_ops.wkv6.launches
    y, st = wkv_ops.wkv6(*a, chunk=64)
    assert wkv_ops.wkv6.launches == before + 1
    py, ps = wkv_ref.wkv6_chunked(*b, chunk=64)
    for out, plain in ((y, py), (st, ps)):
        assert bool(torch.isfinite(out).all())
        assert float((out - plain).abs().max()) <= WKV_TOL * max(
            1.0, float(plain.abs().max()))
    g = torch.randn_like(y)
    ga = torch.autograd.grad(y, a, g)
    gb = torch.autograd.grad(py, b, g)
    for x, z in zip(ga, gb):
        assert bool(torch.isfinite(x).all())
        assert float((x - z).abs().max()) <= GRAD_TOL * max(
            1.0, float(z.abs().max()))


def _reduced(arch, remat="none"):
    cfg = get_config(arch).reduced()
    model = build_model(cfg, Options(q_block=64, kv_block=64, remat=remat))
    params = model.init(torch.Generator("cuda").manual_seed(0), "cuda")
    batch = train.to_device(next(Pipeline(cfg.vocab_size, 64, 2)
                                 .batches(1)), "cuda")
    return model, params, batch


@pytest.mark.cuda
@pytest.mark.parametrize("remat,per_layer", [("none", 1), ("dots", 2),
                                             ("full", 2)])
def test_remat_launch_counts_and_gradients(remat, per_layer):
    """Reduced gemma2 (2 layers): one flash op call a layer, two under
    remat (the forward and its rerun); the loss and gradients equal the
    run without remat within fp32 summation order."""
    _card()
    model, params, batch = _reduced("gemma2-2b", remat)
    fa_ops.flash_attention.launches = 0
    (loss, _), grads = value_and_grad(make_loss_fn(model), params, batch)
    assert fa_ops.flash_attention.launches == per_layer * model.cfg.n_layers
    (loss0, _), grads0 = value_and_grad(
        make_loss_fn(model.with_opts(remat="none")), params, batch)
    assert abs(float(loss) - float(loss0)) <= 1e-5 * abs(float(loss0))
    for x, z in zip(tree_leaves(grads), tree_leaves(grads0)):
        assert float((x - z).abs().max()) <= 1e-3 * max(
            1e-30, float(z.abs().max()))


@pytest.mark.cuda
def test_rwkv6_train_step_launches_one_wkv_a_layer():
    _card()
    model, params, batch = _reduced("rwkv6-1.6b")
    wkv_ops.wkv6.launches = 0
    (loss, _), grads = value_and_grad(make_loss_fn(model), params, batch)
    assert wkv_ops.wkv6.launches == model.cfg.n_layers
    assert np.isfinite(float(loss))
    assert all(bool(torch.isfinite(g).all()) for g in tree_leaves(grads))


@pytest.mark.cuda
def test_checkpoint_of_card_tensors_restores_onto_the_card(tmp_path):
    _card()
    from repro_torch.optim.adamw import init_opt
    from repro_torch.configs import RunConfig
    _, params, _ = _reduced("gemma2-2b")
    opt = init_opt(params, RunConfig(adam_state_dtype="bfloat16"))
    for t in tree_leaves(opt.m):
        t.normal_()
    tree = {"params": params, "opt": opt}
    before = [t.clone() for _, t in ckpt._items(tree)]
    c = ckpt.AsyncCheckpointer(str(tmp_path))
    c.save(4, tree)
    for t in tree_leaves(params):
        t.add_(1.0)                     # in place, as the train step does
    c.wait()
    ptrs = [t.data_ptr() for _, t in ckpt._items(tree)]
    back = ckpt.restore(tmp_path, 4, tree)      # into the card's tensors
    assert back is tree
    for (key, x), want, ptr in zip(ckpt._items(back), before, ptrs):
        assert x.device == want.device and x.dtype == want.dtype, key
        assert x.data_ptr() == ptr and torch.equal(x, want), key
