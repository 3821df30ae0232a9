"""Train step: loss -> grads (optionally microbatched) -> AdamW.

The loss is the JAX package's `loss + aux`: the cross-entropy plus the
router's aux loss summed over a MoE model's layers (`Model.forward(...,
return_aux=True)`; an fp32 0 for every other model), reported as "xent"
and "moe_aux".  As in the JAX package, the microbatched path reports the
mean total loss as "xent" and 0 as "moe_aux".
"""
from __future__ import annotations

import time

import torch

from repro_torch.models.common import softmax_xent, tree_leaves, tree_map
from repro_torch.optim.adamw import OptState, adamw_update, init_opt


def make_loss_fn(model):
    cfg = model.cfg

    def loss_fn(params, batch):
        logits, aux = model.forward(params, batch, return_aux=True)
        loss = softmax_xent(logits, batch["labels"], cfg.vocab_size)
        return loss + aux, {"xent": loss, "moe_aux": aux}

    return loss_fn


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def value_and_grad(loss_fn, params, batch, timings=None):
    """(loss, aux), grads of `loss_fn` at `params`.  With `timings`, adds
    the forward and backward seconds (device synchronised) to "fwd_s" and
    "bwd_s"."""
    leaves = tree_leaves(params)
    device = leaves[0].device
    t0 = _sync(device) if timings is not None else 0.0
    with torch.enable_grad():
        diff = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss, aux = loss_fn(diff, batch)
        if timings is not None:
            t1 = _sync(device)
            timings["fwd_s"] = timings.get("fwd_s", 0.0) + t1 - t0
        flat = torch.autograd.grad(loss, tree_leaves(diff))
    if timings is not None:
        timings["bwd_s"] = timings.get("bwd_s", 0.0) + _sync(device) - t1
    it = iter(flat)
    grads = tree_map(lambda _: next(it), params)
    return (loss.detach(), {k: v.detach() for k, v in aux.items()}), grads


def _microbatch(v, n_mb: int, i: int, axis: int = 0):
    """Rows of microbatch i of n_mb along the batch axis `axis`: the i-th
    contiguous block of the batch's rows, as the reference's reshape takes
    them.  On a DTensor the block keeps v's placements: a batch split over
    the devices holds block i on some of them only, so its rows are
    gathered first and each device keeps its share."""
    b = v.shape[axis] // n_mb
    mb = v.narrow(axis, i * b, b)
    if hasattr(v, "device_mesh"):
        mb = mb.redistribute(v.device_mesh, v.placements)
    return mb


def make_train_step(model, rc):
    """Returns train_step(params, opt_state, batch, timings=None) ->
    (params, opt_state, metrics).  Params and moments are updated in place.
    With a `timings` dict, it is filled with fwd_s, bwd_s and opt_s."""
    loss_fn = make_loss_fn(model)
    n_mb = rc.microbatches
    acc_dtype = torch.bfloat16 if rc.grad_compress == "bf16" \
        else torch.float32

    def train_step(params, opt_state: OptState, batch, timings=None):
        if n_mb == 1:
            (loss, aux), grads = value_and_grad(loss_fn, params, batch,
                                                timings)
        else:
            grads, loss = None, 0.0
            for i in range(n_mb):
                # mrope_positions carries the batch on axis 1 ((3, B, S))
                mb = {k: _microbatch(v, n_mb, i,
                                     1 if k == "mrope_positions" else 0)
                      for k, v in batch.items()}
                (l, _), g = value_and_grad(loss_fn, params, mb, timings)
                g = tree_map(lambda x: x.to(acc_dtype), g)
                grads = g if grads is None else tree_map(torch.add, grads, g)
                loss = loss + l
            grads = tree_map(lambda g: g / n_mb, grads)
            loss = loss / n_mb
            aux = {"xent": loss, "moe_aux": torch.zeros_like(loss)}
        t0 = _sync(loss.device) if timings is not None else 0.0
        params, opt_state, opt_metrics = adamw_update(grads, opt_state,
                                                      params, rc)
        if timings is not None:
            timings["opt_s"] = _sync(loss.device) - t0
        metrics = {"loss": loss, **aux, **opt_metrics}
        return params, opt_state, metrics

    return train_step


def init_train_state(model, rc, generator, device="cuda"):
    params = model.init(generator, device)
    return params, init_opt(params, rc)
