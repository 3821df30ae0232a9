"""Train step: loss -> grads (optionally microbatched) -> AdamW.

The port's `forward` returns logits only; the dense and hybrid models have
no auxiliary loss, so the loss function takes aux = 0 as the JAX versions
of those models return it.  A MoE model's loss would add the router's aux
loss (the JAX package's `loss + aux`), and its MLA prefill would need the
flash backward at head dims 192/128: the loss function refuses MoE and MLA
configs until that training is ported (ROADMAP.md Queue 1, "MoE and MLA
training").
"""
from __future__ import annotations

import time

import torch

from repro_torch.models.common import softmax_xent, tree_leaves, tree_map
from repro_torch.optim.adamw import OptState, adamw_update, init_opt


def make_loss_fn(model):
    cfg = model.cfg
    if cfg.moe is not None or cfg.mla is not None:
        raise NotImplementedError(
            f"{cfg.name}: MoE and MLA training is not ported (ROADMAP.md "
            f"Queue 1, \"MoE and MLA training\"): the MoE aux loss would "
            f"be dropped")

    def loss_fn(params, batch):
        logits = model.forward(params, batch)
        loss = softmax_xent(logits, batch["labels"], cfg.vocab_size)
        aux = torch.zeros((), dtype=torch.float32, device=loss.device)
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
                mb = {k: v.reshape((n_mb, v.shape[0] // n_mb) + v.shape[1:])[i]
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
