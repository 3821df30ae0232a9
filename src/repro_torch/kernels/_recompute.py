"""A kernel op that carries a gradient: the forward is the hand-written
kernel, the backward recomputes the plain version from the saved inputs
under `enable_grad` and differentiates it.  The gradient is therefore the
plain version's own; the kernel's output is never read by the backward.

An op may return one tensor or a tuple of them (WKV returns y and the final
state).  The backward differentiates the plain version against each output
that received a cotangent; an output nothing used gets none and is left
out."""
from __future__ import annotations

import torch


class _Recompute(torch.autograd.Function):

    @staticmethod
    def forward(ctx, kernel, plain, *ins):
        ctx.save_for_backward(*ins)
        ctx.plain = plain
        ctx.set_materialize_grads(False)
        return kernel(*ins)

    @staticmethod
    def backward(ctx, *gs):
        ins = [t.detach().requires_grad_(t.requires_grad)
               for t in ctx.saved_tensors]
        with torch.enable_grad():
            outs = ctx.plain(*ins)
            if isinstance(outs, torch.Tensor):
                outs = (outs,)
            used = [(o.to(g.dtype), g) for o, g in zip(outs, gs)
                    if g is not None]
            wrt = [t for t in ins if t.requires_grad]
            grads = torch.autograd.grad([o for o, _ in used], wrt,
                                        [g for _, g in used],
                                        allow_unused=True)
        grads = iter(grads)
        return (None, None,
                *(next(grads) if t.requires_grad else None for t in ins))


def recompute(kernel, plain, *ins):
    """`kernel(*ins)`, with the gradient of `plain(*ins)`.  `kernel` and
    `plain` take the tensors `ins` only and return a tensor or a tuple of
    tensors alike; bind other arguments beforehand."""
    return _Recompute.apply(kernel, plain, *ins)


__all__ = ["recompute"]
