"""A kernel op that carries a gradient: the forward is the hand-written
kernel, the backward recomputes the plain version from the saved inputs
under `enable_grad` and differentiates it.  The gradient is therefore the
plain version's own; the kernel's output is never read by the backward."""
from __future__ import annotations

import torch


class _Recompute(torch.autograd.Function):

    @staticmethod
    def forward(ctx, kernel, plain, *ins):
        ctx.save_for_backward(*ins)
        ctx.plain = plain
        return kernel(*ins)

    @staticmethod
    def backward(ctx, g):
        ins = [t.detach().requires_grad_(t.requires_grad)
               for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = ctx.plain(*ins).to(g.dtype)
            wrt = [t for t in ins if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wrt, g))
        return (None, None,
                *(next(grads) if t.requires_grad else None for t in ins))


def recompute(kernel, plain, *ins):
    """`kernel(*ins)`, with the gradient of `plain(*ins)`.  `kernel` and
    `plain` take the tensors `ins` only; bind other arguments beforehand."""
    return _Recompute.apply(kernel, plain, *ins)


__all__ = ["recompute"]
