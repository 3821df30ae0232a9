"""Flash attention: the CUDA kernel for tensors on the card, the plain
blockwise version for tensors on the CPU.  Nothing falls back: a CUDA tensor
launches the kernel or raises.

On the card the kernel's output carries a gradient: the backward recomputes
the plain blockwise version from the saved q, k, v and differentiates it.
The JAX package has no attention backward kernel either; its training
differentiates the same blockwise function by autodiff."""
from __future__ import annotations

import functools

from repro_torch.kernels import count_launch
from repro_torch.kernels._recompute import recompute
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import (flash_attention_blockwise,
                                                     flash_attention_ref)


def flash_attention(q, k, v, *, causal: bool = True, window=None,
                    logit_softcap: float = 0.0, scale: float,
                    q_block: int = 1024, kv_block: int = 1024,
                    probs_bf16: bool = False):
    """Attention. q (B,S,Hq,hd), k (B,T,G,hd), v (B,T,G,hd_v) ->
    (B,S,Hq,hd_v); T may differ from S (cross-attention).

    causal: the mask t <= s (False: every key, as whisper's encoder and
    cross-attention).  window: None or an int > 0 (s - t < window).  Both
    are runtime values, so every layer shares one compiled kernel.
    probs_bf16: P rounded to V's type before P.V, the JAX model's knob.
    q_block / kv_block size the plain version's blocks, on the CPU and in
    the card's backward.  `flash_attention.launches` counts kernel
    launches."""
    kw = dict(causal=causal, window=window, logit_softcap=logit_softcap,
              scale=scale, q_block=q_block, kv_block=kv_block,
              probs_bf16=probs_bf16)
    if q.device.type == "cpu":
        return flash_attention_blockwise(q, k, v, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    out = recompute(
        functools.partial(flash_attention_cuda, causal=causal,
                          window=window, logit_softcap=logit_softcap,
                          scale=scale, probs_bf16=probs_bf16),
        functools.partial(flash_attention_blockwise, **kw), q, k, v)
    count_launch(flash_attention)
    return out


flash_attention.launches = 0

__all__ = ["flash_attention", "flash_attention_blockwise",
           "flash_attention_ref"]
