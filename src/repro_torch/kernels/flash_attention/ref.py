"""Plain PyTorch versions of the flash-attention function.

`flash_attention_blockwise` is the port of the JAX model's blockwise online
softmax (src/repro/models/attention.py `flash_attention`): the path tensors on
the CPU take, and what the CUDA kernel is held against on the card.
`flash_attention_ref` is the one-shot masked-softmax oracle.
"""
from __future__ import annotations

import torch

from repro_torch.models.common import softcap

NEG_INF = -2.0e38


def expand_kv(k, hq: int):
    """(B,T,G,hd) -> (B,T,Hq,hd) by repeating each group Hq/G times
    (head h reads group h // (Hq/G))."""
    return k.repeat_interleave(hq // k.shape[2], dim=2)


def flash_attention_blockwise(q, k, v, *, window=None,
                              logit_softcap: float = 0.0, scale: float,
                              q_block: int = 1024, kv_block: int = 1024):
    """Causal blockwise attention with online softmax.

    q: (B, S, Hq, hd); k, v: (B, T, G, hd) with G dividing Hq. Returns
    (B, S, Hq, hd) in q's dtype.  Q.K^T and P.V run in fp32 (products of
    bf16 inputs are exact in fp32), as the kernel does.  KV blocks wholly
    outside the causal and window band are skipped; they would contribute
    exactly nothing.
    """
    B, S, H, hd = q.shape
    T = k.shape[1]
    qb, kb = min(q_block, S), min(kv_block, T)
    qf = q.float().transpose(1, 2)                        # (B,H,S,hd)
    kf = expand_kv(k, H).float().transpose(1, 2)          # (B,H,T,hd)
    vf = expand_kv(v, H).float().transpose(1, 2)
    out = torch.empty((B, H, S, v.shape[-1]), dtype=torch.float32,
                      device=q.device)
    for i0 in range(0, S, qb):
        i1 = min(i0 + qb, S)
        qpos = torch.arange(i0, i1, device=q.device)
        qi = qf[:, :, i0:i1]
        m = torch.full((B, H, i1 - i0), NEG_INF, device=q.device)
        l = torch.zeros((B, H, i1 - i0), device=q.device)
        acc = torch.zeros((B, H, i1 - i0, v.shape[-1]), device=q.device)
        for j0 in range(0, T, kb):
            j1 = min(j0 + kb, T)
            if j0 > i1 - 1:                                  # causal band
                break
            if window is not None and j1 - 1 < i0 - window + 1:
                continue                                     # window band
            kpos = torch.arange(j0, j1, device=q.device)
            s = torch.matmul(qi, kf[:, :, j0:j1].transpose(-1, -2)) * scale
            s = softcap(s, logit_softcap)
            allow = qpos[:, None] >= kpos[None, :]
            if window is not None:
                allow &= (qpos[:, None] - kpos[None, :]) < window
            s = torch.where(allow, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            prob = torch.exp(s - m_new[..., None])
            l = l * alpha + prob.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.matmul(prob, vf[:, :, j0:j1])
            m = m_new
        out[:, :, i0:i1] = acc / torch.clamp(l, min=1e-37)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def flash_attention_ref(q, k, v, *, causal: bool = True, window=None,
                        logit_softcap: float = 0.0, scale: float = None):
    """q/k/v: (B, H, S, hd) -> (B, H, S, hd). One-shot masked softmax."""
    B, H, S, hd = q.shape
    scale = scale if scale is not None else hd ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    s = softcap(s, logit_softcap)
    pos = torch.arange(S, device=q.device)
    allow = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        allow &= pos[:, None] >= pos[None, :]
    if window is not None:
        allow &= (pos[:, None] - pos[None, :]) < window
    s = torch.where(allow, s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return out.to(q.dtype)
