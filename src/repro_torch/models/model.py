"""Uniform model API.

    model = build_model(cfg)
    params = model.init(torch.Generator("cuda").manual_seed(0), "cuda")
    logits = model.forward(params, batch)                         # train
    logits, aux = model.forward(params, batch, return_aux=True)   # train
    logits, cache = model.forward(params, batch, mode="prefill")
    logits, cache = model.decode_step(params, tokens, pos, cache)
    cache = model.init_cache(batch, max_len, device="cuda")
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.models import rwkv, transformer, whisper, zamba
from repro_torch.models.common import Options


@dataclass
class Model:
    cfg: Any
    opts: Options
    _mod: Any

    def init(self, generator: torch.Generator, device="cuda"):
        """fp32 params made on `device` from `generator` (which must lie on
        the same device)."""
        return self._mod.init_lm(generator, self.cfg, device)

    def forward(self, params, batch: dict, mode: str = "train", cache=None,
                dtype=torch.bfloat16, return_aux: bool = False):
        """Train: logits, or with return_aux (logits, aux loss), the aux
        loss the MoE layers' router loss (an fp32 0 for every other
        model).  Prefill: (last-position logits, cache).  An audio model
        (whisper) reads batch["encoder_frames"] (B, F, d_model)."""
        kw = {}
        if self.cfg.mrope and "mrope_positions" in batch:
            kw["mrope_positions"] = batch["mrope_positions"]
        if self.cfg.family == "audio":
            kw["encoder_frames"] = batch["encoder_frames"]
        train_aux = return_aux and mode == "train"
        if train_aux and self.cfg.moe is not None:
            kw["return_aux"] = True                  # the transformer's
        out = self._mod.forward(params, self.cfg, batch["tokens"],
                                opts=self.opts, mode=mode, dtype=dtype,
                                cache=cache, **kw)
        if train_aux and self.cfg.moe is None:
            return out, torch.zeros((), dtype=torch.float32,
                                    device=out.device)
        return out

    def decode_step(self, params, tokens, positions, cache,
                    dtype=torch.bfloat16):
        return self._mod.decode_step(params, self.cfg, tokens, positions,
                                     cache, opts=self.opts, dtype=dtype)

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16,
                   device="cuda"):
        """KV cache on `device`: for a dense model its K/V; for a hybrid
        one the shared block's K/V and each Mamba2 layer's fp32 SSM state
        and conv ring; for an audio one the decoder's K/V and the encoder's
        memory; for an ssm model its fp32 recurrent state (max_len and
        dtype unused)."""
        if self.cfg.family == "ssm":
            return self._mod.init_state(self.cfg, batch, device=device)
        return self._mod.init_cache(self.cfg, batch, max_len, dtype=dtype,
                                    device=device)

    def with_opts(self, **kw) -> "Model":
        return Model(self.cfg, self.opts.replace(**kw), self._mod)


_FAMILY_MODULES = {"dense": transformer, "moe": transformer,
                   "vlm": transformer, "ssm": rwkv, "hybrid": zamba,
                   "audio": whisper}


def build_model(cfg, opts: Options = None) -> Model:
    if cfg.family not in _FAMILY_MODULES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet")
    return Model(cfg, opts or Options(), _FAMILY_MODULES[cfg.family])
