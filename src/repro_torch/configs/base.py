"""Config system for the PyTorch port.

The dataclasses are a copy of the JAX package's configs without JAX, so the
two packages read one architecture table.  Full-width configs are meant for
the card; CPU tests use `reduced()` copies.  `input_specs` gives meta-device
tensors: shapes and dtypes with no storage.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

# ---------------------------------------------------------------------------
# Sub-configs for family-specific blocks
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 multi-head latent attention."""

    q_lora_rank: int = 0          # 0 => full-rank q projection (V2-Lite)
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 64
    top_k: int = 6
    n_shared_experts: int = 2     # shared experts run on every token
    d_expert: int = 1408          # per-expert FFN hidden size
    dense_residual: bool = False  # Arctic: dense FFN in parallel with MoE
    first_dense_layers: int = 1   # leading layers use a dense FFN instead
    dense_d_ff: int = 0           # hidden size of dense FFN (0 => d_ff)
    capacity_factor: float = 1.25
    router_aux_loss: float = 0.001


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD block parameters."""

    state_dim: int = 64
    head_dim: int = 64
    expand: int = 2
    conv_dim: int = 4
    chunk: int = 64               # chunked-scan block length
    n_groups: int = 1


@dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    decay_lora: int = 64          # rank of data-dependent decay LoRA
    tokenshift_lora: int = 32
    chunk: int = 64


@dataclass(frozen=True)
class EncoderConfig:
    """Whisper-style encoder (conv frontend stubbed)."""

    n_layers: int = 6
    n_frames: int = 1500          # post-conv sequence length
    n_heads: int = 8


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"         # dense | hybrid | audio | vlm | ssm | moe
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 1024
    vocab_size: int = 1024
    head_dim: int = 0             # 0 => d_model // n_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    act: str = "silu"             # silu | gelu
    rope_theta: float = 1e6
    # gemma2 features
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    sliding_window: int = 0       # >0: local-attention window
    local_global_every: int = 0   # >0: every Nth layer is global, rest local
    query_pre_attn_scalar: float = 0.0  # gemma2 uses d_model/n_heads
    post_norms: bool = False      # gemma2 post-attn/post-ffn norms
    embed_scale: bool = False     # gemma2 scales embeds by sqrt(d_model)
    rms_plus_one: bool = False    # gemma-style (1 + scale) RMSNorm
    gated_mlp: bool = True        # False => plain 2-layer MLP (whisper)
    # vlm
    mrope: bool = False           # Qwen2-VL multimodal RoPE (3 position streams)
    mrope_sections: tuple = (16, 24, 24)  # per-stream rotary sections (half-dims)
    # hybrid (zamba2): shared attention block applied every `attn_every` ssm layers
    attn_every: int = 0
    # sub-configs
    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None
    encoder: Optional[EncoderConfig] = None
    # vocab padding for sharding (physical embedding rows; logits masked)
    vocab_pad_multiple: int = 256

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm" and self.attn_every == 0

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------------
    def reduced(self) -> "ModelConfig":
        """A tiny same-family config for CPU tests."""
        kw: dict = dict(
            n_layers=min(self.n_layers, 2 if self.attn_every == 0 else 2 * max(self.attn_every, 1)),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) if self.n_kv_heads < self.n_heads else 4,
            d_ff=256,
            vocab_size=512,
            head_dim=32,
            vocab_pad_multiple=16,
        )
        if self.mla is not None:
            kw["mla"] = MLAConfig(q_lora_rank=0, kv_lora_rank=64,
                                  qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32)
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe, n_experts=8, top_k=min(self.moe.top_k, 2),
                n_shared_experts=min(self.moe.n_shared_experts, 1),
                d_expert=64, dense_d_ff=256, first_dense_layers=min(self.moe.first_dense_layers, 1))
        if self.ssm is not None:
            kw["ssm"] = dataclasses.replace(self.ssm, state_dim=16, head_dim=16, chunk=16)
        if self.rwkv is not None:
            kw["rwkv"] = dataclasses.replace(self.rwkv, head_dim=32, decay_lora=16,
                                             tokenshift_lora=8, chunk=16)
        if self.encoder is not None:
            kw["encoder"] = dataclasses.replace(self.encoder, n_layers=2, n_frames=32, n_heads=4)
        if self.mrope:
            kw["mrope_sections"] = (4, 6, 6)   # sums to reduced head_dim//2
        if self.sliding_window:
            kw["sliding_window"] = 16
        if self.attn_every:
            kw["attn_every"] = self.attn_every
        return self.replace(**kw)


# ---------------------------------------------------------------------------
# Input shapes: every arch is paired with all four.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str                     # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def applicable_shapes(cfg: ModelConfig) -> dict[str, str]:
    """shape name -> "run" or "skip:<reason>" per the assignment rules."""
    out = {}
    for name, sh in SHAPES.items():
        if name == "long_500k":
            # sub-quadratic attention required: run for SSM / hybrid / linear-attn
            if cfg.family in ("ssm", "hybrid"):
                out[name] = "run"
            else:
                out[name] = "skip:full-attention arch; 500k decode out of family spec (DESIGN.md §6)"
        else:
            out[name] = "run"
    return out


# ---------------------------------------------------------------------------
# Run-time (training/serving) config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RunConfig:
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: str = "none"           # none | dots | full
    microbatches: int = 1
    # optimizer
    lr: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 1000
    zero1: bool = True            # shard optimizer state over the data axis
    adam_state_dtype: str = "float32"   # float32 | bfloat16 (quantized adam)
    grad_compress: str = "none"   # none | bf16 | int8 (all-reduce compression)
    # serving
    seq_shard_kv: bool = False    # shard KV cache sequence over the data axis
    shard_params_2d: bool = False  # FSDP-style 2D weight sharding (serving)
    # misc
    seed: int = 0

    def replace(self, **kw) -> "RunConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# input_specs: meta-device stand-ins for every model input.
# ---------------------------------------------------------------------------


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Input tensors with no storage (device "meta") for an (arch, shape) cell.

    train:   {tokens, labels}   (B, S) int32
    prefill: {tokens}           (B, S) int32
    decode:  {tokens, positions} (B,) int32 (one new token/seq)
    extras per family (mrope positions, encoder frames).
    """
    B, S = shape.global_batch, shape.seq_len

    def meta(shp, dtype=torch.int32):
        return torch.empty(shp, dtype=dtype, device="meta")

    specs: dict = {}
    if shape.mode == "train":
        specs["tokens"] = meta((B, S))
        specs["labels"] = meta((B, S))
    elif shape.mode == "prefill":
        specs["tokens"] = meta((B, S))
    else:  # decode: one new token against a cache of length S
        specs["tokens"] = meta((B,))
        specs["positions"] = meta((B,))
    if cfg.mrope and shape.mode != "decode":
        specs["mrope_positions"] = meta((3, B, S))
    if cfg.family == "audio":
        specs["encoder_frames"] = meta((B, cfg.encoder.n_frames, cfg.d_model),
                                       torch.bfloat16)
    return specs
