"""Model and shape configuration for the assigned architecture pool.

The port's own copy of ``repro/models/config.py`` (which needs no JAX),
kept field for field so that a config reads the same in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: Optional[int] = None          # default d_model // num_heads
    qkv_bias: bool = False                  # qwen2
    window: Optional[int] = None            # sliding-window attention (mixtral)
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # --- MoE ---
    num_experts: int = 0
    top_k: int = 0
    moe_every: int = 1                      # MoE layer frequency (llama4: 2)
    capacity_factor: float = 1.25
    num_shared_experts: int = 0             # llama4: 1 shared expert

    # --- SSM / hybrid ---
    ssm_state: int = 0                      # Mamba2 N
    ssm_expand: int = 2                     # d_inner = expand * d_model
    ssm_head_dim: int = 64
    ssm_conv: int = 4                       # causal conv width
    attn_every: int = 0                     # zamba2: shared attn every k blocks
    ssm_chunk: int = 256                    # SSD chunk length

    # --- xLSTM ---
    slstm_every: int = 0                    # interleave sLSTM every k blocks

    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0
    encoder_seq: int = 0                    # precomputed frame embeddings

    # --- VLM (pixtral) ---
    num_patches: int = 0                    # precomputed patch embeddings

    # --- numerics / memory policy ---
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    moment_dtype: str = "float32"           # bf16 for >=100B configs
    kv_quant: bool = False                  # int8 KV cache (+absmax scales)
    remat: str = "full"                     # none | full | dots
    loss_chunk: int = 1024                  # seq chunk for the vocab matmul

    # positions: "rope" | "sinusoidal"
    positions: str = "rope"

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim",
                               self.d_model // self.num_heads)
        assert self.num_heads % max(self.num_kv_heads, 1) == 0

    @property
    def is_subquadratic(self) -> bool:
        """Can this arch decode a 500k context with bounded state?"""
        return (self.family in ("ssm", "hybrid")
                or (self.window is not None))

    def reduced(self, **overrides) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        small = dict(
            num_layers=min(self.num_layers, 4),
            d_model=128,
            num_heads=4,
            num_kv_heads=min(4, max(1, self.num_kv_heads
                                    * 4 // self.num_heads)),
            head_dim=32,
            d_ff=0 if self.d_ff == 0 else 256,
            vocab_size=512,
            num_experts=min(self.num_experts, 4),
            top_k=min(self.top_k, 2),
            encoder_layers=min(self.encoder_layers, 2),
            encoder_seq=min(self.encoder_seq, 32),
            num_patches=min(self.num_patches, 16),
            ssm_state=min(self.ssm_state, 16),
            ssm_head_dim=32 if self.ssm_state else self.ssm_head_dim,
            ssm_chunk=16,
            attn_every=2 if self.attn_every else 0,
            window=None if self.window is None else 32,
            loss_chunk=64,
            param_dtype="float32",
            compute_dtype="float32",
            moment_dtype="float32",
            remat="none",
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # "train" | "prefill" | "decode"


SHAPES: dict = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """(runnable, reason-if-not) for an (arch x shape) cell."""
    if shape.name == "long_500k" and not cfg.is_subquadratic:
        return False, ("pure full-attention arch: 524288-token decode has "
                       "unbounded KV + quadratic prefill; skipped per "
                       "assignment (see DESIGN.md SS5)")
    return True, ""
