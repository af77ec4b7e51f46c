"""Shared neural-net primitives of the model stack, in plain PyTorch.

Counterpart of ``repro/models/layers.py``.  Parameters are plain nested
dicts of tensors, as the JAX package keeps pytrees.  Init functions draw
from an explicit ``torch.Generator`` onto an explicit device, with the JAX
package's shapes and scales (the numbers differ: the two frameworks'
generators do not give the same bits; ``repro_torch.convert.model_params``
carries JAX weights across where a test needs the same ones).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return DTYPES[name]


# --------------------------------------------------------------------------
# init helpers: ``gen`` draws, ``device`` holds the result.  They differ only
# for the "meta" device, where ``param_count`` builds shapes without memory
# (a CPU generator drawing nothing).
# --------------------------------------------------------------------------
def normal(gen, shape, scale: float, dtype, device) -> torch.Tensor:
    """``scale`` times a standard normal draw of ``shape``, drawn in
    float32 and cast to ``dtype``."""
    out = torch.randn(shape, generator=gen, device=device,
                      dtype=torch.float32)
    return out.mul_(scale).to(dtype)


def dense_init(gen, d_in: int, d_out: int, dtype, device, *,
               scale: float | None = None) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return normal(gen, (d_in, d_out), scale, dtype, device)


def embed_init(gen, vocab: int, d: int, dtype, device) -> torch.Tensor:
    return normal(gen, (vocab, d), 0.02, dtype, device)


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------
def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps)
    return (x * w.float()).to(dt)


# --------------------------------------------------------------------------
# positions
# --------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0) -> torch.Tensor:
    """x: (..., seq, head_dim), positions: (..., seq) integers.

    Half-split rotation (the first half of the head against the second),
    not interleaved pairs, as the JAX package rotates."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)              # (hd/2,)
    angles = positions[..., None].float() * freqs               # (..., s, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# MLP (SwiGLU)
# --------------------------------------------------------------------------
def mlp_init(gen, d_model: int, d_ff: int, dtype, device) -> dict:
    return {
        "w_gate": dense_init(gen, d_model, d_ff, dtype, device),
        "w_up": dense_init(gen, d_model, d_ff, dtype, device),
        "w_down": dense_init(gen, d_ff, d_model, dtype, device),
    }


def mlp_apply(p: dict, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    x = x.to(compute_dtype)
    g = x @ p["w_gate"].to(compute_dtype)
    u = x @ p["w_up"].to(compute_dtype)
    return (F.silu(g) * u) @ p["w_down"].to(compute_dtype)


# --------------------------------------------------------------------------
# logits
# --------------------------------------------------------------------------
def logits_for(x_last: torch.Tensor, lm_head: torch.Tensor,
               compute_dtype) -> torch.Tensor:
    """Decode-path logits for the sampled position(s): (b, d) -> (b, V)."""
    return (x_last.to(compute_dtype)
            @ lm_head.to(compute_dtype)).float()
