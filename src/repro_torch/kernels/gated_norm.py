"""Fused SiLU gate + RMSNorm (the Mamba2 block's tail).

Counterpart of ``repro/kernels/gated_norm.py`` (``gated_rmsnorm``,
``gated_rmsnorm_ref``).  The kernel is ``csrc/gated_norm.cu``; its source
note gives the design and the bound.  y and z share one storage type,
float32 or bfloat16; w is read as float32; the result has y's dtype.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, tuning

STORAGE = (torch.float32, torch.bfloat16)


def gated_rmsnorm_plain(y: torch.Tensor, z: torch.Tensor, w: torch.Tensor,
                        *, eps: float = 1e-5) -> torch.Tensor:
    """rmsnorm(y * silu(z)) * w over the last axis, in float32."""
    g = y.float() * F.silu(z.float())
    ms = g.square().mean(-1, keepdim=True)
    return (g * torch.rsqrt(ms + eps) * w.float()).to(y.dtype)


def gated_rmsnorm(y: torch.Tensor, z: torch.Tensor, w: torch.Tensor, *,
                  eps: float = 1e-5) -> torch.Tensor:
    """out = rmsnorm(y * silu(z), w).  y/z: (..., d), w: (d,)."""
    d = y.shape[-1]
    if z.shape != y.shape or w.shape != (d,):
        raise TypeError(f"gated_rmsnorm: y {tuple(y.shape)}, z "
                        f"{tuple(z.shape)}, w {tuple(w.shape)} — z must "
                        f"match y and w be ({d},)")
    if not (y.device == z.device == w.device):
        raise ValueError(f"gated_rmsnorm: y on {y.device}, z on {z.device}, "
                         f"w on {w.device}")
    if y.device.type == "cpu":
        return gated_rmsnorm_plain(y, z, w, eps=eps)
    if y.device.type != "cuda":
        raise ValueError(f"gated_rmsnorm: unsupported device {y.device}")
    if y.dtype not in STORAGE or z.dtype != y.dtype:
        raise TypeError(f"gated_rmsnorm: y and z must share float32 or "
                        f"bfloat16 storage, got {y.dtype}, {z.dtype}")
    max_d = (tuning.SMEM_LIMIT - 64) // 4      # g, and 32 B of block sums
    if d > max_d:
        raise ValueError(f"gated_rmsnorm: d = {d} does not fit a block's "
                         f"shared memory (at most {max_d})")
    yc, zc = y.contiguous(), z.contiguous()
    wf = w.float().contiguous()
    out = torch.empty_like(yc)
    rows = yc.numel() // d if d else 0
    if rows == 0:
        return out
    rc = _build.library().repro_gated_rmsnorm(
        yc.data_ptr(), zc.data_ptr(), int(y.dtype == torch.bfloat16),
        wf.data_ptr(), out.data_ptr(), rows, d, float(eps),
        _build.stream_ptr(y))
    _build.check("gated_rmsnorm", rc)
    gated_rmsnorm.launches += 1
    return out


gated_rmsnorm.launches = 0
