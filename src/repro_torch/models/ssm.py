"""Mamba2 (SSD, state-space duality) block: the prefill path and the
single-token decode step.

Counterpart of ``repro/models/ssm.py``.  Recurrence per head (scalar A):

    h_t = a_t * h_{t-1} + dt_t * (B_t (x) x_t)        h: (N, P)
    y_t = C_t . h_t + D * x_t                          a_t = exp(dt_t * A)

``apply`` is the JAX package's kernel branch (``ssm.py`` under
``ops.use_kernels``): the SSD chunked scan (``kernels/ssd.py``) on the
head-major flattened rows, then the SiLU gate and RMSNorm fused in one
pass (``kernels/gated_norm.py``) on float32 y and z, cast afterwards.  The
port has no switch to the JAX package's reference branch (which gates in
the compute dtype and then normalises): a CUDA tensor launches the
kernels, a CPU tensor runs their plain versions.  ``decode`` is plain
PyTorch, as the JAX decode is plain jnp: O(1) per token.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import gated_norm, ssd
from repro_torch.models import layers as L


def _dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_head_dim
    return d_inner, n_heads, cfg.ssm_head_dim, cfg.ssm_state


def init(gen, cfg, device, dtype=torch.float32) -> dict:
    d = cfg.d_model
    d_inner, h, _, n = _dims(cfg)
    conv_dim = d_inner + 2 * n          # conv over [x, B, C] (n_groups = 1)
    # in_proj -> [z (d_inner), x (d_inner), B (n), C (n), dt (h)]
    out_w = d_inner * 2 + 2 * n + h
    f32 = torch.float32
    return {
        "in_proj": L.dense_init(gen, d, out_w, dtype, device),
        "conv_w": L.normal(gen, (cfg.ssm_conv, conv_dim),
                           1.0 / math.sqrt(cfg.ssm_conv), dtype, device),
        "conv_b": torch.zeros(conv_dim, dtype=dtype, device=device),
        "a_log": torch.log(torch.linspace(1.0, 16.0, h, dtype=f32,
                                          device=device)),
        "d_skip": torch.ones(h, dtype=f32, device=device),
        "dt_bias": torch.zeros(h, dtype=f32, device=device),
        "norm": torch.ones(d_inner, dtype=dtype, device=device),
        "out_proj": L.dense_init(gen, d_inner, d, dtype, device),
    }


class SsmState(NamedTuple):
    conv: torch.Tensor   # (b, K-1, conv_dim) last inputs for the causal conv
    h: torch.Tensor      # (b, heads, N, P) ssm state


def init_state(cfg, batch: int, dtype=torch.float32, *, device) -> SsmState:
    d_inner, h, p_dim, n = _dims(cfg)
    conv_dim = d_inner + 2 * n
    return SsmState(
        conv=torch.zeros(batch, cfg.ssm_conv - 1, conv_dim, dtype=dtype,
                         device=device),
        h=torch.zeros(batch, h, n, p_dim, dtype=torch.float32, device=device),
    )


def _split_proj(proj, cfg):
    d_inner, h, _, n = _dims(cfg)
    z, xbc, dt = torch.split(proj, [d_inner, d_inner + 2 * n, h], dim=-1)
    return z, xbc, dt


def _causal_conv(xbc, conv_w, conv_b, prev=None):
    """Depthwise causal conv, width K.  xbc: (b, s, c); prev: (b, K-1, c)."""
    k = conv_w.shape[0]
    if prev is None:
        prev = torch.zeros(xbc.shape[0], k - 1, xbc.shape[2],
                           dtype=xbc.dtype, device=xbc.device)
    xp = torch.cat([prev, xbc], dim=1)
    s = xbc.shape[1]
    out = sum(xp[:, i:i + s] * conv_w[i] for i in range(k))
    return F.silu(out + conv_b), xp[:, -(k - 1):]


def apply(p, x, cfg, *, compute_dtype=torch.bfloat16):
    """Full-sequence Mamba2 block.  x: (b, s, d) -> (b, s, d)."""
    b, s, _ = x.shape
    d_inner, nh, p_dim, n = _dims(cfg)
    proj = x.to(compute_dtype) @ p["in_proj"].to(compute_dtype)
    z, xbc, dt = _split_proj(proj, cfg)
    xbc, _ = _causal_conv(xbc, p["conv_w"].to(compute_dtype),
                          p["conv_b"].to(compute_dtype))
    xin, b_in, c_in = torch.split(xbc, [d_inner, n, n], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"])                # (b, s, h)
    xh = xin.reshape(b, s, nh, p_dim)
    # head-major flatten for the kernel: (b*h, s, p)
    a = -torch.exp(p["a_log"])                                # (h,)
    dth = dt.transpose(1, 2)                                  # (b, h, s)
    x_k = xh.transpose(1, 2).reshape(b * nh, s, p_dim).float()
    y_k = ssd.ssd_scan(x_k, dth.reshape(b * nh, s),
                       (dth * a[None, :, None]).reshape(b * nh, s),
                       b_in.float(), c_in.float(), heads=nh,
                       chunk=min(cfg.ssm_chunk, s))
    y = y_k.reshape(b, nh, s, p_dim).transpose(1, 2)
    y = y + p["d_skip"][None, None, :, None] * xh.float()
    y = y.reshape(b, s, d_inner)
    y = gated_norm.gated_rmsnorm(y, z.float(), p["norm"],
                                 eps=cfg.norm_eps).to(compute_dtype)
    return y @ p["out_proj"].to(compute_dtype)


def decode(p, x, state: SsmState, cfg, *, compute_dtype=torch.bfloat16):
    """Single-token step.  x: (b, 1, d) -> (b, 1, d), new state."""
    b = x.shape[0]
    d_inner, nh, p_dim, n = _dims(cfg)
    proj = x.to(compute_dtype) @ p["in_proj"].to(compute_dtype)
    z, xbc, dt = _split_proj(proj, cfg)
    xbc, conv_prev = _causal_conv(xbc, p["conv_w"].to(compute_dtype),
                                  p["conv_b"].to(compute_dtype),
                                  prev=state.conv.to(compute_dtype))
    xin, b_in, c_in = torch.split(xbc[:, 0], [d_inner, n, n], dim=-1)
    dt = F.softplus(dt[:, 0].float() + p["dt_bias"])          # (b, h)
    a = -torch.exp(p["a_log"])
    decay = torch.exp(dt * a)                                 # (b, h)
    xh = xin.reshape(b, nh, p_dim).float()
    dbx = torch.einsum("bn,bh,bhp->bhnp", b_in.float(), dt, xh)
    h_new = decay[:, :, None, None] * state.h + dbx
    y = torch.einsum("bn,bhnp->bhp", c_in.float(), h_new)
    y = y + p["d_skip"][None, :, None] * xh
    y = y.reshape(b, 1, d_inner).to(compute_dtype)
    y = y * F.silu(z)
    y = L.rmsnorm(y, p["norm"], cfg.norm_eps)
    return y @ p["out_proj"].to(compute_dtype), SsmState(
        conv=conv_prev.to(state.conv.dtype), h=h_new)
