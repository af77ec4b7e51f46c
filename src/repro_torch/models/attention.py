"""GQA multi-head attention: the prefill path and the cached decode step.

Counterpart of ``repro/models/attention.py``.  ``apply`` runs the
attention kernel (``kernels/attention.py``: the kernel on a CUDA tensor,
its plain version on a CPU one); ``decode`` is plain PyTorch, as the JAX
package's decode is plain jnp.

Decode caches (keys cached after RoPE, at absolute positions):
  - full cache: (b, hkv, S, hd) written at slot = position;
  - ring cache (sliding window): (b, hkv, W, hd) written at slot = pos % W,
    masked by the stored absolute position of each slot.
``decode`` writes the new key and value into the cache IN PLACE and
returns the same ``KVCache``: the JAX package returns a new cache (its
arrays are immutable; its serving loop donates the old one), the port
saves the copy.  The int8 cache (``kv_quant``) and cross-attention are not
ported (ROADMAP queue 1 item 12).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import attention as attention_k
from repro_torch.models import layers as L


def init(gen, cfg, device, dtype=torch.float32) -> dict:
    d = cfg.d_model
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "wq": L.dense_init(gen, d, hq * hd, dtype, device),
        "wk": L.dense_init(gen, d, hkv * hd, dtype, device),
        "wv": L.dense_init(gen, d, hkv * hd, dtype, device),
        "wo": L.dense_init(gen, hq * hd, d, dtype, device,
                           scale=1.0 / (hq * hd) ** 0.5),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", hq * hd), ("bk", hkv * hd),
                            ("bv", hkv * hd)):
            p[name] = torch.zeros(width, dtype=dtype, device=device)
    return p


def _project_qkv(p, x, cfg, compute_dtype, positions, rope: bool):
    b, s, _ = x.shape
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    x = x.to(compute_dtype)
    q = x @ p["wq"].to(compute_dtype)
    k = x @ p["wk"].to(compute_dtype)
    v = x @ p["wv"].to(compute_dtype)
    if cfg.qkv_bias:
        q = q + p["bq"].to(compute_dtype)
        k = k + p["bk"].to(compute_dtype)
        v = v + p["bv"].to(compute_dtype)
    q = q.reshape(b, s, hq, hd).transpose(1, 2)     # (b, hq, s, hd)
    k = k.reshape(b, s, hkv, hd).transpose(1, 2)
    v = v.reshape(b, s, hkv, hd).transpose(1, 2)
    if rope:
        q = L.apply_rope(q, positions[:, None, :], cfg.rope_theta)
        k = L.apply_rope(k, positions[:, None, :], cfg.rope_theta)
    return q, k, v


def apply(p, x, cfg, *, positions=None, causal=True, window=None,
          compute_dtype=torch.bfloat16, rope=True):
    """Full-sequence attention (prefill).  x: (b, s, d)."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    q, k, v = _project_qkv(p, x, cfg, compute_dtype, positions, rope)
    out = attention_k.attention(q, k, v, causal=causal, window=window)
    out = out.transpose(1, 2).reshape(b, s, cfg.num_heads * cfg.head_dim)
    return out @ p["wo"].to(compute_dtype)


class KVCache(NamedTuple):
    k: torch.Tensor          # (b, hkv, S_or_W, hd)
    v: torch.Tensor
    kpos: torch.Tensor       # (S_or_W,) absolute position per slot, -1 = empty


def init_cache(cfg, batch: int, seq_len: int, dtype=torch.bfloat16, *,
               device) -> KVCache:
    if getattr(cfg, "kv_quant", False):
        raise NotImplementedError("the int8 KV cache (kv_quant) is not "
                                  "ported (ROADMAP queue 1 item 12)")
    hkv, hd = cfg.num_kv_heads, cfg.head_dim
    slots = min(seq_len, cfg.window) if cfg.window else seq_len
    return KVCache(
        k=torch.zeros(batch, hkv, slots, hd, dtype=dtype, device=device),
        v=torch.zeros(batch, hkv, slots, hd, dtype=dtype, device=device),
        kpos=torch.full((slots,), -1, dtype=torch.int32, device=device),
    )


def decode(p, x, cache: KVCache, pos: int, cfg, *,
           compute_dtype=torch.bfloat16, rope=True, window=None):
    """Single-token decode.  x: (b, 1, d); pos: the absolute position.

    Returns (out (b, 1, d), cache), the cache updated in place.  Works for
    both full and ring caches: the ring is slot = pos % slots with stored
    positions.
    """
    pos = int(pos)
    b = x.shape[0]
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    group = hq // hkv
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(p, x, cfg, compute_dtype, positions, rope)

    slot = pos % cache.k.shape[2]
    cache.k[:, :, slot] = k_new[:, :, 0].to(cache.k.dtype)
    cache.v[:, :, slot] = v_new[:, :, 0].to(cache.v.dtype)
    cache.kpos[slot] = pos

    # scores over all slots, masked by stored absolute positions
    qh = q.reshape(b, hkv, group, hd)
    logits = torch.einsum("bkgd,bksd->bkgs", qh.float(),
                          cache.k.float()) * hd ** -0.5
    valid = (cache.kpos >= 0) & (cache.kpos <= pos)
    if window is not None:
        valid &= cache.kpos > pos - window
    logits = logits.masked_fill(~valid, float("-inf"))
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgs,bksd->bkgd", w, cache.v.float())
    out = out.reshape(b, 1, hq * hd).to(compute_dtype)
    return out @ p["wo"].to(compute_dtype), cache
