"""The zamba2 hybrid stack: Mamba2 blocks and one SHARED attention block.

Counterpart of the zamba2 half of ``repro/models/hybrid.py``.
``num_layers`` Mamba2 blocks; after every ``attn_every`` of them one
shared-weight transformer block (attention + MLP) runs: one set of
attention weights applied at many depths (13 sites for 81 layers / every
6), each site with its OWN KV cache.  Leftover Mamba layers form a tail.

The JAX package stacks the layers' parameters and scans over them; the
port keeps them as lists (``params["groups"][i][j]``, ``params["tail"][t]``)
and loops.  The xLSTM stack is not ported (ROADMAP queue 1 item 12).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.models import attention, layers as L, ssm
from repro_torch.models.config import ModelConfig


def _mamba_layer_init(gen, cfg, device, dtype):
    return {"ln": torch.ones(cfg.d_model, dtype=dtype, device=device),
            "block": ssm.init(gen, cfg, device, dtype)}


def _shared_attn_init(gen, cfg, device, dtype):
    d = cfg.d_model
    return {
        "ln1": torch.ones(d, dtype=dtype, device=device),
        "attn": attention.init(gen, cfg, device, dtype=dtype),
        "ln2": torch.ones(d, dtype=dtype, device=device),
        "mlp": L.mlp_init(gen, d, cfg.d_ff, dtype, device),
    }


def _zamba_split(cfg):
    g = cfg.attn_every
    ng = cfg.num_layers // g
    tail = cfg.num_layers - ng * g
    return g, ng, tail


def zamba_init(cfg: ModelConfig, gen: torch.Generator, device) -> dict:
    pdt = L.dtype_of(cfg.param_dtype)
    g, ng, tail = _zamba_split(cfg)
    params = {
        "embed": L.embed_init(gen, cfg.vocab_size, cfg.d_model, pdt, device),
        "groups": [[_mamba_layer_init(gen, cfg, device, pdt)
                    for _ in range(g)] for _ in range(ng)],
        "shared_attn": _shared_attn_init(gen, cfg, device, pdt),
        "final_norm": torch.ones(cfg.d_model, dtype=pdt, device=device),
        "lm_head": L.dense_init(gen, cfg.d_model, cfg.vocab_size, pdt,
                                device),
    }
    if tail:
        params["tail"] = [_mamba_layer_init(gen, cfg, device, pdt)
                          for _ in range(tail)]
    return params


def _shared_attn_apply(p, x, cfg, positions, cdt):
    h = attention.apply(p["attn"], L.rmsnorm(x, p["ln1"], cfg.norm_eps), cfg,
                        positions=positions, causal=True, compute_dtype=cdt)
    x = x + h
    return x + L.mlp_apply(p["mlp"], L.rmsnorm(x, p["ln2"], cfg.norm_eps), cdt)


def _mamba_apply(p, x, cfg, cdt):
    return x + ssm.apply(p["block"], L.rmsnorm(x, p["ln"], cfg.norm_eps),
                         cfg, compute_dtype=cdt)


def zamba_forward(params, cfg: ModelConfig, tokens):
    cdt = L.dtype_of(cfg.compute_dtype)
    x = params["embed"][tokens].to(cdt)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    for group in params["groups"]:
        for p in group:
            x = _mamba_apply(p, x, cfg, cdt)
        x = _shared_attn_apply(params["shared_attn"], x, cfg, positions, cdt)
    for p in params.get("tail", ()):
        x = _mamba_apply(p, x, cfg, cdt)
    return L.rmsnorm(x, params["final_norm"], cfg.norm_eps)


def zamba_prefill(params, cfg, batch):
    tokens = torch.as_tensor(batch["tokens"],
                             device=params["embed"].device).long()
    x = zamba_forward(params, cfg, tokens)
    cdt = L.dtype_of(cfg.compute_dtype)
    return L.logits_for(x[:, -1], params["lm_head"], cdt)


class ZambaCache(NamedTuple):
    group_ssm: Any      # [ng][g] SsmState
    tail_ssm: Any       # [tail] SsmState, or None
    attn: Any           # [ng] KVCache, one per shared-attention site


def zamba_init_cache(cfg: ModelConfig, batch: int, max_len: int,
                     dtype=torch.bfloat16, *, device) -> ZambaCache:
    g, ng, tail = _zamba_split(cfg)

    def one_ssm():
        return ssm.init_state(cfg, batch, device=device)

    return ZambaCache(
        group_ssm=[[one_ssm() for _ in range(g)] for _ in range(ng)],
        tail_ssm=[one_ssm() for _ in range(tail)] if tail else None,
        attn=[attention.init_cache(cfg, batch, max_len, dtype, device=device)
              for _ in range(ng)],
    )


def zamba_decode(params, cfg: ModelConfig, cache: ZambaCache, token, pos):
    """One token per sequence at absolute position ``pos`` (an int):
    (logits (b, V), the new cache; the KV caches are updated in place)."""
    cdt = L.dtype_of(cfg.compute_dtype)
    token = torch.as_tensor(token, device=params["embed"].device).long()
    x = params["embed"][token][:, None, :].to(cdt)

    def mamba_step(p, x, st):
        h, st2 = ssm.decode(p["block"], L.rmsnorm(x, p["ln"], cfg.norm_eps),
                            st, cfg, compute_dtype=cdt)
        return x + h, st2

    sa = params["shared_attn"]
    group_ssm, attn = [], []
    for gp, gst, kv in zip(params["groups"], cache.group_ssm, cache.attn):
        gst2 = []
        for p, st in zip(gp, gst):
            x, st2 = mamba_step(p, x, st)
            gst2.append(st2)
        h, kv2 = attention.decode(sa["attn"],
                                  L.rmsnorm(x, sa["ln1"], cfg.norm_eps),
                                  kv, pos, cfg, compute_dtype=cdt)
        x = x + h
        x = x + L.mlp_apply(sa["mlp"], L.rmsnorm(x, sa["ln2"], cfg.norm_eps),
                            cdt)
        group_ssm.append(gst2)
        attn.append(kv2)
    tail_ssm = cache.tail_ssm
    if tail_ssm is not None:
        tail_ssm = []
        for p, st in zip(params["tail"], cache.tail_ssm):
            x, st2 = mamba_step(p, x, st)
            tail_ssm.append(st2)

    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = L.logits_for(x[:, 0], params["lm_head"], cdt)
    return logits, ZambaCache(group_ssm=group_ssm, tail_ssm=tail_ssm,
                              attn=attn)
