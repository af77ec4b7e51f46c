"""Step factories: the prefill and the greedy serving step.

Counterpart of ``repro/launch/steps.py`` (``make_prefill_step``,
``make_serve_step``) on one card: no mesh, no shardings, no jit (PyTorch
runs eagerly).  Each factory returns the step function alone.
"""
from __future__ import annotations

import torch

from repro_torch.models import build
from repro_torch.models.config import ModelConfig


def make_prefill_step(cfg: ModelConfig):
    """(params, batch) -> float32 logits (b, V) at the last position."""
    model = build(cfg)

    def prefill_step(params, batch):
        return model.prefill(params, batch)

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """Single-token greedy decode step: (params, cache, token, pos) ->
    (next_token (b,) int32, cache).  The cache stays on the device; its KV
    buffers are updated in place (``models/attention.py``)."""
    model = build(cfg)

    def serve_step(params, cache, token, pos):
        logits, new_cache = model.decode(params, cache, token, pos)
        return logits.argmax(dim=-1).to(torch.int32), new_cache

    return serve_step
