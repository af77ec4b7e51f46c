"""Unified model API: ``build(config) -> Model``.

Counterpart of ``repro/models/model.py``.  ``Model`` exposes the entry
points serving uses:
  init        parameters, drawn from a ``torch.Generator`` on a device
  prefill     full-sequence forward -> logits at the last position
  decode      one-token cached step
  init_cache  the decode cache
The port runs the hybrid family (zamba2); ``loss`` waits for training and
the other families for their slices (ROADMAP queue 1 item 12).  Entry
points run on the card unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import math

import torch

from repro_torch import device as device_mod
from repro_torch.models import hybrid
from repro_torch.models.config import ModelConfig


class Model:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    def init(self, generator: torch.Generator | None = None, *,
             device="cuda") -> dict:
        """Random parameters on ``device``, drawn from ``generator`` (one
        on that device, seeded 0, when None)."""
        dev = device_mod.resolve(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        elif generator.device.type != dev.type:
            raise ValueError(f"Model.init: a generator on "
                             f"{generator.device} cannot draw on {dev}")
        return hybrid.zamba_init(self.cfg, generator, dev)

    def prefill(self, params: dict, batch: dict) -> torch.Tensor:
        """batch["tokens"] (b, s) -> float32 logits (b, V) at s - 1."""
        return hybrid.zamba_prefill(params, self.cfg, batch)

    def decode(self, params: dict, cache, token, pos: int):
        """token (b,) at absolute position ``pos`` -> (logits, cache)."""
        return hybrid.zamba_decode(params, self.cfg, cache, token, pos)

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16, *,
                   device="cuda"):
        return hybrid.zamba_init_cache(self.cfg, batch, max_len, dtype,
                                       device=device_mod.resolve(device))


def build(cfg: ModelConfig) -> Model:
    if cfg.family == "hybrid":
        return Model(cfg)
    raise NotImplementedError(
        f"{cfg.name}: the {cfg.family!r} family is not ported yet (ROADMAP "
        f"queue 1 item 12); the port runs the hybrid family (zamba2)")


def leaves(tree):
    """The tensors of a nested dict / list / tuple, depth first."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from leaves(v)


def param_count(cfg: ModelConfig) -> int:
    """Parameters of ``build(cfg).init``, counted from shapes alone (built
    on the "meta" device: nothing is drawn or allocated)."""
    build(cfg)
    params = hybrid.zamba_init(cfg, torch.Generator(), torch.device("meta"))
    return sum(math.prod(p.shape) for p in leaves(params))
