"""Experiment and model configurations of the port.

``gmres_paper`` is the solver's experiment.  ``get(name)`` returns a model
``ModelConfig`` by module name or by the JAX package's CLI alias
(``"zamba2-7b"``); reduced smoke variants come from ``get(name).reduced()``.
Only the architectures whose model family the port runs have a module here;
the others raise ``NotImplementedError``.
"""
from __future__ import annotations

import importlib

ARCH_IDS = [
    "whisper_small",
    "granite_3_8b",
    "qwen2_7b",
    "tinyllama_1_1b",
    "granite_3_2b",
    "zamba2_7b",
    "xlstm_125m",
    "llama4_maverick_400b_a17b",
    "mixtral_8x22b",
    "pixtral_12b",
]

# CLI aliases (assignment spelling -> module name), as in the JAX package
ALIASES = {
    "whisper-small": "whisper_small",
    "granite-3-8b": "granite_3_8b",
    "qwen2-7b": "qwen2_7b",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "granite-3-2b": "granite_3_2b",
    "zamba2-7b": "zamba2_7b",
    "xlstm-125m": "xlstm_125m",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "mixtral-8x22b": "mixtral_8x22b",
    "pixtral-12b": "pixtral_12b",
}

PORTED = ("zamba2_7b",)


def get(name: str):
    mod_name = ALIASES.get(name, name)
    if mod_name not in ARCH_IDS:
        raise KeyError(f"unknown architecture {name!r}")
    if mod_name not in PORTED:
        raise NotImplementedError(
            f"{name}: its model family is not ported yet (ROADMAP queue 1 "
            f"item 12, the other model families); ported: {PORTED}")
    return importlib.import_module(f"repro_torch.configs.{mod_name}").CONFIG
