"""Serving driver: prompt steps and a greedy decode loop with a
device-resident cache.

Counterpart of ``repro/launch/serve.py``.  The prompt is fed by stepping
the decode program over it (the same cache path serving uses), then
``--gen`` tokens are generated greedily.  Weights are random, drawn from
a ``torch.Generator`` seeded 0 on the device; the prompt is drawn with
numpy (seed 0).  Runs on the card unless ``--device cpu``:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \\
        --batch 2 --prompt-len 64 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \\
        --reduced --device cpu
"""
from __future__ import annotations

import argparse
import logging
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch import device as device_mod
from repro_torch.launch.steps import make_serve_step
from repro_torch.models import build

log = logging.getLogger("repro_torch.serve")


def generate(cfg, params, prompt, gen: int, *, device="cuda") -> np.ndarray:
    """Feed ``prompt`` (b, s) integers through the serving step, then
    generate ``gen`` tokens greedily; returns them as (b, gen) int32."""
    dev = device_mod.resolve(device)
    model = build(cfg)
    serve_step = make_serve_step(cfg)
    prompt = torch.as_tensor(np.asarray(prompt), device=dev)
    b, plen = prompt.shape
    cache = model.init_cache(b, plen + gen, device=dev)
    nxt = None
    for i in range(plen):
        nxt, cache = serve_step(params, cache, prompt[:, i], i)
    generated = []
    tok = nxt
    for i in range(gen):
        tok, cache = serve_step(params, cache, tok, plen + i)
        generated.append(tok)
    if not generated:
        return np.zeros((b, 0), np.int32)
    return torch.stack(generated, dim=1).cpu().numpy()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="zamba2-7b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dev = device_mod.resolve(args.device)
    params = build(cfg).init(torch.Generator(device=dev).manual_seed(0),
                             device=dev)
    rng = np.random.default_rng(0)
    prompt = rng.integers(2, cfg.vocab_size,
                          (args.batch, args.prompt_len)).astype(np.int32)

    t0 = time.perf_counter()
    gen = generate(cfg, params, prompt, args.gen, device=dev)
    dt = time.perf_counter() - t0     # generate ends in a copy to the host
    total_tokens = args.batch * (args.prompt_len + args.gen)
    log.info("%s on %s: %d prompt + %d generated tokens in %.2fs "
             "(%.1f tok/s)", cfg.name, dev, args.batch * args.prompt_len,
             args.batch * args.gen, dt, total_tokens / dt)
    log.info("sample row: %s", gen[0][:16])
    return gen


if __name__ == "__main__":
    main()
