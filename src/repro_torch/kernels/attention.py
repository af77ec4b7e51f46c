"""Blockwise (online-softmax) attention with GQA and a sliding window.

Counterpart of ``repro/kernels/attention.py`` (``attention``); the plain
version is ``ref.attention``.  Two kernels, by storage type (``launch_plan``
picks one, and nothing falls back from one to the other):

- bfloat16: ``csrc/attention_sm90.cu``, TMA loads and ``wgmma`` tiles (bf16
  products, float32 accumulators and softmax; P rounded to bf16 for P V);
- float32: ``csrc/attention.cu``, full float32 on the CUDA cores.

Their source notes give the designs and the bound.  q, k and v share one
storage type; the output has q's dtype.

q: (b, hq, sq, d), k/v: (b, hkv, skv, d) with hq % hkv == 0 and d <= 128.
Queries are aligned to the END of the key axis (prefill: sq == skv;
decode: sq < skv).  Any sq and skv: the kernel masks ragged tiles itself,
so non-causal attention needs no tile-aligned shapes (the JAX kernel's
padding refuses those).  Each tensor may have any strides whose last axis
is contiguous.  The output is (b, hq, sq, d) laid out as (b, sq, hq, d),
so that the model's ``swapaxes(1, 2).reshape(b, sq, hq * d)`` is a view.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.  ``attention.launches`` counts every launch,
``attention.launches_by_kernel`` each kernel's ("wgmma", "simt"), and
``attention.layout_copies`` the tensors copied into TMA's aligned layout.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

STORAGE = (torch.float32, torch.bfloat16)
MAX_D = 128
TMA_BOX = 64         # bf16 columns of one TMA box: the 128-byte swizzle span
TMA_ALIGN = 16       # bytes: TMA's base address and stride alignment
MAX_Q_TILES = 65535  # the wgmma grid's y axis (64-query tiles)


def attention_plain(q, k, v, *, causal: bool = True,
                    window: int | None = None, scale: float | None = None):
    return ref.attention(q, k, v, causal=causal, window=window, scale=scale)


def _check(q, k, v, window) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise TypeError(f"attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                        f"v {tuple(v.shape)} — q must be (b, hq, sq, d) and "
                        f"k, v (b, hkv, skv, d)")
    b, hq, _, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or hq % k.shape[1]:
        raise TypeError(f"attention: q {tuple(q.shape)} and k "
                        f"{tuple(k.shape)} disagree (hq % hkv must be 0)")
    if window is not None and window < 1:
        raise ValueError(f"attention: window = {window}; it must be >= 1")
    if not (q.device == k.device == v.device):
        raise ValueError(f"attention: q on {q.device}, k on {k.device}, "
                         f"v on {v.device}")


def _needs_copy(t) -> bool:
    """Does TMA refuse this bf16 tensor's layout as it stands (the last
    axis not contiguous, the base or a stride of a non-trivial axis not a
    multiple of 16 bytes)?"""
    size = t.element_size()
    return (t.stride(-1) != 1 or t.data_ptr() % TMA_ALIGN != 0
            or any(st * size % TMA_ALIGN for st, n in
                   zip(t.stride()[:3], t.shape[:3]) if n > 1))


def launch_plan(q, k, v) -> dict:
    """Which kernel an attention call launches, and how (reads only the
    tensors' dtype, shape, strides and address, so it runs anywhere).

    bfloat16 -> "wgmma": ``d_pad`` (64 or 128), the TMA boxes' widths and
    the columns of each that hold data (the rest zero-filled), and
    ``copy``: the tensors that go through an aligned, zero-padded layout
    copy first.  float32 -> "simt" (copies only a tensor whose last axis
    is not contiguous).  d > 128 raises.
    """
    d = q.shape[-1]
    if d > MAX_D:
        raise ValueError(f"attention: head_dim {d}; the kernels take "
                         f"d <= {MAX_D}")
    names = ("q", "k", "v")
    if q.dtype != torch.bfloat16:
        return {"kernel": "simt", "d_pad": None, "box_cols": [],
                "box_valid": [],
                "copy": {n: t.stride(-1) != 1
                         for n, t in zip(names, (q, k, v))}}
    if -(-q.shape[2] // 64) > MAX_Q_TILES:
        raise ValueError(f"attention: sq = {q.shape[2]}; the bf16 kernel "
                         f"takes at most {MAX_Q_TILES} tiles of 64 queries")
    boxes = -(-d // TMA_BOX)
    return {"kernel": "wgmma", "d_pad": boxes * TMA_BOX,
            "box_cols": [TMA_BOX] * boxes,
            "box_valid": [min(TMA_BOX, d - i * TMA_BOX)
                          for i in range(boxes)],
            "copy": {n: _needs_copy(t) for n, t in zip(names, (q, k, v))}}


def _tma_layout(t):
    """t in a layout TMA takes: (b, h, s, d) with the head dim padded to a
    multiple of 8 elements (zeros), a view of its first d columns."""
    b, h, s, d = t.shape
    buf = torch.zeros((b, h, s, -(-d // 8) * 8), dtype=t.dtype,
                      device=t.device)
    buf[..., :d].copy_(t)
    attention.layout_copies += 1
    return buf[..., :d]


def _tma_strides(t) -> list[int]:
    """t's (batch, head, position) strides, an axis of extent 1 given the
    next inner axis's span (any stride addresses it; TMA wants one that is
    a multiple of 16 bytes)."""
    st = list(t.stride()[:3])
    for i in (2, 1, 0):
        if t.shape[i] == 1:
            st[i] = (st[i + 1] * t.shape[i + 1] if i < 2
                     else -(-t.shape[3] // 8) * 8)
    return st


def attention(q, k, v, *, causal: bool = True, window: int | None = None,
              scale: float | None = None):
    """Flash attention.  q: (b, hq, sq, d), k/v: (b, hkv, skv, d)."""
    _check(q, k, v, window)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal=causal, window=window,
                               scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"attention: unsupported device {q.device}")
    if q.dtype not in STORAGE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"attention: q, k and v must share float32 or "
                        f"bfloat16 storage, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    plan = launch_plan(q, k, v)
    if scale is None:
        scale = d ** -0.5
    out = torch.empty((b, sq, hq, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    if out.numel() == 0:
        return out
    wgmma = plan["kernel"] == "wgmma"
    relayout = _tma_layout if wgmma else torch.Tensor.contiguous
    q, k, v = (relayout(t) if plan["copy"][n] else t
               for n, t in zip(("q", "k", "v"), (q, k, v)))
    qkv_strides = (_tma_strides(t) if wgmma else t.stride()[:3]
                   for t in (q, k, v))
    strides = (ctypes.c_longlong * 12)(*(st for sts in qkv_strides
                                         for st in sts), *out.stride()[:3])
    launch = (_build.library().repro_attention_wgmma if wgmma
              else _build.library().repro_attention)
    rc = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b,
                hq, hkv, sq, skv, d, strides, float(scale), int(causal),
                int(window or 0), _build.stream_ptr(q))
    _build.check(f"attention ({plan['kernel']})", rc)
    attention.launches += 1
    attention.launches_by_kernel[plan["kernel"]] += 1
    return out


attention.launches = 0
attention.launches_by_kernel = {"wgmma": 0, "simt": 0}
attention.layout_copies = 0
