"""Blockwise (online-softmax) attention with GQA and a sliding window.

Counterpart of ``repro/kernels/attention.py`` (``attention``); the plain
version is ``ref.attention``.  The kernel is ``csrc/attention.cu``; its
source note gives the design and the bound.  q, k and v share one storage
type, float32 or bfloat16; the math is float32; the output has q's dtype.

q: (b, hq, sq, d), k/v: (b, hkv, skv, d) with hq % hkv == 0 and d <= 128.
Queries are aligned to the END of the key axis (prefill: sq == skv;
decode: sq < skv).  Any sq and skv: the kernel masks ragged tiles itself,
so non-causal attention needs no tile-aligned shapes (the JAX kernel's
padding refuses those).  Each tensor may have any strides whose last axis
is contiguous.  The output is (b, hq, sq, d) laid out as (b, sq, hq, d),
so that the model's ``swapaxes(1, 2).reshape(b, sq, hq * d)`` is a view.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

STORAGE = (torch.float32, torch.bfloat16)
MAX_D = 128


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
    if d > MAX_D:
        raise ValueError(f"attention: head_dim {d}; the kernel takes "
                         f"d <= {MAX_D}")
    if scale is None:
        scale = d ** -0.5
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    out = torch.empty((b, sq, hq, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 12)(*(st for t in (q, k, v, out)
                                         for st in t.stride()[:3]))
    rc = _build.library().repro_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        int(q.dtype == torch.bfloat16), out.data_ptr(), b, hq, hkv, sq, skv,
        d, strides, float(scale), int(causal), int(window or 0),
        _build.stream_ptr(q))
    _build.check("attention", rc)
    attention.launches += 1
    return out


attention.launches = 0
