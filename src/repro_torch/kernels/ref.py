"""Plain PyTorch versions of the main path's kernels.

Counterpart of ``repro/kernels/ref.py`` (matvec, gs_project, cgs2).  These
are the ground truth the kernels are held against and what the wrappers run
for tensors on the CPU.  Products accumulate in float32 at least: narrow
storage is widened first, as the kernels widen in registers.
"""
from __future__ import annotations

import torch


def _acc(*dtypes) -> torch.dtype:
    dt = dtypes[0]
    for d in dtypes[1:]:
        dt = torch.promote_types(dt, d)
    return torch.promote_types(dt, torch.float32)


def matvec(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x.  a: (m, n), x: (n,) or (n, k); result in float32 or wider."""
    acc = _acc(a.dtype, x.dtype)
    return a.to(acc) @ x.to(acc)


def gs_project(v: torch.Tensor, w: torch.Tensor, mask: torch.Tensor):
    """One classical Gram-Schmidt pass: h = mask*(V w); w' = w - h V.

    v: (m1, n) row-major basis, w: (n,), mask: (m1,) 0/1 rows valid.
    """
    acc = _acc(v.dtype, w.dtype)
    vf = v.to(acc)
    h = (vf @ w.to(acc)) * mask.to(acc)
    return h, w.to(acc) - h @ vf


def cgs2(v: torch.Tensor, w: torch.Tensor, mask: torch.Tensor):
    """Two GS passes (reorthogonalization); returns (h1+h2, w'')."""
    h1, w1 = gs_project(v, w, mask)
    h2, w2 = gs_project(v, w1, mask)
    return h1 + h2, w2


def row_mask(m1: int, j: int, dtype=torch.float32, device="cpu"):
    """mask[i] = 1 for i <= j else 0 — selects the valid basis rows."""
    return (torch.arange(m1, device=device) <= j).to(dtype)
