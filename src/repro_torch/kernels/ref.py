"""Plain PyTorch versions of the main path's kernels.

Counterpart of ``repro/kernels/ref.py`` (matvec, gs_project, cgs2,
attention).  These
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


def attention(q, k, v, *, causal: bool = True, scale: float | None = None,
              window: int | None = None, q_chunk: int | None = None):
    """Reference multi-head attention, in float32, out in q's dtype.

    q: (b, hq, sq, d), k/v: (b, hkv, skv, d); GQA when hq > hkv (query head
    h reads kv head h // (hq // hkv)).  ``window`` = sliding-window size
    (Mistral-style, counts the diagonal).  Positions are aligned at the END
    (decode: the sq last queries of skv keys): query row i sits at
    skv - sq + i.  A row with no key inside its mask is 0, as in the kernel
    (JAX's softmax gives NaN there; only sq > skv makes such rows).

    ``q_chunk``: query chunks of that many rows at a time, so the float32
    scores peak at (b, h, q_chunk, skv); the numbers are the same (each
    chunk's softmax is complete over skv).
    """
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    if scale is None:
        scale = d ** -0.5
    kf, vf = k.float(), v.float()
    kpos = torch.arange(skv, device=q.device)

    def chunk_out(q_c, qpos_c):
        rows = q_c.shape[2]
        qr = q_c.reshape(b, hkv, group, rows, d).float()
        logits = torch.einsum("bhgqd,bhkd->bhgqk", qr, kf) * scale
        mask = torch.ones(rows, skv, dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos[None, :] <= qpos_c[:, None]
        if window is not None:
            mask &= kpos[None, :] > qpos_c[:, None] - window
        logits = logits.masked_fill(~mask, float("-inf"))
        p = torch.softmax(logits, dim=-1)
        p = p.masked_fill(~mask.any(-1)[:, None], 0.0)
        out = torch.einsum("bhgqk,bhkd->bhgqd", p, vf)
        return out.reshape(b, hq, rows, d).to(q.dtype)

    qpos = torch.arange(sq, device=q.device) + (skv - sq)
    if not q_chunk or sq % q_chunk or sq <= q_chunk:
        return chunk_out(q, qpos)
    return torch.cat([chunk_out(q[:, :, i:i + q_chunk], qpos[i:i + q_chunk])
                      for i in range(0, sq, q_chunk)], dim=2)
