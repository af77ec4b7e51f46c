"""Arnoldi iteration step: builds the Krylov basis one vector at a time.

Counterpart of ``repro/core/arnoldi.py``.  Schemes:

- ``cgs``  — classical Gram-Schmidt, the scheme in the paper's listing.
- ``mgs``  — modified Gram-Schmidt (what pracma::gmres uses).
- ``cgs2`` — classical Gram-Schmidt twice (reorthogonalized), in PyTorch.
- ``cgs2_fused`` — the same CGS2 arithmetic through the fused GS kernel
             (``kernels/cgs2.py``, ``csrc/cgs2.cu``) on the card, its plain
             version on the CPU.

The basis ``V`` is stored row-major (m+1, n): basis vector j is row j.
Every step returns a device-resident ``ArnoldiStep``; nothing here syncs
with the host.  ``cgs2_pipelined`` (single-reduce CGS2) and row-sharded
execution are not ported yet.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.kernels import cgs2 as cgs2_k
from repro_torch.kernels.ref import row_mask


def norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.dot(v, v))


class ArnoldiStep(NamedTuple):
    v_next: torch.Tensor  # candidate basis vector (normalized)
    h: torch.Tensor       # Hessenberg column, length m+1 (entries > j+1 zero)
    h_last: torch.Tensor  # h[j+1] = ||w|| before normalization


def _basis(v_basis: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The basis in w's dtype (a bf16 basis promotes as ``V @ w`` would)."""
    return v_basis.to(torch.promote_types(v_basis.dtype, w.dtype))


def cgs_step(v_basis, w, j: int) -> ArnoldiStep:
    """Classical GS (the paper's listing): one projection pass."""
    v = _basis(v_basis, w)
    h = (v @ w) * row_mask(v.shape[0], j, w.dtype, w.device)
    w = w - h @ v
    return finalize(w, h, j)


def cgs2_step(v_basis, w, j: int) -> ArnoldiStep:
    """CGS2: classical GS applied twice (full reorthogonalization)."""
    v = _basis(v_basis, w)
    mask = row_mask(v.shape[0], j, w.dtype, w.device)
    h1 = (v @ w) * mask
    w = w - h1 @ v
    h2 = (v @ w) * mask
    w = w - h2 @ v
    return finalize(w, h1 + h2, j)


def mgs_step(v_basis, w, j: int) -> ArnoldiStep:
    """Modified GS: sequential projections over the valid rows 0..j."""
    v = _basis(v_basis, w)
    hs = []
    for i in range(j + 1):
        hi = torch.dot(v[i], w)
        w = w - hi * v[i]
        hs.append(hi)
    h = torch.zeros(v.shape[0], dtype=w.dtype, device=w.device)
    h[: j + 1] = torch.stack(hs)
    return finalize(w, h, j)


def cgs2_fused_step(v_basis, w, j: int) -> ArnoldiStep:
    """CGS2 through the fused GS kernel (two launches per step)."""
    h, w2 = cgs2_k.cgs2(v_basis, w, j)
    return finalize(w2.to(w.dtype), h.to(w.dtype), j)


def finalize(w, h, j: int) -> ArnoldiStep:
    """Normalize the orthogonalized w and record the h[j+1] breakdown probe.

    Shared epilogue of every scheme and of the fused Arnoldi-step kernel.
    """
    h_last = norm(w)
    eps = torch.finfo(w.dtype).tiny ** 0.5
    v_next = w / torch.clamp(h_last, min=eps)   # breakdown-guarded
    h = h.clone()
    h[j + 1] = h_last
    return ArnoldiStep(v_next=v_next, h=h, h_last=h_last)


_SCHEMES: dict = {"cgs": cgs_step, "cgs2": cgs2_step, "mgs": mgs_step,
                  "cgs2_fused": cgs2_fused_step}


def step(scheme: str) -> Callable:
    if scheme == "cgs2_pipelined":
        raise NotImplementedError(
            "gs='cgs2_pipelined' (single-reduce pipelined CGS2) is not "
            "ported yet; it arrives with the pipelined-solver slice")
    try:
        return _SCHEMES[scheme]
    except KeyError:
        raise ValueError(f"unknown gram-schmidt scheme {scheme!r}; "
                         f"options: {sorted(_SCHEMES)} + ['fused']") from None
