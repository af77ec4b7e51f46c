"""Arnoldi iteration step: builds the Krylov basis one vector at a time.

Counterpart of ``repro/core/arnoldi.py``.  Schemes:

- ``cgs``  — classical Gram-Schmidt, the scheme in the paper's listing.
- ``mgs``  — modified Gram-Schmidt (what pracma::gmres uses).
- ``cgs2`` — classical Gram-Schmidt twice (reorthogonalized), in PyTorch.
- ``cgs2_fused`` — the same CGS2 arithmetic through the fused GS kernel
             (``kernels/cgs2.py``, ``csrc/cgs2.cu``) on the card, its plain
             version on the CPU.
- ``cgs2_pipelined`` — single-reduce CGS2, a whole-cycle scheme
             (``core/gmres.py::_gmres_cycle_pipelined``); this module holds
             its payload (``sr_payload``, one kernel launch) and the
             host-side recovery (``sr_recover``).

The basis ``V`` is stored row-major (m+1, n): basis vector j is row j.
Every step returns a device-resident ``ArnoldiStep``; nothing here syncs
with the host.

Every scheme takes an optional ``axis_name``: a ``torch.distributed``
process group (JAX's mesh axis).  Vectors are then the local shard of a
row-sharded vector and every inner product is completed by an all-reduce
over the group (``kernels/tuning.py::all_reduce``, JAX's ``psum``);
``cgs2_fused`` runs the split-phase kernel pair (``cgs2_split``).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.kernels import cgs2 as cgs2_k
from repro_torch.kernels import tuning
from repro_torch.kernels.ref import row_mask


def _psum(x: torch.Tensor, axis_name) -> torch.Tensor:
    return tuning.all_reduce(x, axis_name)


def _dot(a: torch.Tensor, b: torch.Tensor, axis_name) -> torch.Tensor:
    return _psum(torch.dot(a, b), axis_name)


def norm(v: torch.Tensor, axis_name=None) -> torch.Tensor:
    return torch.sqrt(_dot(v, v, axis_name))


class ArnoldiStep(NamedTuple):
    v_next: torch.Tensor  # candidate basis vector (normalized)
    h: torch.Tensor       # Hessenberg column, length m+1 (entries > j+1 zero)
    h_last: torch.Tensor  # h[j+1] = ||w|| before normalization


def _basis(v_basis: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The basis in w's dtype (a bf16 basis promotes as ``V @ w`` would)."""
    return v_basis.to(torch.promote_types(v_basis.dtype, w.dtype))


def cgs_step(v_basis, w, j: int, axis_name=None) -> ArnoldiStep:
    """Classical GS (the paper's listing): one projection pass."""
    v = _basis(v_basis, w)
    h = _psum(v @ w, axis_name) * row_mask(v.shape[0], j, w.dtype, w.device)
    w = w - h @ v
    return finalize(w, h, j, axis_name)


def cgs2_step(v_basis, w, j: int, axis_name=None) -> ArnoldiStep:
    """CGS2: classical GS applied twice (full reorthogonalization)."""
    v = _basis(v_basis, w)
    mask = row_mask(v.shape[0], j, w.dtype, w.device)
    h1 = _psum(v @ w, axis_name) * mask
    w = w - h1 @ v
    h2 = _psum(v @ w, axis_name) * mask
    w = w - h2 @ v
    return finalize(w, h1 + h2, j, axis_name)


def mgs_step(v_basis, w, j: int, axis_name=None) -> ArnoldiStep:
    """Modified GS: sequential projections over the valid rows 0..j (one
    all-reduce per row when sharded; the JAX loop runs all m+1 rows with
    the rows past j masked, and so pays m+1)."""
    v = _basis(v_basis, w)
    hs = []
    for i in range(j + 1):
        hi = _dot(v[i], w, axis_name)
        w = w - hi * v[i]
        hs.append(hi)
    h = torch.zeros(v.shape[0], dtype=w.dtype, device=w.device)
    h[: j + 1] = torch.stack(hs)
    return finalize(w, h, j, axis_name)


def cgs2_fused_step(v_basis, w, j: int, axis_name=None) -> ArnoldiStep:
    """CGS2 through the kernels: the fused GS pass (two launches per step),
    or row-sharded the split-phase pair (project, all-reduce, update,
    twice)."""
    if axis_name is None:
        h, w2 = cgs2_k.cgs2(v_basis, w, j)
    else:
        h, w2 = cgs2_k.cgs2_split(v_basis, w, j, axis_name)
    return finalize(w2.to(w.dtype), h.to(w.dtype), j, axis_name)


# --------------------------------------------------------------------------
# Single-reduce CGS2 (gs="cgs2_pipelined"): payload + replicated recovery
# --------------------------------------------------------------------------
#
# The split-phase CGS2 step pays three collective rounds (h1 psum, h2 psum,
# norm psum).  The single-reduce scheme packs everything one step needs into
# ONE stacked payload over the column block W = [z, v_j]:
#
#     p = psum([ mask * (V @ [z, v_j]) ; z.z, v_j.v_j ])   -- (m+2, 2)
#
# Column 0 is the projection of the fresh mat-vec output; column 1 is the
# MEASURED row j of the basis Gram matrix G = V V^T — v_j was built (and
# normalized) last step, so its actual inner products against the older
# rows carry every rounding error of that update.  This measurement is the
# load-bearing part: a G maintained by algebraic prediction alone (the
# g_col = (h1 - G h_tot)/s recurrence of the classical derivation) cannot
# see update/normalization rounding, and the norm recovery's cancellation
# amplifies the resulting G drift by ~||h||^2/||w''||^2 per step —
# orthogonality collapses within a handful of steps on fast-converging
# systems.  With G measured, the recovery is replicated O(m^2) algebra:
#
#     h1     = mask * p[:m1, 0]       zeta = p[m1, 0] = ||z||^2
#     G[j,:] = G[:,j] = mask * p[:m1, 1]   (measured, overwrites the j row)
#     h2     = mask * (h1 - G h1)     (delayed reorthogonalization)
#     h_tot  = h1 + h2                w'' = z - h_tot @ V   (single update)
#     ||w''||^2 = zeta - 2 h_tot.h1 + h_tot.G.h_tot   (exact quadratic form)
#
# No second projection pass, no separate norm psum, no predicted Gram
# column.  The G entries are immutable once measured (basis rows never
# change), so G converges to the true floating-point Gram matrix of the
# basis as built; each restart still recomputes the TRUE residual, which
# is what the +-1-restart parity contract absorbs.
#
# In the port the payload is one kernel launch
# (``kernels/cgs2.py::gs_project_norm_partial``), all-reduced once by the
# cycle when row-sharded; its (m1+1, 2) result is the step's one copy to
# the host, and the recovery runs there, in numpy.


def sr_payload_ref(v_basis, z, j: int) -> torch.Tensor:
    """Plain version of the payload: the (m1 + 1, 2) block
    ``[mask * (V @ [z, v_j]); z.z, v_j.v_j]`` -- column 0 the projection of
    the mat-vec output, column 1 the measured Gram row of basis row j."""
    return cgs2_k.gs_project_norm_partial_plain(v_basis, z, j)


def sr_payload(v_basis, z, j: int) -> torch.Tensor:
    """The single-reduce payload through the payload kernel (its plain
    version for CPU tensors).  Row-sharded, this is one shard's partial:
    the pipelined cycle all-reduces it itself, after it has issued the
    next mat-vec (and so that mat-vec's halo exchange), the one order of
    collectives every rank keeps."""
    return cgs2_k.gs_project_norm_partial(v_basis, z, j)


def sr_recover(payload: np.ndarray, gram: np.ndarray, j: int):
    """Single-reduce recovery on the host (O(m^2) flops, numpy).

    payload: the (m1+1, 2) block on the host; gram: the maintained (m1, m1)
    basis Gram matrix (identity at cycle start), overwritten in place;
    j: current step index.  The arithmetic runs in the payload's dtype
    (float32 for a float32 solve), as the JAX recovery does.

    Returns ``(h_tot, s_norm, zeta, gram)`` -- the combined two-pass
    Hessenberg coefficients, the recovered norm ||w''||, the raw ||z||^2,
    and the Gram matrix with row/column j overwritten by the MEASURED
    inner products of basis row j (payload column 1).
    """
    m1 = gram.shape[0]
    dt = payload.dtype
    mask = (np.arange(m1) <= j).astype(dt)
    h1 = payload[:m1, 0] * mask
    zeta = np.maximum(payload[m1, 0], dt.type(0))
    g_row = payload[:m1, 1] * mask        # measured V @ v_j (diag at j)
    gram[j, :] = g_row
    gram[:, j] = g_row
    h2 = (h1 - gram @ h1) * mask          # second pass against measured G
    h_tot = h1 + h2
    delta = zeta - dt.type(2) * (h_tot @ h1) + h_tot @ (gram @ h_tot)
    s_norm = np.sqrt(np.maximum(delta, dt.type(0)))
    return h_tot, s_norm, zeta, gram


def finalize(w, h, j: int, axis_name=None) -> ArnoldiStep:
    """Normalize the orthogonalized w and record the h[j+1] breakdown probe.

    Shared epilogue of every scheme and of the fused Arnoldi-step kernel.
    """
    h_last = norm(w, axis_name)
    eps = torch.finfo(w.dtype).tiny ** 0.5
    v_next = w / torch.clamp(h_last, min=eps)   # breakdown-guarded
    h = h.clone()
    h[j + 1] = h_last
    return ArnoldiStep(v_next=v_next, h=h, h_last=h_last)


_SCHEMES: dict = {"cgs": cgs_step, "cgs2": cgs2_step, "mgs": mgs_step,
                  "cgs2_fused": cgs2_fused_step}


def step(scheme: str) -> Callable:
    if scheme == "cgs2_pipelined":
        # Stateful scheme (carries a Gram matrix and the pipelined matvec
        # across steps) -- implemented as a dedicated cycle in core/gmres.py,
        # not as a per-step function.  The batched solver degrades it to
        # plain CGS2.
        raise ValueError(
            "gs='cgs2_pipelined' is a whole-cycle scheme handled inside "
            "gmres(); use step('cgs2') for a stateless equivalent")
    try:
        return _SCHEMES[scheme]
    except KeyError:
        raise ValueError(f"unknown gram-schmidt scheme {scheme!r}; "
                         f"options: {sorted(_SCHEMES)} + ['fused', "
                         f"'cgs2_pipelined']") from None
