"""Diagonal, row sums and Gershgorin bounds of an explicit operator.

Counterpart of the first part of ``repro/core/preconditioners.py``:
``_diag_of``, ``_sell_rowreduce``, ``_row_sums_and_diag`` and
``spectral_bounds``, for dense, ELL, banded and sliced-ELL operators.
The s-step solver's Newton basis (``core/sstep.py::_newton_shifts``) reads
its shifts from these bounds.  The preconditioners themselves (the
protocol, the registry and the Jacobi / Chebyshev / ILU(0) members) come
with the preconditioning slice.

Everything runs on the operator's device with no host sync: the bounds
come back as 0-d float32 tensors.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from repro_torch.core.operators import (BandedOperator, DenseOperator,
                                        SlicedEllOperator, SparseOperator)


def _sell_rowreduce(op: SlicedEllOperator, fn: Callable) -> torch.Tensor:
    """Apply ``fn(vals, cols, orig_rows) -> (rows_b,)`` per sliced-ELL bin
    and scatter the concatenated result back to original row order."""
    parts, start = [], 0
    for vals, cols in zip(op.bin_values, op.bin_cols):
        rb = vals.shape[0]
        parts.append(fn(vals, cols, op.perm[start:start + rb]))
        start += rb
    out = torch.cat(parts) if len(parts) > 1 else parts[0]
    if op.identity_perm:
        return out
    return torch.zeros_like(out).index_copy_(0, op.perm.long(), out)


def _diag_of(op) -> torch.Tensor:
    """Main diagonal of an explicit operator, any storage format."""
    if isinstance(op, DenseOperator):
        return torch.diagonal(op.a)
    if isinstance(op, BandedOperator):
        if 0 not in op.offsets:
            raise ValueError("jacobi needs the main diagonal; this banded "
                             "operator has no offset-0 band")
        return op.bands[op.offsets.index(0)]
    if isinstance(op, SparseOperator):
        n = op.values.shape[0]
        hit = op.cols == torch.arange(n, device=op.cols.device)[:, None]
        return torch.where(hit, op.values, 0).sum(dim=1).to(op.values.dtype)
    if isinstance(op, SlicedEllOperator):
        # A row's diagonal is where a stored global column equals the
        # row's original index (a padding slot holds 0, so a spurious
        # column-0 match on original row 0 adds exactly 0).
        return _sell_rowreduce(
            op, lambda vals, cols, orig:
                torch.where(cols == orig[:, None], vals, 0).sum(dim=1)
                .to(vals.dtype))
    raise ValueError(f"jacobi needs explicit storage to read diag(A); got "
                     f"{type(op).__name__}")


def _row_sums_and_diag(op) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum_j |a_ij|, a_ii) per row for any explicit operator, float32."""
    f32 = torch.float32
    if isinstance(op, BandedOperator):
        nbands, n = op.bands.shape
        i = torch.arange(n, device=op.bands.device)
        sums = torch.zeros((n,), dtype=f32, device=op.bands.device)
        for d, off in enumerate(op.offsets):
            valid = (i + off >= 0) & (i + off < n)
            sums = sums + torch.where(valid, op.bands[d].to(f32).abs(), 0.0)
        return sums, _diag_of(op).to(f32)
    if isinstance(op, SparseOperator):
        return op.values.to(f32).abs().sum(dim=1), _diag_of(op).to(f32)
    if isinstance(op, SlicedEllOperator):
        sums = _sell_rowreduce(
            op, lambda vals, cols, orig: vals.to(f32).abs().sum(dim=1))
        return sums, _diag_of(op).to(f32)
    if isinstance(op, DenseOperator):
        a = op.a.to(f32)
        return a.abs().sum(dim=1), torch.diagonal(a)
    raise ValueError(f"spectral bounds need explicit storage; got "
                     f"{type(op).__name__}")


def spectral_bounds(op) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gershgorin bounds (lam_lo, lam_hi) as 0-d tensors on op's device.

    ``lam_lo`` may be <= 0 for systems that are not strictly dominant (2-D
    Poisson touches 0 at the boundary rows).
    """
    sums, diag = _row_sums_and_diag(op)
    radius = sums - diag.abs()
    return (diag - radius).min(), (diag + radius).max()
