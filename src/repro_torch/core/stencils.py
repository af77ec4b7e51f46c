"""Classic sparse GMRES test problems as structured operators.

Counterpart of ``repro/core/stencils.py``.  Five/seven-point stencils on
regular grids (unit spacing, Dirichlet boundaries), built directly as band
vectors on the device: a 1024 x 1024 grid (n = 2^20) costs five band
vectors, never an (n, n) matrix.

  poisson_2d / poisson_3d     -Laplace, SPD: 4 (resp. 6) on the main
                              diagonal, -1 on each neighbour coupling.
  convection_diffusion_2d     Poisson plus a central-difference convection
                              term with velocity ``beta = (bx, by)``:
                              nonsymmetric, the canonical GMRES target.

``fmt`` picks the operator class the system comes back as: "banded"
(native), "ell" (the gather SpMV), "sell" (sliced ELL, which keeps the
original row order on these near-uniform rows) or "dense" (small grids
only).  Every format's mat-vec goes through the port's kernel wrappers
(the SpMV kernels, or the GEMV for "dense"), which launch on a CUDA tensor
and run their plain versions on a CPU tensor.  ``device`` (default
"cuda", raising without a card) is where the bands are built.  Grid
points are ordered x-fastest: site (ix, iy, iz) is row ``ix + nx * (iy +
ny * iz)``.
"""
from __future__ import annotations

import torch

from repro_torch import device as device_mod
from repro_torch.core.operators import (BandedOperator, DenseOperator,
                                        SlicedEllOperator)

FORMATS = ("banded", "ell", "sell", "dense")


def _assemble(bands, offsets, fmt: str):
    op = BandedOperator(bands, offsets, device=bands.device)
    if fmt == "banded":
        return op
    if fmt == "ell":
        return op.to_ell()
    if fmt == "sell":
        return SlicedEllOperator.from_ell(op.to_ell())
    return DenseOperator(op.todense(), "cuda", device=bands.device)


def _grid(n: int, dtype, fmt: str, device):
    if fmt not in FORMATS:
        raise ValueError(f"unknown fmt {fmt!r}; options: banded, ell, sell, "
                         f"dense")
    dev = device_mod.resolve(device)
    i = torch.arange(n, device=dev)
    one = torch.ones((n,), dtype=dtype, device=dev)
    return i, one, torch.zeros_like(one)


def poisson_2d(nx: int, ny: int | None = None, *, dtype=torch.float32,
               fmt: str = "banded", device="cuda"):
    """2-D Poisson five-point stencil on an nx-by-ny grid (SPD, n = nx*ny)."""
    ny = nx if ny is None else ny
    n = nx * ny
    i, one, zero = _grid(n, dtype, fmt, device)
    west = torch.where(i % nx != 0, -one, zero)       # couples x[i - 1]
    east = torch.where(i % nx != nx - 1, -one, zero)  # couples x[i + 1]
    south = torch.where(i >= nx, -one, zero)          # couples x[i - nx]
    north = torch.where(i < n - nx, -one, zero)       # couples x[i + nx]
    bands = torch.stack([south, west, 4 * one, east, north])
    return _assemble(bands, (-nx, -1, 0, 1, nx), fmt)


def poisson_3d(nx: int, ny: int | None = None, nz: int | None = None, *,
               dtype=torch.float32, fmt: str = "banded", device="cuda"):
    """3-D Poisson seven-point stencil on nx-by-ny-by-nz (SPD)."""
    ny = nx if ny is None else ny
    nz = nx if nz is None else nz
    n = nx * ny * nz
    nxy = nx * ny
    i, one, zero = _grid(n, dtype, fmt, device)
    west = torch.where(i % nx != 0, -one, zero)
    east = torch.where(i % nx != nx - 1, -one, zero)
    south = torch.where((i // nx) % ny != 0, -one, zero)
    north = torch.where((i // nx) % ny != ny - 1, -one, zero)
    down = torch.where(i >= nxy, -one, zero)
    up = torch.where(i < n - nxy, -one, zero)
    bands = torch.stack([down, south, west, 6 * one, east, north, up])
    return _assemble(bands, (-nxy, -nx, -1, 0, 1, nx, nxy), fmt)


def convection_diffusion_2d(nx: int, ny: int | None = None, *,
                            beta=(0.5, 0.25), dtype=torch.float32,
                            fmt: str = "banded", device="cuda"):
    """2-D convection-diffusion five-point stencil (nonsymmetric).

    Central differences of ``-Laplace(u) + beta . grad(u)``: the
    x-coupling is ``-1 +- bx/2`` and the y-coupling ``-1 +- by/2`` on top
    of the Poisson diagonal of 4; ``beta = (0, 0)`` is ``poisson_2d``.
    """
    ny = nx if ny is None else ny
    n = nx * ny
    i, one, zero = _grid(n, dtype, fmt, device)
    bx, by = (torch.tensor(b, dtype=dtype, device=one.device) / 2
              for b in beta)
    west = torch.where(i % nx != 0, (-1 - bx) * one, zero)
    east = torch.where(i % nx != nx - 1, (-1 + bx) * one, zero)
    south = torch.where(i >= nx, (-1 - by) * one, zero)
    north = torch.where(i < n - nx, (-1 + by) * one, zero)
    bands = torch.stack([south, west, 4 * one, east, north])
    return _assemble(bands, (-nx, -1, 0, 1, nx), fmt)
