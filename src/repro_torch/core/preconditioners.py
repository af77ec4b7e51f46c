"""The preconditioning subsystem: right preconditioners for every solver.

Counterpart of ``repro/core/preconditioners.py``.  Every member follows the
``Preconditioner`` protocol:

  apply      ``pc(v) -> M^{-1} v``.  Setup (factorizations, the spectral
             interval) runs once, eagerly, at construction.
  batched    ``pc.batched(vs)``: the (k, n) multi-lane form that
             ``gmres_batched`` uses; the default applies lane by lane,
             members with a cheaper block form override it.
  cost       ``pc.cost()`` -> ``PrecondCost``: modeled setup and apply flops,
             HBM bytes and ``matvec_equiv`` (the apply in operator mat-vecs).
  shard      ``pc.shard_aware`` + ``pc.rebind(op_local)``: rebuild against a
             local operator shard (``core/distributed.py`` calls it per
             rank; Jacobi takes the rank's own diagonal entries).
  identity   ``pc.n`` / ``pc.requires_fmt``: the operator dimension and the
             storage format a member needs.

Members: ``identity``; ``jacobi`` (diagonal scaling, every format);
``block_jacobi`` (dense block-diagonal LU, ``torch.linalg.lu_factor``, as
the JAX package uses ``jax.scipy.linalg`` outside any kernel); ``neumann``
(truncated Neumann series, a mat-vec chain); ``chebyshev`` (the degree-
``order`` Chebyshev polynomial for a spectrum in [lam_min, lam_max],
estimated by ``estimate_interval``; on a ``BandedOperator`` a single
vector runs the whole recurrence in one launch,
``kernels/matrix_powers.banded_cheb_apply``, everything else runs the
recurrence through the operator's own mat-vec, as every row-sharded
apply does); ``banded_ilu0`` (ILU(0) on
a ``BandedOperator``'s band pattern: ``kernels/trisolve.banded_ilu0`` for
the setup, two ``banded_trisweep`` launches per apply) and ``line_jacobi``
(the same on the (-1, 0, +1) bands, the exact tridiagonal factorization);
``banded_block_jacobi`` (``banded_ilu0`` that rebinds to a shard's own
diagonal block).  ``make_preconditioner`` builds one by registry name.

The first part of the module (``_diag_of``, ``_row_sums_and_diag``,
``spectral_bounds``) also gives the s-step solver's Newton basis its
shifts (``core/sstep.py::_newton_shifts``): those run on the operator's
device with no host sync, the bounds coming back as 0-d float32 tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from repro_torch.core.operators import (BandedOperator, DenseOperator,
                                        SlicedEllOperator, SparseOperator,
                                        as_operator)
from repro_torch.kernels import matrix_powers, trisolve, tuning


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


# --------------------------------------------------------------------------
# The protocol
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class PrecondCost:
    """Modeled cost account (floats: structural, not measured)."""
    setup_flops: float          # one-time construction cost
    apply_flops: float          # per apply(v)
    apply_hbm_bytes: float      # per apply(v), modeled operand traffic
    matvec_equiv: float         # apply cost in units of one op mat-vec


def _op_nnz(op) -> float:
    """Structural nonzeros of an explicit operator (dense counts all)."""
    if isinstance(op, BandedOperator):
        return float(op.bands.shape[0] * op.bands.shape[1])
    if isinstance(op, SparseOperator):
        return float(op.values.shape[0] * op.values.shape[1])
    if isinstance(op, SlicedEllOperator):
        return float(op.storage_entries)
    if isinstance(op, DenseOperator):
        return float(op.a.shape[0] * op.a.shape[1])
    n = _op_dim(op) or 0
    return float(n) * 8.0       # matrix-free: stencil-like guess


def _op_dim(op):
    """Row dimension of an operator (None when it cannot be told)."""
    shape = getattr(op, "shape", None)
    if shape is not None and len(shape):
        return int(shape[0])
    n = getattr(op, "n", None)
    return int(n) if n else None


def _as_op(a):
    """``a`` as an operator; a raw matrix stays on its own device."""
    if isinstance(a, torch.Tensor):
        return DenseOperator(a, device=a.device)
    return as_operator(a)


class Preconditioner:
    """Base protocol: a callable ``v -> M^{-1} v`` with metadata.

    Subclasses set ``name``/``shard_aware``/``requires_fmt`` and implement
    ``__call__`` (single-vector apply) and ``cost``.  ``n`` is the operator
    dimension the apply is bound to (``None`` = shape-agnostic).
    """

    name: str = "preconditioner"
    shard_aware: bool = False
    is_identity: bool = False
    requires_fmt: Optional[str] = None   # "dense" | "banded" | None (any)
    n: Optional[int] = None

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def batched(self, vs: torch.Tensor) -> torch.Tensor:
        """(k, n) -> (k, n) multi-lane apply; default: lane by lane."""
        return torch.stack([self(v) for v in vs])

    def rebind(self, op_local) -> "Preconditioner":
        """Rebuild against a local operator shard (only meaningful when
        ``shard_aware``)."""
        raise ValueError(
            f"preconditioner {self.name!r} is not shard-aware; "
            f"gmres_sharded supports identity/jacobi/chebyshev/"
            f"banded_block_jacobi (or the 'block_jacobi' dense string)")

    def cost(self) -> PrecondCost:
        return PrecondCost(0.0, 0.0, 0.0, 0.0)

    def __repr__(self):
        nn = "" if self.n is None else f", n={self.n}"
        return f"<{type(self).__name__} {self.name}{nn}>"


class IdentityPreconditioner(Preconditioner):
    name = "identity"
    shard_aware = True
    is_identity = True

    def __call__(self, v):
        return v

    def batched(self, vs):
        return vs

    def rebind(self, op_local):
        return self


class JacobiPreconditioner(Preconditioner):
    """Diagonal scaling M = diag(A), every format; a zero or tiny diagonal
    entry is guarded at tiny^(1/2) of its dtype, keeping its sign."""

    name = "jacobi"
    shard_aware = True

    def __init__(self, a):
        d = _diag_of(_as_op(a))
        guard = torch.finfo(d.dtype).tiny ** 0.5
        mag = torch.clamp(d.abs(), min=guard)
        self.inv_d = torch.sign(torch.where(d == 0, 1, d)) / mag
        self.n = int(d.shape[0])

    def __call__(self, v):
        return self.inv_d * v

    def batched(self, vs):
        return self.inv_d[None, :] * vs

    def rebind(self, op_local):
        # The local operator's storage is the local rows, so setup in local
        # coordinates is construction again, except where the diagonal is
        # not where a square local matrix would hold it: a dense (rows, n)
        # shard keeps it in its own diagonal block (columns rows * rank
        # on), a shard of ELL rows (global columns; a sliced-ELL operator's
        # shard too, when its halo fits) at column rows * rank + i of local
        # row i, and a replicated sliced-ELL payload at the rank's rows.
        # (JAX constructs again in every one of these cases, which reads
        # the wrong entries on every rank past 0: ROADMAP queue 3.)
        group = tuning.shard_axis()
        rank = 0 if group is None else group.rank()
        if isinstance(op_local, DenseOperator) and (
                op_local.a.shape[0] != op_local.a.shape[1]):
            rows = op_local.a.shape[0]
            return JacobiPreconditioner(
                op_local.a[:, rank * rows:(rank + 1) * rows])
        if isinstance(op_local, SparseOperator) and rank:
            rows = op_local.values.shape[0]
            shifted = SparseOperator(op_local.values,
                                     op_local.cols - rank * rows,
                                     device=op_local.values.device)
            return JacobiPreconditioner(shifted)
        pc = JacobiPreconditioner(op_local)
        if isinstance(op_local, SlicedEllOperator) and group is not None:
            # the replicated payload: the rank's rows of the diagonal
            rows = pc.n // group.size()
            pc.inv_d = pc.inv_d[rank * rows:(rank + 1) * rows]
            pc.n = rows
        return pc

    def cost(self):
        return PrecondCost(setup_flops=float(self.n or 0),
                           apply_flops=float(self.n or 0),
                           apply_hbm_bytes=12.0 * float(self.n or 0),
                           matvec_equiv=0.1)


class BlockJacobiPreconditioner(Preconditioner):
    """Dense block-diagonal M: LU of each ``block``-sized diagonal block
    (n divisible by ``block``), applied as a batched pair of triangular
    solves.  Dense single-shard only."""

    name = "block_jacobi"
    requires_fmt = "dense"

    def __init__(self, a, block: int):
        if isinstance(a, DenseOperator):
            a = a.a
        n = a.shape[0]
        if n % block:
            raise ValueError(f"block_jacobi: n = {n} is not a multiple of "
                             f"block = {block}")
        nb = n // block
        blocks = torch.stack([
            a[i * block:(i + 1) * block, i * block:(i + 1) * block]
            for i in range(nb)])
        self.lu, self.piv = torch.linalg.lu_factor(blocks)
        self.n = int(n)
        self.block = int(block)

    def __call__(self, v):
        vb = v.reshape(self.n // self.block, self.block, 1)
        return torch.linalg.lu_solve(self.lu, self.piv, vb).reshape(self.n)

    def cost(self):
        b = float(self.block)
        n = float(self.n)
        return PrecondCost(setup_flops=n * b * b * (2.0 / 3.0),
                           apply_flops=2.0 * n * b,
                           apply_hbm_bytes=4.0 * (n * b + 2 * n),
                           matvec_equiv=b / n)


class NeumannPreconditioner(Preconditioner):
    """Truncated Neumann series M^{-1} ~= sum_k (I - w D^{-1} A)^k w D^{-1}:
    a mat-vec chain."""

    name = "neumann"
    shard_aware = True

    def __init__(self, a, *, order: int = 2, omega: float | None = None):
        self.op = _as_op(a)
        self.inv_d = JacobiPreconditioner(self.op).inv_d
        self.order = int(order)
        self.omega = 1.0 if omega is None else float(omega)
        self.n = int(self.inv_d.shape[0])

    def __call__(self, v):
        z = self.omega * self.inv_d * v
        acc = z
        for _ in range(self.order):
            z = z - self.omega * self.inv_d * self.op(z)
            acc = acc + z
        return acc

    def rebind(self, op_local):
        pc = object.__new__(NeumannPreconditioner)
        pc.op = op_local
        pc.inv_d = JacobiPreconditioner(op_local).inv_d
        pc.order = self.order
        pc.omega = self.omega
        pc.n = self.n
        return pc

    def cost(self):
        nnz = _op_nnz(self.op)
        return PrecondCost(setup_flops=float(self.n),
                           apply_flops=self.order * 2.0 * nnz,
                           apply_hbm_bytes=self.order * 4.0 * nnz,
                           matvec_equiv=float(self.order))


# --------------------------------------------------------------------------
# Spectral-interval estimation (Chebyshev setup)
# --------------------------------------------------------------------------
def estimate_interval(a, *, iters: int = 8, floor: float = 1.0 / 30.0,
                      slack: float = 3.0) -> Tuple[float, float]:
    """Cheap eager spectral-interval estimate for Chebyshev setup.

    ``lam_max`` must bound the spectrum from above (beyond it the Chebyshev
    polynomial grows without sign control and can stall the solve), so the
    Gershgorin bound wins by default; ``iters`` power iterations from the
    float32 probe cos(0.7 i) + 0.5 give a Rayleigh estimate of the spectral
    radius, used only where Gershgorin is more than ``slack`` x that
    (then ``slack / 2`` x the radius).  ``lam_min`` is the Gershgorin lower
    bound clamped to ``floor * lam_max``.  Every term is a ratio of A's
    entries, so the estimate scales with A.  Returns Python floats (a few
    host syncs on the card, once per setup).
    """
    op = _as_op(a)
    lam_lo, lam_hi = spectral_bounds(op)
    gersh_max = float(lam_hi)
    n = _op_dim(op)
    dev = lam_hi.device
    v = torch.cos(torch.arange(n, dtype=torch.float32, device=dev) * 0.7) \
        + 0.5
    v = v / torch.linalg.norm(v)
    rayleigh = gersh_max
    for _ in range(max(iters, 1)):
        w = op(v.to(op_dtype(op))).to(torch.float32)
        rayleigh = float(torch.dot(v, w))
        nrm = float(torch.linalg.norm(w))
        if nrm <= 0.0:
            break
        v = w / nrm
    lam_max = gersh_max
    if abs(rayleigh) > 0.0 and gersh_max > slack * abs(rayleigh):
        lam_max = (slack / 2.0) * abs(rayleigh)
    if lam_max <= 0.0:
        lam_max = max(gersh_max, 1.0)
    lam_min = max(float(lam_lo), floor * lam_max)
    return lam_min, lam_max


def op_dtype(op):
    if isinstance(op, BandedOperator):
        return op.bands.dtype
    if isinstance(op, SparseOperator):
        return op.values.dtype
    if isinstance(op, DenseOperator):
        return op.a.dtype
    return torch.float32


def cheb_coeffs(order: int, lam_min: float, lam_max: float
                ) -> Tuple[float, float, Tuple[Tuple[float, float], ...]]:
    """Scalars of the degree-``order`` Chebyshev recurrence: (theta, delta,
    rhos), the interval's center and half-width and the ``order - 1``
    (rho, rho_old) pairs, all Python floats."""
    theta = 0.5 * (lam_max + lam_min)
    delta = max(0.5 * (lam_max - lam_min), 1e-12 * abs(theta) or 1e-30)
    sigma1 = theta / delta
    rhos = []
    rho_old = 1.0 / sigma1
    for _ in range(order - 1):
        rho = 1.0 / (2.0 * sigma1 - rho_old)
        rhos.append((rho, rho_old))
        rho_old = rho
    return theta, delta, tuple(rhos)


class ChebyshevPreconditioner(Preconditioner):
    """Chebyshev polynomial preconditioner for spectra in [lam_min, lam_max]
    (estimated by ``estimate_interval`` when not given).

    Dispatch: a single vector on a ``BandedOperator`` of one device goes
    to ``matrix_powers.banded_cheb_apply`` (the kernel on the card, at any
    n; its plain version on the CPU).  Everything else (dense, ELL, sliced
    ELL, matrix-free, the (k, n) ``batched`` form, and every row-sharded
    apply, whose mat-vecs must exchange the neighbours' rows) runs
    ``_apply_ref`` through the operator's own mat-vec.
    """

    name = "chebyshev"
    shard_aware = True

    def __init__(self, a, *, order: int = 4,
                 lam_min: Optional[float] = None,
                 lam_max: Optional[float] = None):
        self.op = _as_op(a)
        if lam_min is None or lam_max is None:
            lam_min, lam_max = estimate_interval(self.op)
        self.order = int(order)
        self.lam_min = float(lam_min)
        self.lam_max = float(lam_max)
        self.theta, self.delta, self.rhos = cheb_coeffs(
            self.order, self.lam_min, self.lam_max)
        self.n = _op_dim(self.op)

    def _apply_ref(self, v, matvec):
        theta, delta = self.theta, self.delta
        z = v / theta
        z_old = torch.zeros_like(v)
        for rho, rho_old in self.rhos:
            z_new = (rho * (2.0 / delta * (v - matvec(z))
                            + rho_old * (z - z_old)) + z)
            z_old, z = z, z_new
        return z

    def __call__(self, v):
        op = self.op
        if (tuning.shard_axis() is None and isinstance(op, BandedOperator)
                and v.ndim == 1):
            return matrix_powers.banded_cheb_apply(
                op.bands, v, op.offsets, theta=self.theta, delta=self.delta,
                rhos=self.rhos)
        return self._apply_ref(v, op)

    def batched(self, vs):
        # One operator stream per recurrence step for all k lanes.
        from repro_torch.core.gmres import _block_matvec
        return self._apply_ref(vs, _block_matvec(self.op))

    def rebind(self, op_local):
        pc = object.__new__(ChebyshevPreconditioner)
        pc.op = op_local
        pc.order = self.order
        pc.lam_min, pc.lam_max = self.lam_min, self.lam_max
        pc.theta, pc.delta, pc.rhos = self.theta, self.delta, self.rhos
        pc.n = self.n
        return pc

    def cost(self):
        nnz = _op_nnz(self.op)
        matvecs = float(self.order)
        return PrecondCost(
            setup_flops=10.0 * nnz,                  # interval estimation
            apply_flops=(matvecs * 2.0 * nnz
                         + matvecs * 6.0 * float(self.n or 0)),
            # the fused banded path streams the band stack once for all
            # `order` mat-vecs
            apply_hbm_bytes=4.0 * (nnz + 2.0 * float(self.n or 0)),
            matvec_equiv=matvecs)


class BandedILU0Preconditioner(Preconditioner):
    """ILU(0) on the band pattern of a ``BandedOperator``.

    Setup is one pass over the rows (``trisolve.banded_ilu0``); the apply is
    two banded triangular sweeps, unit-lower forward then upper backward
    (``trisolve.banded_trisweep``; the (k, n) ``batched`` form sweeps the k
    lanes in parallel).  ``pattern`` restricts the factorization to a subset
    of the offsets: ``(-1, 0, 1)`` is line-Jacobi.  Not shard-aware.
    """

    name = "banded_ilu0"
    requires_fmt = "banded"

    def __init__(self, op, *, pattern: Optional[Tuple[int, ...]] = None):
        if not isinstance(op, BandedOperator):
            raise ValueError(
                f"banded_ilu0 needs a BandedOperator (its setup walks the "
                f"band pattern); got {type(op).__name__} — use jacobi/"
                f"chebyshev for dense or ELL operators")
        self.op = op
        bands, offsets = op.bands, tuple(int(o) for o in op.offsets)
        if pattern is not None:
            keep = [d for d, off in enumerate(offsets) if off in pattern]
            if not any(offsets[d] == 0 for d in keep):
                raise ValueError("ilu0 pattern must include the diagonal")
            bands = bands[keep]
            offsets = tuple(offsets[d] for d in keep)
        self.pattern = pattern
        (self.l_bands, self.l_offsets,
         self.u_bands, self.u_offsets) = trisolve.banded_ilu0(
             bands.contiguous(), offsets)
        self.n = int(bands.shape[1])

    def __call__(self, v):
        z = trisolve.banded_trisweep(self.l_bands, v, self.l_offsets,
                                     unit_diag=True, lower=True)
        return trisolve.banded_trisweep(self.u_bands, z, self.u_offsets,
                                        unit_diag=False, lower=False)

    def batched(self, vs):
        return self(vs)

    def cost(self):
        nbands = float(self.l_bands.shape[0] + self.u_bands.shape[0])
        n = float(self.n)
        nnz = max(_op_nnz(self.op), 1.0)
        return PrecondCost(setup_flops=n * nbands * nbands,
                           apply_flops=2.0 * n * nbands,
                           apply_hbm_bytes=4.0 * (n * nbands + 3.0 * n),
                           matvec_equiv=(n * nbands) / nnz)


class BandedBlockJacobiPreconditioner(BandedILU0Preconditioner):
    """Shard-local banded block-Jacobi: ILU(0) of each shard's own diagonal
    block (on one card it is ``banded_ilu0``).  ``rebind`` factors a local
    shard's block, its out-of-range couplings masked at setup."""

    name = "banded_block_jacobi"
    shard_aware = True

    def rebind(self, op_local):
        return BandedBlockJacobiPreconditioner(op_local,
                                               pattern=self.pattern)


def make_preconditioner(name: str, op, **kw) -> Preconditioner:
    """Factory by registry name (see ``PRECONDITIONERS``)."""
    try:
        factory = PRECONDITIONERS[name]
    except KeyError:
        raise ValueError(f"unknown preconditioner {name!r}; options: "
                         f"{sorted(PRECONDITIONERS)}") from None
    return factory(op, **kw)


# --------------------------------------------------------------------------
# Factories (the JAX package's callable-style API)
# --------------------------------------------------------------------------
def identity() -> Preconditioner:
    return IdentityPreconditioner()


def jacobi(a) -> Preconditioner:
    """Diagonal scaling M = diag(A)."""
    return JacobiPreconditioner(a)


def block_jacobi(a, block: int) -> Preconditioner:
    return BlockJacobiPreconditioner(a, block)


def neumann(a, *, order: int = 2,
            omega: float | None = None) -> Preconditioner:
    return NeumannPreconditioner(a, order=order, omega=omega)


def chebyshev(a, *, order: int = 4, lam_min: Optional[float] = None,
              lam_max: Optional[float] = None) -> Preconditioner:
    return ChebyshevPreconditioner(a, order=order, lam_min=lam_min,
                                   lam_max=lam_max)


def banded_ilu0(op) -> Preconditioner:
    return BandedILU0Preconditioner(op)


def line_jacobi(op) -> Preconditioner:
    """ILU(0) restricted to the (-1, 0, +1) bands: the exact tridiagonal
    (Thomas) factorization of the operator's line coupling."""
    return BandedILU0Preconditioner(op, pattern=(-1, 0, 1))


def banded_block_jacobi(op) -> Preconditioner:
    return BandedBlockJacobiPreconditioner(op)


PRECONDITIONERS = {
    "none": lambda a, **kw: identity(),
    "jacobi": lambda a, **kw: jacobi(a),
    "block_jacobi": lambda a, block=64, **kw: block_jacobi(a, block),
    "neumann": lambda a, order=2, **kw: neumann(a, order=order),
    "chebyshev": lambda a, order=4, lam_min=None, lam_max=None, **kw:
        chebyshev(a, order=order, lam_min=lam_min, lam_max=lam_max),
    "banded_ilu0": lambda a, **kw: banded_ilu0(a),
    "line_jacobi": lambda a, **kw: line_jacobi(a),
    "banded_block_jacobi": lambda a, **kw: banded_block_jacobi(a),
}
