"""Linear operators for the solver: dense, sparse, banded and matrix-free.

Counterpart of ``repro/core/operators.py``:

  DenseOperator      explicit (n, n) matrix (the paper's setting)
  SparseOperator     ELL: fixed-width per-row nonzeros (values/cols)
  SlicedEllOperator  sliced ELL: rows sorted by nonzero count into slices,
                     each padded to its own widest row, merged into at most
                     ``max_bins`` width bins (power-law graphs)
  BandedOperator     DIA band stack + diagonal offsets (stencils)
  FunctionOperator   matrix-free ``v -> A @ v`` callable

plus ``with_dtype``, ``as_operator`` and the test matrices.

Row-sharded (inside ``kernels/tuning.py::shard_context``, which
``core/distributed.py`` enters), an operator holds one rank's rows and
maps a local shard of v to the local shard of A v, as the JAX package's
``_sharded_call`` paths do:

  dense       all-gather v, then the local (n_local, n) rows' GEMV
  ELL         a halo exchange and the ELL kernel's halo mode over the
              columns in the halo frame; without a halo bound that fits a
              shard, all-gather v and the same kernel over it
  banded      a halo exchange and the banded kernel's halo mode (halo >
              n_local: JAX's all-gather window)
  sliced ELL  with a halo bound that fits a shard, the rank's rows of
              ``to_ell_arrays()`` as an ELL shard; else the payload is
              replicated: all-gather, the sorted product and the rank's
              rows of it

``DenseOperator`` takes ``backend=`` to select its mat-vec path:

  "torch" — plain PyTorch (JAX's "jnp"): ``a @ v``
  "cuda"  — the hand-written GEMV (JAX's "pallas", ``kernels/matvec.py``)

The sparse operators (ELL, banded, sliced ELL) have no such switch: they
always call the SpMV wrappers (``kernels/spmv.py``), which launch the
kernel on a CUDA tensor and run the plain version on a CPU tensor.

Every ``__call__`` takes an (n,) vector or an (n, k) block (one stream of
the matrix for all k columns: ``gmres_batched`` rides this) and returns the
dtype ``a @ v`` promotes to, accumulating in float32 at least.

Constructors default to ``device="cuda"`` and raise without a card unless
the caller passes ``device="cpu"``.  The ``from_dense`` / ``from_ell``
constructors run on the host in numpy, as the JAX package's do, so their
structure (columns, halo, bins, permutation) is the same element for
element.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.kernels import matvec as matvec_k
from repro_torch.kernels import spmv, tuning

BACKENDS = ("torch", "cuda")


def _host(a):
    """(numpy array, torch dtype) of a matrix given as a tensor or array.
    bfloat16 crosses as float32, which holds it exactly."""
    if isinstance(a, torch.Tensor):
        dtype = a.dtype
        a = a.detach().cpu()
        if dtype == torch.bfloat16:
            a = a.float()
        return a.numpy(), dtype
    a = np.asarray(a)
    return a, torch.from_numpy(np.zeros((), a.dtype)).dtype


def _on(arr: np.ndarray, device, dtype=None) -> torch.Tensor:
    t = device_mod.as_tensor(arr, device)
    return t if dtype is None else t.to(dtype)


class DenseOperator:
    """Explicit dense (n, n) matrix operator (the paper's setting)."""

    def __init__(self, a, backend: str = "torch", device="cuda"):
        if backend not in BACKENDS:
            raise ValueError(f"DenseOperator: backend {backend!r} not in "
                             f"{BACKENDS}")
        self.a = device_mod.as_tensor(a, device)
        self.backend = backend

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        # v: (n,) or (n, k); row-sharded, the local shard: dense rows touch
        # every column, so the operand gather is irreducible.
        group = tuning.shard_axis()
        if group is not None:
            v = tuning.all_gather(v, group)
        if self.backend == "cuda":
            if v.ndim == 1:
                return matvec_k.matvec(self.a, v)
            return matvec_k.block_matvec(self.a, v)
        dt = torch.promote_types(self.a.dtype, v.dtype)
        return self.a.to(dt) @ v.to(dt)

    @property
    def shape(self):
        return tuple(self.a.shape)

    @property
    def dtype(self):
        return self.a.dtype


@dataclasses.dataclass
class FunctionOperator:
    """Matrix-free operator ``v -> A @ v``; ``captures`` are extra args."""

    fn: Callable[..., torch.Tensor]
    n: int
    captures: Any = ()

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        return self.fn(v, *self.captures) if self.captures else self.fn(v)

    @property
    def shape(self):
        return (self.n, self.n)


class SparseOperator:
    """ELL-format sparse operator: fixed-width per-row nonzeros.

    Row i stores its nonzeros in ``values[i, :]`` with their int32 column
    indices in ``cols[i, :]``, padded to the shared width (padding slots
    hold value 0 at column 0, so every gather stays in bounds).  ``halo``
    is the bandwidth bound max |col - row| over the nonzeros, recorded by
    the constructors for the row-sharded solve.

    A rank's shard (``core/distributed.py::local_operator``) holds its rows
    with global ``cols``, and, when ``halo`` fits a shard, ``halo_cols``:
    the same columns in the rank's halo frame (global - rank * n_local +
    halo, clipped as JAX clips them: a padding slot, value 0 at column 0,
    lands in range and adds 0).
    """

    def __init__(self, values, cols, halo: Optional[int] = None,
                 device="cuda", halo_cols=None):
        self.values = device_mod.as_tensor(values, device)
        self.cols = device_mod.as_tensor(cols, device).to(torch.int32)
        if self.values.ndim != 2 or self.cols.shape != self.values.shape:
            raise TypeError(f"SparseOperator: values "
                            f"{tuple(self.values.shape)} and cols "
                            f"{tuple(self.cols.shape)} must be one (n, "
                            f"width) shape")
        self.halo = halo
        self.halo_cols = halo_cols

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        group = tuning.shard_axis()
        if group is None:
            return spmv.ell_matvec(self.values, self.cols, v)
        # Row-sharded: the halo exchange and the ELL kernel's halo mode;
        # without halo columns, the same kernel over the all-gathered
        # operand, whose frame the global columns already are.
        if self.halo_cols is not None:
            return spmv.ell_matvec_halo(
                self.values, self.halo_cols,
                spmv.halo_exchange(v, self.halo, group))
        return spmv.ell_matvec_halo(self.values, self.cols,
                                    tuning.all_gather(v, group))

    @classmethod
    def from_dense(cls, a, *, width: int | None = None,
                   device="cuda") -> "SparseOperator":
        """Compress a dense (n, n) matrix to ELL form (host-side numpy).

        ``width`` defaults to the widest row's nonzero count; a smaller
        width raises rather than dropping entries.  The ``halo`` bound is
        recorded from the nonzero pattern.
        """
        device_mod.resolve(device)
        a_np, dtype = _host(a)
        n = a_np.shape[0]
        mask = a_np != 0
        max_nnz = int(mask.sum(axis=1).max()) if n else 0
        if width is None:
            width = max(max_nnz, 1)
        elif width < max_nnz:
            raise ValueError(f"from_dense: width={width} < widest row "
                             f"({max_nnz} nonzeros) — entries would be "
                             f"dropped")
        # Stable argsort puts each row's nonzero columns first, in order.
        order = np.argsort(~mask, axis=1, kind="stable")[:, :width]
        vals = np.take_along_axis(a_np, order, axis=1)
        keep = np.take_along_axis(mask, order, axis=1)
        rows, nz_cols = np.nonzero(mask)
        halo = int(np.abs(nz_cols - rows).max()) if rows.size else 0
        return cls(_on(np.where(keep, vals, 0).astype(a_np.dtype), device,
                       dtype),
                   _on(np.where(keep, order, 0).astype(np.int32), device),
                   halo, device=device)

    def todense(self) -> torch.Tensor:
        """Materialize the dense (n, n) matrix (tests / small systems)."""
        n, width = self.values.shape
        rows = torch.arange(n, device=self.values.device).repeat_interleave(
            width)
        a = torch.zeros((n, n), dtype=self.values.dtype,
                        device=self.values.device)
        return a.index_put_((rows, self.cols.reshape(-1).long()),
                            self.values.reshape(-1), accumulate=True)

    @property
    def shape(self):
        n = self.values.shape[0]
        return (n, n)

    @property
    def dtype(self):
        return self.values.dtype


class BandedOperator:
    """DIA-style banded operator: ``y[i] = sum_d bands[d, i] * x[i + off_d]``.

    ``bands`` is (nbands, n): band d holds the entries ``A[i, i +
    offsets[d]]`` at index i.  Out-of-range reads count as zero, so
    Dirichlet boundaries are free.
    """

    def __init__(self, bands, offsets, device="cuda"):
        self.bands = device_mod.as_tensor(bands, device)
        self.offsets = tuple(int(o) for o in offsets)
        if self.bands.ndim != 2 or len(self.offsets) != self.bands.shape[0]:
            raise TypeError(f"BandedOperator: bands "
                            f"{tuple(self.bands.shape)} need one offset per "
                            f"band, got {len(self.offsets)}")

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        group = tuning.shard_axis()
        if group is not None:
            return self._sharded_call(v, group)
        return spmv.banded_matvec(self.bands, v, self.offsets)

    def _sharded_call(self, v: torch.Tensor, group) -> torch.Tensor:
        """Halo exchange and the banded kernel's halo mode over the local
        (nbands, n_local) slice of the band stack; the edge ranks' zero
        halos are the single-device kernel's zero reads.  A stencil wider
        than a shard takes JAX's all-gather window."""
        n = self.bands.shape[1]
        halo = max(abs(o) for o in self.offsets)
        if halo > n:
            x_full = tuning.all_gather(v, group)
            pad = torch.zeros((halo,) + tuple(v.shape[1:]), dtype=v.dtype,
                              device=v.device)
            start = group.rank() * n
            x_halo = torch.cat([pad, x_full, pad])[start:start + n + 2 * halo]
        else:
            x_halo = spmv.halo_exchange(v, halo, group)
        return spmv.banded_matvec_halo(self.bands, x_halo, self.offsets)

    def to_ell(self) -> SparseOperator:
        """Convert to ELL form (width = nbands; OOB slots become padding)."""
        nbands, n = self.bands.shape
        i = torch.arange(n, device=self.bands.device)
        cols = torch.stack([i + off for off in self.offsets], dim=1)
        valid = (cols >= 0) & (cols < n)
        vals = torch.where(valid, self.bands.T,
                           torch.zeros((), dtype=self.bands.dtype,
                                       device=self.bands.device))
        halo = max((abs(o) for o in self.offsets), default=0)
        return SparseOperator(vals.contiguous(),
                              torch.where(valid, cols, 0).to(torch.int32),
                              halo, device=self.bands.device)

    def todense(self) -> torch.Tensor:
        """Materialize the dense (n, n) matrix (tests / small systems)."""
        nbands, n = self.bands.shape
        a = torch.zeros((n, n), dtype=self.bands.dtype,
                        device=self.bands.device)
        for d, off in enumerate(self.offsets):
            band = self.bands[d]
            diag = band[:n - off] if off >= 0 else band[-off:]
            a = a + torch.diag(diag, off)
        return a

    @property
    def shape(self):
        n = self.bands.shape[1]
        return (n, n)

    @property
    def dtype(self):
        return self.bands.dtype


class SlicedEllOperator:
    """Sliced-ELL (SELL-C-sigma-style) operator for irregular row patterns.

    Rows are sorted by nonzero count (descending, stable), cut into slices
    of ``slice_height`` rows, each padded only to its own widest row, and
    runs of same-width slices are stored as one rectangle, a width bin:

      bin_values[b]  (rows_b, width_b)  values, sorted-row frame
      bin_cols[b]    (rows_b, width_b)  int32 global column indices
      perm           (n,) int32, perm[i] = original row at sorted slot i

    The mat-vec is one launch of the sliced-ELL kernel over the bin table
    (``spmv.sell_matvec``), which writes row r of the sorted frame to
    y[perm[r]]: no scatter (the JAX package scatters outside its kernel;
    on a CPU tensor the plain version does).  Where sorting would not
    shrink storage by 10% (the stencils), the constructors keep the
    original order, ``identity_perm`` is set, and no permutation is
    passed.
    """

    def __init__(self, bin_values, bin_cols, perm,
                 halo: Optional[int] = None, slice_height: int = 64,
                 identity_perm: bool = False, device="cuda"):
        self.bin_values = tuple(device_mod.as_tensor(v, device)
                                for v in bin_values)
        self.bin_cols = tuple(device_mod.as_tensor(c, device).to(torch.int32)
                              for c in bin_cols)
        self.perm = device_mod.as_tensor(perm, device).to(torch.int32)
        self.halo = halo
        self.slice_height = int(slice_height)
        self.identity_perm = bool(identity_perm)
        self._out_perm = None if self.identity_perm else self.perm

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        group = tuning.shard_axis()
        if group is not None:
            return self._sharded_call(v, group)
        return spmv.sell_matvec(self.bin_values, self.bin_cols, v,
                                self._out_perm)

    def _sharded_call(self, v: torch.Tensor, group) -> torch.Tensor:
        """The replicated payload (a halo bound too wide for a shard: with
        one that fits, ``local_operator`` hands each rank its rows as ELL):
        all-gather v, the product in the original order, and the rank's
        rows of it."""
        nl = v.shape[0]
        p = group.rank()
        x_full = tuning.all_gather(v, group)
        y = spmv.sell_matvec(self.bin_values, self.bin_cols, x_full,
                             self._out_perm)
        return y[p * nl:(p + 1) * nl]

    # -- format conversions -------------------------------------------------
    @classmethod
    def from_dense(cls, a, *, slice_height: int = 64,
                   sort: bool | str = "auto", max_bins: int = 8,
                   device="cuda") -> "SlicedEllOperator":
        """Compress a dense (n, n) matrix to sliced-ELL form (host numpy).

        ``sort="auto"`` sorts rows by nonzero count only when that shrinks
        slice storage by at least 10%; True/False force it.
        """
        device_mod.resolve(device)
        a_np, dtype = _host(a)
        n = a_np.shape[0]
        mask = a_np != 0
        nnz = mask.sum(axis=1)
        wtab = max(int(nnz.max()) if n else 0, 1)
        order = np.argsort(~mask, axis=1, kind="stable")[:, :wtab]
        vals = np.take_along_axis(a_np, order, axis=1)
        keep = np.take_along_axis(mask, order, axis=1)
        row_vals = np.where(keep, vals, 0).astype(a_np.dtype)
        row_cols = np.where(keep, order, 0)
        rows, nz_cols = np.nonzero(mask)
        halo = int(np.abs(nz_cols - rows).max()) if rows.size else 0
        return cls._build(row_vals, row_cols, nnz, slice_height, halo,
                          sort=sort, max_bins=max_bins, device=device,
                          dtype=dtype)

    @classmethod
    def from_ell(cls, sp: SparseOperator, *, slice_height: int = 64,
                 sort: bool | str = "auto",
                 max_bins: int = 8) -> "SlicedEllOperator":
        """Re-slice a plain-ELL operator (value-0 slots become padding), on
        the ELL operator's device."""
        vals_np, dtype = _host(sp.values)
        cols_np = sp.cols.cpu().numpy()
        mask = vals_np != 0
        nnz = mask.sum(axis=1)
        # Pack each row's nonzero slots first (stable, order-preserving).
        order = np.argsort(~mask, axis=1, kind="stable")
        keep = np.take_along_axis(mask, order, axis=1)
        row_vals = np.where(keep, np.take_along_axis(vals_np, order, 1), 0)
        row_cols = np.where(keep, np.take_along_axis(cols_np, order, 1), 0)
        halo = sp.halo
        if halo is None:
            r, c = np.nonzero(mask)
            halo = int(np.abs(cols_np[r, c] - r).max()) if r.size else 0
        return cls._build(row_vals.astype(vals_np.dtype), row_cols, nnz,
                          slice_height, halo, sort=sort, max_bins=max_bins,
                          device=sp.values.device, dtype=dtype)

    @classmethod
    def _build(cls, row_vals, row_cols, nnz, slice_height, halo,
               *, sort="auto", max_bins=8, device="cuda",
               dtype=None) -> "SlicedEllOperator":
        """Shared host-side construction over a packed per-row nonzero table
        (each row's nonzeros first; slots >= nnz[i] hold 0 at column 0).

        Slices the (possibly sorted) row order into ``slice_height`` chunks,
        then greedily merges the adjacent pair that adds the least padding
        until at most ``max_bins`` rectangles remain: the JAX package's
        rule, so bins and ``perm`` come out identical.
        """
        n = row_vals.shape[0]
        c = max(int(slice_height), 1)

        def slice_storage(order):
            return sum(
                len(order[s0:s0 + c]) * int(nnz[order[s0:s0 + c]].max())
                for s0 in range(0, n, c)) if n else 0

        ident = np.arange(n)
        by_nnz = np.argsort(-nnz, kind="stable")
        if sort == "auto":
            use_sort = slice_storage(by_nnz) < 0.9 * slice_storage(ident)
        else:
            use_sort = bool(sort)
        order = by_nnz if use_sort else ident
        # Per-slice exact widths (>= 1 so padding slots exist), merged
        # into [row_start, row_end, width) bins.
        bins = []
        for s0 in range(0, n, c):
            h = min(c, n - s0)
            w = max(int(nnz[order[s0:s0 + h]].max()), 1)
            if bins and bins[-1][2] == w:
                bins[-1][1] += h
            else:
                bins.append([s0, s0 + h, w])
        if not bins:
            bins = [[0, 0, 1]]

        def merge_cost(i):
            (a0, a1, aw), (b0, b1, bw) = bins[i], bins[i + 1]
            w = max(aw, bw)
            return (a1 - a0) * (w - aw) + (b1 - b0) * (w - bw)

        while len(bins) > max(int(max_bins), 1):
            i = min(range(len(bins) - 1), key=merge_cost)
            (a0, a1, aw), (b0, b1, bw) = bins[i], bins[i + 1]
            bins[i:i + 2] = [[a0, b1, max(aw, bw)]]

        bin_values, bin_cols = [], []
        for r0, r1, w in bins:
            rows = order[r0:r1]
            bin_values.append(_on(np.ascontiguousarray(row_vals[rows][:, :w]),
                                  device, dtype))
            bin_cols.append(_on(np.ascontiguousarray(
                row_cols[rows][:, :w].astype(np.int32)), device))
        return cls(tuple(bin_values), tuple(bin_cols),
                   _on(order.astype(np.int32), device), halo, c,
                   bool(np.array_equal(order, ident)), device=device)

    def to_ell_arrays(self):
        """Plain-ELL (values, cols) row table in ORIGINAL row order, width =
        the widest bin."""
        n = self.perm.shape[0]
        w = self.max_width
        dev = self.perm.device
        vs = torch.cat([torch.nn.functional.pad(v, (0, w - v.shape[1]))
                        for v in self.bin_values], dim=0)
        cs = torch.cat([torch.nn.functional.pad(c, (0, w - c.shape[1]))
                        for c in self.bin_cols], dim=0)
        idx = self.perm.long()
        values = torch.zeros((n, w), dtype=self.dtype,
                             device=dev).index_copy_(0, idx, vs)
        cols = torch.zeros((n, w), dtype=torch.int32,
                           device=dev).index_copy_(0, idx, cs)
        return values, cols

    def to_ell(self) -> SparseOperator:
        """Expand back to a plain-ELL operator (pad-to-widest)."""
        values, cols = self.to_ell_arrays()
        return SparseOperator(values, cols, self.halo, device=values.device)

    def todense(self) -> torch.Tensor:
        """Materialize the dense (n, n) matrix (tests / small systems)."""
        n = self.perm.shape[0]
        a = torch.zeros((n, n), dtype=self.dtype, device=self.perm.device)
        start = 0
        for vals, cols in zip(self.bin_values, self.bin_cols):
            rb, wb = vals.shape
            rows = self.perm[start:start + rb].long().repeat_interleave(wb)
            a.index_put_((rows, cols.reshape(-1).long()), vals.reshape(-1),
                         accumulate=True)
            start += rb
        return a

    # -- format statistics ----------------------------------------------------
    @property
    def max_width(self) -> int:
        return max(int(v.shape[1]) for v in self.bin_values)

    @property
    def storage_entries(self) -> int:
        """Stored slots incl. slice padding: sum_b rows_b * width_b."""
        return sum(int(v.shape[0]) * int(v.shape[1])
                   for v in self.bin_values)

    @property
    def shape(self):
        n = self.perm.shape[0]
        return (n, n)

    @property
    def dtype(self):
        return self.bin_values[0].dtype




# Operators with explicit matrix storage: their (n, k) block ``__call__``
# lets the block solver stream the matrix once for all k lanes.
EXPLICIT_OPERATORS = (DenseOperator, SparseOperator, BandedOperator,
                      SlicedEllOperator)


def with_dtype(op, dtype):
    """The same explicit operator with its matrix storage cast to ``dtype``.

    Structure (cols / offsets / perm / halo) is shared, only the value
    stream changes.
    """
    if isinstance(op, DenseOperator):
        return DenseOperator(op.a.to(dtype), op.backend, device=op.a.device)
    if isinstance(op, SparseOperator):
        return SparseOperator(op.values.to(dtype), op.cols, op.halo,
                              device=op.values.device,
                              halo_cols=op.halo_cols)
    if isinstance(op, BandedOperator):
        return BandedOperator(op.bands.to(dtype), op.offsets,
                              device=op.bands.device)
    if isinstance(op, SlicedEllOperator):
        return SlicedEllOperator(
            tuple(v.to(dtype) for v in op.bin_values), op.bin_cols, op.perm,
            op.halo, op.slice_height, op.identity_perm,
            device=op.perm.device)
    raise TypeError(f"with_dtype: no explicit storage on {type(op).__name__}")

def as_operator(a, device="cuda") -> Callable[[torch.Tensor], torch.Tensor]:
    """Normalize ``a`` to a matvec callable.

    Operators and callables pass through; a raw matrix becomes a
    ``DenseOperator`` on the "torch" backend on ``device``.
    """
    if isinstance(a, EXPLICIT_OPERATORS + (FunctionOperator,)) or callable(a):
        return a
    return DenseOperator(a, device=device)


def poisson_1d(n: int, dtype=torch.float32, device="cuda") -> torch.Tensor:
    """Dense 1-D Poisson (tridiagonal) test matrix."""
    dev = device_mod.resolve(device)
    ones = torch.ones(n - 1, dtype=dtype, device=dev)
    return (2.0 * torch.eye(n, dtype=dtype, device=dev)
            - torch.diag(ones, 1) - torch.diag(ones, -1))


def convection_diffusion(n: int, beta: float = 0.5, dtype=torch.float32,
                         device="cuda") -> torch.Tensor:
    """Nonsymmetric convection-diffusion matrix."""
    dev = device_mod.resolve(device)
    ones = torch.ones(n - 1, dtype=dtype, device=dev)
    return (2.0 * torch.eye(n, dtype=dtype, device=dev)
            + (-1.0 + beta) * torch.diag(ones, 1)
            + (-1.0 - beta) * torch.diag(ones, -1))


def random_diagdom(n: int, dtype=torch.float32, *, dominance: float = 2.0,
                   seed: int = 0, device="cuda") -> torch.Tensor:
    """Random nonsymmetric diagonally-dominant matrix.

    The JAX package's construction, ``N(0,1)/sqrt(n) + diag(dominance *
    rowsum|.|)``, drawn from a numpy seed (``jax.random`` streams cannot be
    reproduced, so parity tests bridge the JAX-built matrix instead).
    """
    dev = device_mod.resolve(device)
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n), dtype=np.float32)
    a /= np.float32(np.sqrt(n))
    rowsum = np.abs(a).sum(axis=1)
    a[np.diag_indices(n)] += np.float32(dominance) * rowsum
    return torch.from_numpy(a).to(device=dev, dtype=dtype)
