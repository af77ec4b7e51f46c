"""Distributed GMRES: the operator row-sharded over a process group.

Counterpart of ``repro/core/distributed.py``.  Rank p of a
``torch.distributed`` process group owns row block p of the matrix storage
(dense rows, ELL rows, band-stack columns; a sliced-ELL payload is
replicated) and the matching shard of every Krylov vector.  Per Arnoldi
step the communication is the operand exchange of the mat-vec (an
all-gather for dense A, a halo exchange of O(halo) rows for banded and ELL
operators) and the all-reduces that complete the inner products: two for
CGS2, one for the pipelined single-reduce scheme, j + 1 for MGS.

There is one cycle implementation.  The entry points here cut each rank's
shard out of the global operator and vectors, enter
``kernels/tuning.py::shard_context`` (so operators and schemes take their
per-shard kernels: the split-phase CGS2 pair, the halo SpMV modes, the
communication-avoiding matrix powers) and call the same ``gmres`` /
``gmres_sstep`` the single-device solve uses, with ``axis_name`` set to
the group.  No Arnoldi loop lives in this file.

Every rank calls an entry point with the same global operator and ``b``
(as every device sees the global arrays under JAX's ``shard_map``) and
gets the whole solution back.  Entry points run on the card unless given
``device="cpu"``; a card's tensors need an NCCL group and the host's a
gloo group, and any other pairing raises: nothing switches backend.  The
process group is the caller's: ``torch.distributed.init_process_group``
with its address, world size and rank.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch import device as device_mod
from repro_torch.core import operators as op_mod
from repro_torch.core.gmres import GmresResult, gmres
from repro_torch.core.sstep import gmres_sstep
from repro_torch.kernels import tuning

_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


def local_operator(op, rank: int, nshards: int, device=None):
    """Rank ``rank``'s shard of a global explicit operator.

    Counterpart of the JAX ``shard_specs``, which names the row sharding of
    each storage leaf for ``shard_map`` to cut; here the cut is made:

      DenseOperator      rows [rank * n_local, (rank + 1) * n_local)
      SparseOperator     the same rows of values and cols (cols stay
                         global), and, when ``halo`` fits a shard, the
                         columns in the rank's halo frame (``halo_cols``)
      BandedOperator     columns of the band stack: the same rows of A
      SlicedEllOperator  when ``halo`` fits a shard, the rank's rows of
                         ``to_ell_arrays()`` as a SparseOperator shard (the
                         nnz sort breaks contiguous row ownership of the
                         bins); else replicated whole, and its sharded
                         ``__call__`` takes the rank's rows itself

    ``device``: where the shard goes (its own device by default).  A
    matrix-free operator raises ``TypeError``, as in JAX.
    """
    def cut(t, dim):
        n_local = t.shape[dim] // nshards
        t = t.narrow(dim, rank * n_local, n_local)
        return t.to(device).contiguous() if device is not None \
            else t.contiguous()

    def ell_shard(values, cols, halo):
        vals, cols = cut(values, 0), cut(cols, 0)
        n_local = vals.shape[0]
        halo_cols = None
        if halo is not None and halo <= n_local:
            halo_cols = torch.clamp(
                cols - rank * n_local + halo, 0,
                n_local + 2 * halo - 1).to(torch.int32).contiguous()
        return op_mod.SparseOperator(vals, cols, halo, device=vals.device,
                                     halo_cols=halo_cols)

    if isinstance(op, op_mod.DenseOperator):
        a = cut(op.a, 0)
        return op_mod.DenseOperator(a, op.backend, device=a.device)
    if isinstance(op, op_mod.SparseOperator):
        return ell_shard(op.values, op.cols, op.halo)
    if isinstance(op, op_mod.BandedOperator):
        bands = cut(op.bands, 1)
        return op_mod.BandedOperator(bands, op.offsets, device=bands.device)
    if isinstance(op, op_mod.SlicedEllOperator):
        n_local = op.shape[0] // nshards
        if op.halo is not None and op.halo <= n_local:
            return ell_shard(*op.to_ell_arrays(), op.halo)
        if device is None or op.perm.device == torch.device(device):
            return op
        return op_mod.SlicedEllOperator(
            op.bin_values, op.bin_cols, op.perm, op.halo, op.slice_height,
            op.identity_perm, device=device)
    raise TypeError(
        f"gmres_sharded needs an explicit-storage operator (Dense/Sparse/"
        f"Banded/SlicedEll) or a dense matrix; got {type(op).__name__}: "
        f"a matrix-free operator shards itself, through gmres(..., "
        f"axis_name=group) inside tuning.shard_context")


def _check_group(group, dev: torch.device, caller: str) -> None:
    if not isinstance(group, dist.ProcessGroup):
        raise TypeError(f"{caller}: group must be a torch.distributed "
                        f"ProcessGroup, got {type(group).__name__}")
    backend = dist.get_backend(group)
    if backend != _BACKEND[dev.type]:
        raise ValueError(
            f"{caller}: a {dev.type} solve needs a {_BACKEND[dev.type]!r} "
            f"process group, got {backend!r}")


def _run_sharded(group, op, b, x0, caller: str, body,
                 device) -> GmresResult:
    """Shared skeleton of the sharded entry points: check the group and
    the divisibility, cut this rank's (op, b, x0), run ``body(op_local,
    b_local, x0_local)`` inside ``shard_context`` and all-gather x, so the
    caller sees the global solution (JAX's ``res._replace(x=x_full)``).
    The entry points differ only in which cycle ``body`` calls."""
    dev = device_mod.resolve(device)
    _check_group(group, dev, caller)
    b = device_mod.as_tensor(b, dev)
    nshards, rank = group.size(), group.rank()
    n = b.shape[0]
    if n % nshards:
        raise ValueError(f"{caller}: n={n} not divisible by the "
                         f"{nshards}-rank group")
    if op.shape[0] != n:
        raise ValueError(f"{caller}: operator {op.shape} vs b "
                         f"{tuple(b.shape)}")
    x0 = torch.zeros_like(b) if x0 is None else device_mod.as_tensor(x0, dev)
    rows = n // nshards
    op_local = local_operator(op, rank, nshards, dev)
    b_local = b[rank * rows:(rank + 1) * rows].contiguous()
    x0_local = x0[rank * rows:(rank + 1) * rows].contiguous()
    with tuning.shard_context(group):
        res = body(op_local, b_local, x0_local)
        return res._replace(x=tuning.all_gather(res.x, group))


def _local_block_jacobi(a_local: torch.Tensor, group):
    """Shard-local block-Jacobi: each rank factors its own diagonal block of
    A (``torch.linalg.lu_factor``, which JAX too computes outside Pallas)
    and applies it with no communication: cutting the steps cuts the
    collective rounds, and the preconditioner adds none."""
    rows = a_local.shape[0]
    p = group.rank()
    block = a_local[:, p * rows:(p + 1) * rows]
    lu, piv = torch.linalg.lu_factor(block)

    def apply(v_local):
        return torch.linalg.lu_solve(lu, piv, v_local[:, None])[:, 0]

    return apply


_SHARD_PRECONDS = ("block_jacobi", "jacobi", "chebyshev",
                   "banded_block_jacobi")


def _resolve_shard_precond(precond, op, caller: str):
    """Resolve ``precond=`` for the sharded wrappers, at the call.

    Returns ``build(op_local, group) -> callable | None``.  A string names
    a built-in shard-safe member, set up here against the global operator
    (Chebyshev's interval, the dense block-Jacobi check) and rebound to the
    local storage per rank; a ``Preconditioner`` instance must be
    ``shard_aware``.  Anything else raises here.
    """
    if precond is None:
        return lambda op_local, group: None
    from repro_torch.core import preconditioners as pc_mod
    if isinstance(precond, str):
        if precond not in _SHARD_PRECONDS:
            raise ValueError(
                f"{caller}: unknown precond {precond!r}; options: "
                f"{[None, *_SHARD_PRECONDS]}")
        if precond == "block_jacobi":
            if not isinstance(op, op_mod.DenseOperator):
                raise ValueError(
                    f"{caller}: precond='block_jacobi' needs a dense "
                    f"operator (it factorizes the diagonal block of A); "
                    f"banded operators take 'banded_block_jacobi'")
            return lambda op_local, group: _local_block_jacobi(op_local.a,
                                                               group)
        if precond == "banded_block_jacobi":
            if not isinstance(op, op_mod.BandedOperator):
                raise ValueError(
                    f"{caller}: precond='banded_block_jacobi' needs a "
                    f"BandedOperator (its setup walks the band pattern); "
                    f"dense operators take 'block_jacobi'")
            # Each rank factors its own block only (JAX also factors the
            # global operator first, then rebinds: the same local factors).
            return lambda op_local, group: \
                pc_mod.BandedBlockJacobiPreconditioner(op_local)
        if precond == "jacobi":
            pc = pc_mod.jacobi(op)
        else:
            pc = pc_mod.chebyshev(op)
        return lambda op_local, group: pc.rebind(op_local)
    if getattr(precond, "shard_aware", False):
        return lambda op_local, group: precond.rebind(op_local)
    raise ValueError(
        f"{caller}: precond {getattr(precond, 'name', precond)!r} is not "
        f"shard-aware; pass one of {list(_SHARD_PRECONDS)} or a "
        f"Preconditioner with shard_aware=True (e.g. chebyshev, jacobi, "
        f"banded_block_jacobi): banded_ilu0's sweeps recur across the "
        f"whole row range and cannot be sharded")


def gmres_sharded(group, a, b, x0=None, *, m: int = 30, tol: float = 1e-5,
                  max_restarts: int = 50, gs: str = "cgs2_fused",
                  precond=None, compute_dtype=None,
                  device="cuda") -> GmresResult:
    """Solve A x = b with the operator row-sharded over ``group``.

    ``a``: a global dense (n, n) matrix or explicit operator (dense, ELL,
    banded, sliced ELL) holding global storage; ``b``: global (n,).  Every
    rank passes the same ``a`` and ``b`` and gets the global x.  The
    default ``gs="cgs2_fused"`` runs the split-phase kernel pair per shard
    (project, all-reduce, update); "cgs2_pipelined" pays one all-reduce
    per step.  ``precond``: None | "block_jacobi" (dense; shard-local LU
    of the diagonal block) | "banded_block_jacobi" (banded; shard-local
    ILU(0) sweeps) | "jacobi" | "chebyshev" (its mat-vecs exchange halos
    only: no extra all-reduce) | a ``shard_aware`` ``Preconditioner``
    instance (rebound per rank); anything else raises ``ValueError``.
    """
    op = op_mod.as_operator(a, device=device)
    build_pc = _resolve_shard_precond(precond, op, "gmres_sharded")

    def body(op_local, b_local, x0_local):
        return gmres(op_local, b_local, x0_local, m=m, tol=tol,
                     max_restarts=max_restarts, gs=gs, axis_name=group,
                     precond=build_pc(op_local, group),
                     compute_dtype=compute_dtype)

    return _run_sharded(group, op, b, x0, "gmres_sharded", body, device)


def gmres_sstep_sharded(group, a, b, x0=None, *, s: int = 4,
                        blocks: int = 5, tol: float = 1e-5,
                        max_restarts: int = 30, gs: str = "cgs2",
                        precond=None, device="cuda") -> GmresResult:
    """Row-sharded s-step GMRES: the communication-avoiding wrapper.

    On banded operators each block runs the halo matrix-powers kernel (one
    neighbour exchange and one all-reduce for all s powers) and two
    split-phase block-GS passes (two all-reduces each): 1 exchange and 5
    all-reduces per s steps, where the standard sharded cycle pays about 4
    collectives per step.  ``gs="cgs2_pipelined"`` makes each pass's C and
    Gram reductions one stacked all-reduce (3 per block).  ``precond``
    takes the options of ``gmres_sharded``; a non-identity M^-1 moves the
    powers onto the all-reduce-per-power reference over A M^-1.
    """
    op = op_mod.as_operator(a, device=device)
    build_pc = _resolve_shard_precond(precond, op, "gmres_sstep_sharded")

    def body(op_local, b_local, x0_local):
        return gmres_sstep(op_local, b_local, x0_local, s=s, blocks=blocks,
                           tol=tol, max_restarts=max_restarts,
                           axis_name=group, gs=gs,
                           precond=build_pc(op_local, group))

    return _run_sharded(group, op, b, x0, "gmres_sstep_sharded", body,
                        device)


def make_sharded_solver(group, n: int, *, m: int = 30, tol: float = 1e-5,
                        max_restarts: int = 50, gs: str = "cgs2_fused",
                        device="cuda"):
    """A closure ``solve(a, b) -> GmresResult`` over ``group`` for systems
    of size n (JAX's jit-compiled entry; eager PyTorch compiles nothing,
    so this fixes the options and checks the size)."""
    def solve(a, b, x0: Optional[torch.Tensor] = None) -> GmresResult:
        if b.shape[0] != n:
            raise ValueError(f"make_sharded_solver: built for n={n}, got b "
                             f"{tuple(b.shape)}")
        return gmres_sharded(group, a, b, x0, m=m, tol=tol,
                             max_restarts=max_restarts, gs=gs, device=device)

    return solve
