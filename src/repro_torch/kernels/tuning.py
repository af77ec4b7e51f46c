"""Launch shapes of the port's Hopper kernels, and the fused-step fits check.

Counterpart of ``repro/kernels/tuning.py``, redesigned for Hopper: the
TPU's VMEM budget, (8, 128) tile rounding and persisted block choices have
no meaning here.  What the kernels need is

- the GEMV launch shape (csrc/matvec.cu: one warp per row);
- the SpMV block size (csrc/spmv.cu: one thread per row, ELL and banded);
- the cooperative kernels' shared-memory cap and blocks per SM
  (csrc/cgs2.cu, csrc/arnoldi_fused.cu, csrc/batched_cgs2.cu,
  csrc/matrix_powers.cu, csrc/block_gs.cu); the C side picks the grid from
  these with the occupancy calculator;
- the grid of the single-reduce kernels (csrc/sr_payload.cu's payload and
  the single-reduce pair in csrc/block_gs.cu), plain launches: ``sr_grid``;
- the launch of the streaming GEMV pair (csrc/sr_payload.cu's gs_update
  and gs_project_partial: 16-byte pieces, a scalar route for misaligned
  operands and the ragged tail; the projection a block a row for short
  rows): ``stream_aligned``, ``gemv_stream_shape``, ``gemv_partial_shape``;
- the preconditioning kernels' shapes: the fused Chebyshev apply
  (csrc/matrix_powers.cu) is a persistent cooperative launch of
  CHEB_BLOCKS_PER_SM blocks per SM at most; the triangular sweep
  (csrc/trisolve.cu) is one block of 1024 threads per right-hand side,
  walking chunks of ``trisolve.chunk_rows`` rows (at most 1024); the ILU(0)
  setup is one thread;
- ``fused_step_fits``: can the fused Arnoldi step keep each block's basis
  slice in shared memory?  ``core/gmres.py`` asks this before any launch,
  as the JAX solver asks its VMEM check;
- the shard context of the row-sharded solvers (``shard_context``,
  ``shard_axis``, ``shard_size``: JAX's ``tuning.shard_context``, with a
  ``torch.distributed`` process group in the place of the mesh axis) and
  their collectives (``all_reduce``, ``all_gather``; the halo exchange is
  ``kernels/spmv.py::halo_exchange``), counted by kind in ``COLLECTIVES``.

The JAX package's SpMV, batched-GS and s-step gates (``spmv_fits``,
``sell_fits``, ``banded_fits``, ``block_gs_fits``, ``powers_fits``,
``ell_powers_fits`` and their block choosers) have no counterpart: they
exist because the TPU keeps x, a lane's whole basis, or a band stack and
its s powers, in 12 MiB of VMEM.  Here x and the bases stay in
global memory (x in L2), so no size sends a CUDA tensor to a plain
version.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.distributed as dist

H100_SMS = 132            # SMs of an H100 SXM; used when no card is present
GEMV_THREADS = 256        # 8 warps per block, one row of A per warp
GS_WARPS = 8              # warps per cooperative block (csrc/common.cuh)
# Dynamic shared memory a cooperative block may use (of the 227 KB limit),
# leaving room for the runtime's reserved shared memory.
SMEM_BUDGET = 200 * 1024
# The most dynamic shared memory one block may have on an H100 (227 KB):
# the model kernels' shapes are refused above it (kernels/ssd.py,
# kernels/gated_norm.py).
SMEM_LIMIT = 232_448
# Upper bound on co-resident blocks per SM for the cooperative kernels.
# The GS pass alone is latency-bound (fewer blocks: cheaper grid sync and
# fewer partials to reduce); the fused step also streams A and wants more
# warps in flight.
GS_BLOCKS_PER_SM = 1
FUSED_BLOCKS_PER_SM = 4
# The streamed GS passes (V read from global memory: gs_project where a
# block's slice does not fit shared memory, batched_cgs2 always) are
# latency-bound and want as many warps in flight as the SM holds (the
# occupancy calculator caps this; see PERF.md for the sweep).
STREAM_BLOCKS_PER_SM = 8
SPMV_THREADS = 256        # rows per SpMV block, one thread per row
# The s-step kernels (csrc/matrix_powers.cu, csrc/block_gs.cu) are
# persistent cooperative launches: these many blocks per SM at most, fewer
# where the occupancy calculator says fewer are co-resident, and never more
# blocks than the rows (a thread per row; dense: a warp per row) or columns
# (a thread per column) need.  The banded and ELL powers share one value,
# so a stencil gets the same row partition, and the same bits, in both
# formats.  Each power ends in a grid sync whose cost grows with the grid;
# each block-GS pass reduces (k_start + 1) * s partials per block.
POWERS_BLOCKS_PER_SM = 4
BLOCK_GS_BLOCKS_PER_SM = 2
BLOCK_GS_MAX_S = 8        # accumulators per thread: s columns of Q x 8 rows
# The single-reduce kernels stream V through a plain grid; four blocks per
# SM keep enough loads in flight, and a slice of at most 2048 columns keeps
# the (8, 2048) f32 slice of Q within 64 KB of shared memory.
SR_BLOCKS_PER_SM = 4
SR_MAX_COLS = 2048
# The streaming GEMV pair (csrc/sr_payload.cu: gs_update and
# gs_project_partial) gives each thread 16-byte pieces of columns.  Blocks
# of 256 threads (at most the kernels' kThreads, which the C side checks),
# or of 64 where there is less than one piece a thread for 256-thread
# blocks on every SM (n = 10^4: 2,500 f32 pieces on 40 SMs, not 10; PERF.md
# §6: the update 0.0019 ms warm against 0.0021).  The grid is at most
# GEMV_BLOCKS_PER_SM blocks an SM; a thread that then owns more than one
# piece takes two at once.  One: 16 rows of 16-byte loads (two pieces: 32)
# fill a thread's registers, so no second block fits an SM (PERF.md §6:
# at n = 2^20 both kernels are slowest with no cap, the projection slower
# with 2 or 4 too).
STREAM_THREADS = 256
STREAM_SMALL_THREADS = 64
GEMV_BLOCKS_PER_SM = 1
# The projection of a short basis (at most this many pieces, or scalar
# columns, a row; n = 10^4 f32 has 2,500) takes a block a row (the
# kernel's own kThreads): no partials, no second launch (PERF.md §6:
# faster at 2,500 and 8,192 pieces, slower at 16,384 and 32,768).
PARTIAL_ROW_MAX_ITEMS = 8192
# The fused Chebyshev apply takes the banded powers' row partition (a
# thread per row), so the same value.
CHEB_BLOCKS_PER_SM = POWERS_BLOCKS_PER_SM


def gemv_launch(m: int) -> tuple[int, int]:
    """(blocks, threads) for ``block_matvec`` over m rows."""
    rows_per_block = GEMV_THREADS // 32
    return -(-m // rows_per_block), GEMV_THREADS


def sm_count(device) -> int:
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_properties(dev).multi_processor_count
    return H100_SMS


def gs_smem_bytes(m1: int, cols: int) -> int:
    """Shared memory of one cooperative block (csrc/common.cuh layout): its
    (m1, cols) basis slice and w slice widened to f32, two h rows, and one
    partial sum per warp and row (the fused step's phase 0)."""
    return 4 * (m1 * cols + cols + 2 * m1 + GS_WARPS * cols)


def fused_step_fits(m1: int, n: int, sms: int = H100_SMS) -> bool:
    """Does the fused step's per-block V slice + w slice fit in shared memory
    with a co-resident grid of one block per SM?  (The basis is held as f32
    in shared memory whatever its storage dtype.)"""
    cols = -(-n // min(sms, n))
    return gs_smem_bytes(m1, cols) <= SMEM_BUDGET


def partial_blocks(device, blocks_per_sm: int) -> int:
    """Most blocks a cooperative launch can have: the partials' capacity."""
    return blocks_per_sm * sm_count(device)


def persistent_grid(device, blocks_per_sm: int, max_grid: int) -> int:
    """Upper bound of a persistent kernel's grid (the C side may take fewer
    where occupancy is lower): the partials' capacity."""
    return max(1, min(partial_blocks(device, blocks_per_sm), max_grid))


def sr_grid(device, n: int) -> int:
    """Grid of the single-reduce kernels (csrc/sr_payload.cu's payload and
    csrc/block_gs.cu's project-gram / update pair): plain launches whose
    partials a second launch reduces, so any grid is valid.  SR_BLOCKS_PER_SM
    blocks per SM, at least a thread's worth of columns each, and at most
    SR_MAX_COLS columns per block (the project-gram kernel keeps an
    (s, cols) slice of Q in shared memory)."""
    g = min(SR_BLOCKS_PER_SM * sm_count(device), -(-n // (32 * GS_WARPS)))
    return max(g, -(-n // SR_MAX_COLS), 1)


def stream_aligned(ptrs, row_bytes: int, rows: int) -> bool:
    """May the streaming GEMV pair read in 16 bytes?  Every pointer (V, w)
    16-byte aligned, and the row stride too where more than one row is
    read."""
    return all(p % 16 == 0 for p in ptrs) and (rows <= 1
                                                or row_bytes % 16 == 0)


def gemv_stream_shape(n: int, elem_size: int, aligned: bool,
                      sms: int) -> dict:
    """Launch shape of the streaming GEMV pair over n columns of a basis
    stored in ``elem_size`` bytes, on ``sms`` SMs.

    ``pieces`` 16-byte pieces of ``vec`` columns cover [0, pieces * vec);
    the scalar loop covers [pieces * vec, n): the ragged tail when
    ``aligned``, every column when not (pieces = 0).  ``route`` is "vec"
    where any piece is read in 16 bytes, else "scalar".  ``threads`` and
    ``blocks``: enough threads for one work item (a piece, or a scalar
    column where there are no pieces) each, at most GEMV_BLOCKS_PER_SM
    blocks an SM; ``unroll`` = 2 where a thread then owns more than one
    item (it takes two at once; the projection's 32-row bucket one at a
    time)."""
    vec = 16 // elem_size
    pieces = n // vec if aligned else 0
    tail = n - pieces * vec
    items = max(pieces, tail)
    threads = (STREAM_THREADS if items >= STREAM_THREADS * sms
               else STREAM_SMALL_THREADS)
    blocks = min(max(1, -(-items // threads)), GEMV_BLOCKS_PER_SM * sms)
    unroll = 2 if items > blocks * threads else 1
    return {"threads": threads, "blocks": blocks, "unroll": unroll,
            "vec": vec, "pieces": pieces, "tail": tail,
            "route": "vec" if pieces else "scalar"}


def gemv_partial_shape(shape: dict, rows: int) -> dict:
    """The projection's launch from ``gemv_stream_shape``'s: a block for
    each of the ``rows`` valid rows (``by_row``; the kernel takes its own
    block size, so ``threads`` is 0) where a row has at most
    PARTIAL_ROW_MAX_ITEMS work items, else the shape as given."""
    if max(shape["pieces"], shape["tail"]) > PARTIAL_ROW_MAX_ITEMS:
        return dict(shape, by_row=0)
    return dict(shape, by_row=1, threads=0, blocks=rows, unroll=1)


# --------------------------------------------------------------------------
# Row-sharded execution: the shard context and the collectives
# --------------------------------------------------------------------------
# The JAX package names a mesh axis; the port names the process group that
# plays its part.  A shard's index on the axis is ``group.rank()``.
_SHARD_CTX: list = []

# Collectives issued by the sharded solvers, by kind: zeroed and read like
# the kernels' ``.launches`` counters (a halo exchange counts once, however
# many neighbours it talks to).
COLLECTIVES = {"all_reduce": 0, "all_gather": 0, "halo": 0}


def check_group(group) -> None:
    """``group`` must be None (one device) or a ``torch.distributed``
    process group; anything else (a JAX-style axis name) is a TypeError."""
    if group is not None and not isinstance(group, dist.ProcessGroup):
        raise TypeError(f"axis_name must be None or a torch.distributed "
                        f"ProcessGroup, got {type(group).__name__} "
                        f"{group!r}")


@contextlib.contextmanager
def shard_context(group):
    """Declare that the code inside operates on row-local shards of
    ``group``: operators and schemes read it back (``shard_axis``,
    ``shard_size``) to take their per-shard paths (halo SpMV, split-phase
    CGS2, communication-avoiding matrix powers)."""
    check_group(group)
    if group is None:
        raise TypeError("shard_context needs a process group")
    _SHARD_CTX.append(group)
    try:
        yield
    finally:
        _SHARD_CTX.pop()


def shard_axis() -> Optional["dist.ProcessGroup"]:
    """The process group of the ambient ``shard_context`` (None: one
    device)."""
    return _SHARD_CTX[-1] if _SHARD_CTX else None


def shard_size() -> int:
    """Shard count of the ambient ``shard_context`` (1: one device)."""
    return _SHARD_CTX[-1].size() if _SHARD_CTX else 1


_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """The sum (or max) of ``x`` over ``group``, as a new tensor (JAX's
    ``psum`` / ``pmax``); ``x`` itself for ``group=None``."""
    if group is None:
        return x
    y = x.contiguous().clone()
    dist.all_reduce(y, op=_REDUCE_OPS[op], group=group)
    COLLECTIVES["all_reduce"] += 1
    return y


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """The shards of ``x`` over ``group`` concatenated along dim 0 in rank
    order (JAX's ``all_gather(..., tiled=True)``)."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(group.size())]
    dist.all_gather(parts, x, group=group)
    COLLECTIVES["all_gather"] += 1
    return torch.cat(parts, dim=0)
