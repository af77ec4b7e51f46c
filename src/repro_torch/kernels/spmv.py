"""Sparse / structured mat-vec: ELL gather, sliced ELL and banded stencils.

Counterpart of ``repro/kernels/spmv.py`` (``ell_matvec``, ``sell_matvec``,
``banded_matvec``, the row-sharded ``halo_exchange``,
``banded_matvec_halo`` and ``ell_matvec_halo``, and their ``_ref``
oracles).  The kernels are ``csrc/spmv.cu``; its source note gives the
design and the bound.

- ``ell_matvec(values, cols, x)``: values/cols (n, width), padding slots
  holding value 0 at column 0.
- ``sell_matvec(bin_values, bin_cols, x, perm=None)``: one launch over a
  table of width bins (``sell_plan``) on the same x (columns are global),
  a few threads per row in the wide bins (``threads_per_row``); the output
  in the bins' sorted-row frame, or with ``perm`` row r of that frame at
  y[perm[r]] (``SlicedEllOperator``'s original order).
- ``banded_matvec(bands, x, offsets)``: y[i] = sum_d bands[d, i] *
  x[i + offsets[d]], out-of-range reads counting as zero.
- ``halo_exchange(x, halo, group)``: a shard of a row-partitioned vector
  with ``halo`` rows of each neighbour rank on either side (zeros at the
  ends of the row range), from one ``batch_isend_irecv``.
- ``banded_matvec_halo(bands, x_halo, offsets)`` and
  ``ell_matvec_halo(values, cols, x_halo)``: one shard's product over such
  an operand (ELL columns remapped into its frame); the same kernels in
  their halo modes, each with its own entry point and launch counter.

Values and bands are float32 or bfloat16 storage; x is (n,) or (n, k),
taken as float32 by the kernels (a wider x is cut into launches of
``MAX_K`` columns); every sum accumulates in float32 (float64 on the plain
path for float64 operands).  The result has the dtype ``A @ x`` promotes
to, as the JAX package's ``_acc_dtypes`` defines it.

On a CPU tensor a wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.distributed as dist

from repro_torch.kernels import _build, tuning

MAX_K = 8            # accumulators per thread (columns of x per launch)
MAX_BANDS = 32       # offsets passed by value to the banded kernel
SELL_THREADS = 256   # threads of a sliced-ELL block (csrc kSellThreads)
MAX_SELL_BINS = 16   # bins passed by value to one launch (kMaxSellBins)
SELL_NARROW = 8      # widths up to this keep one thread per row
SELL_SLOTS = 4       # slots each lane of a wider row walks, at most
STORAGE = (torch.float32, torch.bfloat16)


def _acc_dtypes(mat_dtype, x_dtype):
    """(compute, accumulate) dtypes matching dense ``a @ x`` promotion."""
    compute = torch.promote_types(mat_dtype, x_dtype)
    return compute, torch.promote_types(compute, torch.float32)


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------
def ell_matvec_plain(values: torch.Tensor, cols: torch.Tensor,
                     x: torch.Tensor) -> torch.Tensor:
    compute, acc = _acc_dtypes(values.dtype, x.dtype)
    g = x[cols.long()].to(acc)               # (n, width) or (n, width, k)
    vals = values.to(acc)
    if x.ndim == 2:
        vals = vals[:, :, None]
    return (vals * g).sum(dim=1).to(compute)


def sell_matvec_plain(bin_values, bin_cols, x: torch.Tensor) -> torch.Tensor:
    _check_bins(bin_values, bin_cols)
    return torch.cat([ell_matvec_plain(v, c, x)
                      for v, c in zip(bin_values, bin_cols)], dim=0)


# --------------------------------------------------------------------------
# the sliced-ELL launch plan (pure Python: the CPU tests reach it)
# --------------------------------------------------------------------------
def threads_per_row(width: int) -> int:
    """Threads the sliced-ELL kernel gives each row of a bin this wide.

    One up to ``SELL_NARROW`` slots (the ELL loop: most rows of a graph,
    every row of a stencil); wider, the least power of two that leaves
    each lane at most ``SELL_SLOTS`` slots, up to a whole block of
    ``SELL_THREADS`` (the PageRank hub bin, width 689: 256).
    """
    if width <= SELL_NARROW:
        return 1
    t = 1
    while t < SELL_THREADS and t * SELL_SLOTS < width:
        t *= 2
    return t


def sell_plan(shapes, tpr=None) -> list[dict]:
    """The bin table of one sliced-ELL launch.

    ``shapes``: (rows, width) of each bin, in output order; ``tpr``: an
    optional threads-per-row override per bin (None keeps the rule).  Each
    entry gives the bin's rows, width, first output row ``row0``, first
    block ``block0``, ``threads_per_row`` and ``blocks``: the bins' rows
    and blocks follow each other, and the grid is the sum of the blocks.
    More than ``MAX_SELL_BINS`` bins raise (the kernel takes its table by
    value in its parameters).
    """
    shapes = [(int(r), int(w)) for r, w in shapes]
    if not 1 <= len(shapes) <= MAX_SELL_BINS:
        raise ValueError(f"sell_matvec: {len(shapes)} bins; one launch "
                         f"takes 1 to {MAX_SELL_BINS}")
    plan, row0, block0 = [], 0, 0
    for i, (rows, width) in enumerate(shapes):
        t = threads_per_row(width) if tpr is None or tpr[i] is None \
            else int(tpr[i])
        if t < 1 or t > SELL_THREADS or t & (t - 1):
            raise ValueError(f"sell_matvec: {t} threads per row; a power "
                             f"of two up to {SELL_THREADS}")
        blocks = -(-rows // (SELL_THREADS // t))
        plan.append({"rows": rows, "width": width, "row0": row0,
                     "block0": block0, "threads_per_row": t,
                     "blocks": blocks})
        row0 += rows
        block0 += blocks
    return plan


def banded_matvec_plain(bands: torch.Tensor, x: torch.Tensor,
                        offsets) -> torch.Tensor:
    halo = max(abs(int(o)) for o in offsets)
    pad = torch.zeros((halo,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    return banded_matvec_halo_plain(bands, torch.cat([pad, x, pad], dim=0),
                                    offsets)


def banded_matvec_halo_plain(bands: torch.Tensor, x_halo: torch.Tensor,
                             offsets) -> torch.Tensor:
    """The product over an operand padded with ``halo`` = max |offset|
    rows on each side: y[i] = sum_d bands[d, i] x_halo[i + halo + off_d]."""
    nbands, n = bands.shape
    compute, acc = _acc_dtypes(bands.dtype, x_halo.dtype)
    halo = max(abs(int(o)) for o in offsets)
    xp = (x_halo[:, None] if x_halo.ndim == 1 else x_halo).to(acc)
    out = torch.zeros((n, xp.shape[1]), dtype=acc, device=x_halo.device)
    for d, off in enumerate(offsets):
        seg = xp[halo + int(off): halo + int(off) + n]
        out = out + bands[d][:, None].to(acc) * seg
    out = out.to(compute)
    return out[:, 0] if x_halo.ndim == 1 else out


# The ELL gather does not care how long its operand is: over a halo-padded
# operand (columns remapped into its frame) it is the same arithmetic.
ell_matvec_halo_plain = ell_matvec_plain


# --------------------------------------------------------------------------
# checks (the JAX wrappers' contracts: a length mismatch is a TypeError)
# --------------------------------------------------------------------------
def _check_x(name: str, n: int, x: torch.Tensor, mat: torch.Tensor) -> None:
    if x.ndim not in (1, 2) or x.shape[0] != n:
        raise TypeError(f"{name}: matrix {tuple(mat.shape)} @ x "
                        f"{tuple(x.shape)} — x must be (n,) or (n, k) with "
                        f"n = {n} rows")
    if mat.device != x.device:
        raise ValueError(f"{name}: matrix on {mat.device}, x on {x.device}")


def _check_ell(name: str, values: torch.Tensor, cols: torch.Tensor) -> None:
    if values.ndim != 2 or cols.shape != values.shape:
        raise TypeError(f"{name}: cols {tuple(cols.shape)} must match "
                        f"values {tuple(values.shape)} (both (rows, width))")


def _check_bins(bin_values, bin_cols) -> None:
    if not len(bin_values) or len(bin_values) != len(bin_cols):
        raise TypeError(f"sell_matvec: {len(bin_values)} value bins vs "
                        f"{len(bin_cols)} cols bins (need >= 1, matching)")
    for i, (v, c) in enumerate(zip(bin_values, bin_cols)):
        if v.ndim != 2 or c.shape != v.shape:
            raise TypeError(f"sell_matvec: bin {i} cols {tuple(c.shape)} "
                            f"must match values {tuple(v.shape)}")


def _check_storage(name: str, mat: torch.Tensor, idx=None) -> None:
    if mat.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {mat.device}")
    if mat.dtype not in STORAGE:
        raise TypeError(f"{name}: storage must be float32 or bfloat16, got "
                        f"{mat.dtype}")
    if not mat.is_contiguous() or (idx is not None
                                   and not idx.is_contiguous()):
        raise ValueError(f"{name}: the matrix must be contiguous (row-major)")
    if idx is not None and idx.dtype != torch.int32:
        raise TypeError(f"{name}: column indices must be int32, got "
                        f"{idx.dtype}")


def _x_block(name: str, x: torch.Tensor, compute) -> torch.Tensor:
    """x as a contiguous float32 (n, k) block (values rounded to compute)."""
    if x.dtype not in STORAGE:
        raise TypeError(f"{name}: x must be float32 or bfloat16 on the card, "
                        f"got {x.dtype}")
    x2 = x[:, None] if x.ndim == 1 else x
    return x2.to(compute).to(torch.float32).contiguous()


def _chunks(k: int) -> int:
    return -(-k // MAX_K)


@functools.lru_cache(maxsize=64)
def _sell_table(bins: tuple, tpr) -> tuple:
    """The launch's ctypes arguments for bins ((values ptr, cols ptr, rows,
    width), ...): built once per table (a solve calls the same operator
    thousands of times); they depend on nothing but the key."""
    plan = sell_plan([(rows, width) for _, _, rows, width in bins], tpr)
    nb = len(plan)
    vals = (ctypes.c_void_p * nb)(*(b[0] for b in bins))
    cols = (ctypes.c_void_p * nb)(*(b[1] for b in bins))
    meta = (ctypes.c_int * (5 * nb))(*(
        p[key] for p in plan
        for key in ("rows", "width", "row0", "block0", "threads_per_row")))
    return vals, cols, meta, nb


def _launch_sell(bin_values, bin_cols, xf, y, perm, name: str,
                 tpr=None) -> None:
    """One launch per chunk of MAX_K columns over the whole bin table."""
    vals, cols, meta, nb = _sell_table(
        tuple((v.data_ptr(), c.data_ptr(), v.shape[0], v.shape[1])
              for v, c in zip(bin_values, bin_cols)),
        None if tpr is None else tuple(tpr))
    rc = _build.library().repro_sell_matvec(
        ctypes.addressof(vals), int(bin_values[0].dtype == torch.bfloat16),
        ctypes.addressof(cols), ctypes.addressof(meta), nb, xf.data_ptr(),
        y.data_ptr(), xf.shape[1], None if perm is None else perm.data_ptr(),
        _build.stream_ptr(xf))
    _build.check(name, rc)


def _launch_ell(values, cols, xf, y, name: str) -> None:
    rows, width = values.shape
    rc = _build.library().repro_ell_matvec(
        values.data_ptr(), int(values.dtype == torch.bfloat16),
        cols.data_ptr(), xf.data_ptr(), y.data_ptr(), rows, width,
        xf.shape[1], tuning.SPMV_THREADS, _build.stream_ptr(values))
    _build.check(name, rc)


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------
def ell_matvec(values: torch.Tensor, cols: torch.Tensor,
               x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for ELL A.  values/cols: (n, width); x: (n,) or (n, k)."""
    _check_ell("ell_matvec", values, cols)
    _check_x("ell_matvec", values.shape[0], x, values)
    if values.device.type == "cpu":
        return ell_matvec_plain(values, cols, x)
    _check_storage("ell_matvec", values, cols)
    compute, _ = _acc_dtypes(values.dtype, x.dtype)
    xf = _x_block("ell_matvec", x, compute)
    y = torch.empty_like(xf)
    _launch_ell(values, cols, xf, y, "ell_matvec")
    ell_matvec.launches += _chunks(xf.shape[1])
    y = y.to(compute)
    return y[:, 0] if x.ndim == 1 else y


ell_matvec.launches = 0


def sell_matvec(bin_values, bin_cols, x: torch.Tensor,
                perm=None) -> torch.Tensor:
    """Sliced-ELL SpMV: one launch over the table of width bins.

    ``bin_values[b]`` / ``bin_cols[b]`` are (rows_b, width_b) rectangles of
    nnz-sorted rows with global int32 column indices, which must index x.
    Returns (sum_b rows_b,) or (sum_b rows_b, k): in bin order (the
    sorted-row frame, JAX's contract) without ``perm``; with ``perm``
    (int32, one entry per row, a permutation) row r of that frame lands at
    y[perm[r]], written there by the kernel (no scatter on the card).
    """
    bin_values, bin_cols = tuple(bin_values), tuple(bin_cols)
    _check_bins(bin_values, bin_cols)
    if x.ndim not in (1, 2):
        raise TypeError(f"sell_matvec: x {tuple(x.shape)} must be (n,) or "
                        f"(n, k)")
    if any(v.device != x.device or c.device != x.device
           for v, c in zip(bin_values, bin_cols)):
        raise ValueError(f"sell_matvec: bins and x on different devices "
                         f"(x on {x.device})")
    rows = sum(v.shape[0] for v in bin_values)
    if perm is not None and (perm.ndim != 1 or perm.shape[0] != rows
                             or perm.device != x.device):
        raise TypeError(f"sell_matvec: perm {tuple(perm.shape)} on "
                        f"{perm.device} must be ({rows},) on {x.device}")
    if x.device.type == "cpu":
        y = sell_matvec_plain(bin_values, bin_cols, x)
        if perm is None:
            return y
        return torch.zeros_like(y).index_copy_(0, perm.long(), y)
    for v, c in zip(bin_values, bin_cols):
        _check_storage("sell_matvec", v, c)
    dtype = bin_values[0].dtype
    if any(v.dtype != dtype for v in bin_values):
        raise TypeError("sell_matvec: all bins must share one storage dtype")
    if perm is not None and (perm.dtype != torch.int32
                             or not perm.is_contiguous()):
        raise TypeError(f"sell_matvec: perm must be contiguous int32, got "
                        f"{perm.dtype}")
    compute, _ = _acc_dtypes(dtype, x.dtype)
    xf = _x_block("sell_matvec", x, compute)
    y = torch.empty((rows, xf.shape[1]), dtype=torch.float32, device=x.device)
    _launch_sell(bin_values, bin_cols, xf, y, perm, "sell_matvec")
    sell_matvec.launches += _chunks(xf.shape[1])
    y = y.to(compute)
    return y[:, 0] if x.ndim == 1 else y


sell_matvec.launches = 0


def banded_matvec(bands: torch.Tensor, x: torch.Tensor,
                  offsets) -> torch.Tensor:
    """y[i] = sum_d bands[d, i] * x[i + offsets[d]], out-of-range -> 0.

    bands: (nbands, n); offsets: one int diagonal shift per band (e.g.
    (-nx, -1, 0, 1, nx) for the five-point stencil); x: (n,) or (n, k).
    """
    offsets = tuple(int(o) for o in offsets)
    if bands.ndim != 2 or len(offsets) != bands.shape[0]:
        raise TypeError(f"banded_matvec: bands {tuple(bands.shape)} but "
                        f"{len(offsets)} offsets")
    _check_x("banded_matvec", bands.shape[1], x, bands)
    if bands.device.type == "cpu":
        return banded_matvec_plain(bands, x, offsets)
    _check_storage("banded_matvec", bands)
    nbands, n = bands.shape
    if nbands > MAX_BANDS:
        raise ValueError(f"banded_matvec: {nbands} bands; the kernel takes "
                         f"at most {MAX_BANDS}")
    compute, _ = _acc_dtypes(bands.dtype, x.dtype)
    xf = _x_block("banded_matvec", x, compute)
    y = torch.empty_like(xf)
    offs = (ctypes.c_int * nbands)(*offsets)
    rc = _build.library().repro_banded_matvec(
        bands.data_ptr(), int(bands.dtype == torch.bfloat16),
        ctypes.addressof(offs), nbands, xf.data_ptr(), y.data_ptr(), n,
        xf.shape[1], tuning.SPMV_THREADS, _build.stream_ptr(bands))
    _build.check("banded_matvec", rc)
    banded_matvec.launches += _chunks(xf.shape[1])
    y = y.to(compute)
    return y[:, 0] if x.ndim == 1 else y


banded_matvec.launches = 0


# --------------------------------------------------------------------------
# row-sharded halo variants
# --------------------------------------------------------------------------
def halo_exchange(x: torch.Tensor, halo: int, group) -> torch.Tensor:
    """Fetch ``halo`` boundary rows from each neighbour rank of ``group``.

    x: the local (n_local,) or (n_local, k) shard of a row-partitioned
    vector.  Returns (n_local + 2 halo, ...): rows [0, halo) hold the
    previous rank's last rows, rows [halo + n_local, ...) the next rank's
    first rows; the first and last ranks get zeros there (the kernels'
    out-of-range-is-zero convention).  One ``batch_isend_irecv`` of at
    most four halo-row messages, counted once in
    ``tuning.COLLECTIVES["halo"]``; halo > n_local raises, as in JAX.
    """
    if halo == 0:
        return x
    if halo > x.shape[0]:
        raise ValueError(f"halo_exchange: halo={halo} exceeds the local "
                         f"shard length {x.shape[0]}; neighbours' "
                         f"neighbours would be needed: use an all-gather")
    x = x.contiguous()
    rank, size = group.rank(), group.size()
    top = torch.zeros((halo,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    bot = torch.zeros_like(top)
    ops = []
    if rank > 0:
        peer = dist.get_global_rank(group, rank - 1)
        ops += [dist.P2POp(dist.isend, x[:halo].contiguous(), peer, group),
                dist.P2POp(dist.irecv, top, peer, group)]
    if rank < size - 1:
        peer = dist.get_global_rank(group, rank + 1)
        ops += [dist.P2POp(dist.isend, x[-halo:].contiguous(), peer, group),
                dist.P2POp(dist.irecv, bot, peer, group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    tuning.COLLECTIVES["halo"] += 1
    return torch.cat([top, x, bot], dim=0)


def banded_matvec_halo(bands: torch.Tensor, x_halo: torch.Tensor,
                       offsets) -> torch.Tensor:
    """One shard's banded product over an already halo-padded operand.

    bands: the (nbands, n_local) shard of the band stack; x_halo: the
    (n_local + 2 halo, ...) output of ``halo_exchange`` with halo =
    max |offsets|.  Returns the (n_local, ...) local output shard.
    """
    offsets = tuple(int(o) for o in offsets)
    if bands.ndim != 2 or len(offsets) != bands.shape[0]:
        raise TypeError(f"banded_matvec_halo: bands {tuple(bands.shape)} "
                        f"but {len(offsets)} offsets")
    nbands, n = bands.shape
    halo = max(abs(o) for o in offsets)
    _check_x("banded_matvec_halo", n + 2 * halo, x_halo, bands)
    if bands.device.type == "cpu":
        return banded_matvec_halo_plain(bands, x_halo, offsets)
    _check_storage("banded_matvec_halo", bands)
    if nbands > MAX_BANDS:
        raise ValueError(f"banded_matvec_halo: {nbands} bands; the kernel "
                         f"takes at most {MAX_BANDS}")
    compute, _ = _acc_dtypes(bands.dtype, x_halo.dtype)
    xf = _x_block("banded_matvec_halo", x_halo, compute)
    y = torch.empty((n, xf.shape[1]), dtype=torch.float32,
                    device=bands.device)
    offs = (ctypes.c_int * nbands)(*offsets)
    rc = _build.library().repro_banded_matvec_halo(
        bands.data_ptr(), int(bands.dtype == torch.bfloat16),
        ctypes.addressof(offs), nbands, xf.data_ptr(), y.data_ptr(), n,
        halo, xf.shape[1], tuning.SPMV_THREADS, _build.stream_ptr(bands))
    _build.check("banded_matvec_halo", rc)
    banded_matvec_halo.launches += _chunks(xf.shape[1])
    y = y.to(compute)
    return y[:, 0] if x_halo.ndim == 1 else y


banded_matvec_halo.launches = 0


def ell_matvec_halo(values: torch.Tensor, cols: torch.Tensor,
                    x_halo: torch.Tensor) -> torch.Tensor:
    """One shard's ELL product over an already halo-padded operand.

    values/cols: the (n_local, width) shard with ``cols`` remapped into
    the padded frame (global column - shard offset + halo; see
    ``SparseOperator.__call__``); x_halo: the output of ``halo_exchange``,
    at least n_local rows.
    """
    _check_ell("ell_matvec_halo", values, cols)
    if x_halo.ndim not in (1, 2) or x_halo.shape[0] < values.shape[0]:
        raise TypeError(f"ell_matvec_halo: x_halo {tuple(x_halo.shape)} "
                        f"must be (rows, ...) with rows >= "
                        f"{values.shape[0]}")
    if values.device != x_halo.device:
        raise ValueError(f"ell_matvec_halo: matrix on {values.device}, x "
                         f"on {x_halo.device}")
    if values.device.type == "cpu":
        return ell_matvec_halo_plain(values, cols, x_halo)
    _check_storage("ell_matvec_halo", values, cols)
    compute, _ = _acc_dtypes(values.dtype, x_halo.dtype)
    xf = _x_block("ell_matvec_halo", x_halo, compute)
    rows, width = values.shape
    y = torch.empty((rows, xf.shape[1]), dtype=torch.float32,
                    device=values.device)
    rc = _build.library().repro_ell_matvec_halo(
        values.data_ptr(), int(values.dtype == torch.bfloat16),
        cols.data_ptr(), xf.data_ptr(), xf.shape[0], y.data_ptr(), rows,
        width, xf.shape[1], tuning.SPMV_THREADS, _build.stream_ptr(values))
    _build.check("ell_matvec_halo", rc)
    ell_matvec_halo.launches += _chunks(xf.shape[1])
    y = y.to(compute)
    return y[:, 0] if x_halo.ndim == 1 else y


ell_matvec_halo.launches = 0
