"""Launch shapes of the port's Hopper kernels, and the fused-step fits check.

Counterpart of ``repro/kernels/tuning.py``, redesigned for Hopper: the
TPU's VMEM budget, (8, 128) tile rounding and persisted block choices have
no meaning here.  What the kernels need is

- the GEMV launch shape (csrc/matvec.cu: a warp takes R rows at once on a
  persistent grid): ``gemv_rows_shape``;
- the SpMV block size (csrc/spmv.cu: one thread per row, ELL and banded);
- the cooperative kernels' shared-memory cap and blocks per SM
  (csrc/cgs2.cu, csrc/arnoldi_fused.cu, csrc/batched_cgs2.cu,
  csrc/matrix_powers.cu, csrc/block_gs.cu); the C side picks the grid from
  these with the occupancy calculator;
- the grid of csrc/block_gs.cu's update, a plain launch: ``sr_grid``;
- the launch of the streaming GEMV kernels (csrc/sr_payload.cu's
  gs_update, gs_project_partial and the payload, its two right-hand
  columns: 16-byte pieces, a scalar route for misaligned operands and the
  ragged tail; the projections a block a row for short rows):
  ``stream_aligned``, ``gemv_stream_shape``, ``gemv_partial_shape``;
- the banded and ELL matrix powers and the fused Chebyshev apply
  (csrc/matrix_powers.cu): one row partition into segments
  (``powers_segments``), several a block, the band stack or table rows
  each keeps in shared memory across the powers, and the banded kernels'
  operand tile: ``banded_plan``, ``ell_powers_plan``;
- the preconditioning kernels' shapes: the fused Chebyshev apply takes
  ``banded_plan``; the triangular sweep
  (csrc/trisolve.cu) takes a device-wide scan without a far band, else a
  chain of chunks, one block per right-hand side: ``trisweep_plan``; the
  ILU(0) setup is a wavefront of warps over tiles of rows: ``ilu0_plan``;
- the per-lane CGS2 of the block solver (csrc/batched_cgs2.cu): blocks
  split over the active lanes by their rows, ``batched_cgs2_split``; the
  scalar solver's CGS2 (csrc/cgs2.cu): the shared-memory pass or the
  streamed one-launch cgs2, ``gs_stream_plan``; the s-step block pass
  and the projections of the single-reduce and row-sharded passes
  (csrc/block_gs.cu): ``block_gs_plan``;
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
import functools
from typing import Optional

import torch
import torch.distributed as dist

H100_SMS = 132            # SMs of an H100 SXM; used when no card is present
GEMV_THREADS = 256        # 8 warps per block (csrc/matvec.cu)
GS_WARPS = 8              # warps per cooperative block (csrc/common.cuh)
# Dynamic shared memory a cooperative block may use (of the 227 KB limit),
# leaving room for the runtime's reserved shared memory.
SMEM_BUDGET = 200 * 1024
# The most dynamic shared memory one block may have on an H100 (227 KB):
# the gated RMSNorm's shapes are refused above it (kernels/gated_norm.py).
SMEM_LIMIT = 232_448
# The most blocks on a grid's x axis (its y and z take 65,535).
MAX_GRID = 2 ** 31 - 1
# Upper bound on co-resident blocks per SM for the cooperative kernels.
# The GS pass alone is latency-bound (fewer blocks: cheaper grid sync and
# fewer partials to reduce); the fused step also streams A and wants more
# warps in flight.
GS_BLOCKS_PER_SM = 1
FUSED_BLOCKS_PER_SM = 4
# The streamed GS pass (csrc/cgs2.cu, where a block's slice does not fit
# shared memory: gs_stream_plan) runs csrc/stream_gs.cuh's sweeps as one
# lane of batched_cgs2's launch rule (BATCHED_THREADS a block, two blocks
# an SM, fixed in the kernel).
SPMV_THREADS = 256        # rows per SpMV block, one thread per row
# The s-step kernels (csrc/matrix_powers.cu, csrc/block_gs.cu) are
# persistent cooperative launches: these many blocks per SM at most, fewer
# where the occupancy calculator says fewer are co-resident, and never more
# blocks than the rows (a thread per row; dense: a warp per row) or columns
# (a thread per column) need.  The banded and ELL powers cut their rows
# into this many segments an SM (``powers_segments``, several a block), so
# a stencil gets the same row partition, and the same bits, in both
# formats.  Each power ends in a grid sync whose cost grows with the grid;
# each block-GS pass reduces (k_start + 1) * s partials per block.
POWERS_BLOCKS_PER_SM = 4
# block_gs_pass (csrc/block_gs.cu): one block of 256 threads an SM (fixed
# in the kernel), a block a contiguous range of 16-byte pieces, at least
# BLOCK_GS_MIN_ITEMS a block (two warps' share of a row group); the warps
# split the valid rows into groups of BLOCK_GS_ROW_GROUP (a thread holds
# that many rows x s accumulators).
BLOCK_GS_MAX_S = 8        # accumulators per thread: s columns of Q x 8 rows
BLOCK_GS_ROW_GROUP = 8
BLOCK_GS_MIN_ITEMS = 64
# block_gs_update (csrc/block_gs.cu) takes a thread a column of its block's
# slice of the columns over a plain grid: four blocks per SM keep enough
# loads in flight, and at most SR_MAX_COLS columns a block (eight a thread)
# let the grid grow with n past 4 x 132 blocks.
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
# The ELL powers (csrc/matrix_powers.cu's ell_powers_kernel): a block of
# kThreads x (at most ELL_POWERS_GROUPS) threads owns consecutive segments
# of the banded grid's row partition, ELL_POWERS_GROUPS of them at once,
# and keeps the first rows of each in shared memory; the slots of a row
# are unrolled to the smallest of ELL_BUCKETS that holds them (wider rows
# loop over the largest), and a thread takes ELL_ROWS_IN_FLIGHT[bucket]
# rows at once (csrc's ell_rows_in_flight).
ELL_POWERS_GROUPS = 4
ELL_BUCKETS = (4, 5, 8, 16)
ELL_ROWS_IN_FLIGHT = {4: 2, 5: 2, 8: 1, 16: 1}
# The banded powers and the fused Chebyshev apply (csrc/matrix_powers.cu's
# banded_powers_kernel, banded_cheb_kernel): the ELL powers' segments, up
# to ELL_POWERS_GROUPS a block, one group of kThreads threads each; in
# shared memory the grid's partials, a tile of the block's rows and a halo
# each side, its ends moved to 16-byte boundaries (BANDED_TILE_SLACK
# rows), then the first rows of each segment's band stack.  The Chebyshev
# kernel keeps KEEP_ROWS rows of a thread's segment in registers between
# steps (kKeepRows).
BANDED_TILE_SLACK = 8
KEEP_ROWS = 8
# block_matvec (csrc/matvec.cu): a warp takes R rows at once (each x
# piece loaded once for them, all their 16-byte A pieces in flight), on a
# persistent grid of a few blocks an SM whose warps split the rows evenly,
# U pieces of each row in flight, A read evict-first (__ldcs) or not
# (__ldg).  (R, blocks an SM, U, evict-first) by the widest k and A's
# element size: the fastest of chip_smoke.py's sweep at n = 10^4, k = 1
# and 4 (PERF.md section 6, row 1); wider X takes fewer rows (registers).
# (U, evict-first) other than (2, True) only at k = 1 and 4 (the kernel's
# instantiations).
GEMV_SHAPES = {(2, 4): (2, 6, 4, False), (2, 2): (2, 6, 4, False),
               (4, 4): (4, 4, 2, False), (4, 2): (8, 2, 2, True),
               (8, 4): (1, 2, 2, True), (8, 2): (1, 2, 2, True)}
GEMV_ROWS_CHOICES = (1, 2, 4, 8)   # the kernel's instantiations
# The triangular sweep (csrc/trisolve.cu).  Route "scan": tiles of
# TRISWEEP_SCAN_TILE rows (8 a thread, kThreads a block) on a cooperative
# grid of at most TRISWEEP_SCAN_BLOCKS_PER_SM blocks an SM, each tile read
# twice (its aggregate, then its rows).  Route "chunk": chunks of at most
# TRISWEEP_MAX_CHUNK rows, TRISWEEP_ROWS consecutive rows a lane (the
# kernel's kChunkRows) and a warp a strip of 32 x that (at most
# TRISWEEP_MAX_THREADS threads a block), up to TRISWEEP_STAGES chunks'
# loads in flight (8, 4 or 2, the most that fit SMEM_BUDGET).
# The ILU(0) setup (csrc/trisolve.cu): a warp a tile of at most
# ILU_MAX_TILE consecutive rows, in groups of ILU_GROUP rows (a lane a
# row); a tile is the nearest lower offset of at least ILU_GROUP rows (a
# grid line of a stencil), so a tile's rows wait for the tile before it
# row by row.
ILU_GROUP = 32
ILU_MAX_TILE = 1024
# batched_cgs2 (csrc/batched_cgs2.cu): blocks of BATCHED_THREADS threads,
# as many as are co-resident (two an SM, fixed in the kernel), split over
# the active lanes by their rows; a lane's thread keeps
# up to BATCHED_SLOTS 16-byte loads of V in flight: a lane of at most 2
# rows takes BATCHED_SLOTS / 2 pieces at once (at most 32 columns of w),
# a larger one a piece with up to BATCHED_SLOTS of its rows.  Two buckets
# only: each is a copy of the three sweeps in the one kernel, and more
# copies pushed it past 255 registers (PERF.md).  The kernel keeps the
# same rule (block_gs.kernel_unroll reports it; the card tests compare).
BATCHED_THREADS = 128
BATCHED_SLOTS = 16
BATCHED_BUCKETS = (2, 32)
TRISWEEP_SCAN_ROWS = 8
TRISWEEP_SCAN_TILE = 256 * TRISWEEP_SCAN_ROWS
TRISWEEP_SCAN_BLOCKS_PER_SM = 2
TRISWEEP_MAX_CHUNK = 1024
TRISWEEP_ROWS = 4
TRISWEEP_MAX_THREADS = 256
TRISWEEP_STAGES = 8
# The SSD scan (csrc/ssd.cu): t tiles of 64 rows, stages of 32 rows,
# G = C B^T kept for a window of 256 u, and enough head groups for two
# blocks an SM.  The kernels' shared memory is the C side's
# (``repro_ssd_smem``).
SSD_TILE = 64
SSD_STAGE = 32
SSD_WINDOW = 256
SSD_BLOCKS_PER_SM = 2
SSD_N = 64               # N, padded to the state's rows


def sm_count(device) -> int:
    dev = torch.device(device)
    if dev.type == "cuda":
        return _cuda_sms(torch.cuda.current_device() if dev.index is None
                         else dev.index)
    return H100_SMS


@functools.lru_cache(maxsize=None)
def _cuda_sms(index: int) -> int:
    """The SMs of card ``index``, asked once (the wrappers plan every
    launch from it)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    """Grid of ``block_gs_update`` (csrc/block_gs.cu): a plain launch whose
    partials a second launch reduces, so any grid is valid.
    SR_BLOCKS_PER_SM blocks per SM, at least a thread's worth of columns
    each, and at most SR_MAX_COLS columns per block."""
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


def gemv_partial_shape(shape: dict, rows: int, k: int = 1) -> dict:
    """The projections' launch from ``gemv_stream_shape``'s: a block for
    each of the ``rows`` valid rows (``by_row``; the kernel takes its own
    block size, so ``threads`` is 0) where a row has at most
    PARTIAL_ROW_MAX_ITEMS work items, else the column sweep.  ``k`` right-
    hand columns: 1 (``gs_project_partial``: the shape as given), or 2 (the
    payload: V [z, v_j] with v_j = row rows - 1, and the two squared norms;
    the sweep sums rows 0..rows-2 in buckets of ``bucket`` rows: 8 where
    they fit, else 16, looped past 16 rows; in the 16-row bucket two
    pieces at once only for float32 V: bfloat16's spills and was slower,
    and a 32-row bucket spilled in both, PERF.md §6)."""
    if max(shape["pieces"], shape["tail"]) <= PARTIAL_ROW_MAX_ITEMS:
        out = dict(shape, by_row=1, threads=0, blocks=rows, unroll=1)
    else:
        out = dict(shape, by_row=0)
    if k == 2:
        bucket = 8 if rows - 1 <= 8 else 16
        out["bucket"] = 0 if out["by_row"] else bucket
        if bucket == 16 and shape["vec"] != 4:
            out["unroll"] = 1
    return out


def _round16(nbytes: int) -> int:
    return -(-nbytes // 16) * 16


def ell_smem_bytes(seg_per_block: int, res_seg: int, width: int,
                   elem_size: int) -> int:
    """Dynamic shared memory of the ELL powers kernel
    (csrc/matrix_powers.cu's ell_smem_bytes): kWarps partials a segment and
    the norm, then the resident values and cols of each segment."""
    k = seg_per_block
    return (_round16(4 * (k * GS_WARPS + 1))
            + _round16(k * res_seg * width * elem_size)
            + 4 * k * res_seg * width)


def powers_segments(n: int, sms: int) -> int:
    """The row segments of the banded and ELL powers at this n on ``sms``
    SMs: POWERS_BLOCKS_PER_SM a SM, at most a segment per kThreads rows.
    One partition for both formats, so a stencil gets the same bits in
    both (and the first banded design's grid, whose bits they keep)."""
    return max(1, min(POWERS_BLOCKS_PER_SM * sms, -(-n // (32 * GS_WARPS))))


def banded_smem_bytes(seg_per_block: int, segments: int, res_seg: int,
                      nbands: int, elem_size: int, tile_rows: int) -> int:
    """Dynamic shared memory of the banded kernels
    (csrc/matrix_powers.cu's banded_smem_bytes): kWarps partials a segment,
    the norm and the grid's ``segments`` partials, the tile (``tile_rows``
    floats), then the resident band stack of each segment."""
    k = seg_per_block
    return (_round16(4 * (k * GS_WARPS + 1 + segments))
            + _round16(4 * tile_rows)
            + _round16(k * res_seg * nbands * elem_size))


def banded_plan(n: int, offsets, elem_size: int, sms: int) -> dict:
    """The launch of ``banded_powers`` and ``banded_cheb_apply`` over an
    (nbands, n) band stack stored in ``elem_size`` bytes with these
    offsets, on ``sms`` SMs.

    ``segments`` (``powers_segments``), ``per`` rows each (a multiple of
    32), ``seg_per_block`` consecutive ones a block (as few as one block
    an SM allows: at most ELL_POWERS_GROUPS), ``blocks`` of
    ``threads`` (a group of kThreads a segment), ``rows`` a block at
    most.  The tile: the block's rows
    and ``tile_halo`` rows each side, ``tile_rows`` floats.  ``route``
    "tile" where the whole halo (max |offset|) fits SMEM_BUDGET; "far"
    where only a nearer one does (the bands farther than ``tile_halo``,
    ``far`` of them, are read from L2); "l2" where not even the block's
    rows fit (no tile: tile_halo -1, tile_rows 0).  Then ``res_seg``: the
    first rows of each segment whose band entries stay in shared memory
    (whole chunks of 32, within SMEM_BUDGET); ``resident`` =
    ``seg_per_block`` x that.  ``reg_rows``: the most rows of a segment a
    thread owns (the Chebyshev kernel keeps KEEP_ROWS of them in registers
    between steps)."""
    offsets = tuple(int(o) for o in offsets)
    nbands = len(offsets)
    segs = powers_segments(n, sms)
    per = (-(-n // segs) + 31) // 32 * 32
    k = -(-segs // sms)
    rows = k * per
    halo = max(abs(o) for o in offsets)

    def fits(h):
        return banded_smem_bytes(k, segs, 0, nbands, elem_size,
                                 rows + 2 * h + BANDED_TILE_SLACK) \
            <= SMEM_BUDGET
    if fits(halo):
        route, tile_halo = "tile", halo
    elif fits(0):
        route = "far"
        tile_halo = max(abs(o) for o in offsets if fits(abs(o))) \
            if any(fits(abs(o)) for o in offsets) else 0
    else:
        route, tile_halo = "l2", -1
    tile_rows = rows + 2 * tile_halo + BANDED_TILE_SLACK \
        if tile_halo >= 0 else 0
    avail = SMEM_BUDGET - banded_smem_bytes(k, segs, 0, nbands, elem_size,
                                            tile_rows)
    res = min(per, avail // (k * nbands * elem_size) // 32 * 32)
    return {"segments": segs, "per": per, "seg_per_block": k,
            "blocks": -(-segs // k), "threads": 32 * GS_WARPS * k,
            "rows": rows, "halo": halo, "tile_halo": tile_halo,
            "tile_rows": tile_rows,
            "far": sum(abs(o) > tile_halo for o in offsets),
            "res_seg": res, "resident": k * res,
            "smem": banded_smem_bytes(k, segs, res, nbands, elem_size,
                                      tile_rows),
            "reg_rows": -(-per // (32 * GS_WARPS)), "route": route}


def ell_powers_plan(n: int, width: int, elem_size: int, sms: int,
                    segments: Optional[int] = None) -> dict:
    """The launch of ``ell_powers`` over an (n, width) table with values
    stored in ``elem_size`` bytes, on ``sms`` SMs.

    ``segments``: the banded powers' segments at this n (default
    ``powers_segments``; row_range's rule, ``per`` rows a segment, a
    multiple of 32), so a stencil gets the same bits in both formats.  ``seg_per_block``
    consecutive segments a block, as few as one block an SM allows;
    ``blocks`` of ``threads`` (kThreads a segment run at once, at most
    ELL_POWERS_GROUPS).  ``res_seg``: the first rows of each segment kept
    in shared memory (whole chunks of 32 rows, within SMEM_BUDGET);
    ``resident`` = ``seg_per_block`` x that, of at most ``rows`` a block.
    ``route`` "resident", or "stream" where not one chunk of 32 rows fits
    (the table then read every power).  ``bucket``: the slots unrolled,
    ``rows_in_flight`` the rows a thread takes at once."""
    segs = segments or powers_segments(n, sms)
    per = (-(-n // segs) + 31) // 32 * 32
    k = -(-segs // sms)
    avail = SMEM_BUDGET - ell_smem_bytes(k, 0, width, elem_size)
    res = min(per, avail // (k * width * (elem_size + 4)) // 32 * 32)
    bucket = next((b for b in ELL_BUCKETS if b >= width), ELL_BUCKETS[-1])
    return {"segments": segs, "per": per, "seg_per_block": k,
            "blocks": -(-segs // k),
            "threads": 32 * GS_WARPS * min(k, ELL_POWERS_GROUPS),
            "rows": k * per, "res_seg": res, "resident": k * res,
            "smem": ell_smem_bytes(k, res, width, elem_size),
            "bucket": bucket, "rows_in_flight": ELL_ROWS_IN_FLIGHT[bucket],
            "route": "resident" if res else "stream"}


def gemv_rows_shape(m: int, n: int, k: int, elem_size: int, sms: int,
                    rows: Optional[int] = None,
                    blocks_per_sm: Optional[int] = None,
                    unroll: Optional[int] = None,
                    evict_first: Optional[bool] = None) -> dict:
    """Launch shape of ``block_matvec`` over an (m, n) A stored in
    ``elem_size`` bytes and k columns of X, on ``sms`` SMs.

    ``rows`` (R): the rows a warp takes at once, from one shared x piece;
    R > 1 needs every row to start at the same distance from a 16-byte
    boundary (n * elem_size % 16 == 0: route "rows"), else a warp takes
    one row at a time with its own head (route "row", common.cuh's
    row_dot).  ``blocks``: at most ``blocks_per_sm`` blocks an SM, never
    more than a warp a row; warp w of the grid's W takes rows
    [w m // W, (w + 1) m // W), R at a time.  ``unroll`` pieces of each
    row in flight, A read ``evict_first`` or not.  Each defaults to
    GEMV_SHAPES; the one-row route and k other than 1 and 4 take
    (unroll, evict_first) = (2, True)."""
    kk = 2 if k <= 2 else 4 if k <= 4 else 8
    r0, bps0, u0, cs0 = GEMV_SHAPES[(kk, 2 if elem_size == 2 else 4)]
    r = rows or r0
    if r not in GEMV_ROWS_CHOICES:
        raise ValueError(f"gemv_rows_shape: rows {r} not in "
                         f"{GEMV_ROWS_CHOICES}")
    if (n * elem_size) % 16:
        r = 1
    warps = GEMV_THREADS // 32
    bps = blocks_per_sm or bps0
    blocks = max(1, min(bps * sms, -(-m // warps)))
    u = unroll or u0
    cs = cs0 if evict_first is None else bool(evict_first)
    if r == 1 or k not in (1, 4):
        u, cs = 2, True
    if u not in (2, 4):
        raise ValueError(f"gemv_rows_shape: unroll {u} not in (2, 4)")
    return {"rows": r, "blocks": blocks, "threads": GEMV_THREADS,
            "unroll": u, "evict_first": cs,
            "route": "rows" if r > 1 else "row"}


def gemv_rows_of(shape: dict, m: int) -> list:
    """The row groups of each warp under ``shape`` (what the kernel's
    loops visit): a list, per warp, of (first row, rows) pairs."""
    total = shape["blocks"] * (shape["threads"] // 32)
    out = []
    for w in range(total):
        lo, hi = w * m // total, (w + 1) * m // total
        out.append([(r0, min(shape["rows"], hi - r0))
                    for r0 in range(lo, hi, shape["rows"])])
    return out


def _pow2_at_least(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def trisweep_smem_bytes(threads: int, rows: int, nbands: int, elem: int,
                        ring: int, stages: int) -> int:
    """Dynamic shared memory of the chunk route (csrc/trisolve.cu's
    chunk_smem_bytes): the ring, and per stage v and the bands of a
    block's rows."""
    return 4 * ring + stages * threads * rows * (4 + nbands * elem)


def trisweep_plan(offsets, n: int, k: int, elem_size: int,
                  aligned: bool) -> dict:
    """The route and launch shape of ``banded_trisweep`` for a band stack
    with these offsets (all on one side), n rows, k right-hand sides, bands
    stored in ``elem_size`` bytes; ``aligned``: every operand 16-byte
    aligned, with row strides that keep it so.

    No far band (every |off| <= 1): route "scan", ``tiles`` tiles of
    TRISWEEP_SCAN_TILE rows a right-hand side, ``agg`` floats of scratch;
    ``vec``: 16-byte loads (aligned, n % 8 == 0).

    Else a chain of ``chunks`` chunks of ``chunk`` rows: the nearest far
    offset c (at most TRISWEEP_MAX_CHUNK), halved where another far offset
    is neither a multiple of it nor at least twice it (so every far term
    lies at the same position of the previous chunk, which the same
    thread solved, or two chunks back or more).  ``rows`` a lane
    (TRISWEEP_ROWS), ``threads`` = 32 x warps for the chunk; ``vec``: the
    cp.async pipeline of ``stages`` chunks (aligned, chunk and n multiples
    of rows), else loads one chunk at a time (``stages`` = 1).  A far term
    ``chunk`` back is the thread's own z in registers; any other needs
    ``ring``, a ring of solved entries in shared memory, a power of two >=
    max|off| + chunk, or where that does not fit SMEM_BUDGET beside two
    stages, route "chunk_l2" (``far_l2``: read back from z)."""
    offsets = tuple(int(o) for o in offsets)
    far = sorted({abs(o) for o in offsets if abs(o) >= 2})
    if not far:
        groups = -(-n // TRISWEEP_SCAN_ROWS)
        tiles = -(-groups // (TRISWEEP_SCAN_TILE // TRISWEEP_SCAN_ROWS))
        return {"route": "scan", "chunk": 0, "chunks": 1, "tiles": tiles,
                "agg": 2 * k * tiles, "rows": TRISWEEP_SCAN_ROWS,
                "threads": TRISWEEP_SCAN_TILE // TRISWEEP_SCAN_ROWS,
                "vec": bool(aligned and n % TRISWEEP_SCAN_ROWS == 0),
                "ring": 0, "far_l2": 0, "stages": 0, "smem": 0,
                "blocks_per_sm": TRISWEEP_SCAN_BLOCKS_PER_SM}
    r = TRISWEEP_ROWS
    chunk = min(far[0], TRISWEEP_MAX_CHUNK)
    if any(f % chunk and f < 2 * chunk for f in far):
        chunk = max(1, chunk // 2)
    warps = -(-chunk // (32 * r))
    threads = 32 * warps
    vec = bool(aligned and chunk % r == 0 and n % r == 0)
    other = any(f != chunk for f in far)
    ring = max(4, _pow2_at_least(far[-1] + chunk)) if other else 0
    nbands = len(offsets)

    def fits(ring, stages):
        return trisweep_smem_bytes(threads, r, nbands, elem_size, ring,
                                   stages) <= SMEM_BUDGET

    def most_stages(ring):
        return next((st for st in (TRISWEEP_STAGES, 4, 2)
                     if fits(ring, st)), 0)
    far_l2 = 0
    stages = most_stages(ring) if vec else (1 if fits(ring, 1) else 0)
    if not stages and ring:
        ring, far_l2 = 0, 1
        stages = most_stages(ring) if vec else 1
    if not stages:
        vec, stages = False, 1
    return {"route": "chunk_l2" if far_l2 else "chunk", "chunk": chunk,
            "chunks": -(-n // chunk), "tiles": 0, "agg": 0, "rows": r,
            "threads": threads, "vec": vec, "ring": ring, "far_l2": far_l2,
            "stages": stages,
            "smem": trisweep_smem_bytes(threads, r, nbands, elem_size, ring,
                                        stages),
            "blocks_per_sm": 0}


def ilu0_plan(offsets) -> dict:
    """The ILU(0) setup's dependency rule and tiles for a band stack with
    these offsets (0 among them).

    ``lower``: the lower offsets, most negative first (the elimination
    order); ``wait``: for each, whether a row always waits for row i + l
    (l is a slot an earlier elimination can fill, u + l' for an upper u
    and a lower l': the plain version's ``filled``) or only where
    a[i, l] != 0; ``wait_mask`` the same as bits.  ``tile_rows``: the rows
    a warp takes (the nearest lower offset of at least ILU_GROUP rows, at
    most ILU_MAX_TILE; ILU_MAX_TILE without one)."""
    lower = tuple(sorted(o for o in offsets if o < 0))
    upper = [o for o in offsets if o > 0]
    filled = {u + lo for lo in lower for u in upper}
    wait = tuple(lo in filled for lo in lower)
    far = [-lo for lo in lower if -lo >= ILU_GROUP]
    tile = min(ILU_MAX_TILE, min(far)) if far else ILU_MAX_TILE
    return {"lower": lower, "wait": wait,
            "wait_mask": sum(1 << j for j, w in enumerate(wait) if w),
            "tile_rows": tile}


def _pieces(n: int, elem_size: int, aligned: bool) -> tuple:
    """(vec, pieces, tail): ``vec`` columns a 16-byte piece of V, the
    pieces a row (0 where not ``aligned``: the scalar route) and the
    scalar tail columns."""
    vec = 16 // elem_size
    pieces = n // vec if aligned else 0
    return vec, pieces, n - pieces * vec


def gs_stream_plan(m1: int, n: int, j: int, elem_size: int, aligned: bool,
                   budget: int) -> dict:
    """The streamed ``gs_project`` / ``cgs2`` kernel (csrc/cgs2.cu, where a
    block's V slice does not fit shared memory: not ``fused_step_fits``)
    on a basis V (m1, n) stored in ``elem_size`` bytes at step j (rows
    0..j): route "vec" (16-byte pieces, where V, w and the row stride are
    ``aligned``) or "scalar" (pieces = 0).  One lane of
    ``batched_cgs2_split``'s rule: ``grid`` = min(``budget`` co-resident
    blocks, what gives each thread one round of U pieces), U from
    ``batched_unroll``."""
    vec, pieces, tail = _pieces(n, elem_size, aligned)
    rows = j + 1
    t = BATCHED_THREADS
    bucket, u = batched_unroll(rows, elem_size)
    grid = max(1, min(budget, max(1, -(-pieces // (t * u)), -(-tail // t))))
    return {"route": "vec" if pieces else "scalar", "grid": grid,
            "pieces": pieces, "tail": tail, "vec": vec, "bucket": bucket,
            "unroll": u, "threads": t}


def block_gs_plan(m1: int, n: int, s: int, rows: int, elem_size: int,
                  aligned: bool, sms: int) -> dict:
    """The launch of ``block_gs_pass`` over V (m1, n) stored in
    ``elem_size`` bytes with ``rows`` = k_start + 1 valid rows and s
    columns of W, and of the projections ``block_gs_project_gram`` (rows =
    every row given) and ``block_gs_project``, which run its projection
    sweep as a plain launch: ``grid`` blocks (at most one an SM, at least
    BLOCK_GS_MIN_ITEMS work items a block), block b owning pieces
    [b pb, (b + 1) pb) and tail columns [pieces vec + b tb, ... + tb);
    ``groups``: the warps' row groups of the first (only, for rows <= 64)
    set of rows and ``shares`` the column shares of each.

    One block an SM for the projections too: at n = 2^20, 26 rows, s = 5,
    cold, the plan on twice the SMs (264 blocks) was slower in all eight
    pairs timed in turn (``block_gs_project_gram`` 0.0726-0.0727 ms f32
    against 0.0679-0.0701, bf16 0.0550 against 0.0511-0.0514;
    ``block_gs_project`` 0.0676-0.0682 against 0.0657, bf16 0.0497
    against 0.0485-0.0486; PERF.md section 6): at s = 5 the kernels hold
    158-250 registers a thread, so a second block of 256 threads is not
    co-resident on an SM and runs as a second wave."""
    vec, pieces, tail = _pieces(n, elem_size, aligned)
    items = max(pieces, tail)
    grid = max(1, min(sms, -(-items // BLOCK_GS_MIN_ITEMS)))
    pb = -(-pieces // grid)
    tb = -(-tail // grid)
    warps = GS_WARPS
    set_rows = min(rows, BLOCK_GS_ROW_GROUP * warps)
    groups = -(-set_rows // BLOCK_GS_ROW_GROUP)
    return {"route": "vec" if pieces else "scalar", "grid": grid,
            "pieces": pieces, "tail": tail, "vec": vec, "pb": pb, "tb": tb,
            "groups": groups, "shares": warps // groups,
            "threads": 32 * warps}


def batched_unroll(rows: int, elem_size: int) -> tuple:
    """(R, U) of a lane with ``rows`` valid basis rows: the bucket of R
    rows (the smallest of BATCHED_BUCKETS that holds them, else the
    largest, looped) and the U 16-byte pieces a thread takes at once, so
    that U min(R, BATCHED_SLOTS) <= BATCHED_SLOTS loads of V and
    U x (16 / elem_size) <= 32 columns of w are in flight
    (csrc/batched_cgs2.cu's bc_unroll)."""
    r = next((b for b in BATCHED_BUCKETS if b >= rows), BATCHED_BUCKETS[-1])
    vec = 16 // elem_size
    if r >= BATCHED_SLOTS:
        return r, 1
    return r, min(BATCHED_SLOTS // r, 32 // vec)


def _split_blocks(js, cap, budget: int) -> list:
    """The blocks of ``batched_cgs2_split``: shares clamp(c (j + 1), 1,
    cap) summing to min(budget, sum of caps), rounded down, the rest to
    the largest remainders."""
    active = [lane for lane, j in enumerate(js) if j >= 0]
    total = min(budget, sum(cap[lane] for lane in active))

    def shares(c):
        return [min(cap[lane], max(1.0, c * (js[lane] + 1)))
                for lane in active]
    lo, hi = 0.0, float(max(cap))
    for _ in range(60):                    # sum of shares(c) is monotone
        mid = (lo + hi) / 2
        if sum(shares(mid)) < total:
            lo = mid
        else:
            hi = mid
    x = dict(zip(active, shares(hi)))
    blocks = [0] * len(js)
    for lane in active:
        blocks[lane] = min(cap[lane], max(1, int(x[lane])))
    spare = total - sum(blocks)
    order = sorted((lane for lane in active if blocks[lane] < cap[lane]),
                   key=lambda lane: (blocks[lane] - x[lane], lane))
    for lane in order[:max(0, spare)]:
        blocks[lane] += 1
    return blocks


def batched_cgs2_split(js, n: int, elem_size: int, aligned: bool,
                       budget: int) -> dict:
    """How ``batched_cgs2`` spreads its cooperative grid over the lanes.

    js: each lane's step (rows 0..j valid; -1: no work); ``budget``: the
    co-resident blocks (the cooperative launch's limit).  A lane with
    j = -1 gets no block.  Every active lane gets at least one, at most
    what gives each of its threads one round of U pieces (``cap``), and
    between those bounds blocks in proportion to its rows j + 1: shares
    x_l = clamp(c (j_l + 1), 1, cap_l) with c set so they sum to the
    budget (or to the caps' sum, if smaller), rounded down, the blocks
    left given to the largest remainders.  Raises where the active lanes
    outnumber the budget.

    Returns ``blocks`` (per lane), ``first`` (k + 1 prefix sums: lane l
    owns blocks first[l] .. first[l + 1] - 1), ``grid`` (first[k]; with
    no active lane, min(budget, k) blocks that only copy w), ``cap``,
    and the column split: ``vec`` columns a 16-byte piece, ``pieces``
    (0 where not ``aligned``: the scalar route) and the scalar ``tail``;
    ``route`` "vec" or "scalar"."""
    js = [int(j) for j in js]
    k = len(js)
    vec = 16 // elem_size
    pieces = n // vec if aligned else 0
    tail = n - pieces * vec
    t = BATCHED_THREADS
    active = [lane for lane, j in enumerate(js) if j >= 0]
    if len(active) > budget:
        raise ValueError(f"batched_cgs2: {len(active)} active lanes exceed "
                         f"the {budget} co-resident blocks of one "
                         f"cooperative launch")
    cap = [0] * k
    for lane in active:
        u = batched_unroll(js[lane] + 1, elem_size)[1]
        cap[lane] = max(1, -(-pieces // (t * u)), -(-tail // t))
    blocks = _split_blocks(js, cap, budget) if active else [0] * k
    first = [0]
    for b in blocks:
        first.append(first[-1] + b)
    grid = first[-1] if active else max(1, min(budget, k))
    return {"blocks": blocks, "first": first, "grid": grid, "cap": cap,
            "threads": t, "vec": vec, "pieces": pieces, "tail": tail,
            "route": "vec" if pieces else "scalar"}


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


def _up(a: int, b: int) -> int:
    return -(-a // b) * b


def ssd_plan(batch: int, heads: int, s: int, p: int, n: int, q: int,
             sms: int = H100_SMS) -> dict:
    """Launch plan of the SSD scan (csrc/ssd.cu) for x (batch * heads, s, p),
    b and c (batch, s, n), chunk q dividing s, on ``sms`` SMs.

    Launch 1 (``ssd_state_kernel``): a block per (row, chunk).  Launch 2
    (``ssd_scan_kernel``): a block per (pair of t tiles, head group) of each
    chunk and batch row; a pair is tiles i and nt - 1 - i of the chunk's
    ``tiles`` (the middle tile alone when nt is odd), so every pair reaches
    the same u rows.  ``head_group`` heads share a block's G: as many heads
    as leave SSD_BLOCKS_PER_SM blocks an SM, one where G's ``window`` does
    not span the chunk.  With three chunks or more ``ssd_pass_kernel``
    runs between the two (``launches`` 3).  Each grid is one axis
    (``grid_states``, ``grid_pass``, ``grid_scan``: blocks), at most
    MAX_GRID.  The scratch's layout, which the wrapper allocates and the
    kernels take: N padded to SSD_N, ``pc`` (P padded to the kernels' 64
    or 128 columns), ``qp`` (Q padded to SSD_TILE), and its bytes."""
    nc = s // q
    nt = -(-q // SSD_TILE)
    pairs = -(-nt // 2)
    pc, qp = 64 if p <= 64 else 128, _up(q, SSD_TILE)
    if q > SSD_WINDOW:
        hg = 1
    else:
        target = max(1, SSD_BLOCKS_PER_SM * sms // (batch * nc * pairs))
        hg = -(-heads // min(target, heads))
    groups = -(-heads // hg)
    bh = batch * heads
    scratch = {"cum": 8 * bh * nc * qp, "dt": 4 * bh * nc * qp,
               "totals": 4 * bh * nc,
               "states": 4 * bh * (nc - 1) * SSD_N * pc}
    return {"chunks": nc, "tiles": nt, "pairs": pairs, "window": SSD_WINDOW,
            "windows": -(-q // SSD_WINDOW), "head_group": hg,
            "groups": groups,
            "pc": pc, "qp": qp,
            "grid_states": bh * nc, "grid_pass": bh * pc // 16,
            "grid_scan": groups * pairs * nc * batch,
            "scratch": scratch, "scratch_bytes": sum(scratch.values()),
            "launches": 2 if nc <= 2 else 3}


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
