"""The banded matrix powers and the fused Chebyshev apply, on the CPU.

The kernels run only on the card (``tests/test_torch_cuda.py``); what
surrounds them is pure Python and is held here:

- their plan (``tuning.banded_plan``): the kernels' loops (blocks of
  consecutive segments, a group of kThreads threads a segment, the bands
  in order, each operand from the tile or from L2, each band entry from
  the resident stack or from global memory) replayed, covering every row
  and every band entry once; the segments are the ELL powers' (one row
  partition, ``tuning.powers_segments``); the tile and the resident rows
  fit SMEM_BUDGET; the far-band and no-tile routes where the halo, or the
  block's rows, do not fit;
- numpy replays of both kernels' orders (fmaf chains in float64 rounded
  once, warp shuffles, the warps and the segments in order; the
  Chebyshev rows in registers or from global memory, z_0 as v / theta):
  the new kernels' order gives the first design's bits (a grid of one
  block a segment), and both hold to the plain versions;
- the plain versions (the wrappers on the CPU) against the JAX kernels at
  ``interpret=True`` at the edge shapes: 1 and 9 bands, n not a multiple
  of 32, Chebyshev steps 0, 3 and 31 (the shifted powers against JAX's
  ``matrix_powers_ref`` over its banded kernel: the shifted Pallas branch
  fails on this jax, ``pl.load`` is gone).  Tolerances relative to the
  largest entry: float32 1e-5, bfloat16 2e-2.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import operators as jax_ops  # noqa: E402
from repro.core import preconditioners as JP  # noqa: E402
from repro.kernels import matrix_powers as jax_mp  # noqa: E402
from repro.kernels import spmv as jax_spmv  # noqa: E402
from repro_torch.core import stencils  # noqa: E402
from repro_torch.kernels import tuning  # noqa: E402
from repro_torch.kernels import matrix_powers as mp  # noqa: E402

BAR = {"f32": 1e-5, "bf16": 2e-2}
DTYPES = [("f32", torch.float32, jnp.float32),
          ("bf16", torch.bfloat16, jnp.bfloat16)]
WARP = 32
SEG_THREADS = 32 * tuning.GS_WARPS     # csrc/common.cuh's kThreads
F32 = np.float32
STENCIL5 = (-1024, -1, 0, 1, 1024)     # the 1024^2 five-point stencil
# a 160^3 seven-point stencil: the z neighbours' halo does not fit
STENCIL7 = (-25_600, -160, -1, 0, 1, 160, 25_600)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _fma(a, b, c):
    """fmaf: a * b + c rounded once (the float32 product is exact in
    float64)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(F32)


def _warp_sum(x):
    """common.cuh's warp_sum over axis 0 (32 lanes): the xor butterfly."""
    x = np.array(x, F32)
    lanes = np.arange(WARP)
    for o in (16, 8, 4, 2, 1):
        x = (x + x[lanes ^ o]).astype(F32)
    return x[0]


def _seq_sum(x):
    s = np.zeros(np.asarray(x).shape[1:], F32)
    for t in np.asarray(x, F32):
        s = (s + t).astype(F32)
    return s


def _seg_range(n, segs, seg):
    """csrc/matrix_powers.cu's seg_range (row_range's rule)."""
    per = (-(-n // segs) + 31) // 32 * 32
    r0 = min(n, seg * per)
    return r0, min(n, r0 + per)


# --------------------------------------------------------------------------
# the plan
# --------------------------------------------------------------------------
def _block_tile(plan, n, blk):
    """banded_block: the block's rows and its tile, ends on multiples of
    4 (16-byte boundaries of float rows)."""
    k, segs = plan["seg_per_block"], plan["segments"]
    seg0 = blk * k
    seg_end = min(segs, seg0 + k)
    rows0 = _seg_range(n, segs, seg0)[0]
    rows1 = _seg_range(n, segs, seg_end - 1)[1]
    th = plan["tile_halo"]
    if th < 0:
        return seg0, seg_end, rows0, rows1, 0, 0
    t0 = max(0, rows0 - th) & ~3
    t1 = min(n, (rows1 + th + 3) & ~3)
    return seg0, seg_end, rows0, rows1, t0, t1


def _replay_plan(plan, n, offsets):
    """The kernels' loops: thread t of a segment's group takes rows r0 + t,
    + kThreads, ...; each row reads every in-range band, its entry from the
    resident stack (row - r0 < res_seg) or global memory, its operand from
    the tile (|offset| <= tile_halo, at index c - t0 inside the tile) or
    L2.  Returns each segment's threads' rows and the count of reads of
    every (band, row) entry."""
    offs = np.asarray(offsets)
    near = np.abs(offs) <= plan["tile_halo"]
    entry_reads = np.zeros((len(offs), n), np.int64)
    rows_of = {}
    for blk in range(plan["blocks"]):
        seg0, seg_end, rows0, rows1, t0, t1 = _block_tile(plan, n, blk)
        assert t1 - t0 <= plan["tile_rows"]
        assert plan["threads"] == SEG_THREADS * plan["seg_per_block"]
        for ls in range(seg_end - seg0):       # group ls: segment seg0 + ls
            r0, r1 = _seg_range(n, plan["segments"], seg0 + ls)
            rows_of[seg0 + ls] = [list(range(r0 + t, r1, SEG_THREADS))
                                  for t in range(SEG_THREADS)]
            i = np.arange(r0, r1)
            for d, off in enumerate(offs):
                c = i + off
                ok = (c >= 0) & (c < n)
                entry_reads[d, i[ok]] += 1
                if near[d] and ok.any():
                    # a near operand lies inside the tile
                    assert (c[ok] >= t0).all() and (c[ok] < t1).all()
            if plan["tile_halo"] >= 0 and r1 > r0:
                assert t0 <= r0 and r1 <= t1      # the shift term, u_{p-1}
    return rows_of, entry_reads


def _check_plan(plan, n, offsets, elem):
    segs = plan["segments"]
    assert segs == tuning.powers_segments(n, plan["sms"])
    assert plan["blocks"] == -(-segs // plan["seg_per_block"]) <= plan["sms"]
    assert plan["seg_per_block"] <= tuning.ELL_POWERS_GROUPS
    rows_of, reads = _replay_plan(plan, n, offsets)
    hits = np.zeros(n, np.int64)
    for seg, mine in rows_of.items():
        r0, r1 = _seg_range(n, segs, seg)
        for t, rows in enumerate(mine):
            # the first design's thread t of block `seg`
            assert rows == list(range(r0 + t, r1, SEG_THREADS))
            np.add.at(hits, rows, 1)
    assert (hits == 1).all()
    i = np.arange(n)
    for d, off in enumerate(offsets):
        in_range = (i + off >= 0) & (i + off < n)
        assert (reads[d] == in_range).all()
    # shared memory
    nb = len(offsets)
    assert plan["res_seg"] % 32 == 0 and plan["res_seg"] <= plan["per"]
    assert plan["resident"] == plan["seg_per_block"] * plan["res_seg"]
    assert plan["smem"] == tuning.banded_smem_bytes(
        plan["seg_per_block"], segs, plan["res_seg"], nb, elem,
        plan["tile_rows"])
    assert plan["smem"] <= tuning.SMEM_BUDGET
    more = tuning.banded_smem_bytes(plan["seg_per_block"], segs,
                                    plan["res_seg"] + 32, nb, elem,
                                    plan["tile_rows"])
    assert plan["res_seg"] == plan["per"] or more > tuning.SMEM_BUDGET
    # the route: the whole halo in the tile where it fits, else the
    # nearest bands that fit, else no tile
    halo = max(abs(o) for o in offsets)
    rows = plan["seg_per_block"] * plan["per"]

    def tile_fits(h):
        return tuning.banded_smem_bytes(
            plan["seg_per_block"], segs, 0, nb, elem,
            rows + 2 * h + tuning.BANDED_TILE_SLACK) <= tuning.SMEM_BUDGET
    if tile_fits(halo):
        assert plan["route"] == "tile" and plan["tile_halo"] == halo
    elif tile_fits(0):
        assert plan["route"] == "far"
        assert plan["tile_halo"] == max(
            [abs(o) for o in offsets if tile_fits(abs(o))], default=0)
    else:
        assert plan["route"] == "l2" and plan["tile_halo"] == -1
    if plan["tile_halo"] >= 0:
        assert plan["tile_rows"] == (rows + 2 * plan["tile_halo"]
                                     + tuning.BANDED_TILE_SLACK)
    else:
        assert plan["tile_rows"] == 0
    assert plan["far"] == sum(abs(o) > plan["tile_halo"] for o in offsets)
    assert plan["reg_rows"] == -(-plan["per"] // SEG_THREADS)


@pytest.mark.parametrize("sms", [tuning.H100_SMS, 7, 1])
@pytest.mark.parametrize("elem", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("n,offsets", [
    (1, (0,)), (1000, (-1, 0, 1)), (1024, (-32, -1, 0, 1, 32)),
    (4099, tuple(range(-4, 5))), (7700, (-3000, -77, 0, 77, 3000)),
    (65_541, (-256, -1, 0, 1, 256))])
def test_banded_plan_covers_every_row_and_band_once(n, offsets, elem, sms):
    plan = dict(tuning.banded_plan(n, offsets, elem, sms), sms=sms)
    _check_plan(plan, n, offsets, elem)


@pytest.mark.parametrize("n", [1 << 20, 32 * 32, 1000, (1 << 20) + 3])
def test_banded_segments_are_the_ell_powers(n):
    """One row partition for both formats (so one set of bits), the first
    design's grid: min(4 x 132, n / 256) segments."""
    for elem in (4, 2):
        plan = tuning.banded_plan(n, (-1, 0, 1), elem, tuning.H100_SMS)
        ell = tuning.ell_powers_plan(n, 5, elem, tuning.H100_SMS)
        assert (plan["segments"], plan["per"], plan["seg_per_block"],
                plan["blocks"], plan["threads"]) == \
            (ell["segments"], ell["per"], ell["seg_per_block"],
             ell["blocks"], ell["threads"])
        assert plan["segments"] == min(4 * tuning.H100_SMS,
                                       -(-n // SEG_THREADS))


@pytest.mark.parametrize("elem,smem", [(4, 204_016), (2, 123_376)])
def test_banded_plan_at_the_1024_squared_stencil(elem, smem):
    """528 segments of 2,016 rows, four a block on 132 blocks of 1,024
    threads; the grid's 528 partials (2 KB), the tile of 8,064 rows and
    1,024 each side (40 KB) and the whole band stack on chip (161 KB f32,
    81 KB bf16); 8 rows a thread, all in the Chebyshev kernel's
    registers."""
    n = 1 << 20
    plan = tuning.banded_plan(n, STENCIL5, elem, tuning.H100_SMS)
    assert (plan["segments"], plan["per"], plan["seg_per_block"],
            plan["blocks"], plan["threads"]) == (528, 2016, 4, 132, 1024)
    assert plan["route"] == "tile" and plan["tile_halo"] == 1024
    assert plan["tile_rows"] == 4 * 2016 + 2 * 1024 + 8
    assert plan["res_seg"] == plan["per"] and plan["smem"] == smem
    assert plan["reg_rows"] == tuning.KEEP_ROWS == 8
    _check_plan(dict(plan, sms=tuning.H100_SMS), n, STENCIL5, elem)


def test_banded_plan_keeps_part_of_a_wide_stack():
    """Nine bands at 1024^2 in f32: 290 KB of stack a block, so the first
    1,152 rows of each segment stay (whole chunks of 32); bf16 fits."""
    offs = tuple(range(-4, 5))
    f32 = tuning.banded_plan(1 << 20, offs, 4, tuning.H100_SMS)
    bf16 = tuning.banded_plan(1 << 20, offs, 2, tuning.H100_SMS)
    assert f32["route"] == bf16["route"] == "tile"
    assert 0 < f32["res_seg"] < f32["per"] and f32["res_seg"] == 1152
    assert bf16["res_seg"] == bf16["per"]


@pytest.mark.parametrize("elem", [4, 2])
def test_banded_plan_gathers_far_bands_where_the_halo_does_not_fit(elem):
    """The 160^3 seven-point stencil: 31,104 rows a block and a 25,600-row
    halo each side do not fit, the 160-row one does, so the z neighbours
    are gathered from L2 (route "far"); at 8M rows not even the block's
    rows fit (route "l2", no tile); a 1-D halo past any tile at n = 2^20
    keeps the near bands in the tile."""
    n = 160 ** 3
    plan = tuning.banded_plan(n, STENCIL7, elem, tuning.H100_SMS)
    assert plan["route"] == "far" and plan["tile_halo"] == 160
    assert plan["far"] == 2
    l2 = tuning.banded_plan(8_000_000, (-1, 0, 1), elem, tuning.H100_SMS)
    assert l2["route"] == "l2" and l2["tile_rows"] == 0 and l2["far"] == 3
    assert l2["res_seg"] > 0
    far = tuning.banded_plan(1 << 20, (-300_000, -1, 0, 1, 300_000), elem,
                             tuning.H100_SMS)
    assert (far["route"], far["tile_halo"], far["far"]) == ("far", 1, 2)
    # the replay, at a size the CPU walks quickly: far bands at n = 65,536
    small = tuning.banded_plan(65_536, (-30_000, -1, 0, 1, 30_000), elem,
                               tuning.H100_SMS)
    assert small["route"] == "far" and small["tile_halo"] == 1
    _check_plan(dict(small, sms=tuning.H100_SMS), 65_536,
                (-30_000, -1, 0, 1, 30_000), elem)


# --------------------------------------------------------------------------
# numpy replays of the summation orders
# --------------------------------------------------------------------------
def _partials(sq_of_thread):
    """A segment's partial: each warp's shuffles, then the warps in order
    from 0 (block_sum's order)."""
    s = F32(0)
    for w in range(tuning.GS_WARPS):
        s = F32(s + _warp_sum(sq_of_thread[w * WARP:(w + 1) * WARP]))
    return s


def _grid_norm(part):
    """grid_norm / ell_norm: lane l sums partials l, l + 32, ... from 0,
    then the shuffles, then sqrtf."""
    lanes = np.zeros(WARP, F32)
    for lane in range(min(WARP, len(part))):
        lanes[lane] = _seq_sum(part[lane::WARP])
    return np.sqrt(_warp_sum(lanes)).astype(F32)


def _banded_rows(bands, offsets, operand, rows):
    """Each row's fmaf chain in band order over operand[c], out-of-range
    neighbours skipped."""
    n = bands.shape[1]
    acc = np.zeros(len(rows), F32)
    for d, off in enumerate(offsets):
        c = rows + off
        ok = (c >= 0) & (c < n)
        acc = np.where(ok, _fma(bands[d, rows], operand[np.clip(c, 0, n - 1)],
                                acc), acc)
    return acc


def _thread_sums(acc, mine):
    """A segment's threads' fmaf chains of acc[r]^2 over their rows in
    order (``mine``: thread t's rows), all threads at once."""
    width = max(len(r) for r in mine)
    idx = np.array([list(r) + [-1] * (width - len(r)) for r in mine])
    sq = np.zeros(len(mine), F32)
    for j in range(width):
        live = idx[:, j] >= 0
        a = acc[np.where(live, idx[:, j], 0)]
        sq = np.where(live, _fma(a, a, sq), sq)
    return sq


def _powers_replay(bands, offsets, x, s, partition, tile, shifts=None):
    """The s powers in a kernel's order.  ``partition``: each segment's
    threads' rows in order.  ``tile``: the new kernel (each element of the
    previous raw row divided once into the tile, u_{p-1} written from it)
    or the first design (each operand divided where it is read: the same
    correctly rounded quotient, so the same operand)."""
    n = bands.shape[1]
    rows = np.arange(n)
    eps = F32(np.finfo(F32).tiny ** 0.5)
    cur, denom = np.asarray(x, F32), F32(1)
    us, sigmas = [], []
    for p in range(s):
        op = (cur / denom).astype(F32)
        if p:
            us.append(op if tile else (cur / denom).astype(F32))
        acc = _banded_rows(bands, offsets, op, rows)
        if shifts is not None:      # __fsub_rn(acc, __fmul_rn(shift, u))
            acc = (acc - (F32(shifts[p]) * op).astype(F32)).astype(F32)
        part = [_partials(_thread_sums(acc, mine)) for mine in partition]
        sg = _grid_norm(np.array(part, F32))
        denom = max(sg, eps)
        sigmas.append(sg)
        cur = acc
    us.append((cur / denom).astype(F32))   # the last pass, or finish_power
    return np.stack(us), np.array(sigmas, F32)


def _partitions(n, sms):
    plan = tuning.banded_plan(n, (0,), 4, sms)
    rows_of, _ = _replay_plan(plan, n, (0,))
    new = [rows_of[seg] for seg in range(plan["segments"])]
    old = []
    for blk in range(plan["segments"]):     # the first design's grid
        r0, r1 = _seg_range(n, plan["segments"], blk)
        old.append([list(range(r0 + t, r1, SEG_THREADS))
                    for t in range(SEG_THREADS)])
    return new, old


@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("sms", [tuning.H100_SMS, 3])
@pytest.mark.parametrize("nx,ny,s", [(40, 31, 5), (64, 64, 2), (33, 47, 8)])
def test_powers_replay_gives_the_first_designs_bits(nx, ny, s, sms,
                                                    shifted):
    """A stencil: the new kernel's order (its plan's segments, blocks and
    groups; the operand divided once into the tile) gives the first
    design's bits (a block a segment, each operand divided where read),
    and both hold to the plain version."""
    op = stencils.convection_diffusion_2d(nx, ny, beta=(0.3, 0.2),
                                          device="cpu")
    n = op.shape[0]
    bands = op.bands.numpy()
    x = np.random.default_rng(nx + ny + s).standard_normal(n).astype(F32)
    sh = np.linspace(0.5, 7.5, s).astype(F32) if shifted else None
    new, old = _partitions(n, sms)
    got = _powers_replay(bands, op.offsets, x, s, new, True, sh)
    want = _powers_replay(bands, op.offsets, x, s, old, False, sh)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1],
                                                               want[1])
    plain = mp.banded_powers_plain(op.bands, torch.from_numpy(x), op.offsets,
                                   s, shifts=None if sh is None
                                   else torch.from_numpy(sh))
    assert _rel(got[0], plain[0].numpy()) < BAR["f32"] * 10
    assert _rel(got[1], plain[1].numpy()) < BAR["f32"]


def _cheb_replay(bands, offsets, v, theta, c, rhos, plan, new):
    """The Chebyshev recurrence in a kernel's order and roundings
    (csrc's cheb_next, the first design's compiled form).  ``new``: step 0's tile divided from v, no z_0 stored; a
    thread's first KEEP_ROWS rows' v and z_{t-1} in registers (in the
    kernel those of them that read only the tile and the stack: the same
    values), further rows' from global memory (z_0 recomputed as v /
    theta, z_{t-1} from the row about to be overwritten); far bands read
    v / theta at step 0.
    Else the first design: z_0 stored, z_{t-1} and v from global memory."""
    n = bands.shape[1]
    v = np.asarray(v, F32)
    c, theta = F32(c), F32(theta)
    z0 = (v / theta).astype(F32)
    if not rhos:
        return z0
    near = np.abs(np.asarray(offsets)) <= plan["tile_halo"]
    zbuf = np.zeros((2, n), F32)
    if not new:
        zbuf[0] = z0
    rows = np.arange(n)
    seg_of = np.minimum(rows // plan["per"], plan["segments"] - 1)
    j_of = (rows - seg_of * plan["per"]) // SEG_THREADS   # a thread's j-th
    reg = j_of < tuning.KEEP_ROWS
    zo_reg = np.zeros(n, F32)
    out = None
    for t, (rho, rho_old) in enumerate(rhos):
        rho, rho_old = F32(rho), F32(rho_old)
        z = zbuf[t & 1]
        if new:
            tile = z0 if t == 0 else z.copy()
            # far bands: v / theta at step 0, else z_t through L2: the
            # same values as the tile's
            far_val = z0 if t == 0 else z
            acc = np.zeros(n, F32)
            for d, off in enumerate(offsets):
                col = rows + off
                ok = (col >= 0) & (col < n)
                src = tile if near[d] else far_val
                acc = np.where(ok, _fma(bands[d], src[np.clip(col, 0, n - 1)],
                                        acc), acc)
            zi = tile
            zold_glob = (np.zeros(n, F32) if t == 0 else z0 if t == 1
                         else zbuf[(t + 1) & 1])
            zold = np.where(reg, zo_reg, zold_glob)
        else:
            acc = _banded_rows(bands, offsets, z, rows)
            zi = z
            zold = np.zeros(n, F32) if t == 0 else zbuf[(t + 1) & 1]
        # cheb_next: fmaf(rho, fmaf(rho_old, z - z_old, c (v - w)), z)
        inner = _fma(rho_old, (zi - zold).astype(F32),
                     (c * (v - acc).astype(F32)).astype(F32))
        znew = _fma(rho, inner, zi)
        if new:
            zo_reg = np.where(reg, zi, zo_reg)
        if t == len(rhos) - 1:
            out = znew
        else:
            zbuf[(t + 1) & 1] = znew
    return out


@pytest.mark.parametrize("order", [1, 2, 4, 9])
@pytest.mark.parametrize("n,offsets,sms", [
    (40 * 31, (-40, -1, 0, 1, 40), tuning.H100_SMS),
    (65_536, (-30_000, -1, 0, 1, 30_000), tuning.H100_SMS),
    (20_000, (-100, -1, 0, 1, 100), 1)])
def test_cheb_replay_gives_the_first_designs_bits(n, offsets, sms, order):
    """The new Chebyshev order (the tile, registers for the first 8 rows a
    thread and global memory past them, z_0 never stored, far bands from
    v / theta at step 0) gives the first design's bits, and holds to the
    plain version.  At 20,000 rows on one SM a thread owns 20 rows, 12 of
    them past its registers; at 65,536 two bands are far."""
    plan = tuning.banded_plan(n, offsets, 4, sms)
    assert plan["reg_rows"] > tuning.KEEP_ROWS or n != 20_000
    assert plan["far"] == 2 or n != 65_536
    rng = np.random.default_rng(n + order)
    bands = (rng.standard_normal((len(offsets), n)) / 3).astype(F32)
    bands[offsets.index(0)] += 2
    v = rng.standard_normal(n).astype(F32)
    theta, delta = 2.0, 1.5
    rhos = tuple((0.4 + 0.05 * t, 0.0 if t == 0 else 0.4 + 0.05 * (t - 1))
                 for t in range(order - 1))
    got = _cheb_replay(bands, offsets, v, theta, 2.0 / delta, rhos, plan,
                       True)
    want = _cheb_replay(bands, offsets, v, theta, 2.0 / delta, rhos, plan,
                        False)
    assert np.array_equal(got, want)
    plain = mp.banded_cheb_apply_plain(torch.from_numpy(bands),
                                       torch.from_numpy(v), offsets,
                                       theta=theta, delta=delta, rhos=rhos)
    assert _rel(got, plain.numpy()) < BAR["f32"]


# --------------------------------------------------------------------------
# the plain versions against JAX at the edge shapes
# --------------------------------------------------------------------------
def _bands(nbands, n, seed):
    rng = np.random.default_rng(seed)
    half = nbands // 2
    offsets = tuple(range(-half, nbands - half)) if nbands > 1 else (0,)
    if nbands == 9:
        offsets = (-37, -9, -2, -1, 0, 1, 2, 9, 37)
    bands = (rng.standard_normal((nbands, n)) / np.sqrt(nbands)).astype(F32)
    return bands, offsets


@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("s", [2, 5])
@pytest.mark.parametrize("nbands", [1, 9])
@pytest.mark.parametrize("name,tdt,jdt", DTYPES, ids=["f32", "bf16"])
def test_banded_powers_plain_matches_jax(name, tdt, jdt, nbands, s,
                                         shifted):
    n = 1000
    bands, offsets = _bands(nbands, n, seed=nbands * 10 + s)
    x = np.random.default_rng(s).standard_normal(n).astype(F32)
    bj = jnp.asarray(bands).astype(jdt)
    sh = np.linspace(0.5, 2.5, s).astype(F32) if shifted else None
    if shifted:
        eps = float(jnp.finfo(jnp.float32).tiny) ** 0.5
        want = jax_mp.matrix_powers_ref(
            lambda u: jax_spmv.banded_matvec(bj, u, offsets, interpret=True)
            .astype(jnp.float32), jnp.asarray(x), s, eps,
            shifts=jnp.asarray(sh))
    else:
        want = jax_mp.banded_powers(bj, jnp.asarray(x), offsets, s,
                                    interpret=True)
    got = mp.banded_powers(torch.from_numpy(bands).to(tdt),
                           torch.from_numpy(x), offsets, s,
                           shifts=None if sh is None else torch.from_numpy(sh))
    assert got[0].shape == (s, n) and got[0].dtype == torch.float32
    assert _rel(got[0], want[0]) < BAR[name]
    assert _rel(got[1], want[1]) < BAR[name]


@pytest.mark.parametrize("order", [1, 4, 32])
@pytest.mark.parametrize("nbands", [1, 9])
@pytest.mark.parametrize("name,tdt,jdt", DTYPES, ids=["f32", "bf16"])
def test_banded_cheb_apply_plain_matches_jax(name, tdt, jdt, nbands, order):
    """Steps 0, 3 and 31 (orders 1, 4 and 32) on a diagonally dominant
    band stack, n = 1000, its interval from the JAX package's estimate."""
    n = 1000
    bands, offsets = _bands(nbands, n, seed=nbands + order)
    bands[offsets.index(0)] = np.abs(bands).sum(axis=0) + 1.0
    bj = jnp.asarray(bands).astype(jdt)
    pc = JP.chebyshev(jax_ops.BandedOperator(bj, offsets), order=order)
    assert len(pc.rhos) == order - 1
    v = np.random.default_rng(order).standard_normal(n).astype(F32)
    want = jax_mp.banded_cheb_apply(bj, jnp.asarray(v), offsets,
                                    theta=pc.theta, delta=pc.delta,
                                    rhos=pc.rhos, interpret=True)
    got = mp.banded_cheb_apply(torch.from_numpy(bands).to(tdt),
                               torch.from_numpy(v), offsets, theta=pc.theta,
                               delta=pc.delta, rhos=pc.rhos)
    assert got.shape == (n,) and got.dtype == torch.float32
    assert _rel(got, np.asarray(want, np.float32)) < BAR[name]
