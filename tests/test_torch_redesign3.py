"""The redesigned sweep and GEMV (``banded_trisweep``, ``block_matvec``), on
the CPU.

The kernels run only on the card (``tests/test_torch_cuda.py``); what
surrounds them is pure Python and is held here:

- the sweep's route rule (``tuning.trisweep_plan``): offsets with no far
  band take the device-wide scan, others the chain of chunks, whose length
  keeps every far term at the same position of the previous chunk or two
  chunks back; the ring of solved entries, or z through L2 where it does
  not fit; 16-byte loads only where aligned;
- the GEMV's launch shape (``tuning.gemv_rows_shape``): the warps' row
  ranges cover every row exactly once for m = 1 .. 10,001 and k = 1 .. 8;
- the scan route's tile order and prefix bookkeeping, replayed in torch
  (``_scan_model``: physical groups of 8 rows, tiles of 256 groups, back to
  front for an upper sweep, warp scans, the tiles' aggregates folded in
  order) against ``banded_trisweep_plain``;
- both wrappers on the CPU (their plain versions) against JAX's
  ``banded_trisweep_ref`` and ``block_matvec`` (interpret) at the edge
  shapes: n not a multiple of the tile, chunks of 2 and 1,024 rows, both
  directions, k = 1 and 4, bfloat16 bands; GEMV rows that do and do not
  start on a 16-byte boundary.

Tolerances: float32 rtol = atol = 3e-5 (``tests/test_torch_precond.py``'s:
the sweep scans where the reference substitutes row by row), bfloat16
storage 2e-2.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import matvec as jax_matvec  # noqa: E402
from repro.kernels import trisolve as jax_tri  # noqa: E402
from repro_torch.kernels import matvec, trisolve, tuning  # noqa: E402

F32 = dict(rtol=3e-5, atol=3e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)


# --------------------------------------------------------------------------
# the sweep's route rule
# --------------------------------------------------------------------------
@pytest.mark.parametrize("offsets", [(-1,), (-1, 0), (0, 1), (1,), (0,),
                                     (0, -1)])
def test_offsets_within_one_take_the_scan(offsets):
    n, k = 10_007, 3
    plan = tuning.trisweep_plan(offsets, n, k, 4, True)
    assert plan["route"] == "scan" and plan["chunk"] == 0
    groups = -(-n // tuning.TRISWEEP_SCAN_ROWS)
    assert plan["tiles"] == -(-groups // plan["threads"])
    assert plan["tiles"] * tuning.TRISWEEP_SCAN_TILE >= n
    assert plan["agg"] == 2 * k * plan["tiles"]
    assert not plan["vec"]                    # n % 8 != 0: loads one by one
    assert tuning.trisweep_plan(offsets, 1 << 20, 1, 2, True)["vec"]
    assert not tuning.trisweep_plan(offsets, 1 << 20, 1, 4, False)["vec"]


# (offsets, n, expected chunk)
CHUNKS = [((-2, -1, 0), 200, 2), ((-1024, -1), 1 << 20, 1024),
          ((0, 1, 1024), 1 << 20, 1024), ((-2048, -1), 1 << 22, 1024),
          ((-1000, -1), 10_000, 1000), ((-1500, -1000, -1), 9_000, 500),
          ((-10_000, -100, -1), 100_000, 100), ((-3, -2, -1), 50, 1),
          ((-3072, -2048, -1), 1 << 20, 1024),
          ((-3000, -1000, -1), 30_000, 1000),
          ((-2000, -1000, -1), 20_000, 1000)]


@pytest.mark.parametrize("k,elem", [(1, 4), (4, 4), (4, 2)],
                         ids=["k1-f32", "k4-f32", "k4-bf16"])
@pytest.mark.parametrize("offsets,n,chunk", CHUNKS)
def test_far_bands_take_the_chunk_chain(offsets, n, chunk, k, elem):
    plan = tuning.trisweep_plan(offsets, n, k, elem, True)
    rows = tuning.TRISWEEP_ROWS
    far = [abs(o) for o in offsets if abs(o) >= 2]
    assert plan["route"] == "chunk" and plan["chunk"] == chunk
    assert plan["chunks"] == -(-n // chunk)
    # no far term inside a chunk; one in the previous chunk is at the
    # same position (the same thread solved it), else two chunks back
    assert all(f >= chunk and (f % chunk == 0 or f >= 2 * chunk)
               for f in far)
    assert plan["threads"] % 32 == 0
    assert plan["threads"] <= tuning.TRISWEEP_MAX_THREADS
    assert plan["threads"] * rows >= chunk > (plan["threads"] - 32) * rows
    # far terms other than one chunk back need the ring
    ring = plan["ring"]
    if any(f != chunk for f in far):
        assert ring & (ring - 1) == 0 and ring >= max(far) + chunk
    else:
        assert ring == 0
    assert plan["far_l2"] == 0
    assert plan["vec"] == (chunk % rows == 0 and n % rows == 0)
    assert plan["stages"] == (tuning.TRISWEEP_STAGES if plan["vec"] else 1)
    assert plan["smem"] == tuning.trisweep_smem_bytes(
        plan["threads"], rows, len(offsets), elem, ring, plan["stages"])
    assert plan["smem"] <= tuning.SMEM_BUDGET


def test_a_ring_too_large_reads_far_terms_back_from_z():
    plan = tuning.trisweep_plan((-60_000, -1024, -1), 1 << 20, 1, 4, True)
    assert plan["route"] == "chunk_l2" and plan["ring"] == 0
    assert plan["far_l2"] == 1
    assert plan["vec"] and plan["smem"] <= tuning.SMEM_BUDGET
    # fewer stages where eight do not fit beside the ring
    plan = tuning.trisweep_plan((-10_000, -100, -1), 1 << 20, 1, 4, True)
    assert plan["ring"] == 16_384 and plan["stages"] == 8
    wide = tuning.trisweep_plan(tuple(-1024 * m for m in range(1, 13))
                                + (-1,), 1 << 20, 1, 4, True)
    assert (wide["route"], wide["chunk"], wide["ring"]) == ("chunk", 1024,
                                                            16_384)
    assert wide["stages"] == 2 and wide["smem"] <= tuning.SMEM_BUDGET
    # misaligned operands: loads one chunk at a time, one stage
    plan = tuning.trisweep_plan((-1024, -1), 1 << 20, 1, 4, False)
    assert plan["route"] == "chunk" and not plan["vec"]
    assert plan["stages"] == 1


def test_sweep_plan_reads_the_operands_alignment():
    n = 1 << 12
    bands = torch.zeros(2, n)
    vf = torch.zeros(2, n)
    assert trisolve.sweep_plan(bands, vf, torch.zeros(2, n), (-64, -1))["vec"]
    odd = torch.zeros(2 * n + 1)[1:].view(2, n)        # v 4 bytes off
    assert not trisolve.sweep_plan(bands, odd, torch.zeros(2, n),
                                   (-64, -1))["vec"]
    # bf16 bands with a row stride of 2 (n + 1) bytes
    b16 = torch.zeros(2, n + 1, dtype=torch.bfloat16)
    v1 = torch.zeros(1, n + 1)
    assert not trisolve.sweep_plan(b16, v1, torch.zeros(1, n + 1),
                                   (-1, 0))["vec"]


# --------------------------------------------------------------------------
# the GEMV's launch shape
# --------------------------------------------------------------------------
@pytest.mark.parametrize("sms", [tuning.H100_SMS, 1])
@pytest.mark.parametrize("elem_size", [4, 2], ids=["f32", "bf16"])
def test_gemv_rows_cover_every_row_once(elem_size, sms):
    for k in range(1, 9):
        rows = {}
        for m in range(1, 10_002):
            s = tuning.gemv_rows_shape(m, m + 3, k, elem_size, sms)
            rows[s["rows"]] = True
            w = s["blocks"] * s["threads"] // 32
            assert 1 <= s["blocks"] <= 8 * sms
            assert s["route"] == ("rows" if s["rows"] > 1 else "row")
            # warp i takes [i m // w, (i + 1) m // w), a partition of
            # [0, m) into ranges of m // w or m // w + 1 rows; never a
            # whole block without a row
            assert w - m < s["threads"] // 32
            lo = [i * m // w for i in (0, w // 2, w - 1)]
            hi = [(i + 1) * m // w for i in (0, w // 2, w - 1)]
            assert lo[0] == 0 and hi[-1] == m
            assert all(h - l in (m // w, m // w + 1) for l, h in zip(lo, hi))
        # (m + 3) * elem_size % 16 decides the route: both seen
        kk = 2 if k <= 2 else 4 if k <= 4 else 8
        assert set(rows) == {1, tuning.GEMV_SHAPES[(kk, elem_size)][0]}


@pytest.mark.parametrize("m", [1, 7, 97, 1000, 10_000, 10_001])
def test_gemv_row_groups_hit_each_row_once(m):
    for k in (1, 3, 8):
        for rows in tuning.GEMV_ROWS_CHOICES:
            s = tuning.gemv_rows_shape(m, 10_000, k, 4, tuning.H100_SMS,
                                       rows=rows)
            hits = np.zeros(m, np.int64)
            for groups in tuning.gemv_rows_of(s, m):
                for r0, nr in groups:
                    assert 1 <= nr <= rows
                    hits[r0:r0 + nr] += 1
            assert (hits == 1).all()
    for k, elem in ((1, 4), (1, 2), (4, 4), (4, 2), (8, 4)):
        s = tuning.gemv_rows_shape(10_000, 10_000, k, elem, tuning.H100_SMS)
        r, bps, u, cs = tuning.GEMV_SHAPES[(2 if k <= 2 else k, elem)]
        assert (s["rows"], s["blocks"]) == (r, bps * tuning.H100_SMS)
        assert (s["unroll"], s["evict_first"]) == (
            (u, cs) if k in (1, 4) and r > 1 else (2, True))


def test_gemv_rows_shape_refuses_rows_the_kernel_lacks():
    with pytest.raises(ValueError):
        tuning.gemv_rows_shape(100, 100, 1, 4, 132, rows=3)


# --------------------------------------------------------------------------
# the scan route's bookkeeping, replayed in torch
# --------------------------------------------------------------------------
def _then(A, B, a, b):
    return a * A, a * B + b


def _scan_model(bands, v, offsets, unit, lower):
    """csrc/trisolve.cu's route "scan", step for step (float32, products
    and sums rounded one by one where the kernel fuses them): physical
    groups of 8 rows, a thread a group, tiles of 256 threads in 8 warps;
    the thread composes its rows, a warp scans, the warps' totals in order
    make the tile's aggregate; the aggregates of a right-hand side's
    earlier tiles, 256 at a time in warps of 32, give the carry."""
    rows, threads, warps = 8, 256, 8
    reverse = not lower
    k, n = v.shape
    near = next((d for d, o in enumerate(offsets) if o == (1 if reverse
                                                          else -1)), None)
    diag = offsets.index(0) if (0 in offsets and not unit) else None
    ngroups = -(-n // rows)
    tiles = -(-ngroups // threads)
    lg = torch.arange(tiles * threads)
    pg = torch.where(lg < ngroups, (ngroups - 1 - lg) if reverse else lg,
                     -1)
    i = torch.arange(rows)
    j = (rows - 1 - i) if reverse else i
    row = pg[:, None] * rows + j[None, :]                  # (groups, 8)
    ok = (pg[:, None] >= 0) & (row < n)
    r = row.clamp(0, n - 1)
    edge = (r == n - 1) if reverse else (r == 0)
    nn = bands[near][r] if near is not None else torch.zeros_like(r, dtype=v.dtype)
    a = torch.where(edge, torch.zeros(()), -nn)
    b = v[:, r]                                            # (k, groups, 8)
    if diag is not None:
        a = a / bands[diag][r]
        b = b / bands[diag][r]
    a = torch.where(ok, a, torch.ones(())).expand_as(b)
    b = torch.where(ok, b, torch.zeros(()))
    ta, tb = torch.ones_like(b[..., 0]), torch.zeros_like(b[..., 0])
    for q in range(rows):                                  # thread compose
        ta, tb = _then(ta, tb, a[..., q], b[..., q])
    ta = ta.reshape(k, tiles, warps, 32)
    tb = tb.reshape(k, tiles, warps, 32)

    def warp_scan(x, y):      # inclusive, lane o adds lane o - d's prefix
        d = 1
        while d < 32:
            ux = torch.cat([torch.ones_like(x[..., :d]), x[..., :-d]], -1)
            uy = torch.cat([torch.zeros_like(y[..., :d]), y[..., :-d]], -1)
            lane = torch.arange(32) >= d
            x, y = (torch.where(lane, x * ux, x),
                    torch.where(lane, x * uy + y, y))
            d *= 2
        return x, y
    sa, sb = warp_scan(ta, tb)
    ea = torch.cat([torch.ones_like(sa[..., :1]), sa[..., :-1]], -1)
    eb = torch.cat([torch.zeros_like(sb[..., :1]), sb[..., :-1]], -1)
    wa, wb = sa[..., 31], sb[..., 31]                      # (k, tiles, 8)
    pa, pb = torch.ones_like(wa), torch.zeros_like(wb)
    A, B = torch.ones_like(wa[..., 0]), torch.zeros_like(wb[..., 0])
    for w in range(warps):
        pa[..., w], pb[..., w] = A, B
        A, B = _then(A, B, wa[..., w], wb[..., w])
    agg_a, agg_b = A, B                                    # (k, tiles)
    carry = torch.zeros(k, tiles)
    for u in range(tiles):                                 # scan_prefix
        c = torch.zeros(k)
        for base in range(0, u, threads):
            idx = torch.arange(base, base + threads)
            xa = torch.where(idx < u, agg_a[:, idx.clamp(max=tiles - 1)],
                             torch.ones(()))
            xb = torch.where(idx < u, agg_b[:, idx.clamp(max=tiles - 1)],
                             torch.zeros(()))
            xa, xb = warp_scan(xa.reshape(k, warps, 32),
                               xb.reshape(k, warps, 32))
            for w in range(warps):
                c = xa[:, w, 31] * c + xb[:, w, 31]
        carry[:, u] = c
    zt = ea * (pa[..., None] * carry[..., None, None] + pb[..., None]) + eb
    zt = zt.reshape(k, -1)
    z = torch.zeros(k, n)
    for q in range(rows):
        zt = a[..., q] * zt + b[..., q]
        sel = ok[:, q]
        z[:, row[sel, q]] = zt[:, sel]
    return z


@pytest.mark.parametrize("n", [1, 9, 2048, 2049, 2048 * 3 + 5, 2048 * 256 + 8])
@pytest.mark.parametrize("offsets,unit,lower", [
    ((-1,), True, True), ((-1, 0), False, True), ((0, 1), False, False),
    ((1,), True, False)])
def test_scan_model_matches_the_plain_sweep(n, offsets, unit, lower):
    rng = np.random.default_rng(n)
    bands = rng.uniform(0.1, 0.5, (len(offsets), n)).astype(np.float32)
    if 0 in offsets:
        bands[offsets.index(0)] += 2.0
    bands = trisolve._mask_oob(torch.from_numpy(bands), offsets)
    v = torch.from_numpy(rng.standard_normal((2, n)).astype(np.float32))
    got = _scan_model(bands, v, offsets, unit, lower)
    want = trisolve.banded_trisweep_plain(bands, v, offsets, unit_diag=unit,
                                          lower=lower)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32)


# --------------------------------------------------------------------------
# the wrappers on the CPU against JAX
# --------------------------------------------------------------------------
# (offsets, n): the scan at n = 2 tiles + 5 rows; chunks of 2 and 1,024
SWEEPS = [((-1,), 2048 * 2 + 5), ((-2, -1), 515), ((-1024, -1), 1024 * 3 + 2)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("case", range(len(SWEEPS)))
def test_sweeps_match_jax_at_the_edge_shapes(case, k, dtype):
    lo, n = SWEEPS[case]
    rng = np.random.default_rng(case)
    for offs, unit, lower in ((lo, True, True), (lo + (0,), False, True),
                              ((0,) + tuple(-o for o in lo), False, False)):
        bands = rng.uniform(0.1, 0.5, (len(offs), n)).astype(np.float32)
        if 0 in offs:
            bands[offs.index(0)] += 2.0
        bands = np.array(jax_tri._mask_oob(jnp.asarray(bands), offs))
        bands = torch.from_numpy(bands).to(dtype)
        v = rng.standard_normal((k, n)).astype(np.float32)
        sweep = functools.partial(
            jax_tri.banded_trisweep_ref,
            jnp.asarray(bands.float().numpy(), jnp.float32), offsets=offs,
            unit_diag=unit, lower=lower)
        want = np.asarray(jax.vmap(sweep)(jnp.asarray(v)))
        vin = torch.from_numpy(v[0] if k == 1 else v)
        got = trisolve.banded_trisweep(bands, vin, offs, unit_diag=unit,
                                       lower=lower)
        assert tuple(got.shape) == vin.shape
        np.testing.assert_allclose(got.float().numpy().reshape(k, n), want,
                                   **(F32 if dtype == torch.float32
                                      else BF16))


@pytest.mark.parametrize("m,n,k", [(97, 97, 1), (300, 1003, 3),
                                   (64, 256, 4), (33, 130, 8)])
@pytest.mark.parametrize("tdt,jdt,tol", [
    (torch.float32, jnp.float32, F32), (torch.bfloat16, jnp.bfloat16, BF16)],
    ids=["f32", "bf16"])
def test_block_matvec_matches_jax_at_the_edge_shapes(m, n, k, tdt, jdt, tol):
    rng = np.random.default_rng(m + n + k)
    a = (rng.standard_normal((m, n)) / np.sqrt(n)).astype(np.float32)
    x = rng.standard_normal((n, k)).astype(np.float32)
    at = torch.from_numpy(a).to(tdt)
    want = jax_matvec.block_matvec(jnp.asarray(a, jdt), jnp.asarray(x),
                                   interpret=True)
    got = matvec.block_matvec(at, torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               **tol)
