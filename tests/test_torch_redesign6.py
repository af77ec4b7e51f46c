"""The ELL matrix powers and the single-reduce payload, on the CPU.

The kernels run only on the card (``tests/test_torch_cuda.py``); what
surrounds them is pure Python and is held here:

- the ELL powers' plan (``tuning.ell_powers_plan``): the kernel's loops
  (blocks of consecutive segments, a group of kThreads threads a segment
  at once, RB rows a thread in flight, the slots in groups of the width
  bucket) replayed, covering every row and slot once; the segments are the
  banded grid's row partition, the resident rows fit SMEM_BUDGET in whole
  chunks of 32;
- the payload's launch (``tuning.gemv_partial_shape(k=2)``): the column
  sweep and the block-a-row route cover every column once, the bucket of
  8 or 16 rows (looped past 16);
- numpy replays of both kernels' fixed summation orders (fmaf chains in
  float64 rounded once, warp shuffles, the warps, segments or blocks in
  order): the ELL replay gives the banded replay's bits and both hold to
  the plain versions, as does the payload's on both routes;
- the plain versions (the wrappers on the CPU) against the JAX kernels at
  ``interpret=True`` at the edge shapes: ELL n not a multiple of 32, width
  1 and 9 (the shifted powers against JAX's ``matrix_powers_ref`` over its
  ELL kernel: the shifted Pallas branch fails on this jax, ``pl.load`` is
  gone); the payload at j = 0 and m1 - 1, n = 1027.  Tolerances relative
  to the largest entry: float32 1e-5, bfloat16 2e-2.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import cgs2 as jax_cgs2  # noqa: E402
from repro.kernels import matrix_powers as jax_mp  # noqa: E402
from repro.kernels import spmv as jax_spmv  # noqa: E402
from repro_torch.core import stencils  # noqa: E402
from repro_torch.kernels import cgs2, tuning  # noqa: E402
from repro_torch.kernels import matrix_powers as mp  # noqa: E402

BAR = {"f32": 1e-5, "bf16": 2e-2}
DTYPES = [("f32", torch.float32, jnp.float32),
          ("bf16", torch.bfloat16, jnp.bfloat16)]
WARP = 32
SEG_THREADS = 32 * tuning.GS_WARPS     # csrc/common.cuh's kThreads
F32 = np.float32


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


def _table(n, width, seed):
    """A random ELL table with ragged rows: padding slots value 0 at
    column 0."""
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal((n, width)).astype(F32)
    cols = rng.integers(0, n, (n, width)).astype(np.int32)
    vals[:, width // 2 + 1:] *= rng.random((n, 1)) < 0.5
    cols[vals == 0] = 0
    return vals, cols


# --------------------------------------------------------------------------
# the ELL powers' plan
# --------------------------------------------------------------------------
def _seg_range(n, segs, seg):
    """csrc/matrix_powers.cu's row_range for block ``seg`` of ``segs``."""
    per = (-(-n // segs) + 31) // 32 * 32
    r0 = min(n, seg * per)
    return r0, min(n, r0 + per)


def _ell_visits(plan, n, width):
    """The kernel's loops: for each segment, thread t's rows in its order
    (a list per thread), each row's slot groups, and whether each row is
    resident."""
    k, groups = plan["seg_per_block"], plan["threads"] // SEG_THREADS
    rb = plan["rows_in_flight"]
    rows_of, resident = {}, np.zeros(n, bool)
    for blk in range(plan["blocks"]):
        for grp in range(groups):
            for ls in range(grp, k, groups):
                seg = blk * k + ls
                if seg >= plan["segments"]:
                    continue
                r0, r1 = _seg_range(n, plan["segments"], seg)
                mine = [[] for _ in range(SEG_THREADS)]
                for k0 in range(r0, r1, rb * SEG_THREADS):
                    for b in range(rb):
                        for t in range(SEG_THREADS):
                            row = k0 + b * SEG_THREADS + t
                            if row < r1:
                                mine[t].append(row)
                                resident[row] = row - r0 < plan["res_seg"]
                rows_of[seg] = mine
    slots = [t0 + q for t0 in range(0, width, plan["bucket"])
             for q in range(plan["bucket"]) if t0 + q < width]
    return rows_of, slots, resident


@pytest.mark.parametrize("sms", [tuning.H100_SMS, 7, 1])
@pytest.mark.parametrize("elem", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("width", [1, 5, 9, 17])
@pytest.mark.parametrize("n", [1, 31, 1027, 7700, 65_541])
def test_ell_plan_covers_every_row_and_slot_once(n, width, elem, sms):
    plan = tuning.ell_powers_plan(n, width, elem, sms)
    segs = plan["segments"]
    assert segs == tuning.persistent_grid("cpu", tuning.POWERS_BLOCKS_PER_SM,
                                          -(-n // SEG_THREADS)) or sms != 132
    assert plan["blocks"] == -(-segs // plan["seg_per_block"]) <= sms
    assert plan["threads"] in (256, 512, 768, 1024)
    assert plan["threads"] == 256 * min(plan["seg_per_block"],
                                        tuning.ELL_POWERS_GROUPS)
    assert plan["bucket"] in tuning.ELL_BUCKETS
    assert plan["bucket"] >= min(width, tuning.ELL_BUCKETS[-1])
    assert plan["rows_in_flight"] * min(plan["bucket"], width) <= 16
    rows_of, slots, resident = _ell_visits(plan, n, width)
    hits = np.zeros(n, np.int64)
    for seg, mine in rows_of.items():
        r0, r1 = _seg_range(n, segs, seg)
        for t, rows in enumerate(mine):
            # the banded kernel's thread t: rows r0 + t, + kThreads, ...
            assert rows == list(range(r0 + t, r1, SEG_THREADS))
            np.add.at(hits, rows, 1)
    assert (hits == 1).all()
    assert slots == list(range(width))
    # resident: the first res_seg rows of each segment, whole chunks
    assert plan["res_seg"] % 32 == 0 and plan["res_seg"] <= plan["per"]
    for seg in rows_of:
        r0, r1 = _seg_range(n, segs, seg)
        assert resident[r0:r1].sum() == min(r1 - r0, plan["res_seg"])
    assert plan["smem"] == tuning.ell_smem_bytes(
        plan["seg_per_block"], plan["res_seg"], width, elem)
    assert plan["smem"] <= tuning.SMEM_BUDGET
    # as many whole chunks as fit
    more = tuning.ell_smem_bytes(plan["seg_per_block"], plan["res_seg"] + 32,
                                 width, elem)
    assert plan["res_seg"] == plan["per"] or more > tuning.SMEM_BUDGET
    assert plan["route"] == ("resident" if plan["res_seg"] else "stream")


@pytest.mark.parametrize("elem,res_seg,share", [(4, 1248, 0.61),
                                                (2, 1696, 0.84)])
def test_ell_plan_at_the_1024_squared_stencil(elem, res_seg, share):
    """528 segments of 2,016 rows (the banded grid), four a block on 132
    blocks of 1,024 threads, two rows a thread at once: 62% of the f32
    table kept on chip, 84% with bf16 values."""
    n = 1 << 20
    plan = tuning.ell_powers_plan(n, 5, elem, tuning.H100_SMS)
    assert (plan["segments"], plan["per"], plan["seg_per_block"],
            plan["blocks"], plan["threads"]) == (528, 2016, 4, 132, 1024)
    assert plan["res_seg"] == res_seg and plan["bucket"] == 5
    assert plan["rows_in_flight"] == 2
    assert plan["resident"] * plan["blocks"] / n > share
    assert plan["route"] == "resident"


def test_ell_plan_streams_a_table_too_wide_for_a_chunk():
    plan = tuning.ell_powers_plan(2000, 900, 4, tuning.H100_SMS)
    assert plan["route"] == "stream" and plan["res_seg"] == 0
    assert plan["smem"] == tuning.ell_smem_bytes(1, 0, 900, 4)


def test_ell_plan_takes_the_segments_it_is_given():
    plan = tuning.ell_powers_plan(1 << 20, 5, 4, 132, segments=396)
    assert (plan["segments"], plan["seg_per_block"], plan["blocks"]) == \
        (396, 3, 132)
    assert plan["per"] == (-(-(1 << 20) // 396) + 31) // 32 * 32


# --------------------------------------------------------------------------
# the payload's launch
# --------------------------------------------------------------------------
def _sweep_columns(shape, n):
    """Each thread's columns in the column sweep's order: rounds of U
    pieces t + u g, a piece's vec columns in order, then the scalar
    columns pieces vec + t, + g, ..."""
    g = shape["threads"] * shape["blocks"]
    u, vec, pieces = shape["unroll"], shape["vec"], shape["pieces"]
    out = []
    for t in range(g):
        mine = []
        for p0 in range(t, pieces, u * g):
            for k in range(u):
                p = p0 + k * g
                if p < pieces:
                    mine.extend(range(p * vec, p * vec + vec))
        mine.extend(range(pieces * vec + t, n, g))
        out.append(mine)
    return out


def _row_columns(shape, n):
    """A row block's threads (kThreads): pieces t, t + kThreads, ..., then
    the scalar columns."""
    vec, pieces = shape["vec"], shape["pieces"]
    out = []
    for t in range(SEG_THREADS):
        mine = []
        for p in range(t, pieces, SEG_THREADS):
            mine.extend(range(p * vec, p * vec + vec))
        mine.extend(range(pieces * vec + t, n, SEG_THREADS))
        out.append(mine)
    return out


@pytest.mark.parametrize("sms", [tuning.H100_SMS, 1])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("elem", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [1, 5, 1027, 10_000, 10_003, 40_000])
@pytest.mark.parametrize("j", [0, 8, 9, 16, 17, 30])
def test_payload_shape_covers_every_column_once(j, n, elem, aligned, sms):
    shape = tuning.gemv_stream_shape(n, elem, aligned, sms)
    plan = tuning.gemv_partial_shape(shape, j + 1, k=2)
    assert plan["route"] == ("vec" if plan["pieces"] else "scalar")
    items = max(shape["pieces"], shape["tail"])
    if plan["by_row"]:
        assert items <= tuning.PARTIAL_ROW_MAX_ITEMS
        assert plan["blocks"] == j + 1 and plan["bucket"] == 0
        cols = _row_columns(plan, n)
    else:
        assert plan["bucket"] == (8 if j <= 8 else 16)
        assert plan["unroll"] == (1 if plan["bucket"] == 16 and elem == 2
                                  else shape["unroll"])
        cols = _sweep_columns(plan, n)
    hits = np.zeros(n, np.int64)
    for mine in cols:
        np.add.at(hits, mine, 1)
    assert (hits == 1).all()
    # k = 1 is row 4's launch, as it was
    assert tuning.gemv_partial_shape(shape, j + 1) == (
        dict(shape, by_row=1, threads=0, blocks=j + 1, unroll=1)
        if items <= tuning.PARTIAL_ROW_MAX_ITEMS else dict(shape, by_row=0))


# --------------------------------------------------------------------------
# numpy replays of the summation orders
# --------------------------------------------------------------------------
def _partials(sq_of_thread):
    """A segment's (a banded block's) partial: each warp's shuffles, then
    the warps in order from 0 (block_sum)."""
    s = F32(0)
    for w in range(tuning.GS_WARPS):
        s = F32(s + _warp_sum(sq_of_thread[w * WARP:(w + 1) * WARP]))
    return s


def _grid_norm(part):
    """grid_norm: lane l sums partials l, l + 32, ... from 0, then the
    shuffles, then sqrtf."""
    lanes = np.zeros(WARP, F32)
    for lane in range(min(WARP, len(part))):
        lanes[lane] = _seq_sum(part[lane::WARP])
    return np.sqrt(_warp_sum(lanes)).astype(F32)


def _powers_replay(rows_sum, x, s, partition, shifts=None):
    """The s powers in the kernels' order from x: ``rows_sum(cur, denom)``
    gives every row's fmaf chain over cur / denom; ``partition`` lists
    each block's (segment's) threads' rows in order."""
    eps = F32(np.finfo(F32).tiny ** 0.5)
    cur = x
    denom = F32(1)
    us, sigmas = [], []
    for p in range(s):
        acc = rows_sum(cur, denom)
        if shifts is not None:
            acc = (acc - (F32(shifts[p]) * (cur / denom).astype(F32)
                          ).astype(F32)).astype(F32)
        part = []
        for mine in partition:
            sq = np.zeros(SEG_THREADS, F32)
            for t, rows in enumerate(mine):
                for r in rows:
                    sq[t] = _fma(acc[r], acc[r], sq[t])
            part.append(_partials(sq))
        sg = _grid_norm(np.array(part, F32))
        denom = max(sg, eps)
        us.append((acc / denom).astype(F32))
        sigmas.append(sg)
        cur = acc
    return np.stack(us), np.array(sigmas, F32)


def _ell_rows_sum(vals, cols):
    def run(cur, denom):
        g = (cur[cols] / denom).astype(F32)
        acc = np.zeros(vals.shape[0], F32)
        for t in range(vals.shape[1]):
            acc = _fma(vals[:, t], g[:, t], acc)
        return acc
    return run


def _banded_rows_sum(bands, offsets):
    n = bands.shape[1]

    def run(cur, denom):
        x = (cur / denom).astype(F32)
        acc = np.zeros(n, F32)
        i = np.arange(n)
        for d, off in enumerate(offsets):
            c = i + off
            ok = (c >= 0) & (c < n)
            acc = np.where(ok, _fma(bands[d], x[np.clip(c, 0, n - 1)], acc),
                           acc)
        return acc
    return run


@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("sms", [tuning.H100_SMS, 3])
@pytest.mark.parametrize("nx,ny,s", [(40, 31, 5), (64, 64, 2), (33, 47, 8)])
def test_ell_replay_gives_the_banded_bits(nx, ny, s, sms, shifted):
    """A stencil in both formats: the ELL kernel's order (its plan's
    segments, blocks and groups) gives the banded kernel's bits (a grid
    of the same segments), and both hold to the plain versions."""
    op = stencils.convection_diffusion_2d(nx, ny, beta=(0.3, 0.2),
                                          device="cpu")
    ell = op.to_ell()
    n = op.shape[0]
    x = np.random.default_rng(nx + ny + s).standard_normal(n).astype(F32)
    sh = (np.linspace(0.5, 7.5, s).astype(F32) if shifted else None)
    plan = tuning.ell_powers_plan(n, ell.values.shape[1], 4, sms)
    rows_of, _, _ = _ell_visits(plan, n, ell.values.shape[1])
    ell_part = [rows_of[seg] for seg in range(plan["segments"])]
    band_part = []
    for b in range(plan["segments"]):      # the banded grid's blocks
        r0, r1 = _seg_range(n, plan["segments"], b)
        band_part.append([list(range(r0 + t, r1, SEG_THREADS))
                          for t in range(SEG_THREADS)])
    got = _powers_replay(_ell_rows_sum(ell.values.numpy(),
                                       ell.cols.numpy()), x, s, ell_part, sh)
    want = _powers_replay(_banded_rows_sum(op.bands.numpy(), op.offsets),
                          x, s, band_part, sh)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1],
                                                               want[1])
    plain = mp.ell_powers_plain(ell.values, ell.cols, torch.from_numpy(x),
                                s, shifts=None if sh is None
                                else torch.from_numpy(sh))
    assert _rel(got[0], plain[0].numpy()) < BAR["f32"] * 10
    assert _rel(got[1], plain[1].numpy()) < BAR["f32"]


def _payload_replay(v, z, j, plan):
    """The payload in the kernels' order: the column sweep (each thread's
    columns, the block's warps, the blocks in grid_norm's order) or a
    block a row (its threads, its warps)."""
    m1, n = v.shape
    vj = v[j]
    p = np.zeros((m1 + 1, 2), F32)
    if plan["by_row"]:
        cols = _row_columns(plan, n)

        def total(a, b):
            acc = np.zeros(SEG_THREADS, F32)
            for t, mine in enumerate(cols):
                for c in mine:
                    acc[t] = _fma(a[c], b[c], acc[t])
            return _partials(acc)
        for r in range(j):
            p[r] = total(v[r], z), total(v[r], vj)
        p[j] = total(vj, z), total(vj, vj)
        p[m1] = total(z, z), p[j, 1]
        return p
    cols = _sweep_columns(plan, n)
    threads = plan["threads"]

    def total(a, b):
        acc = np.zeros(len(cols), F32)
        for t, mine in enumerate(cols):
            for c in mine:
                acc[t] = _fma(a[c], b[c], acc[t])
        blocks = []
        for blk in range(plan["blocks"]):
            s = F32(0)
            for w in range(threads // WARP):
                t0 = blk * threads + w * WARP
                s = F32(s + _warp_sum(acc[t0:t0 + WARP]))
            blocks.append(s)
        lanes = np.zeros(WARP, F32)
        for lane in range(min(WARP, len(blocks))):
            lanes[lane] = _seq_sum(np.array(blocks[lane::WARP], F32))
        return _warp_sum(lanes)
    for r in range(j):
        p[r] = total(v[r], z), total(v[r], vj)
    p[j] = total(vj, z), total(vj, vj)
    p[m1] = total(z, z), p[j, 1]
    return p


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("n,j,sms", [(1027, 0, 2), (1027, 12, 2),
                                     (4096, 16, 1), (3001, 30, 3),
                                     (20_000, 5, 1)])
def test_payload_replay_holds_to_plain(n, j, sms, aligned):
    m1 = 31
    rng = np.random.default_rng(n + j)
    q, _ = np.linalg.qr(rng.standard_normal((n, j + 1)))
    v = np.zeros((m1, n), F32)
    v[:j + 1] = q.T
    z = rng.standard_normal(n).astype(F32)
    shape = tuning.gemv_stream_shape(n, 4, aligned, sms)
    plan = tuning.gemv_partial_shape(shape, j + 1, k=2)
    got = _payload_replay(v, z, j, plan)
    want = cgs2.gs_project_norm_partial_plain(torch.from_numpy(v),
                                              torch.from_numpy(z), j)
    assert _rel(got, want.numpy()) < BAR["f32"]
    assert not got[j + 1:m1].any()
    assert got[j, 1] == got[m1, 1]          # v_j.v_j, one partial, twice


# --------------------------------------------------------------------------
# the plain versions against JAX at the edge shapes
# --------------------------------------------------------------------------
@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("s", [2, 5])
@pytest.mark.parametrize("width", [1, 9])
@pytest.mark.parametrize("name,tdt,jdt", DTYPES, ids=["f32", "bf16"])
def test_ell_powers_plain_matches_jax(name, tdt, jdt, width, s, shifted):
    n = 1027
    vals, cols = _table(n, width, seed=width * 10 + s)
    vals /= np.sqrt(width)
    x = np.random.default_rng(s).standard_normal(n).astype(F32)
    vj, cj = jnp.asarray(vals).astype(jdt), jnp.asarray(cols)
    sh = np.linspace(0.5, 2.5, s).astype(F32) if shifted else None
    if shifted:
        eps = float(jnp.finfo(jnp.float32).tiny) ** 0.5
        want = jax_mp.matrix_powers_ref(
            lambda u: jax_spmv.ell_matvec(vj, cj, u, interpret=True)
            .astype(jnp.float32), jnp.asarray(x), s, eps,
            shifts=jnp.asarray(sh))
    else:
        want = jax_mp.ell_powers(vj, cj, jnp.asarray(x), s, interpret=True)
    got = mp.ell_powers(torch.from_numpy(vals).to(tdt),
                        torch.from_numpy(cols), torch.from_numpy(x), s,
                        shifts=None if sh is None else torch.from_numpy(sh))
    assert got[0].shape == (s, n) and got[0].dtype == torch.float32
    assert _rel(got[0], want[0]) < BAR[name]
    assert _rel(got[1], want[1]) < BAR[name]


@pytest.mark.parametrize("j", [0, 16])
@pytest.mark.parametrize("name,tdt,jdt", DTYPES, ids=["f32", "bf16"])
def test_payload_plain_matches_jax(name, tdt, jdt, j):
    m1, n = 17, 1027
    rng = np.random.default_rng(j)
    q, _ = np.linalg.qr(rng.standard_normal((n, j + 1)))
    v = np.zeros((m1, n), F32)
    v[:j + 1] = q.T
    z = rng.standard_normal(n).astype(F32)
    vj = jnp.asarray(v).astype(jdt)
    mask = (jnp.arange(m1) <= j).astype(jnp.float32)
    w2 = jnp.stack([jnp.asarray(z), vj[j].astype(jnp.float32)], axis=1)
    want = jax_cgs2.gs_project_norm_partial(vj, w2, mask, interpret=True)
    got = cgs2.gs_project_norm_partial(torch.from_numpy(v).to(tdt),
                                       torch.from_numpy(z), j)
    assert got.shape == (m1 + 1, 2) and got.dtype == torch.float32
    assert _rel(got, want) < BAR[name]
    assert not got[j + 1:m1].any()
