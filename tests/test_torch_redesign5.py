"""The streamed ``cgs2`` / ``gs_project`` and ``block_gs_pass``, on the CPU.

The kernels run only on the card (``tests/test_torch_cuda.py``); what
surrounds them is pure Python and is held here:

- the launch-plan rules: ``tuning.gs_stream_plan`` (the shared-memory
  route where ``fused_step_fits``, else one lane of ``batched_cgs2``'s
  rule: 16-byte pieces or the scalar route, the grid) and
  ``tuning.block_gs_plan`` (a block a contiguous range of pieces and of
  the scalar tail, the warps' row groups of eight and their column
  shares), their loops replayed in numpy, covering every column and every
  valid row once;
- a numpy replay of each kernel's fixed summation order (a thread's
  columns in its loop order, warp shuffles, the warps or column shares in
  order, the blocks in order; Q = T W formed again in the update by the
  same chain), held to the plain versions at float32 rtol 1e-5;
- the plain versions (the wrappers on the CPU) against the JAX kernels at
  ``interpret=True`` at the edge shapes: j = 0 and m1 - 1, n not a
  multiple of 4, s = 1 and 8, k_start 0 and m1 - 1, bfloat16 storage.
  Tolerances relative to the largest entry: float32 1e-5, bfloat16 2e-2.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import block_gs as jax_block_gs  # noqa: E402
from repro.kernels import cgs2 as jax_cgs2  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels import block_gs, cgs2, ref, tuning  # noqa: E402

BAR = {"f32": 1e-5, "bf16": 2e-2}
WARP = 32


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _basis(n, m1, j, seed=0):
    """Orthonormal rows 0..j, zeros after (float32 numpy)."""
    q, _ = np.linalg.qr(np.random.default_rng(seed).standard_normal(
        (n, j + 1)))
    v = np.zeros((m1, n), np.float32)
    v[:j + 1] = q.T
    return v


def _warp_sum(x):
    """common.cuh's warp_sum over axis 0 (32 lanes): the xor butterfly,
    the same value in every lane."""
    x = np.array(x, np.float32)
    lanes = np.arange(WARP)
    for o in (16, 8, 4, 2, 1):
        x = (x + x[lanes ^ o]).astype(np.float32)
    return x[0]


def _seq_sum(x, axis=0):
    """Sum along ``axis`` one term at a time from 0 (a thread's loop)."""
    x = np.moveaxis(np.asarray(x, np.float32), axis, 0)
    s = np.zeros(x.shape[1:], np.float32)
    for t in x:
        s = (s + t).astype(np.float32)
    return s


# --------------------------------------------------------------------------
# the streamed cgs2 / gs_project (csrc/cgs2.cu over csrc/stream_gs.cuh)
# --------------------------------------------------------------------------
def _stream_columns(plan, n):
    """Each thread's columns in its loop order (bc_project's): rounds of U
    pieces t + u g, a piece's vec columns in order, then the scalar
    columns pieces vec + t, + g, ..."""
    g = plan["grid"] * plan["threads"]
    u, vec, pieces = plan["unroll"], plan["vec"], plan["pieces"]
    cols = []
    for t in range(g):
        mine = []
        for p0 in range(t, pieces, u * g):
            for k in range(u):
                p = p0 + k * g
                if p < pieces:
                    mine.extend(range(p * vec, p * vec + vec))
        mine.extend(range(pieces * vec + t, n, g))
        cols.append(mine)
    return cols


def _stream_project(v, x, rows, plan, cols):
    """h[r] = sum_c V[r, c] x[c] in the kernel's order: a thread's
    columns, the block's warps (shuffles, then in order), the blocks
    (lane l sums blocks l, l + 32, ..., then shuffles)."""
    threads, grid = plan["threads"], plan["grid"]
    width = max(len(c) for c in cols)
    idx = np.full((len(cols), width), -1)
    for t, c in enumerate(cols):
        idx[t, :len(c)] = c
    acc = np.zeros((len(cols), rows), np.float32)
    for k in range(width):
        c = idx[:, k]
        live = c >= 0
        prod = (v[:rows, np.where(live, c, 0)].T
                * x[np.where(live, c, 0)][:, None]).astype(np.float32)
        acc = np.where(live[:, None], acc + prod, acc).astype(np.float32)
    blocks = np.zeros((grid, rows), np.float32)
    for b in range(grid):
        s = np.zeros(rows, np.float32)
        for w in range(threads // WARP):
            t0 = b * threads + w * WARP
            s = (s + _warp_sum(acc[t0:t0 + WARP])).astype(np.float32)
        blocks[b] = s
    lanes = np.zeros((WARP, rows), np.float32)
    for lane in range(WARP):
        lanes[lane] = _seq_sum(blocks[lane::WARP]) if lane < grid else 0
    return _warp_sum(lanes)


def _stream_update(v, x, h, rows):
    """out[c] = x[c] - sum_r h[r] V[r, c], the rows in order from 0."""
    u = np.zeros(v.shape[1], np.float32)
    for r in range(rows):
        u = (u + h[r] * v[r]).astype(np.float32)
    return (x - u).astype(np.float32)


def _stream_replay(v, w, j, plan, passes):
    """The kernel's cgs2 (passes 2) or gs_project (passes 1)."""
    rows, n = j + 1, v.shape[1]
    cols = _stream_columns(plan, n)
    h1 = _stream_project(v, w, rows, plan, cols)
    w1 = _stream_update(v, w, h1, rows)
    h = np.zeros(v.shape[0], np.float32)
    if passes == 1:
        h[:rows] = h1
        return h, w1
    h2 = _stream_project(v, w1, rows, plan, cols)
    h[:rows] = (h1 + h2).astype(np.float32)
    return h, _stream_update(v, w1, h2, rows)


@pytest.mark.parametrize("elem", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("n,j,budget", [
    (1 << 20, 15, 264), (1 << 20, 0, 264), (1 << 20, 1, 264),
    (1 << 20, 30, 264), ((1 << 20) + 3, 7, 264), (300_000, 39, 264),
    (4099, 5, 3), (4096, 2, 1)])
def test_stream_plan_covers_every_column_once(n, j, budget, aligned, elem):
    plan = tuning.gs_stream_plan(40, n, j, elem, aligned, budget)
    vec, pieces = plan["vec"], plan["pieces"]
    assert plan["route"] == ("vec" if aligned else "scalar")
    assert pieces == (n // vec if aligned else 0)
    assert pieces * vec + plan["tail"] == n
    assert 1 <= plan["grid"] <= budget
    bucket, u = tuning.batched_unroll(j + 1, elem)
    assert (plan["bucket"], plan["unroll"]) == (bucket, u)
    # one round of U pieces a thread at most, unless the budget is short
    g = plan["grid"] * plan["threads"]
    assert plan["grid"] == budget or pieces <= u * g
    # the kernel's loops: thread t's pieces t + i U g + k g (k < U), then
    # its scalar columns pieces vec + t, + g, ...: every column once
    t = np.arange(g)
    hits = np.zeros(n, np.int64)
    for base in range(0, pieces, u * g):
        for k in range(u):
            p = base + t + k * g
            p = p[p < pieces]
            for c in range(vec):
                np.add.at(hits, p * vec + c, 1)
    for c0 in range(pieces * vec, n, g):
        c = c0 + t
        np.add.at(hits, c[c < n], 1)
    assert (hits == 1).all()


@pytest.mark.parametrize("elem,j,want", [
    (4, 0, (256, 2, 8)), (4, 15, (264, 32, 1)), (4, 29, (264, 32, 1)),
    (2, 0, (256, 2, 4)), (2, 15, (264, 32, 1))])
def test_stream_plan_at_2_20_fills_the_co_resident_grid(elem, j, want):
    """At n = 2^20 on an H100's co-resident blocks (two of 128 threads an
    SM: 264) a step past two rows takes the whole grid a piece at a time;
    a one-row step takes U pieces at once, so 256 blocks give each thread
    one round."""
    plan = tuning.gs_stream_plan(31, 1 << 20, j, elem, True, 264)
    assert (plan["grid"], plan["bucket"], plan["unroll"]) == want
    assert plan["route"] == "vec" and plan["tail"] == 0


@pytest.mark.parametrize("n,m1,route", [(10_000, 31, "smem"),
                                        (1 << 20, 31, "stream"),
                                        (300_000, 40, "stream")])
def test_the_shared_memory_route_is_the_fits_check(n, m1, route):
    fits = tuning.fused_step_fits(m1, n, tuning.H100_SMS)
    assert fits == (route == "smem")


@pytest.mark.parametrize("passes", [1, 2])
@pytest.mark.parametrize("n,m1,j,budget,aligned", [
    (4096, 12, 0, 3, True), (4096, 12, 1, 3, True), (4096, 12, 11, 3, True),
    (4099, 12, 7, 2, False), (2048, 40, 35, 2, True)])
def test_stream_replay_matches_plain(n, m1, j, budget, aligned, passes):
    v = _basis(n, m1, j, seed=j)
    w = np.random.default_rng(n + j).standard_normal(n).astype(np.float32)
    plan = tuning.gs_stream_plan(m1, n, j, 4, aligned, budget)
    h, w_out = _stream_replay(v, w, j, plan, passes)
    vt, wt = torch.from_numpy(v), torch.from_numpy(w)
    hp, wp = (cgs2.cgs2(vt, wt, j) if passes == 2
              else cgs2.gs_project(vt, wt, j))
    assert _rel(h, hp.numpy()) < BAR["f32"]
    assert _rel(w_out, wp.numpy()) < BAR["f32"]
    assert not h[j + 1:].any()


# --------------------------------------------------------------------------
# block_gs_pass (csrc/block_gs.cu)
# --------------------------------------------------------------------------
def _block_threads(plan, n, b):
    """Block b's pieces and scalar columns: (pieces, columns)."""
    vec, pieces = plan["vec"], plan["pieces"]
    p_lo = min(pieces, b * plan["pb"])
    p_hi = min(pieces, p_lo + plan["pb"])
    t_lo = min(n, pieces * vec + b * plan["tb"])
    t_hi = min(n, t_lo + plan["tb"])
    return (p_lo, p_hi), (t_lo, t_hi)


def _projection_columns(plan, n, b, share, shares, lane):
    """The columns a projection thread visits, in order: its share's
    pieces p_lo + 32 share + lane, + 32 shares, ..., then the tail."""
    (p_lo, p_hi), (t_lo, t_hi) = _block_threads(plan, n, b)
    vec, step = plan["vec"], WARP * shares
    out = []
    for p in range(p_lo + WARP * share + lane, p_hi, step):
        out.extend(range(p * vec, p * vec + vec))
    out.extend(range(t_lo + WARP * share + lane, t_hi, step))
    return out


def _update_columns(plan, n, b, tid):
    (p_lo, p_hi), (t_lo, t_hi) = _block_threads(plan, n, b)
    vec, threads = plan["vec"], plan["threads"]
    out = []
    for p in range(p_lo + tid, p_hi, threads):
        out.extend(range(p * vec, p * vec + vec))
    out.extend(range(t_lo + tid, t_hi, threads))
    return out


def _q_of(t, w):
    """Q = T W, each entry an fmaf chain from 0 over b (q_of_four)."""
    q = np.zeros((t.shape[0], w.shape[1]), np.float32)
    for bb in range(t.shape[1]):
        q = (q + t[:, bb:bb + 1] * w[bb]).astype(np.float32)
    return q


def _block_replay(v, w, tin, k_start, plan):
    m1, n = v.shape
    s = w.shape[0]
    rows = k_start + 1
    grid, warps = plan["grid"], plan["threads"] // WARP
    q = _q_of(tin, w)
    groups, shares = plan["groups"], plan["shares"]
    assert rows <= tuning.BLOCK_GS_ROW_GROUP * warps   # one set of rows
    # 1. C partials: warp w holds rows 8 (w % groups) .. over share
    # w // groups; the block sums the shares of a row group in order
    part = np.zeros((rows, s, grid), np.float32)
    for b in range(grid):
        for g in range(groups):
            r0 = g * tuning.BLOCK_GS_ROW_GROUP
            rr = list(range(r0, min(rows, r0 + tuning.BLOCK_GS_ROW_GROUP)))
            tot = np.zeros((len(rr), s), np.float32)
            for sh in range(shares):
                lanes = np.zeros((WARP, len(rr), s), np.float32)
                for lane in range(WARP):
                    for c in _projection_columns(plan, n, b, sh, shares,
                                                 lane):
                        lanes[lane] = (lanes[lane] + v[rr, c][:, None]
                                       * q[:, c][None, :]).astype(np.float32)
                tot = (tot + _warp_sum(lanes)).astype(np.float32)
            part[rr, :, b] = tot
    # 2. each entry over the blocks: lane l sums blocks l, l + 32, ...
    lanes = np.zeros((WARP, rows, s), np.float32)
    for lane in range(min(WARP, grid)):
        lanes[lane] = _seq_sum(part[:, :, lane::WARP], axis=2)
    c = np.zeros((m1, s), np.float32)
    c[:rows] = _warp_sum(lanes)
    # 3. W' = Q - C^T V, the rows in order, then the difference
    u = np.zeros((s, n), np.float32)
    for r in range(rows):
        u = (u + c[r][:, None] * v[r][None, :]).astype(np.float32)
    w2 = (q - u).astype(np.float32)
    # G: a thread's columns in order, the warps in order, the blocks
    tri = [(a, bb) for a in range(s) for bb in range(a, s)]
    gpart = np.zeros((len(tri), grid), np.float32)
    for b in range(grid):
        tot = np.zeros(len(tri), np.float32)
        for wp in range(warps):
            lanes_g = np.zeros((WARP, len(tri)), np.float32)
            for lane in range(WARP):
                for col in _update_columns(plan, n, b, wp * WARP + lane):
                    lanes_g[lane] = (lanes_g[lane] + np.array(
                        [w2[a, col] * w2[bb, col] for a, bb in tri],
                        np.float32)).astype(np.float32)
            tot = (tot + _warp_sum(lanes_g)).astype(np.float32)
        gpart[:, b] = tot
    lanes_g = np.zeros((WARP, len(tri)), np.float32)
    for lane in range(min(WARP, grid)):
        lanes_g[lane] = _seq_sum(gpart[:, lane::WARP], axis=1)
    gsum = _warp_sum(lanes_g)
    g = np.zeros((s, s), np.float32)
    for e, (a, bb) in enumerate(tri):
        g[a, bb] = g[bb, a] = gsum[e]
    return c, w2, g


@pytest.mark.parametrize("elem", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("n,rows,s,sms", [
    (1 << 20, 26, 5, 132), (1 << 20, 1, 8, 132), (1 << 20, 31, 1, 132),
    (10_000, 26, 5, 132), ((1 << 20) + 3, 13, 5, 132), (300, 9, 8, 132),
    (5000, 64, 2, 7), (4099, 17, 3, 2)])
def test_block_plan_covers_columns_and_rows_once(n, rows, s, sms, aligned,
                                                 elem):
    m1 = max(rows, 31)
    plan = tuning.block_gs_plan(m1, n, s, rows, elem, aligned, sms)
    vec, pieces = plan["vec"], plan["pieces"]
    assert plan["route"] == ("vec" if aligned else "scalar")
    assert pieces * vec + plan["tail"] == n
    assert 1 <= plan["grid"] <= sms
    # the blocks' contiguous ranges cover every piece and tail column once
    hits = np.zeros(n, np.int64)
    for b in range(plan["grid"]):
        (p_lo, p_hi), (t_lo, t_hi) = _block_threads(plan, n, b)
        for p in range(p_lo, p_hi):
            hits[p * vec:(p + 1) * vec] += 1
        hits[t_lo:t_hi] += 1
    assert (hits == 1).all()
    # in a block, the column shares of the projection and the threads of
    # the update each visit the block's columns once
    b = plan["grid"] // 2
    (p_lo, p_hi), (t_lo, t_hi) = _block_threads(plan, n, b)
    want = sorted(list(range(p_lo * vec, p_hi * vec))
                  + list(range(t_lo, t_hi)))
    shares = plan["shares"]
    got = sorted(c for sh in range(shares) for lane in range(WARP)
                 for c in _projection_columns(plan, n, b, sh, shares, lane))
    assert got == want
    got = sorted(c for tid in range(plan["threads"])
                 for c in _update_columns(plan, n, b, tid))
    assert got == want
    # the warps' row groups of eight hold every valid row once
    warps = plan["threads"] // WARP
    groups = plan["groups"]
    assert groups * shares <= warps and groups * tuning.BLOCK_GS_ROW_GROUP \
        >= min(rows, tuning.BLOCK_GS_ROW_GROUP * warps)


def test_block_plan_is_one_block_an_sm_at_2_20():
    """One block an SM at n = 2^20: a block's slice of a row is 1,986
    pieces (31.8 KB f32) or 993 (15.9 KB bf16); 26 rows make four row
    groups of eight, two column shares each."""
    f32 = tuning.block_gs_plan(31, 1 << 20, 5, 26, 4, True, 132)
    bf16 = tuning.block_gs_plan(31, 1 << 20, 5, 26, 2, True, 132)
    assert (f32["grid"], f32["pb"], f32["tb"]) == (132, 1986, 0)
    assert (bf16["grid"], bf16["pb"]) == (132, 993)
    assert (f32["groups"], f32["shares"]) == (4, 2)


@pytest.mark.parametrize("n,m1,k_start,s,sms,aligned", [
    (1024, 12, 11, 5, 3, True), (1024, 12, 0, 1, 2, True),
    (1027, 12, 9, 8, 2, False), (640, 31, 30, 3, 2, True)])
def test_block_replay_matches_plain(n, m1, k_start, s, sms, aligned):
    rng = np.random.default_rng(n + s)
    v = _basis(n, m1, k_start, seed=k_start)
    w = rng.standard_normal((s, n)).astype(np.float32)
    tin = (np.triu(rng.standard_normal((s, s))) + 2 * np.eye(s)) \
        .astype(np.float32)
    plan = tuning.block_gs_plan(m1, n, s, k_start + 1, 4, aligned, sms)
    c, w2, g = _block_replay(v, w, tin, k_start, plan)
    cp, wp, gp = block_gs.block_gs_pass(torch.from_numpy(v),
                                        torch.from_numpy(w),
                                        torch.from_numpy(tin), k_start)
    assert _rel(c, cp.numpy()) < BAR["f32"]
    assert _rel(w2, wp.numpy()) < BAR["f32"]
    assert _rel(g, gp.numpy()) < BAR["f32"]
    assert not c[k_start + 1:].any()
    np.testing.assert_array_equal(g, g.T)


# --------------------------------------------------------------------------
# the plain versions against the JAX kernels (interpret)
# --------------------------------------------------------------------------
DTYPES = [("f32", torch.float32, jnp.float32),
          ("bf16", torch.bfloat16, jnp.bfloat16)]


@pytest.mark.parametrize("name,tdtype,jdtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("n,m1,j", [(1027, 8, 0), (1027, 8, 7),
                                    (2048, 31, 30), (2048, 31, 15)])
def test_cgs2_and_gs_project_match_jax(n, m1, j, name, tdtype, jdtype):
    v = _basis(n, m1, j, seed=n + j)
    w = np.random.default_rng(j).standard_normal(n).astype(np.float32)
    vj = jnp.asarray(v).astype(jdtype)
    mask = jnp.asarray(ref.row_mask(m1, j).numpy())
    vt = convert.tensor(vj, "cpu")
    wt = torch.from_numpy(w)
    for jax_fn, fn in ((jax_cgs2.cgs2, cgs2.cgs2),
                       (jax_cgs2.gs_project, cgs2.gs_project)):
        hj, wj = jax_fn(vj, jnp.asarray(w), mask, interpret=True)
        ht, wt2 = fn(vt, wt, j)
        assert _rel(ht.numpy(), np.asarray(hj)) < BAR[name]
        assert _rel(wt2.numpy(), np.asarray(wj)) < BAR[name]
        assert not ht[j + 1:].any()


@pytest.mark.parametrize("name,tdtype,jdtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("n,m1,k_start,s", [(1027, 8, 0, 1), (1027, 8, 7, 8),
                                            (2048, 31, 30, 5),
                                            (2048, 31, 12, 8)])
def test_block_gs_pass_matches_jax(n, m1, k_start, s, name, tdtype, jdtype):
    rng = np.random.default_rng(n + s + k_start)
    v = _basis(n, m1, k_start, seed=k_start)
    w = rng.standard_normal((s, n)).astype(np.float32)
    tin = (np.triu(rng.standard_normal((s, s))) + 2 * np.eye(s)) \
        .astype(np.float32)
    vj = jnp.asarray(v).astype(jdtype)
    mask = jnp.asarray((np.arange(m1) <= k_start).astype(np.float32))
    cj, wj, gj = jax_block_gs.block_gs_pass(vj, jnp.asarray(w),
                                            jnp.asarray(tin), mask,
                                            interpret=True)
    ct, wt, gt = block_gs.block_gs_pass(convert.tensor(vj, "cpu"),
                                        torch.from_numpy(w),
                                        torch.from_numpy(tin), k_start)
    for got, want in ((ct, cj), (wt, wj), (gt, gj)):
        assert _rel(got.numpy(), np.asarray(want)) < BAR[name]
    assert not ct[k_start + 1:].any()
