"""The s-step projections ``block_gs_project_gram`` and ``block_gs_project``
on block_gs_pass's projection sweep, on the CPU.

The kernels run only on the card (``tests/test_torch_cuda.py``); what
surrounds them is pure Python and is held here:

- the launch plan (``tuning.block_gs_plan``, ``block_gs.block_gs_plan``,
  also on twice the SMs, as two blocks an SM would take it): the
  blocks' contiguous ranges of 16-byte pieces and of the scalar tail cover
  every column once, the column shares of a block cover its columns once,
  the sets of rows and their row groups cover every row read once, and the
  warps that store Q (row group 0 of the first set) cover every column
  once; on both routes, at the test shapes and at n = 2^20 and 10^4;
- a numpy replay of the kernels' summation order (a thread's fmaf chain
  over its columns, the warps' shuffles, the column shares in order, then
  the blocks as the reduction launch sums them), held to the plain
  versions at float32 rtol 1e-5; its Q is the fmaf chain from 0 over b,
  checked bit for bit against exact arithmetic rounded once to float32;
- the plain versions against the JAX kernels at ``interpret=True``: f32
  1e-5, bf16 2e-2 relative to the largest entry.
"""
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import block_gs as jax_block_gs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels import block_gs, tuning  # noqa: E402

BAR = {"f32": 1e-5, "bf16": 2e-2}
WARP = 32
GROUP = tuning.BLOCK_GS_ROW_GROUP
SET_ROWS = GROUP * tuning.GS_WARPS      # rows one set of the sweep covers


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _fma32(a, b, c):
    """fmaf on float32 operands: the product is exact in float64."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def _warp_sum(x):
    """common.cuh's warp_sum over axis 0 (32 lanes): the xor butterfly."""
    x = np.array(x, np.float32)
    lanes = np.arange(WARP)
    for o in (16, 8, 4, 2, 1):
        x = (x + x[lanes ^ o]).astype(np.float32)
    return x[0]


def _seq_sum(x, axis=0):
    """Sum along ``axis`` one term at a time from 0."""
    x = np.moveaxis(np.asarray(x, np.float32), axis, 0)
    s = np.zeros(x.shape[1:], np.float32)
    for t in x:
        s = (s + t).astype(np.float32)
    return s


# --------------------------------------------------------------------------
# the plan
# --------------------------------------------------------------------------
def _block_range(plan, n, b):
    """Block b's pieces and scalar columns: ((p_lo, p_hi), (t_lo, t_hi))."""
    vec, pieces = plan["vec"], plan["pieces"]
    p_lo = min(pieces, b * plan["pb"])
    p_hi = min(pieces, p_lo + plan["pb"])
    t_lo = min(n, pieces * vec + b * plan["tb"])
    t_hi = min(n, t_lo + plan["tb"])
    return (p_lo, p_hi), (t_lo, t_hi)


def _sets(rows):
    """The sweep's sets of rows: (first row, row groups, column shares)."""
    out = []
    for rs in range(0, rows, SET_ROWS):
        ng = -(-min(SET_ROWS, rows - rs) // GROUP)
        out.append((rs, ng, tuning.GS_WARPS // ng))
    return out


def _lane_columns(plan, n, b, share, shares, lane):
    """The columns one thread visits, in order: its share's pieces
    p_lo + 32 share + lane, + 32 shares, ..., then the tail."""
    (p_lo, p_hi), (t_lo, t_hi) = _block_range(plan, n, b)
    vec, step = plan["vec"], WARP * shares
    out = []
    for p in range(p_lo + WARP * share + lane, p_hi, step):
        out.extend(range(p * vec, p * vec + vec))
    out.extend(range(t_lo + WARP * share + lane, t_hi, step))
    return out


@pytest.mark.parametrize("elem", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("aligned", [True, False], ids=["vec", "scalar"])
@pytest.mark.parametrize("n,rows,s,sms", [
    (1 << 20, 26, 5, 132), (1 << 20, 1, 8, 264), (10_000, 26, 5, 132),
    (100_003, 70, 3, 132), (300, 1, 1, 264), (1027, 70, 8, 3),
    (5000, 64, 2, 14)])
def test_plan_covers_columns_rows_and_q_once(n, rows, s, sms, aligned,
                                             elem):
    plan = tuning.block_gs_plan(rows, n, s, rows, elem, aligned, sms)
    vec, pieces = plan["vec"], plan["pieces"]
    assert plan["route"] == ("vec" if aligned else "scalar")
    assert pieces * vec + plan["tail"] == n
    assert 1 <= plan["grid"] <= sms
    # the blocks' contiguous ranges hold every piece and tail column once
    hits = np.zeros(n, np.int64)
    for b in range(plan["grid"]):
        (p_lo, p_hi), (t_lo, t_hi) = _block_range(plan, n, b)
        hits[p_lo * vec:p_hi * vec] += 1
        hits[t_lo:t_hi] += 1
    assert (hits == 1).all()
    # in a block, each set's column shares (the Q-storing warps among
    # them) visit the block's columns once; the groups hold every row once
    b = plan["grid"] // 2
    (p_lo, p_hi), (t_lo, t_hi) = _block_range(plan, n, b)
    want = list(range(p_lo * vec, p_hi * vec)) + list(range(t_lo, t_hi))
    row_hits = np.zeros(rows, np.int64)
    for rs, ng, nsh in _sets(rows):
        assert ng * nsh <= tuning.GS_WARPS
        got = sorted(c for sh in range(nsh) for lane in range(WARP)
                     for c in _lane_columns(plan, n, b, sh, nsh, lane))
        assert got == want
        for g in range(ng):
            row_hits[rs + g * GROUP:min(rows, rs + (g + 1) * GROUP)] += 1
    assert (row_hits == 1).all()
    assert (_sets(rows)[0][1], _sets(rows)[0][2]) == (plan["groups"],
                                                      plan["shares"])


def test_plan_at_the_solvers_shapes():
    """n = 2^20, 26 rows: one block an SM, 1,986 f32 pieces a block (993
    bf16), four row groups of two column shares; n = 10^4: 40 blocks of
    63 pieces (f32) or 20 (bf16)."""
    f32 = tuning.block_gs_plan(26, 1 << 20, 5, 26, 4, True, 132)
    bf16 = tuning.block_gs_plan(26, 1 << 20, 5, 26, 2, True, 132)
    assert (f32["grid"], f32["pb"], f32["tb"]) == (132, 1986, 0)
    assert (bf16["grid"], bf16["pb"]) == (132, 993)
    assert (f32["groups"], f32["shares"]) == (4, 2)
    assert tuning.block_gs_plan(26, 10_000, 5, 26, 4, True,
                                132)["grid"] == 40
    assert tuning.block_gs_plan(26, 10_000, 5, 26, 2, True,
                                132)["grid"] == 20


@pytest.mark.parametrize("n,off,rows,route", [
    (1024, 0, 26, "vec"), (1027, 0, 26, "scalar"), (1024, 1, 26, "scalar"),
    (1028, 0, 1, "vec"), (1028, 0, 2, "vec")])
def test_plan_takes_the_scalar_route_off_16_bytes(n, off, rows, route):
    """The 16-byte route needs V, W and their row strides 16-byte aligned
    (n = 1,027, or W one float into its buffer, takes the scalar route)."""
    v = torch.zeros(rows * n).view(rows, n)
    w = torch.zeros(5 * n + off)[off:].view(5, n)
    plan = block_gs.block_gs_plan(v, w, rows - 1)
    assert plan["route"] == route
    assert plan == tuning.block_gs_plan(rows, n, 5, rows, 4, route == "vec",
                                        tuning.H100_SMS)


# --------------------------------------------------------------------------
# the kernels' summation order
# --------------------------------------------------------------------------
def _q_chain(t, w):
    """Q = T W, each entry an fmaf chain from 0 over b (q_of_four)."""
    q = np.zeros((t.shape[0], w.shape[1]), np.float32)
    for bb in range(t.shape[1]):
        q = _fma32(t[:, bb:bb + 1], w[bb][None, :], q)
    return q


def _fmaf_exact(a, b, c) -> np.float32:
    """a b + c for float32 a, b, c, rounded once to float32 (to nearest,
    ties to even), from exact rationals."""
    exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    r = np.float32(float(exact))          # within one float32 step
    best = None
    for cand in (np.nextafter(r, np.float32(-np.inf)), r,
                 np.nextafter(r, np.float32(np.inf))):
        d = abs(Fraction(float(cand)) - exact)
        even = int(cand.view(np.int32)) % 2 == 0
        if best is None or d < best[0] or (d == best[0] and even):
            best = (d, cand)
    return best[1]


def _thread_columns(plan, n, nsh):
    """Every thread's columns (block, share, lane order) as a padded index
    array (-1: no column) of shape (grid, nsh, 32, width)."""
    cols = [[[_lane_columns(plan, n, b, sh, nsh, lane)
              for lane in range(WARP)] for sh in range(nsh)]
            for b in range(plan["grid"])]
    width = max(1, max(len(c) for blk in cols for sh in blk for c in sh))
    idx = np.full((plan["grid"], nsh, WARP, width), -1, np.int64)
    for b, blk in enumerate(cols):
        for sh, lanes in enumerate(blk):
            for lane, c in enumerate(lanes):
                idx[b, sh, lane, :len(c)] = c
    return idx


def _chains(x, y, idx):
    """acc[..., i, j] = fmaf(x[i, c], y[j, c], acc) over each thread's
    columns c in order: (grid, nsh, 32, len(x), len(y))."""
    acc = np.zeros(idx.shape[:3] + (x.shape[0], y.shape[0]), np.float32)
    for k in range(idx.shape[3]):
        c = idx[..., k]
        live = (c >= 0)[..., None, None]
        cc = np.where(c >= 0, c, 0)
        step = _fma32(np.moveaxis(x[:, cc], 0, -1)[..., :, None],
                      np.moveaxis(y[:, cc], 0, -1)[..., None, :], acc)
        acc = np.where(live, step, acc)
    return acc


def _block_sums(acc):
    """The warps' shuffles, then the column shares in order: (grid, ...)."""
    warps = _warp_sum(np.moveaxis(acc, 2, 0))       # (grid, nsh, ...)
    return _seq_sum(warps, axis=1)


def _over_blocks(part):
    """reduce_partials_kernel: lane l sums blocks l, l + 32, ... in order,
    then the shuffles (part: (grid, entries))."""
    lanes = np.zeros((WARP,) + part.shape[1:], np.float32)
    for lane in range(min(WARP, part.shape[0])):
        lanes[lane] = _seq_sum(part[lane::WARP], axis=0)
    return _warp_sum(lanes)


def _replay(v, w, tin, rows, plan, gram):
    """The projection kernel and its reduction in their fixed order:
    (q, C over rows 0..rows-1, M or None)."""
    n = v.shape[1]
    s = w.shape[0]
    q = _q_chain(tin, w)
    part_c = np.zeros((plan["grid"], rows, s), np.float32)
    m = None
    for rs, ng, nsh in _sets(rows):
        idx = _thread_columns(plan, n, nsh)
        for g in range(ng):
            rr = slice(rs + g * GROUP, min(rows, rs + (g + 1) * GROUP))
            part_c[:, rr] = _block_sums(_chains(v[rr], q, idx))
        if gram and rs == 0:
            tri = _block_sums(_chains(q, q, idx))     # (grid, s, s)
            iu = np.triu_indices(s)
            part_m = np.zeros_like(tri)
            part_m[:, iu[0], iu[1]] = tri[:, iu[0], iu[1]]
            part_m[:, iu[1], iu[0]] = tri[:, iu[0], iu[1]]
            m = _over_blocks(part_m)
    return q, _over_blocks(part_c), m


def _inputs(n, m1, s, seed):
    rng = np.random.default_rng(seed)
    v = (rng.standard_normal((m1, n)) / n ** 0.5).astype(np.float32)
    w = rng.standard_normal((s, n)).astype(np.float32)
    tin = (np.triu(rng.standard_normal((s, s))) + 2 * np.eye(s)) \
        .astype(np.float32)
    return v, w, tin


@pytest.mark.parametrize("n,m1,s,sms,aligned", [
    (1024, 12, 5, 3, True), (1027, 9, 8, 2, False), (640, 70, 2, 2, True),
    (1024, 1, 1, 4, True)])
def test_project_gram_replay_matches_plain(n, m1, s, sms, aligned):
    v, w, tin = _inputs(n, m1, s, n + m1 + s)
    plan = tuning.block_gs_plan(m1, n, s, m1, 4, aligned, sms)
    q, c_hat, m = _replay(v, w, tin, m1, plan, gram=True)
    qp, cp, mp = block_gs.block_gs_project_gram(
        torch.from_numpy(v), torch.from_numpy(w), torch.from_numpy(tin))
    assert _rel(q, qp.numpy()) < BAR["f32"]
    assert _rel(c_hat, cp.numpy()) < BAR["f32"]
    assert _rel(m, mp.numpy()) < BAR["f32"]
    np.testing.assert_array_equal(m, m.T)


@pytest.mark.parametrize("n,m1,k_start,s,sms,aligned", [
    (1024, 31, 25, 5, 3, True), (1024, 31, 0, 8, 2, True),
    (1027, 70, 69, 3, 2, False)])
def test_project_replay_matches_plain(n, m1, k_start, s, sms, aligned):
    v, w, tin = _inputs(n, m1, s, n + k_start)
    plan = tuning.block_gs_plan(m1, n, s, k_start + 1, 4, aligned, sms)
    v[k_start + 1:] = np.nan          # rows past k_start: never read
    q, c, _ = _replay(v, w, tin, k_start + 1, plan, gram=False)
    assert np.isfinite(c).all()
    qp, cp = block_gs.block_gs_project_plain(
        torch.from_numpy(np.nan_to_num(v)), torch.from_numpy(w),
        torch.from_numpy(tin), k_start)
    assert _rel(q, qp.numpy()) < BAR["f32"]
    assert _rel(c, cp.numpy()[:k_start + 1]) < BAR["f32"]
    assert not cp[k_start + 1:].any()


def test_q_chain_is_fmaf_bit_for_bit():
    """The replay's Q (and the kernels': q_of_four / q_of_one) is the
    fmaf chain from 0 over b; float64 emulation of each fmaf gives the
    once-rounded result for these operands."""
    s, n = 8, 24
    rng = np.random.default_rng(7)
    t = (rng.standard_normal((s, s)) * 3).astype(np.float32)
    w = (rng.standard_normal((s, n)) * 1e3).astype(np.float32)
    q = _q_chain(t, w)
    for a in range(s):
        for c in range(n):
            acc = np.float32(0)
            for bb in range(s):
                acc = _fmaf_exact(t[a, bb], w[bb, c], acc)
            assert acc.view(np.int32) == q[a, c].view(np.int32)


# --------------------------------------------------------------------------
# the plain versions against the JAX kernels (interpret)
# --------------------------------------------------------------------------
DTYPES = [("f32", torch.float32, jnp.float32),
          ("bf16", torch.bfloat16, jnp.bfloat16)]


@pytest.mark.parametrize("name,tdtype,jdtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("n,m1,s", [(1027, 9, 8), (300, 70, 1)])
def test_project_gram_matches_jax(n, m1, s, name, tdtype, jdtype):
    v, w, tin = _inputs(n, m1, s, n + s)
    vj = jnp.asarray(v).astype(jdtype)
    want = jax_block_gs.block_gs_project_gram(vj, jnp.asarray(w),
                                              jnp.asarray(tin),
                                              interpret=True)
    got = block_gs.block_gs_project_gram(convert.tensor(vj, "cpu"),
                                         torch.from_numpy(w),
                                         torch.from_numpy(tin))
    for g, wt in zip(got, want):
        assert _rel(g.numpy(), np.asarray(wt)) < BAR[name]


@pytest.mark.parametrize("name,tdtype,jdtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("n,m1,k_start,s", [(1027, 9, 0, 5),
                                            (300, 70, 69, 8)])
def test_project_matches_jax(n, m1, k_start, s, name, tdtype, jdtype):
    v, w, tin = _inputs(n, m1, s, n + k_start)
    vj = jnp.asarray(v).astype(jdtype)
    mask = jnp.asarray((np.arange(m1) <= k_start).astype(np.float32))
    qj, cj = jax_block_gs.block_gs_project(vj, jnp.asarray(w),
                                           jnp.asarray(tin), mask,
                                           interpret=True)
    qt, ct = block_gs.block_gs_project(convert.tensor(vj, "cpu"),
                                       torch.from_numpy(w),
                                       torch.from_numpy(tin), k_start)
    assert _rel(qt.numpy(), np.asarray(qj)) < BAR[name]
    assert _rel(ct.numpy(), np.asarray(cj)) < BAR[name]
    assert not ct[k_start + 1:].any()
