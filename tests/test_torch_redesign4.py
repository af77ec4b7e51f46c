"""The ILU(0) setup's wavefront and ``batched_cgs2``'s work split, on the CPU.

The kernels run only on the card (``tests/test_torch_cuda.py``); what
surrounds them is pure Python and is held here:

- the ILU(0) setup's dependency rule (``tuning.ilu0_plan``: which lower
  offsets a row always waits for, the tiles a warp takes), replayed in
  torch in the kernel's order (``_wave_replay``: tiles in ticket order,
  groups of 32 rows, rounds of the rows whose dependencies are done, a
  unit-diagonal row wherever the rule cuts one) and held bit for bit to
  ``ilu0_factor_plain``; a pattern whose zero entry an elimination fills
  shows that the rule must wait there;
- the same factors against JAX's ``_ilu0_factor`` at
  ``tests/test_torch_precond.py``'s tolerance (rtol 3e-5, atol 3e-5 of
  the largest factor entry);
- ``batched_cgs2``'s split of the cooperative grid over the lanes
  (``tuning.batched_cgs2_split``): at least one block an active lane, none
  for a lane at -1, in proportion to the rows within one block, at most
  the co-resident blocks, and the kernel's loops over 16-byte pieces and
  scalar columns, replayed in numpy, covering each lane's columns once;
- the wrapper on the CPU (its plain version) against JAX's
  ``batched_cgs2`` (interpret) at the kernel's edge shapes.  Tolerances:
  float32 rtol = atol = 3e-5, bfloat16 storage 2e-2
  (``tests/test_torch_batched.py``'s).
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import stencils as jax_stencils  # noqa: E402
from repro.kernels import block_gs as jax_block_gs  # noqa: E402
from repro.kernels import trisolve as jax_tri  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import stencils  # noqa: E402
from repro_torch.kernels import block_gs, trisolve, tuning  # noqa: E402

F32 = dict(rtol=3e-5, atol=3e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)


# --------------------------------------------------------------------------
# the ILU(0) setup
# --------------------------------------------------------------------------
def _random_pattern(n, offsets, seed, zero_share=0.3):
    """Bands with entries in [-0.5, 0.5), a dominant diagonal, and about
    ``zero_share`` of the off-diagonal entries zero."""
    rng = np.random.default_rng(seed)
    b = rng.random((len(offsets), n), dtype=np.float32) - np.float32(0.5)
    b[offsets.index(0)] += np.float32(3.0)
    for d, off in enumerate(offsets):
        if off != 0:
            b[d] *= rng.random(n) > zero_share
    return b


def _ilu_case(name):
    """(bands float32 numpy, offsets) of each case."""
    if name == "five-point 32^2":
        op = stencils.convection_diffusion_2d(32, 32, device="cpu")
        return op.bands.numpy(), op.offsets
    if name == "seven-point 8^3":
        op = stencils.poisson_3d(8, 8, 8, device="cpu")
        return op.bands.numpy(), op.offsets
    if name == "line-Jacobi 48^2":
        op = stencils.convection_diffusion_2d(48, 48, device="cpu")
        return np.ascontiguousarray(op.bands.numpy()[1:4]), (-1, 0, 1)
    if name == "random (-2, -1, 0)":
        return _random_pattern(700, (-2, -1, 0), 1), (-2, -1, 0)
    # (-3, -2, 0, 1): eliminating -3 writes slot -3 + 1 = -2, so a row
    # whose -2 entry is zero must still wait for row i - 2
    offs = (-3, -2, 0, 1)
    b = _random_pattern(300, offs, 2)
    b[1, ::3] = 0.0
    return b, offs


ILU_CASES = ("five-point 32^2", "seven-point 8^3", "line-Jacobi 48^2",
             "random (-2, -1, 0)", "filled zero (-3, -2, 0, 1)")


def _wave_replay(bands, offsets, wait=None):
    """The ILU(0) kernel's order on the CPU: tiles of ``tile_rows`` rows in
    ticket order (a tile's dependencies on earlier tiles are then done),
    groups of ILU_GROUP rows, and rounds in which every row of the group
    whose dependencies are done (the previous rounds' rows, earlier
    groups, earlier tiles) is factored at once.  Row i waits for row
    i + l where the plan says always (``wait``) or a[i, l] != 0, and
    eliminates against a unit-diagonal row where it does not wait.  Each
    row's arithmetic is the kernel's (float32, no fused multiply-add).
    Returns (l_bands, u_bands) and the rounds of each group."""
    offsets = tuple(offsets)
    n = bands.shape[1]
    plan = tuning.ilu0_plan(offsets)
    wait = plan["wait"] if wait is None else wait
    idx = {o: d for d, o in enumerate(offsets)}
    upper = sorted(o for o in offsets if o > 0)
    a = trisolve._mask_oob(bands.float(), offsets).T.contiguous()
    seed = torch.zeros(len(offsets))
    seed[idx[0]] = 1.0
    need = {lo: ((a[:, idx[lo]] != 0) | w) & (torch.arange(n) + lo >= 0)
            for lo, w in zip(plan["lower"], wait)}
    fact = torch.full_like(a, float("nan"))
    done = torch.zeros(n, dtype=torch.bool)
    eps = torch.finfo(torch.float32).eps
    guard = torch.tensor(torch.finfo(torch.float32).tiny ** 0.5)
    rounds = []
    tile = plan["tile_rows"]
    for t0 in range(0, n, tile):
        t1 = min(n, t0 + tile)
        for g0 in range(t0, t1, tuning.ILU_GROUP):
            group = torch.arange(g0, min(t1, g0 + tuning.ILU_GROUP))
            count = 0
            while not done[group].all():
                ready = ~done[group]
                for lo in plan["lower"]:
                    k = (group + lo).clamp(min=0)
                    ready &= ~need[lo][group] | done[k]
                rows = group[ready]
                assert rows.numel(), "no row of the group can go: deadlock"
                row = a[rows].clone()
                for lo in plan["lower"]:
                    dep = need[lo][rows][:, None]
                    krow = torch.where(dep, fact[(rows + lo).clamp(min=0)],
                                       seed)
                    lik = row[:, idx[lo]] / krow[:, idx[0]]
                    row[:, idx[lo]] = lik
                    for up in upper:
                        if up + lo in idx:
                            row[:, idx[up + lo]] = (row[:, idx[up + lo]]
                                                    + (-lik * krow[:, idx[up]]))
                piv = row[:, idx[0]]
                floor = torch.maximum(row.abs().amax(dim=1) * eps, guard)
                row[:, idx[0]] = torch.where(piv.abs() >= floor, piv,
                                             torch.where(piv < 0, -floor,
                                                         floor))
                fact[rows] = row
                done[rows] = True
                count += 1
            rounds.append(count)
    return trisolve._split(fact.T, offsets), rounds


@pytest.mark.parametrize("case", ILU_CASES)
def test_wave_order_gives_the_plain_bits(case):
    bands, offs = _ilu_case(case)
    got, rounds = _wave_replay(torch.from_numpy(bands), offs)
    want = trisolve.ilu0_factor_plain(torch.from_numpy(bands), offs)
    for g, w in zip(got, want):
        assert torch.equal(g, w), case
    assert max(rounds) <= tuning.ILU_GROUP
    if case == "line-Jacobi 48^2":
        # the -1 chain inside a grid line takes a round a row: a group
        # takes as many rounds as its longest piece of a line
        n, g = bands.shape[1], tuning.ILU_GROUP
        want_rounds = [max(len(seg) for seg in np.split(
            np.arange(g0, min(n, g0 + g)),
            [i - g0 for i in range(g0 + 1, min(n, g0 + g)) if i % 48 == 0]))
            for g0 in range(0, n, g)]
        assert rounds == want_rounds


def test_wave_must_wait_where_an_elimination_fills_a_zero():
    bands, offs = _ilu_case("filled zero (-3, -2, 0, 1)")
    plan = tuning.ilu0_plan(offs)
    assert plan["wait"] == (False, True) and plan["wait_mask"] == 2
    want = trisolve.ilu0_factor_plain(torch.from_numpy(bands), offs)
    got, _ = _wave_replay(torch.from_numpy(bands), offs, wait=(False, False))
    assert not all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("offsets,tile", [
    ((-1024, -1, 0, 1, 1024), 1024),              # a tile a grid line
    ((-1, 0, 1), tuning.ILU_MAX_TILE),            # no far offset
    ((-64, -8, -1, 0, 1, 8, 64), 64),             # 8^3: a tile a plane
    ((-256, -16, -1, 0, 1, 16, 256), 256),
    ((-10_000, -100, -1, 0, 1, 100, 10_000), 100),
    ((-3000, -1, 0), tuning.ILU_MAX_TILE),
    ((-2, -1, 0), tuning.ILU_MAX_TILE),
    ((0,), tuning.ILU_MAX_TILE)])
def test_ilu0_plan_tiles(offsets, tile):
    plan = tuning.ilu0_plan(offsets)
    assert plan["tile_rows"] == tile
    assert plan["lower"] == tuple(sorted(o for o in offsets if o < 0))
    # a five-point or seven-point pattern fills no lower slot
    assert not any(plan["wait"])


@pytest.mark.parametrize("case", ILU_CASES)
def test_ilu0_matches_jax(case):
    bands, offs = _ilu_case(case)
    want = jax_tri.banded_ilu0(jnp.asarray(bands), offs)
    got = trisolve.banded_ilu0(torch.from_numpy(bands), offs)
    for g, w in ((got[0], want[0]), (got[2], want[2])):
        w = np.asarray(w)
        scale = max(float(np.abs(w).max()) if w.size else 1.0, 1e-30)
        np.testing.assert_allclose(g.numpy(), w, rtol=3e-5,
                                   atol=3e-5 * scale)


def test_ilu0_seven_point_matches_jax_stencil():
    op_j = jax_stencils.poisson_3d(8)
    op = stencils.poisson_3d(8, device="cpu")
    assert op.offsets == op_j.offsets
    np.testing.assert_array_equal(op.bands.numpy(), np.asarray(op_j.bands))


# --------------------------------------------------------------------------
# batched_cgs2's split of the grid
# --------------------------------------------------------------------------
def _check_split(js, n, elem, aligned, budget):
    s = tuning.batched_cgs2_split(js, n, elem, aligned, budget)
    blocks, cap = s["blocks"], s["cap"]
    active = [lane for lane, j in enumerate(js) if j >= 0]
    assert all(blocks[lane] == 0 for lane in range(len(js))
               if lane not in active)
    assert all(1 <= blocks[lane] <= cap[lane] for lane in active)
    assert sum(blocks) <= budget and s["first"][-1] == sum(blocks)
    assert s["first"] == list(np.cumsum([0] + blocks))
    assert s["grid"] == (sum(blocks) if active
                         else max(1, min(budget, len(js))))
    # the budget is used up unless every lane is at its cap
    assert sum(blocks) == min(budget, sum(cap[lane] for lane in active))
    # in proportion to the rows within one block: no lane could hand a
    # block to another lane below its cap and both come nearer their
    # shares
    for a in active:
        for b in active:
            if a != b and blocks[a] > 1 and blocks[b] < cap[b]:
                wa, wb = js[a] + 1, js[b] + 1
                assert (blocks[a] - 1) / wa <= (blocks[b] + 1) / wb + 1e-12
    return s


def _lane_hits(s, n, elem, rows, lane):
    """How often the kernel's loops visit each column of a lane: thread t
    of the lane's G takes pieces p0 = t, t + U G, ... and p0 + u G
    (u < U), then the scalar columns pieces * vec + t, + G, ..."""
    g = s["blocks"][lane] * s["threads"]
    u = tuning.batched_unroll(rows, elem)[1]
    vec, pieces = s["vec"], s["pieces"]
    hits = np.zeros(n, np.int64)
    t = np.arange(g)
    for p0 in range(0, max(pieces, 1), u * g):
        for q in range(u):
            p = p0 + t + q * g
            p = p[p < pieces]
            for c in range(vec):
                np.add.at(hits, p * vec + c, 1)
    for c0 in range(pieces * vec, n, g):
        c = c0 + t
        np.add.at(hits, c[c < n], 1)
    return hits


# the co-resident blocks of batched_cgs2 on an H100: two an SM (fixed in
# csrc/batched_cgs2.cu)
H100_BLOCKS = 2 * tuning.H100_SMS


@pytest.mark.parametrize("elem", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("js,n", [
    ((0, 7, 15, 29), 1 << 20),
    ((15, 15, 15, 15), 1 << 20),
    ((0, 3, 7, 12, 15, 20, 25, 29), 8192),
    ((-1, -1, -1), 5000),
    ((12,), 1001),
    ((-1, 4, -1, 30, 0), 100_003),
    ((0,) * 264, 8192),                       # as many lanes as blocks
    ((29,) + (-1,) * 300, 4096)])
def test_batched_split_rule(js, n, elem):
    budget = H100_BLOCKS
    for aligned in (True, False):
        s = _check_split(js, n, elem, aligned, budget)
        vec = 16 // elem
        assert s["vec"] == vec
        assert s["pieces"] == (n // vec if aligned else 0)
        assert s["pieces"] * vec + s["tail"] == n
        assert s["route"] == ("vec" if s["pieces"] else "scalar")
        for lane, j in enumerate(js):
            if j >= 0 and lane < 8:
                assert (_lane_hits(s, n, elem, j + 1, lane) == 1).all()


def test_batched_split_gives_the_heavy_lane_the_most_blocks():
    budget = H100_BLOCKS
    s = tuning.batched_cgs2_split((0, 7, 15, 29), 1 << 20, 4, True, budget)
    assert s["grid"] == budget
    assert s["blocks"][3] > s["blocks"][2] > s["blocks"][1] > s["blocks"][0]
    # one lane alone takes the whole budget; the PageRank burst's lanes
    # stop at their caps (a round of pieces a thread)
    assert tuning.batched_cgs2_split((29,), 1 << 20, 4, True,
                                     budget)["blocks"] == [budget]
    s = tuning.batched_cgs2_split((0, 3, 7, 12, 15, 20, 25, 29), 8192, 4,
                                  True, budget)
    assert s["blocks"] == s["cap"] and s["grid"] < budget


def test_batched_split_refuses_more_active_lanes_than_blocks():
    with pytest.raises(ValueError, match="active lanes exceed"):
        tuning.batched_cgs2_split((0,) * 11, 100, 4, True, 10)
    # lanes at -1 do not count
    s = tuning.batched_cgs2_split((0,) * 10 + (-1,) * 50, 100, 4, True, 10)
    assert s["grid"] == 10


@pytest.mark.parametrize("rows,elem,want", [
    (1, 4, (2, 8)), (1, 2, (2, 4)), (2, 4, (2, 8)), (3, 4, (32, 1)),
    (8, 2, (32, 1)), (30, 4, (32, 1)), (41, 2, (32, 1))])
def test_batched_unroll_keeps_the_loads_in_flight(rows, elem, want):
    r, u = tuning.batched_unroll(rows, elem)
    assert (r, u) == want
    assert u * min(r, tuning.BATCHED_SLOTS) <= tuning.BATCHED_SLOTS
    assert u * 16 // elem <= 32


# --------------------------------------------------------------------------
# batched_cgs2 against JAX at the kernel's edge shapes
# --------------------------------------------------------------------------
def _bases(k, m1, n, js, seed=0):
    rng = np.random.default_rng(seed)
    v = np.zeros((k, m1, n), np.float32)
    for lane, j in enumerate(js):
        if j >= 0:
            q, _ = np.linalg.qr(rng.standard_normal((n, j + 1)))
            v[lane, :j + 1] = q.T
    return v


@pytest.mark.parametrize("dtype,tol", [(jnp.float32, F32),
                                       (jnp.bfloat16, BF16)])
@pytest.mark.parametrize("js,n", [
    ((4, -1, 11, 0), 301),                # n off the 16-byte piece
    ((-1, -1), 64),                       # every lane skipped
    ((0, 7, 11), 1024)])
def test_batched_cgs2_matches_jax_at_the_edges(js, n, dtype, tol):
    k, m1 = len(js), 12
    v = _bases(k, m1, n, js)
    w = np.random.default_rng(1).standard_normal((k, n)).astype(np.float32)
    v_j = jnp.asarray(v).astype(dtype)
    mask = block_gs.row_masks(js, m1).numpy()
    h_j, w_j = jax_block_gs.batched_cgs2(v_j, jnp.asarray(w),
                                         jnp.asarray(mask), interpret=True)
    h_t, w_t = block_gs.batched_cgs2(convert.tensor(v_j, "cpu"),
                                     torch.from_numpy(w), js)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), **tol)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), **tol)
    for lane, j in enumerate(js):
        if j < 0:
            assert not h_t[lane].any()
            np.testing.assert_array_equal(w_t[lane].numpy(), w[lane])
