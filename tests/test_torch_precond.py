"""The port's preconditioning slice vs the JAX package, on the CPU.

Kernels: each port wrapper runs its plain version (the tensors lie on the
CPU) on inputs made with numpy from a seed.  ``banded_cheb_apply`` is held
against the JAX kernel in interpret mode and against the JAX member's
``_apply_ref``; ``banded_trisweep`` against the JAX ``banded_trisweep_ref``
(vmapped for k lanes; the JAX trisweep kernel calls ``pl.load``, which the
installed jax no longer has); the ILU(0) setup against the JAX
``trisolve.banded_ilu0`` element by element.

Members: the interval estimate, the Chebyshev scalars, every member's
apply and cost, the registry, and ``convert.preconditioner`` (JAX state
carried across, the applies compared on identical state).

Solves: the port's ``gmres`` (default and pipelined Gram-Schmidt),
``gmres_sstep`` and ``gmres_batched`` with a preconditioner, on operators
carried across with ``convert.operator``, against the JAX solvers; the
JAX package runs ILU(0), line-Jacobi and banded block-Jacobi under
``force_kernel_mode("ref")`` (the same ``pl.load`` fault).

Tolerances: float32 rtol = atol = 3e-5 (the JAX package's kernel
contract: the port sums in another order, and the sweep scans where the
reference substitutes row by row), bfloat16 bands 2e-2; the ILU(0) factors
atol 3e-5 of the largest factor entry (so c A at c = 1e-6 is held as
tightly as A); the interval 1e-5 relative; solves converged, restarts
within +-1 and x within rtol 1e-3 / atol 1e-4 (the JAX package's
preconditioned-parity contract, ``tests/test_precond.py``), batched lanes
each against the JAX batched output.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import operators as jax_ops  # noqa: E402
from repro.core import preconditioners as JP  # noqa: E402
from repro.core.gmres import gmres as jax_gmres  # noqa: E402
from repro.core.gmres import (  # noqa: E402
    gmres_batched as jax_gmres_batched)
from repro.core.sstep import gmres_sstep as jax_gmres_sstep  # noqa: E402
from repro.core import stencils as jax_stencils  # noqa: E402
from repro.kernels import matrix_powers as jax_mp  # noqa: E402
from repro.kernels import trisolve as jax_tri  # noqa: E402
from repro.kernels import tuning as jax_tuning  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import gmres, gmres_batched, gmres_sstep  # noqa: E402
from repro_torch.core import operators  # noqa: E402
from repro_torch.core import preconditioners as P  # noqa: E402
from repro_torch.kernels import matrix_powers, trisolve  # noqa: E402

F32 = dict(rtol=3e-5, atol=3e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
SOLVE = dict(rtol=1e-3, atol=1e-4)
STENCILS = {
    "poisson": lambda nx: jax_stencils.poisson_2d(nx),
    "convdiff": lambda nx: jax_stencils.convection_diffusion_2d(
        nx, beta=(0.3, 0.2)),
}
# The JAX members whose Pallas kernel fails on the installed jax run in
# ref mode (queue 3 of ROADMAP.md).
REF_MODE = ("banded_ilu0", "line_jacobi", "banded_block_jacobi")


def _np(t):
    return convert.to_numpy(t).astype(np.float32)


def _vec(n, seed, k=None):
    shape = (n,) if k is None else (k, n)
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _mode(name):
    return jax_tuning.force_kernel_mode("ref" if name in REF_MODE
                                        else "interpret")


def _sym_banded(seed, n, halo):
    """Random symmetric diagonally dominant band stack (SPD), as the JAX
    tests' ``_sym_banded``, from numpy."""
    offs = tuple(range(-halo, halo + 1))
    vals = np.random.default_rng(seed).uniform(0.1, 1.0, (halo, n))
    rows = []
    for off in offs:
        if off == 0:
            rows.append(np.zeros(n))
        elif off > 0:
            rows.append(-vals[off - 1])
        else:
            rows.append(-np.roll(vals[-off - 1], -off))
    bands = np.array(jax_tri._mask_oob(jnp.asarray(np.stack(rows)), offs))
    bands[offs.index(0)] = np.abs(bands).sum(axis=0) + 0.5
    return bands.astype(np.float32), offs


# --------------------------------------------------------------------------
# kernels
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype,tol", [(jnp.float32, F32),
                                       (jnp.bfloat16, BF16)])
@pytest.mark.parametrize("order", [2, 4, 5])
@pytest.mark.parametrize("stencil,nx", [("poisson", 8), ("convdiff", 16)])
def test_banded_cheb_apply_matches_jax(stencil, nx, order, dtype, tol):
    op_j = STENCILS[stencil](nx)
    pc_j = JP.chebyshev(op_j, order=order)
    bands_j = op_j.bands.astype(dtype)
    v = _vec(nx * nx, order)
    ker = jax_mp.banded_cheb_apply(bands_j, jnp.asarray(v), op_j.offsets,
                                   theta=pc_j.theta, delta=pc_j.delta,
                                   rhos=pc_j.rhos, interpret=True)
    ref = pc_j._apply_ref(jnp.asarray(v),
                          jax_ops.BandedOperator(bands_j, op_j.offsets))
    got = matrix_powers.banded_cheb_apply(
        convert.tensor(bands_j, "cpu"), torch.from_numpy(v), op_j.offsets,
        theta=pc_j.theta, delta=pc_j.delta, rhos=pc_j.rhos)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(ker, np.float32), **tol)
    np.testing.assert_allclose(_np(got), np.asarray(ref, np.float32), **tol)


def test_banded_cheb_apply_checks_its_arguments():
    bands = torch.ones(3, 10)
    with pytest.raises(TypeError):
        matrix_powers.banded_cheb_apply(bands, torch.ones(10), (-1, 0),
                                        theta=1.0, delta=0.5, rhos=())
    with pytest.raises(TypeError):
        matrix_powers.banded_cheb_apply(bands, torch.ones(9), (-1, 0, 1),
                                        theta=1.0, delta=0.5, rhos=())


TRI_CASES = ["random-lower-unit", "random-lower", "random-upper",
             "poisson-L", "poisson-U", "convdiff-L", "convdiff-U"]


def _tri_case(name):
    """(bands (numpy), offsets, unit, lower): the three directions of the
    JAX ``test_trisweep_kernel_matches_ref`` on a random pattern, and the
    ILU(0) factors of both stencils."""
    if name.startswith("random"):
        lower, unit = name != "random-upper", name.endswith("unit")
        offs = (-2, -1, 0) if lower else (0, 1, 2)
        bands = np.random.default_rng(7).uniform(0.2, 1.0, (3, 200)) \
            .astype(np.float32)
        bands[offs.index(0)] += 2.0
        return (np.array(jax_tri._mask_oob(jnp.asarray(bands), offs)),
                offs, unit, lower)
    stencil, side = name.split("-")
    op_j = STENCILS[stencil](8 if stencil == "poisson" else 16)
    lb, lo, ub, uo = jax_tri.banded_ilu0(op_j.bands, op_j.offsets)
    if side == "L":
        return np.array(lb), lo, True, True
    return np.array(ub), uo, False, False


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("case", TRI_CASES)
def test_banded_trisweep_matches_jax_ref(case, k):
    bands, offs, unit, lower = _tri_case(case)
    n = bands.shape[1]
    v = _vec(n, 11, k=None if k == 1 else k)
    sweep = functools.partial(jax_tri.banded_trisweep_ref, jnp.asarray(bands),
                              offsets=offs, unit_diag=unit, lower=lower)
    want = sweep(jnp.asarray(v)) if k == 1 else jax.vmap(sweep)(
        jnp.asarray(v))
    got = trisolve.banded_trisweep(torch.from_numpy(bands),
                                   torch.from_numpy(v), offs,
                                   unit_diag=unit, lower=lower)
    assert tuple(got.shape) == v.shape
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)


def test_banded_trisweep_checks_its_arguments():
    bands = torch.ones(2, 8)
    v = torch.ones(8)
    with pytest.raises(ValueError):      # an upper offset in a lower sweep
        trisolve.banded_trisweep(bands, v, (-1, 1), unit_diag=True,
                                 lower=True)
    with pytest.raises(ValueError):      # non-unit without the diagonal
        trisolve.banded_trisweep(bands, v, (-2, -1), unit_diag=False,
                                 lower=True)
    with pytest.raises(TypeError):
        trisolve.banded_trisweep(bands, torch.ones(7), (-1, 0),
                                 unit_diag=False, lower=True)
    empty = trisolve.banded_trisweep(torch.zeros(0, 8), v, (),
                                     unit_diag=True, lower=True)
    np.testing.assert_array_equal(_np(empty), _np(v))


ILU_CASES = ["poisson6", "convdiff16", "line_jacobi", "sym-halo1",
             "sym-halo2", "sym-halo3", "convdiff16x1e-06", "convdiff16x1e+06"]


def _ilu_case(name):
    """(bands (numpy float32), offsets) of an ILU(0) case."""
    if name.startswith("sym"):
        halo = int(name[-1])
        return _sym_banded(halo, 60, halo)
    if name == "poisson6":
        op_j = jax_stencils.poisson_2d(6)
        return np.array(op_j.bands), op_j.offsets
    cd = STENCILS["convdiff"](16)
    bands = np.asarray(cd.bands)
    if name == "line_jacobi":
        return np.ascontiguousarray(bands[1:4]), (-1, 0, 1)
    c = float(name.split("x")[1]) if "x" in name else 1.0
    return (bands * np.float32(c)).astype(np.float32), cd.offsets


@pytest.mark.parametrize("case", ILU_CASES)
def test_banded_ilu0_matches_jax(case):
    bands, offs = _ilu_case(case)
    want = jax_tri.banded_ilu0(jnp.asarray(bands), offs)
    got = trisolve.banded_ilu0(torch.from_numpy(bands), offs)
    assert got[1] == want[1] and got[3] == want[3]
    for g, w in ((got[0], want[0]), (got[2], want[2])):
        w = np.asarray(w)
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        scale = max(float(np.abs(w).max()) if w.size else 1.0, 1e-30)
        np.testing.assert_allclose(_np(g), w, rtol=3e-5, atol=3e-5 * scale)


def test_banded_ilu0_factors_bf16_bands_in_f32():
    op_j = STENCILS["convdiff"](8)
    bands = op_j.bands.astype(jnp.bfloat16)
    want = jax_tri.banded_ilu0(bands, op_j.offsets)
    got = trisolve.banded_ilu0(convert.tensor(bands, "cpu"), op_j.offsets)
    for g, w in ((got[0], want[0]), (got[2], want[2])):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(_np(g), np.asarray(w), **F32)


def test_ilu0_tridiagonal_is_exact():
    """On a tridiagonal pattern ILU(0) is the LU factorization (the JAX
    test of the same name, on the port)."""
    bands, offs = _sym_banded(0, 48, 1)
    op = operators.BandedOperator(bands, offs, device="cpu")
    v = _vec(48, 1)
    exact = np.linalg.solve(op.todense().double().numpy(), v)
    got = P.banded_ilu0(op)(torch.from_numpy(v))
    np.testing.assert_allclose(_np(got), exact, rtol=2e-4, atol=2e-4)


# --------------------------------------------------------------------------
# members
# --------------------------------------------------------------------------
@pytest.mark.parametrize("stencil,fmt", [("poisson", "banded"),
                                         ("convdiff", "banded"),
                                         ("convdiff", "ell")])
def test_estimate_interval_and_coeffs_match_jax(stencil, fmt):
    op_j = STENCILS[stencil](8)
    if fmt == "ell":
        op_j = op_j.to_ell()
    op = convert.operator(op_j, "cpu")
    lo, hi = P.estimate_interval(op)
    lo_j, hi_j = JP.estimate_interval(op_j)
    np.testing.assert_allclose([lo, hi], [lo_j, hi_j], rtol=1e-5)
    eigs = np.linalg.eigvals(np.asarray(op_j.todense(), np.float64))
    assert hi >= float(eigs.real.max()) - 1e-4 and 0.0 < lo < hi
    for order in (1, 4, 7):
        th, de, rh = P.cheb_coeffs(order, lo, hi)
        th_j, de_j, rh_j = JP.cheb_coeffs(order, lo_j, hi_j)
        np.testing.assert_allclose([th, de], [th_j, de_j], rtol=1e-5)
        assert len(rh) == order - 1
        np.testing.assert_allclose(np.asarray(rh).reshape(-1),
                                   np.asarray(rh_j).reshape(-1), rtol=1e-5)


def test_estimate_interval_falls_back_to_the_rayleigh_radius():
    """One outlier row makes Gershgorin pathologically loose: lam_max falls
    back to slack/2 x the power-iteration radius, as in JAX."""
    a = np.diag(np.linspace(1.0, 2.0, 64)).astype(np.float32)
    a[0, 1:] = 0.5
    lo_j, hi_j = JP.estimate_interval(jax_ops.DenseOperator(jnp.asarray(a)))
    lo, hi = P.estimate_interval(torch.from_numpy(a))
    np.testing.assert_allclose([lo, hi], [lo_j, hi_j], rtol=1e-5)
    assert hi < float(np.abs(a).sum(axis=1).max())


def _dense_system(n=64, seed=3):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)).astype(np.float32) / n
    a += np.diag(2.0 + rng.uniform(size=n)).astype(np.float32)
    return a


MEMBERS = {
    "jacobi": lambda mod, op, a: mod.jacobi(op),
    "block_jacobi": lambda mod, op, a: mod.block_jacobi(a, 16),
    "neumann": lambda mod, op, a: mod.neumann(op, order=3, omega=0.9),
    "chebyshev": lambda mod, op, a: mod.chebyshev(op, order=5),
}


@pytest.mark.parametrize("name", sorted(MEMBERS))
def test_member_applies_and_costs_match_jax(name):
    a = _dense_system()
    op_j = jax_ops.DenseOperator(jnp.asarray(a))
    op = operators.DenseOperator(torch.from_numpy(a), device="cpu")
    pc_j = MEMBERS[name](JP, op_j, jnp.asarray(a))
    pc = MEMBERS[name](P, op, torch.from_numpy(a))
    assert type(pc).__name__ == type(pc_j).__name__ and pc.n == pc_j.n
    assert (pc.name, pc.shard_aware, pc.requires_fmt) == \
        (pc_j.name, pc_j.shard_aware, pc_j.requires_fmt)
    v = _vec(64, 5)
    vs = _vec(64, 6, k=3)
    np.testing.assert_allclose(_np(pc(torch.from_numpy(v))),
                               np.asarray(pc_j(jnp.asarray(v))), **F32)
    np.testing.assert_allclose(_np(pc.batched(torch.from_numpy(vs))),
                               np.asarray(pc_j.batched(jnp.asarray(vs))),
                               **F32)
    np.testing.assert_allclose(np.asarray(tuple(vars(pc.cost()).values())),
                               np.asarray(tuple(vars(pc_j.cost()).values())),
                               rtol=1e-6)


def test_jacobi_guards_a_zero_diagonal():
    bands = np.array([[0.0, 2.0, -1e-30, 4.0]], np.float32)
    pc_j = JP.jacobi(jax_ops.BandedOperator(jnp.asarray(bands), (0,)))
    pc = P.jacobi(operators.BandedOperator(bands, (0,), device="cpu"))
    np.testing.assert_allclose(_np(pc.inv_d), np.asarray(pc_j.inv_d),
                               rtol=1e-6)
    assert bool(torch.isfinite(pc.inv_d).all())


@pytest.mark.parametrize("name", ["jacobi", "chebyshev", "banded_ilu0",
                                  "line_jacobi", "banded_block_jacobi",
                                  "neumann", "none"])
def test_convert_carries_state_and_applies_match(name):
    op_j = STENCILS["convdiff"](16)
    with _mode(name):
        pc_j = JP.make_preconditioner(name, op_j)
        vs = _vec(256, 9, k=2)
        want = pc_j(jnp.asarray(vs[0]))
        want_b = pc_j.batched(jnp.asarray(vs))
    pc = convert.preconditioner(pc_j, "cpu")
    assert type(pc).__name__ == type(pc_j).__name__
    np.testing.assert_allclose(_np(pc(torch.from_numpy(vs[0]))),
                               np.asarray(want), **F32)
    np.testing.assert_allclose(_np(pc.batched(torch.from_numpy(vs))),
                               np.asarray(want_b), **F32)


def test_convert_carries_block_jacobi_pivots():
    a = _dense_system()
    pc_j = JP.block_jacobi(jnp.asarray(a), 16)
    pc = convert.preconditioner(pc_j, "cpu")
    v = _vec(64, 2)
    np.testing.assert_allclose(_np(pc(torch.from_numpy(v))),
                               np.asarray(pc_j(jnp.asarray(v))), **F32)


def test_registry_matches_jax_and_rejects():
    assert sorted(P.PRECONDITIONERS) == sorted(JP.PRECONDITIONERS)
    op_j = STENCILS["poisson"](8)
    op = convert.operator(op_j, "cpu")
    for name in sorted(JP.PRECONDITIONERS):
        if name == "block_jacobi":
            continue               # dense only: the member test covers it
        with _mode(name):
            pc_j = JP.make_preconditioner(name, op_j)
        pc = P.make_preconditioner(name, op)
        assert type(pc).__name__ == type(pc_j).__name__, name
        assert pc.is_identity == pc_j.is_identity
    with pytest.raises(ValueError, match="unknown preconditioner"):
        P.make_preconditioner("ilu7", op)
    dense = operators.DenseOperator(op.todense(), device="cpu")
    with pytest.raises(ValueError, match="BandedOperator"):
        P.make_preconditioner("banded_ilu0", dense)
    with pytest.raises(ValueError, match="diagonal"):
        P.BandedILU0Preconditioner(op, pattern=(-1, 1))


def test_rebind_is_local_or_raises():
    op = convert.operator(STENCILS["poisson"](8), "cpu")
    for name in ("jacobi", "chebyshev", "neumann", "banded_block_jacobi",
                 "none"):
        pc = P.make_preconditioner(name, op)
        assert type(pc.rebind(op)) is type(pc)
    with pytest.raises(ValueError, match="not shard-aware"):
        P.banded_ilu0(op).rebind(op)
    # a dense (rows, n) shard: the diagonal of its own diagonal block
    # (rank 0 outside a shard context)
    shard = operators.DenseOperator(torch.arange(1., 33.).reshape(4, 8),
                                    device="cpu")
    pc = P.jacobi(operators.DenseOperator(torch.eye(8), device="cpu")) \
        .rebind(shard)
    assert pc.n == 4
    torch.testing.assert_close(pc.inv_d, 1 / torch.tensor([1., 10., 19., 28.]))


# --------------------------------------------------------------------------
# solves
# --------------------------------------------------------------------------
SOLVE_PCS = ("chebyshev", "banded_ilu0", "line_jacobi", "jacobi")


def _rhs(n, seed=1):
    return _vec(n, seed)


@functools.lru_cache(maxsize=None)
def _jax_solve(solver, stencil, nx, name, gs="cgs2"):
    op_j = STENCILS[stencil](nx)
    b = jnp.asarray(_rhs(nx * nx))
    with _mode(name):
        pc = JP.make_preconditioner(name, op_j)
        if solver == "gmres":
            res = jax_gmres(op_j, b, m=16, tol=1e-5,
                                      max_restarts=100, gs=gs, precond=pc)
        else:
            res = jax_gmres_sstep(op_j, b, s=4, blocks=4, tol=1e-5,
                                        max_restarts=60, precond=pc)
    return convert.result_to_numpy(res)


def _check_solve(res, ref):
    assert res.converged and bool(ref["converged"])
    assert abs(res.restarts - int(ref["restarts"])) <= 1
    np.testing.assert_allclose(_np(res.x), ref["x"], **SOLVE)


@pytest.mark.parametrize("nx", [8, 16])
@pytest.mark.parametrize("stencil", sorted(STENCILS))
@pytest.mark.parametrize("name", SOLVE_PCS)
def test_gmres_with_precond_matches_jax(name, stencil, nx):
    op = convert.operator(STENCILS[stencil](nx), "cpu")
    pc = P.make_preconditioner(name, op)
    res = gmres(op, torch.from_numpy(_rhs(nx * nx)), m=16, tol=1e-5,
                max_restarts=100, precond=pc)
    _check_solve(res, _jax_solve("gmres", stencil, nx, name))


@pytest.mark.parametrize("stencil", sorted(STENCILS))
def test_preconditioners_cut_restarts(stencil):
    """The JAX tests' contract on the port: Chebyshev, ILU(0) and
    line-Jacobi take strictly fewer restarts than no preconditioner."""
    op = convert.operator(STENCILS[stencil](16), "cpu")
    b = torch.from_numpy(_rhs(256))
    plain = gmres(op, b, m=16, tol=1e-5, max_restarts=100)
    for name in ("chebyshev", "banded_ilu0", "line_jacobi"):
        res = gmres(op, b, m=16, tol=1e-5, max_restarts=100,
                    precond=P.make_preconditioner(name, op))
        assert res.converged and res.restarts < plain.restarts, name
        rel = float((res.x - plain.x).norm() / plain.x.norm())
        assert rel < 1e-3


def test_pipelined_gs_with_chebyshev_matches_jax():
    op = convert.operator(STENCILS["poisson"](8), "cpu")
    pc = P.chebyshev(op, order=4)
    res = gmres(op, torch.from_numpy(_rhs(64)), m=16, tol=1e-5,
                max_restarts=100, gs="cgs2_pipelined", precond=pc)
    _check_solve(res, _jax_solve("gmres", "poisson", 8, "chebyshev",
                                 gs="cgs2_pipelined"))
    split = gmres(op, torch.from_numpy(_rhs(64)), m=16, tol=1e-5,
                  max_restarts=100, precond=pc)
    assert res.restarts == split.restarts


@pytest.mark.parametrize("stencil", sorted(STENCILS))
@pytest.mark.parametrize("name", ["chebyshev", "banded_ilu0"])
def test_sstep_with_precond_matches_jax(name, stencil):
    op = convert.operator(STENCILS[stencil](8), "cpu")
    pc = P.make_preconditioner(name, op)
    res = gmres_sstep(op, torch.from_numpy(_rhs(64)), s=4, blocks=4,
                      tol=1e-5, max_restarts=60, precond=pc)
    _check_solve(res, _jax_solve("sstep", stencil, 8, name))


def test_batched_with_chebyshev_matches_jax_lane_by_lane():
    op_j = STENCILS["poisson"](8)
    bs = _vec(64, 2, k=3)
    with _mode("chebyshev"):
        pc_j = JP.chebyshev(op_j, order=4)
        ref = convert.result_to_numpy(jax_gmres_batched(
            op_j, jnp.asarray(bs), m=16, tol=1e-4, max_restarts=80,
            precond=pc_j))
    op = convert.operator(op_j, "cpu")
    res = gmres_batched(op, torch.from_numpy(bs), m=16, tol=1e-4,
                        max_restarts=80, precond=P.chebyshev(op, order=4))
    assert bool(np.all(res.converged)) and bool(np.all(ref["converged"]))
    for lane in range(3):
        assert abs(int(res.restarts[lane]) - int(ref["restarts"][lane])) <= 1
        np.testing.assert_allclose(_np(res.x[lane]), ref["x"][lane], **SOLVE)


@pytest.mark.parametrize("c", [1e-6, 1e6])
@pytest.mark.parametrize("name", ["chebyshev", "banded_ilu0"])
def test_precond_scale_invariant(name, c):
    op = convert.operator(STENCILS["poisson"](8), "cpu")
    sop = operators.BandedOperator(op.bands * c, op.offsets, device="cpu")
    b = torch.from_numpy(_rhs(64))
    ref = gmres(op, b, m=16, tol=1e-5, max_restarts=60,
                precond=P.make_preconditioner(name, op))
    res = gmres(sop, b * c, m=16, tol=1e-5, max_restarts=60,
                precond=P.make_preconditioner(name, sop))
    assert bool(torch.isfinite(res.x).all()) and res.converged
    assert res.restarts == ref.restarts
    assert float((res.x - ref.x).norm() / ref.x.norm()) < 1e-3
