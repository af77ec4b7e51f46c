"""The port's s-step slice vs the JAX package, on the CPU.

Kernels: each port wrapper runs its plain version (the tensors lie on the
CPU) against the JAX Pallas kernel in interpret mode, on inputs made with
numpy from a seed.  The shifted (Newton) powers are held against the JAX
``matrix_powers_ref`` instead: the shifted Pallas branches call
``pl.load``, which the installed jax no longer has.

Solves: the port's ``gmres_sstep`` on operators carried across with
``convert.operator`` against the JAX ``gmres_sstep`` on the same operator
(its kernels in interpret mode; the Newton basis under
``force_kernel_mode("ref")``, for the same reason).

Tolerances: float32 kernels rtol = atol = 3e-5 (the JAX package's kernel
contract; sums run in another order), bfloat16 storage 2e-2; solves
converged, restarts within +-1 and x within rtol 1e-3 / atol 1e-4 (the
contract of ``tests/test_sstep.py::test_sstep_kernel_matches_ref_path``,
which runs s = 4), and rtol 2e-2 / atol 2e-3 at s = 8 (the contract of
``test_sstep_stencil_convergence_parity``): there the monomial basis
conditions like kappa^8, and the JAX package's own kernel and reference
paths already differ by 1.4e-4 in x on the 16 x 16 ELL Poisson system, and
by one restart.  With a bfloat16 basis x is held within 2e-2, the bfloat16
bar, and the true residual of the port's x within 2 tol.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import operators as jax_ops  # noqa: E402
from repro.core import sstep as jax_sstep  # noqa: E402
from repro.core import stencils as jax_stencils  # noqa: E402
from repro.core import strategies as jax_strategies  # noqa: E402
from repro.kernels import block_gs as jax_bgs  # noqa: E402
from repro.kernels import matrix_powers as jax_mp  # noqa: E402
from repro.kernels import tuning as jax_tuning  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import operators, preconditioners, sstep  # noqa: E402
from repro_torch.core import stencils, strategies  # noqa: E402
from repro_torch.kernels import block_gs, matrix_powers  # noqa: E402

F32 = dict(rtol=3e-5, atol=3e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
DTYPES = [(jnp.float32, F32), (jnp.bfloat16, BF16)]
SOLVE = dict(rtol=1e-3, atol=1e-4)
SOLVE_WIDE = dict(rtol=2e-2, atol=2e-3)     # s = 8
STENCILS = {
    "poisson": lambda **kw: jax_stencils.poisson_2d(16, 16, **kw),
    "convdiff": lambda **kw: jax_stencils.convection_diffusion_2d(
        16, 16, beta=(0.3, 0.2), **kw),
}


def _np(t):
    return convert.to_numpy(t).astype(np.float32)


def _x(n, seed):
    x = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _close(got, want, tol):
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(_np(g), np.asarray(w, np.float32), **tol)


def _shifts(s):
    """Leja-ordered points of [0.5, 7.5], as the Newton basis uses."""
    k = np.arange(s)
    pts = 4.0 + 3.5 * np.cos(np.pi * (2 * k + 1) / (2 * s))
    return pts[list(sstep._leja_perm(s))].astype(np.float32)


# --------------------------------------------------------------------------
# kernels
# --------------------------------------------------------------------------
@pytest.mark.parametrize("s", [2, 4, 8])
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("system", sorted(STENCILS))
def test_banded_powers_matches_pallas(system, dtype, tol, s):
    op_j = jax_ops.with_dtype(STENCILS[system](), dtype)
    op_t = convert.operator(op_j, "cpu")
    x_j, x_t = _x(256, s)
    want = jax_mp.banded_powers(op_j.bands, x_j, op_j.offsets, s,
                                interpret=True)
    got = matrix_powers.banded_powers(op_t.bands, x_t, op_t.offsets, s)
    assert got[0].dtype == torch.float32
    _close(got, want, tol)


@pytest.mark.parametrize("s", [2, 4, 8])
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("system", sorted(STENCILS))
def test_ell_powers_matches_pallas(system, dtype, tol, s):
    op_j = jax_ops.with_dtype(STENCILS[system](fmt="ell"), dtype)
    op_t = convert.operator(op_j, "cpu")
    x_j, x_t = _x(256, 10 + s)
    want = jax_mp.ell_powers(op_j.values, op_j.cols, x_j, s, interpret=True)
    got = matrix_powers.ell_powers(op_t.values, op_t.cols, x_t, s)
    _close(got, want, tol)


@pytest.mark.parametrize("s", [2, 4, 8])
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_dense_powers_matches_pallas(dtype, tol, s):
    a = operators.random_diagdom(256, seed=3, device="cpu").numpy()
    a_j = jnp.asarray(a).astype(dtype)
    a_t = convert.tensor(a_j, "cpu")
    x_j, x_t = _x(256, 20 + s)
    want = jax_mp.dense_powers(a_j, x_j, s, interpret=True)
    got = matrix_powers.dense_powers(a_t, x_t, s)
    _close(got, want, tol)


@pytest.mark.parametrize("s", [2, 4, 8])
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("fmt", ["banded", "ell"])
def test_shifted_powers_match_reference(fmt, dtype, tol, s):
    """The Newton-basis powers against JAX's ``matrix_powers_ref`` over the
    same operator (the shifted Pallas branches fail on this jax)."""
    op_j = jax_ops.with_dtype(STENCILS["convdiff"](fmt=fmt), dtype)
    op_t = convert.operator(op_j, "cpu")
    sh = _shifts(s)
    x_j, x_t = _x(256, 30 + s)
    eps = float(jnp.finfo(jnp.float32).tiny) ** 0.5
    want = jax_mp.matrix_powers_ref(
        lambda u: op_j(u).astype(jnp.float32), x_j, s, eps,
        shifts=jnp.asarray(sh))
    if fmt == "banded":
        got = matrix_powers.banded_powers(op_t.bands, x_t, op_t.offsets, s,
                                          shifts=torch.from_numpy(sh))
    else:
        got = matrix_powers.ell_powers(op_t.values, op_t.cols, x_t, s,
                                       shifts=torch.from_numpy(sh))
    _close(got, want, tol)


@pytest.mark.parametrize("s", [2, 4, 8])
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("m1,k_start", [(9, 0), (9, 4), (9, 8),
                                        (17, 0), (17, 8), (17, 16)])
def test_block_gs_pass_matches_pallas(m1, k_start, dtype, tol, s):
    """n = 300 (ragged); T = I (pass 1) and an upper-triangular T."""
    n = 300
    rng = np.random.default_rng(m1 * 100 + k_start * 10 + s)
    q, _ = np.linalg.qr(rng.standard_normal((n, m1)))
    v = q.T.astype(np.float32)
    v[k_start + 1:] = 0
    w = rng.standard_normal((s, n)).astype(np.float32)
    upper = np.triu(rng.standard_normal((s, s))).astype(np.float32)
    upper += 2 * np.eye(s, dtype=np.float32)
    mask = (np.arange(m1) <= k_start).astype(np.float32)
    v_j = jnp.asarray(v).astype(dtype)
    v_t = convert.tensor(v_j, "cpu")
    for tin in (np.eye(s, dtype=np.float32), upper):
        want = jax_bgs.block_gs_pass(v_j, jnp.asarray(w), jnp.asarray(tin),
                                     jnp.asarray(mask), interpret=True)
        got = block_gs.block_gs_pass(v_t, torch.from_numpy(w),
                                     torch.from_numpy(tin), k_start)
        assert all(t.dtype == torch.float32 for t in got)
        _close(got, want, tol)


def test_kernel_wrappers_raise_on_bad_shapes():
    x = torch.ones(20)
    with pytest.raises(TypeError, match="offsets"):
        matrix_powers.banded_powers(torch.ones(3, 20), x, (-1, 0), 2)
    with pytest.raises(TypeError, match="shape"):
        matrix_powers.ell_powers(torch.ones(20, 3),
                                 torch.zeros(20, 3, dtype=torch.int32),
                                 torch.ones(19), 2)
    with pytest.raises(TypeError, match="shifts"):
        matrix_powers.banded_powers(torch.ones(3, 20), x, (-1, 0, 1), 2,
                                    shifts=torch.ones(3))
    with pytest.raises(TypeError, match="square"):
        matrix_powers.dense_powers(torch.ones(20, 19), x, 2)
    with pytest.raises(TypeError, match="tin"):
        block_gs.block_gs_pass(torch.ones(5, 20), torch.ones(2, 20),
                               torch.eye(3), 0)
    with pytest.raises(ValueError, match="k_start"):
        block_gs.block_gs_pass(torch.ones(5, 20), torch.ones(2, 20),
                               torch.eye(2), 5)


# --------------------------------------------------------------------------
# solves
# --------------------------------------------------------------------------
def _dense_pair(n=256, seed=3):
    a = operators.random_diagdom(n, dominance=0.5, seed=seed,
                                 device="cpu").numpy()
    return jax_ops.DenseOperator(jnp.asarray(a)), \
        operators.DenseOperator(torch.from_numpy(a), device="cpu")


def _op_pair(kind):
    if kind == "dense":
        return _dense_pair()
    system, fmt = kind.split("-")
    op_j = STENCILS[system](fmt=fmt)
    return op_j, convert.operator(op_j, "cpu")


def _solve_both(op_j, op_t, b, *, ref_mode=False, jax_kw=None, **kw):
    jkw = dict(kw, **(jax_kw or {}))
    if ref_mode:
        with jax_tuning.force_kernel_mode("ref"):
            want = jax_sstep.gmres_sstep(op_j, jnp.asarray(b), **jkw)
    else:
        want = jax_sstep.gmres_sstep(op_j, jnp.asarray(b), **jkw)
    got = sstep.gmres_sstep(op_t, torch.from_numpy(b), **kw)
    return want, got


def _assert_parity(want, got, tol=SOLVE):
    assert bool(want.converged) and got.converged
    assert abs(int(want.restarts) - got.restarts) <= 1
    np.testing.assert_allclose(_np(got.x), np.asarray(want.x, np.float32),
                               **tol)


KINDS = ["dense", "poisson-banded", "poisson-ell", "poisson-sell",
         "convdiff-banded"]


@pytest.mark.parametrize("s", [2, 4, 8])
@pytest.mark.parametrize("kind", KINDS)
def test_gmres_sstep_matches_jax(kind, s):
    op_j, op_t = _op_pair(kind)
    n = op_t.shape[0]
    b = np.random.default_rng(s).standard_normal(n).astype(np.float32)
    want, got = _solve_both(op_j, op_t, b, s=s, blocks=max(16 // s, 1),
                            tol=1e-5, max_restarts=60)
    _assert_parity(want, got, SOLVE if s <= 4 else SOLVE_WIDE)
    assert got.inner_steps == got.restarts * s * max(16 // s, 1)
    assert got.diagnostics.residual_history[-1] == np.float32(got.residual)


@pytest.mark.parametrize("kind", ["dense", "poisson-banded", "poisson-ell",
                                  "convdiff-sell"])
def test_newton_basis_matches_jax_ref_mode(kind):
    op_j, op_t = _op_pair(kind)
    n = op_t.shape[0]
    b = np.random.default_rng(7).standard_normal(n).astype(np.float32)
    want, got = _solve_both(op_j, op_t, b, ref_mode=True, s=4, blocks=4,
                            tol=1e-5, max_restarts=60, basis="newton")
    _assert_parity(want, got)
    np.testing.assert_allclose(
        _np(sstep._newton_shifts(op_t, 4)),
        np.asarray(jax_sstep._newton_shifts(op_j, 4)), rtol=1e-6)


@pytest.mark.parametrize("fmt", ["banded", "ell"])
def test_bf16_basis_matches_jax(fmt):
    op_j, op_t = _op_pair(f"poisson-{fmt}")
    b = np.random.default_rng(4).standard_normal(256).astype(np.float32)
    want, got = _solve_both(op_j, op_t, b, s=4, blocks=4, tol=1e-4,
                            max_restarts=60, compute_dtype=torch.bfloat16,
                            jax_kw={"compute_dtype": jnp.bfloat16})
    _assert_parity(want, got, BF16)
    r = op_t.todense().double() @ got.x.double() - torch.from_numpy(b).double()
    assert float(r.norm() / np.linalg.norm(b)) <= 2e-4


def test_preconditioned_solve_matches_jax():
    """The same diagonal scaling on both sides (reference powers over
    A M^-1, the update un-preconditioned)."""
    op_j, op_t = _op_pair("convdiff-banded")
    d = np.asarray(op_j.bands[op_j.offsets.index(0)], np.float32)
    inv_j, inv_t = jnp.asarray(1 / d), torch.from_numpy(1 / d)
    b = np.random.default_rng(5).standard_normal(256).astype(np.float32)
    want = jax_sstep.gmres_sstep(op_j, jnp.asarray(b), s=4, blocks=4,
                                 tol=1e-5, max_restarts=60,
                                 precond=lambda v: inv_j * v)
    got = sstep.gmres_sstep(op_t, torch.from_numpy(b), s=4, blocks=4,
                            tol=1e-5, max_restarts=60,
                            precond=lambda v: inv_t * v)
    _assert_parity(want, got)


def test_spectral_bounds_match_jax():
    from repro.core import preconditioners as jax_pc

    for kind in ("dense", "poisson-banded", "convdiff-ell", "convdiff-sell"):
        op_j, op_t = _op_pair(kind)
        want = jax_pc.spectral_bounds(op_j)
        got = preconditioners.spectral_bounds(op_t)
        np.testing.assert_allclose([float(g) for g in got],
                                   [float(w) for w in want], rtol=1e-6)
        np.testing.assert_allclose(_np(preconditioners._diag_of(op_t)),
                                   np.asarray(jax_pc._diag_of(op_j)))


# --------------------------------------------------------------------------
# the port alone
# --------------------------------------------------------------------------
@pytest.mark.parametrize("scale", [1e-6, 1e6])
def test_scale_invariance(scale):
    """x(cA, cb) == x(A, b): the guards, the CholQR ridge and the Givens
    breakdown probe are all relative."""
    op = stencils.poisson_2d(12, 12, device="cpu")
    b = torch.from_numpy(np.random.default_rng(5).standard_normal(144)
                         .astype(np.float32))
    r1 = sstep.gmres_sstep(op, b, s=4, blocks=4, tol=1e-4, max_restarts=60)
    op_s = operators.BandedOperator(op.bands * scale, op.offsets,
                                    device="cpu")
    r2 = sstep.gmres_sstep(op_s, b * scale, s=4, blocks=4, tol=1e-4,
                           max_restarts=60)
    assert r1.converged and r2.converged
    assert abs(r1.restarts - r2.restarts) <= 1
    np.testing.assert_allclose(r2.x.numpy(), r1.x.numpy(), rtol=5e-3,
                               atol=5e-4)


def test_degenerate_block_is_safe():
    """b an eigenvector: the power basis collapses inside the first block;
    the solve stays finite and converges."""
    a = torch.diag(torch.arange(1.0, 65.0))
    b = torch.zeros(64)
    b[2] = 1.0
    res = sstep.gmres_sstep(a, b, s=4, blocks=4, tol=1e-6)
    assert res.converged and bool(torch.isfinite(res.x).all())
    np.testing.assert_allclose(res.x.numpy()[2], 1 / 3, rtol=1e-5)


def test_device_resident_sstep_matches_jax():
    a = operators.random_diagdom(128, dominance=0.5, seed=4,
                                 device="cpu").numpy()
    b = np.random.default_rng(4).standard_normal(128).astype(np.float32)
    want = jax_strategies.device_resident_sstep(a, b, m=16, s=4, tol=1e-5)
    got = strategies.device_resident_sstep(a, b, m=16, s=4, tol=1e-5,
                                           device="cpu")
    assert "device_resident_sstep" in strategies.STRATEGIES
    _assert_parity(want, got)
    assert got.inner_steps == 16 * got.restarts


def test_unported_sstep_paths_raise():
    a = operators.random_diagdom(16, device="cpu")
    b = torch.ones(16)
    res = sstep.gmres_sstep(a, b, gs="cgs2_pipelined")   # ported
    assert res.converged and res.x.device.type == "cpu"
    with pytest.raises(TypeError, match="ProcessGroup"):
        sstep.gmres_sstep(a, b, axis_name="rows")
    with pytest.raises(ValueError, match="unknown gs"):
        sstep.gmres_sstep(a, b, gs="mgs")
    with pytest.raises(ValueError, match="unknown basis"):
        sstep.gmres_sstep(a, b, basis="chebyshev")
    with pytest.raises(ValueError, match="explicit storage"):
        sstep.gmres_sstep(operators.FunctionOperator(lambda v: 2 * v, 16), b,
                          basis="newton")
