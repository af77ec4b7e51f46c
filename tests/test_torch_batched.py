"""The port's block multi-RHS solver vs the JAX package, on the CPU.

``batched_cgs2`` (plain version on CPU tensors) against the JAX Pallas
kernel in interpret mode; ``gmres_batched`` and ``gmres_batched_cycle``
on banded and sliced-ELL operators against the JAX batched solver on the
same operator (the reference's batched-vs-scalar contract itself fails,
see ROADMAP queue 3, so each lane is held to the JAX *batched* output).

Tolerances: float32 kernel rtol = atol = 3e-5, bfloat16 basis 2e-2;
solves per lane x rtol 1e-4 / atol 1e-5, restarts within +-1, and the
same ``converged`` / ``done`` flags.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import gmres_batched as jax_gmres_batched  # noqa: E402
from repro.core.gmres import gmres_batched_cycle as jax_cycle  # noqa: E402
from repro.core import graphs as jax_graphs  # noqa: E402
from repro.core import stencils as jax_stencils  # noqa: E402
from repro.kernels import block_gs as jax_block_gs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import gmres_batched, gmres_batched_cycle  # noqa: E402
from repro_torch.kernels import block_gs, spmv  # noqa: E402

F32 = dict(rtol=3e-5, atol=3e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)


def _bases(k, m1, n, js, seed=0):
    """(k, m1, n): lane l has orthonormal rows 0..js[l], zeros after."""
    rng = np.random.default_rng(seed)
    v = np.zeros((k, m1, n), np.float32)
    for lane, j in enumerate(js):
        q, _ = np.linalg.qr(rng.standard_normal((n, j + 1)))
        v[lane, :j + 1] = q.T
    return v


@pytest.mark.parametrize("dtype,tol", [(jnp.float32, F32),
                                       (jnp.bfloat16, BF16)])
def test_batched_cgs2_matches_pallas(dtype, tol):
    k, m1, n, js = 3, 12, 300, (0, 5, 11)
    v = _bases(k, m1, n, js)
    w = np.random.default_rng(1).standard_normal((k, n)).astype(np.float32)
    v_j = jnp.asarray(v).astype(dtype)
    mask = block_gs.row_masks(js, m1).numpy()
    h_j, w_j = jax_block_gs.batched_cgs2(v_j, jnp.asarray(w),
                                         jnp.asarray(mask), interpret=True)
    h_t, w_t = block_gs.batched_cgs2(convert.tensor(v_j, "cpu"),
                                     torch.from_numpy(w), js)
    assert h_t.shape == (k, m1) and w_t.shape == (k, n)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), **tol)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), **tol)
    # rows past each lane's j get no projection; w'' is orthogonal to V
    assert np.all(h_t.numpy()[mask == 0] == 0)
    if dtype == jnp.float32:
        for lane, j in enumerate(js):
            assert np.abs(v[lane, :j + 1] @ w_t[lane].numpy()).max() < 1e-4


def test_batched_cgs2_skips_lanes_and_checks_shapes():
    v = torch.from_numpy(_bases(2, 4, 10, (1, 3)))
    w = torch.randn(2, 10)
    h, w2 = block_gs.batched_cgs2(v, w, [-1, 3])
    assert torch.all(h[0] == 0) and torch.equal(w2[0], w[0])
    with pytest.raises(TypeError, match="need v"):
        block_gs.batched_cgs2(v, w[:, :9], [0, 0])
    with pytest.raises(TypeError, match="lanes"):
        block_gs.batched_cgs2(v, w, [0])
    with pytest.raises(ValueError, match="outside"):
        block_gs.batched_cgs2(v, w, [0, 4])


# --------------------------------------------------------------------------
# the block solver
# --------------------------------------------------------------------------
SYSTEMS = {
    "convdiff_banded": lambda: jax_stencils.convection_diffusion_2d(
        10, 10, backend="pallas"),
    "laplacian_sell": lambda: jax_graphs.graph_laplacian(
        128, shift=1.0, backend="pallas"),
}
TOL = np.array([1e-5, 1e-4, 1e-6, 1e-3], np.float32)
BUDGET = np.array([50, 50, 1, 50], np.int32)       # lane 2 must fail


@functools.lru_cache(maxsize=None)
def _jax_operator(system):
    return SYSTEMS[system]()


def _rhs(k, n, seed=7):
    return np.random.default_rng(seed).standard_normal((k, n)).astype(
        np.float32)


@functools.lru_cache(maxsize=None)
def _jax_batched(system, gs):
    op = _jax_operator(system)
    b = _rhs(4, op.shape[0])
    res = jax_gmres_batched(op, jnp.asarray(b), m=12, tol=jnp.asarray(TOL),
                            max_restarts=jnp.asarray(BUDGET), gs=gs)
    return {f: np.asarray(getattr(res, f)) for f in
            ("x", "restarts", "converged", "done", "inner_steps")}


def _assert_lanes_match(res, ref):
    np.testing.assert_array_equal(res.converged, ref["converged"])
    np.testing.assert_array_equal(res.done, ref["done"])
    assert np.all(np.abs(res.restarts - ref["restarts"]) <= 1)
    np.testing.assert_allclose(convert.to_numpy(res.x), ref["x"], rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("system,gs", [("convdiff_banded", "cgs2"),
                                       ("laplacian_sell", "cgs2"),
                                       ("convdiff_banded", "mgs")])
def test_gmres_batched_matches_jax_per_lane(system, gs, monkeypatch):
    op = convert.operator(_jax_operator(system), device="cpu")
    b = torch.from_numpy(_rhs(4, op.shape[0]))
    calls = {"gs": 0, "spmv": 0}

    def spy(key, fn):
        def wrapped(*args):
            calls[key] += 1
            return fn(*args)
        return wrapped

    monkeypatch.setattr(block_gs, "batched_cgs2",
                        spy("gs", block_gs.batched_cgs2))
    for name in ("banded_matvec", "sell_matvec"):
        monkeypatch.setattr(spmv, name, spy("spmv", getattr(spmv, name)))
    res = gmres_batched(op, b, m=12, tol=TOL, max_restarts=BUDGET, gs=gs)
    ref = _jax_batched(system, gs)
    _assert_lanes_match(res, ref)
    assert list(res.converged) == [True, True, False, True]
    assert list(res.done) == [True] * 4 and res.restarts[2] == 1
    assert res.x.shape == b.shape and res.x.device.type == "cpu"
    # one block mat-vec per lockstep step, plus the true residuals: one at
    # the start and one per restart cycle of the longest lane
    cycles = int(res.restarts.max())
    if gs == "cgs2":
        assert calls["gs"] > 0
        assert calls["spmv"] == calls["gs"] + cycles + 1
    else:
        assert calls["gs"] == 0


def test_gmres_batched_cycle_matches_jax():
    op_j = _jax_operator("convdiff_banded")
    op = convert.operator(op_j, device="cpu")
    n = op.shape[0]
    b = _rhs(3, n, seed=11)
    x = _rhs(3, n, seed=12) * 0.1
    tol_abs = np.array([1e-4, 1e-3, 1e-4], np.float32)
    active = np.array([True, False, True])
    xj, beta_j, inner_j = jax_cycle(op_j, jnp.asarray(b), jnp.asarray(x),
                                    m=10, tol_abs=jnp.asarray(tol_abs),
                                    active=jnp.asarray(active))
    xt, beta_t, inner_t = gmres_batched_cycle(
        op, torch.from_numpy(b), torch.from_numpy(x), m=10, tol_abs=tol_abs,
        active=active)
    np.testing.assert_array_equal(inner_t, np.asarray(inner_j))
    assert inner_t[1] == 0 and inner_t[0] > 0
    np.testing.assert_array_equal(xt[1].numpy(), x[1])   # inactive: as is
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(beta_t, np.asarray(beta_j), rtol=1e-3,
                               atol=1e-6)


def test_gmres_batched_rejects_unported_scheme():
    op = convert.operator(_jax_operator("convdiff_banded"), device="cpu")
    with pytest.raises(ValueError, match="unknown gram-schmidt"):
        gmres_batched(op, torch.ones(2, op.shape[0]), gs="householder")


def test_gmres_batched_pipelined_runs_cgs2_as_jax_does(monkeypatch):
    """The batched solver has no whole-cycle pipelining: "cgs2_pipelined"
    runs CGS2 through batched_cgs2, as JAX's ``_CGS2_FAMILY`` does (the
    system of tests/test_pipelined.py::
    test_pipelined_batched_degrades_to_cgs2)."""
    import jax

    from repro.core import operators as jax_ops
    from repro_torch.core import operators

    n = 64
    a = np.array(jax_ops.random_diagdom(jax.random.PRNGKey(0), n))
    bb = np.array(jax.random.normal(jax.random.PRNGKey(1), (3, n)))
    kw = dict(m=12, tol=1e-5, max_restarts=50)
    want = jax_gmres_batched(jnp.asarray(a), jnp.asarray(bb),
                             gs="cgs2_pipelined", **kw)
    calls = []
    monkeypatch.setattr(block_gs, "batched_cgs2",
                        lambda *args: calls.append(1)
                        or block_gs.batched_cgs2_plain(*args))
    got = gmres_batched(operators.DenseOperator(torch.from_numpy(a),
                                                device="cpu"),
                        torch.from_numpy(bb), gs="cgs2_pipelined", **kw)
    assert calls and bool(np.asarray(want.converged).all())
    _assert_lanes_match(got, {f: np.asarray(getattr(want, f)) for f in
                              ("x", "restarts", "converged", "done")})
