"""The port's solver vs the JAX package's, on the CPU.

The JAX side builds the systems (``jax.random`` streams cannot be
reproduced in torch) and they cross through ``repro_torch.convert``.  The
JAX solver runs its Pallas kernels in interpret mode for ``cgs2_fused`` /
``fused``; the port runs its kernels' plain versions.

Bars, from the JAX package's own contracts: x within rtol 1e-4 / atol 1e-5,
restarts within +-1, relres < 5e-5 (tests/test_fused_solver.py); the
strategies within rtol 2e-2 / atol 1e-3 (benchmarks/gmres_strategies.py).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import givens as jax_givens  # noqa: E402
from repro.core import gmres as jax_gmres  # noqa: E402
from repro.core import operators as jax_ops  # noqa: E402
from repro.core import strategies as jax_strategies  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import givens, gmres, strategies  # noqa: E402
from repro_torch.core.gmres import STATUS_NAMES  # noqa: E402

SCHEMES = ["cgs", "mgs", "cgs2", "cgs2_fused", "fused"]


def _system(n=160, dominance=0.15, seed=0):
    a = jax_ops.random_diagdom(jax.random.PRNGKey(seed), n,
                               dominance=dominance)
    b = jax.random.normal(jax.random.PRNGKey(seed + 1), (n,))
    return a, b


def _relres(a, x, b):
    a, x, b = (np.asarray(t, np.float64) for t in (a, x, b))
    return np.linalg.norm(a @ x - b) / np.linalg.norm(b)


@functools.lru_cache(maxsize=None)
def _jax_solve(gs, dominance, max_restarts):
    a, b = _system(dominance=dominance)
    res = jax_gmres(a, b, m=20, tol=1e-5, gs=gs, max_restarts=max_restarts)
    return convert.result_to_numpy(res)


def _port_solve(gs, backend, dominance, max_restarts):
    a, b = _system(dominance=dominance)
    op = convert.dense_operator(
        jax_ops.DenseOperator(a, backend={"torch": "jnp",
                                          "cuda": "pallas"}[backend]),
        device="cpu")
    assert op.backend == backend
    res = gmres(op, convert.tensor(b, "cpu"), m=20, tol=1e-5, gs=gs,
                max_restarts=max_restarts)
    return a, b, res, convert.result_to_numpy(res)


def test_givens_update_and_solve_match_jax():
    m = 10
    rng = np.random.default_rng(0)
    hess = np.triu(rng.standard_normal((m + 1, m)).astype(np.float32), -1)
    beta = np.float32(1.7)
    sj = jax_givens.init(m, jnp.asarray(beta))
    sp = givens.init(m, beta)
    update = jax.jit(jax_givens.update)
    for j in range(m):
        sj = update(sj, jnp.asarray(hess[:, j]), j, active=jnp.asarray(True))
        sp = givens.update(sp, hess[:, j], j, active=True)
        np.testing.assert_allclose(givens.residual_norm(sp, j),
                                   np.asarray(jax_givens.residual_norm(sj, j)),
                                   rtol=1e-5, atol=1e-6)
    sc = convert.givens_state(sj)
    for ours, theirs in ((sp.r, sc.r), (sp.cs, sc.cs), (sp.sn, sc.sn),
                         (sp.g, sc.g)):
        np.testing.assert_allclose(ours, theirs, rtol=1e-5, atol=1e-6)
    for steps in (None, 6):
        np.testing.assert_allclose(
            givens.solve(sp, steps), np.asarray(jax_givens.solve(sj, steps)),
            rtol=1e-4, atol=1e-5)
    # an inactive step writes the identity column and zeroes g[j]
    sp = givens.update(givens.init(m, beta), hess[:, 0], 0, active=False)
    assert sp.r[0, 0] == 1 and sp.g[0] == 0


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("gs", SCHEMES)
def test_gmres_schemes_match_jax(gs, backend):
    ref = _jax_solve(gs, 0.15, 50)
    a, b, res, got = _port_solve(gs, backend, 0.15, 50)
    assert res.converged and bool(ref["converged"])
    assert abs(res.restarts - int(ref["restarts"])) <= 1
    assert res.restarts >= 2                   # the system really restarts
    assert _relres(a, got["x"], b) < 5e-5
    np.testing.assert_allclose(got["x"], ref["x"], rtol=1e-4, atol=1e-5)
    assert res.x.device.type == "cpu" and res.x.dtype == torch.float32


@pytest.mark.parametrize("gs", ["cgs2", "fused"])
def test_diagnostics_match_jax_on_stagnating_system(gs):
    ref = _jax_solve(gs, 0.05, 10)
    _, _, res, got = _port_solve(gs, "cuda", 0.05, 10)
    assert not res.converged and res.done
    assert res.restarts == int(ref["restarts"]) == 10
    assert STATUS_NAMES[res.diagnostics.status] == \
        STATUS_NAMES[int(ref["status"])] == "STAGNATED"
    assert res.diagnostics.history_len == int(ref["history_len"])
    np.testing.assert_allclose(got["residual_history"],
                               ref["residual_history"], rtol=1e-4)


def test_strategies_match_jax():
    n = 200
    a, b = _system(n=n, dominance=2.0)
    a, b = np.asarray(a), np.asarray(b)
    x_ref = jax_strategies.serial_numpy(a, b, m=30, tol=1e-5)[0]
    for name in ("serial_numpy", "offload_matvec", "transfer_per_call"):
        kw = {} if name == "serial_numpy" else {"device": "cpu"}
        x, beta, _, conv, _ = strategies.STRATEGIES[name](a, b, m=30,
                                                          tol=1e-5, **kw)
        assert conv and beta / np.linalg.norm(b) < 1e-5
        np.testing.assert_allclose(x, x_ref, rtol=2e-2, atol=1e-3)
    ref = jax_strategies.device_resident(a, b, m=30, tol=1e-5)
    for gs, backend in (("cgs2", "torch"), ("fused", "cuda")):
        res = strategies.device_resident(a, b, m=30, tol=1e-5, gs=gs,
                                         backend=backend, device="cpu")
        assert res.converged
        np.testing.assert_allclose(convert.to_numpy(res.x), x_ref,
                                   rtol=2e-2, atol=1e-3)
        np.testing.assert_allclose(convert.to_numpy(res.x),
                                   np.asarray(ref.x), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("gs", ["cgs2", "fused"])
def test_compute_dtype_bf16_converges(gs):
    a, b = _system(n=128, dominance=2.0, seed=19)
    ref = jax_gmres(a, b, m=20, tol=1e-4, gs=gs, compute_dtype=jnp.bfloat16,
                    max_restarts=100)
    res = gmres(convert.tensor(a, "cpu"), convert.tensor(b, "cpu"), m=20,
                tol=1e-4, gs=gs, compute_dtype=torch.bfloat16,
                max_restarts=100)
    assert res.converged
    assert _relres(a, convert.to_numpy(res.x), b) < 5e-4
    assert abs(res.restarts - int(ref.restarts)) <= 5
    np.testing.assert_allclose(convert.to_numpy(res.x), np.asarray(ref.x),
                               rtol=3e-2, atol=3e-3)


def test_fused_degrades_before_any_launch(monkeypatch):
    """gs="fused" needs a DenseOperator whose basis slices fit shared
    memory; a matrix-free operator, or a shape that does not fit, runs the
    cgs2_fused scheme instead (decided from shapes, before any launch)."""
    from repro_torch.core import operators
    from repro_torch.kernels import arnoldi_fused, cgs2, tuning

    assert tuning.fused_step_fits(31, 10_000)
    assert not tuning.fused_step_fits(31, 2_000_000)
    calls = []

    def spy(name, fn):
        def wrapped(*args):
            calls.append(name)
            return fn(*args)
        return wrapped

    monkeypatch.setattr(arnoldi_fused, "arnoldi_step",
                        spy("fused", arnoldi_fused.arnoldi_step))
    monkeypatch.setattr(cgs2, "cgs2", spy("cgs2_fused", cgs2.cgs2))
    a, b = _system(n=96, dominance=2.0, seed=5)
    a_t, b_t = convert.tensor(a, "cpu"), convert.tensor(b, "cpu")
    dense = operators.DenseOperator(a_t, device="cpu")
    free = operators.FunctionOperator(lambda v, mat: mat @ v, 96,
                                      captures=(a_t,))
    for op, fits, scheme in ((dense, True, "fused"),
                             (free, True, "cgs2_fused"),
                             (dense, False, "cgs2_fused")):
        monkeypatch.setattr(tuning, "fused_step_fits", lambda *_: fits)
        calls.clear()
        res = gmres(op, b_t, m=20, tol=1e-5, gs="fused")
        assert res.converged and set(calls) == {scheme}
        assert _relres(a, convert.to_numpy(res.x), b) < 5e-5


def test_test_matrices_match_jax():
    from repro_torch.core import operators

    n = 12
    np.testing.assert_array_equal(
        operators.poisson_1d(n, device="cpu").numpy(),
        np.asarray(jax_ops.poisson_1d(n)))
    np.testing.assert_array_equal(
        operators.convection_diffusion(n, 0.3, device="cpu").numpy(),
        np.asarray(jax_ops.convection_diffusion(n, 0.3)))
    # random_diagdom: same construction, numpy-seeded (jax.random streams
    # differ); check the dominance it builds in
    a = operators.random_diagdom(64, dominance=2.0, seed=3, device="cpu")
    a = a.numpy().astype(np.float64)
    off = np.abs(a).sum(axis=1) - np.abs(np.diag(a))
    assert np.all(np.abs(np.diag(a)) > 1.9 * off)
    np.testing.assert_array_equal(
        a, operators.random_diagdom(64, dominance=2.0, seed=3,
                                    device="cpu").numpy())
