"""The port's sparse slice vs the JAX package, on the CPU.

Kernels: each port wrapper runs its plain version (the tensors lie on the
CPU) against the JAX Pallas kernel in interpret mode, on inputs made with
numpy from a seed.  Operators, stencils and graphs: the same structure
element for element (columns, halo, bins, permutation) and the same dense
matrix.  Solves: the port's ``gmres`` on operators carried across with
``convert.operator`` against the JAX ``gmres`` on the same operator with
``backend="pallas"``.

Tolerances: float32 kernels rtol = atol = 3e-5 (the JAX package's own
kernel contract; sums run in another order), bfloat16 storage 2e-2;
solves x rtol 1e-4 / atol 1e-5 with restarts within +-1; integer
structure exactly.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import gmres as jax_gmres  # noqa: E402
from repro.core import graphs as jax_graphs  # noqa: E402
from repro.core import operators as jax_ops  # noqa: E402
from repro.core import stencils as jax_stencils  # noqa: E402
from repro.kernels import spmv as jax_spmv  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import gmres, graphs, operators, stencils  # noqa: E402
from repro_torch.kernels import arnoldi_fused, cgs2, matvec, spmv  # noqa: E402

F32 = dict(rtol=3e-5, atol=3e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
DTYPES = [(jnp.float32, F32), (jnp.bfloat16, BF16)]
N = 333                                   # ragged: not a multiple of 128


def _pair(arr, dtype=jnp.float32):
    """The same values as a JAX array and a CPU tensor (dtype preserved)."""
    j = jnp.asarray(arr, jnp.float32).astype(dtype)
    return j, convert.tensor(j, "cpu")


def _np(t):
    return convert.to_numpy(t).astype(np.float32)


def _ell_pattern(n, width, seed):
    """Random ELL table: each row 1..width distinct columns, padding value
    0 at column 0."""
    rng = np.random.default_rng(seed)
    vals = np.zeros((n, width), np.float32)
    cols = np.zeros((n, width), np.int32)
    for i in range(n):
        nnz = rng.integers(1, width + 1)
        cols[i, :nnz] = rng.choice(n, nnz, replace=False)
        vals[i, :nnz] = rng.standard_normal(nnz)
    return vals, cols


# --------------------------------------------------------------------------
# kernels
# --------------------------------------------------------------------------
@pytest.mark.parametrize("k", [1, 6])
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_ell_matvec_matches_pallas(k, dtype, tol):
    vals, cols = _ell_pattern(N, 7, seed=k)
    v_j, v_t = _pair(vals, dtype)
    c_j, c_t = jnp.asarray(cols), torch.from_numpy(cols)
    x = np.random.default_rng(10 + k).standard_normal((N, k))
    x_j, x_t = _pair(x[:, 0] if k == 1 else x)
    want = jax_spmv.ell_matvec(v_j, c_j, x_j, interpret=True)
    got = spmv.ell_matvec(v_t, c_t, x_t)
    assert got.shape == tuple(want.shape) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **tol)
    np.testing.assert_allclose(
        _np(got), np.asarray(jax_spmv.ell_matvec_ref(v_j, c_j, x_j),
                             np.float32), **tol)


@pytest.mark.parametrize("offsets", [(-9, -1, 0, 1, 9), (-7, -2, 0, 3)],
                         ids=["stencil", "asymmetric"])
@pytest.mark.parametrize("k", [1, 6])
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_banded_matvec_matches_pallas(offsets, k, dtype, tol):
    rng = np.random.default_rng(len(offsets) + k)
    b_j, b_t = _pair(rng.standard_normal((len(offsets), N)), dtype)
    x = rng.standard_normal((N, k))
    x_j, x_t = _pair(x[:, 0] if k == 1 else x)
    want = jax_spmv.banded_matvec(b_j, x_j, offsets, interpret=True)
    got = spmv.banded_matvec(b_t, x_t, offsets)
    assert got.shape == tuple(want.shape)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **tol)


@functools.lru_cache(maxsize=None)
def _jax_laplacian(n, fmt="sell", backend="jnp"):
    return jax_graphs.graph_laplacian(n, fmt=fmt, shift=1.0, backend=backend)


@pytest.mark.parametrize("n", [96, 256])
@pytest.mark.parametrize("k", [1, 6])
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_sell_matvec_matches_pallas(n, k, dtype, tol):
    op_j = jax_ops.with_dtype(_jax_laplacian(n), dtype)
    op_t = convert.operator(op_j, device="cpu")
    assert len(op_t.bin_values) > 1
    x = np.random.default_rng(n + k).standard_normal((n, k))
    x_j, x_t = _pair(x[:, 0] if k == 1 else x)
    want = jax_spmv.sell_matvec(op_j.bin_values, op_j.bin_cols, x_j,
                                interpret=True)
    got = spmv.sell_matvec(op_t.bin_values, op_t.bin_cols, x_t)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **tol)
    # the operator (sorted frame scattered back through perm)
    np.testing.assert_allclose(_np(op_t(x_t)), np.asarray(op_j(x_j),
                                                          np.float32), **tol)


def test_spmv_wrappers_raise_on_bad_shapes():
    vals, cols = _ell_pattern(20, 3, seed=0)
    v, c = torch.from_numpy(vals), torch.from_numpy(cols)
    with pytest.raises(TypeError, match="must match"):
        spmv.ell_matvec(v, c[:, :2], torch.ones(20))
    with pytest.raises(TypeError, match="20 rows"):
        spmv.ell_matvec(v, c, torch.ones(19))
    with pytest.raises(TypeError, match="offsets"):
        spmv.banded_matvec(torch.ones(3, 20), torch.ones(20), (-1, 0))
    with pytest.raises(TypeError, match="20 rows"):
        spmv.banded_matvec(torch.ones(3, 20), torch.ones(21), (-1, 0, 1))
    with pytest.raises(TypeError, match="value bins"):
        spmv.sell_matvec((v,), (), torch.ones(20))
    with pytest.raises(TypeError, match="bin 0"):
        spmv.sell_matvec((v,), (c[:5],), torch.ones(20))
    with pytest.raises(TypeError, match="20 rows"):
        jax_spmv.ell_matvec(jnp.asarray(vals), jnp.asarray(cols),
                            jnp.ones(19), interpret=True)


def test_spmv_result_dtype_follows_promotion():
    vals, cols = _ell_pattern(16, 3, seed=1)
    v = torch.from_numpy(vals).to(torch.bfloat16)
    c = torch.from_numpy(cols)
    assert spmv.ell_matvec(v, c, torch.ones(16)).dtype == torch.float32
    assert spmv.ell_matvec(v, c, torch.ones(16, dtype=torch.bfloat16)).dtype \
        == torch.bfloat16
    assert spmv.banded_matvec(torch.ones(1, 16, dtype=torch.float64),
                              torch.ones(16), (0,)).dtype == torch.float64


# --------------------------------------------------------------------------
# operators, stencils, graphs
# --------------------------------------------------------------------------
STENCILS = [
    ("poisson_2d", (7, 9), {}),
    ("poisson_3d", (4, 3, 5), {}),
    ("convection_diffusion_2d", (13, 11), {"beta": (0.7, 0.3)}),
]


@pytest.mark.parametrize("name,args,kw", STENCILS,
                         ids=[s[0] for s in STENCILS])
def test_stencils_match_jax(name, args, kw):
    op_j = getattr(jax_stencils, name)(*args, **kw)
    op_t = getattr(stencils, name)(*args, device="cpu", **kw)
    assert op_t.offsets == op_j.offsets
    np.testing.assert_array_equal(op_t.bands.numpy(), np.asarray(op_j.bands))
    dense = np.asarray(op_j.todense())
    np.testing.assert_array_equal(op_t.todense().numpy(), dense)
    # every format materializes the same matrix, with the same structure
    for fmt in ("ell", "sell", "dense"):
        got = getattr(stencils, name)(*args, fmt=fmt, device="cpu", **kw)
        ref = getattr(jax_stencils, name)(*args, fmt=fmt, **kw)
        mat = got.a if fmt == "dense" else got.todense()
        np.testing.assert_array_equal(mat.numpy(), dense)
        if fmt == "ell":
            np.testing.assert_array_equal(got.cols.numpy(),
                                          np.asarray(ref.cols))
            assert got.halo == ref.halo
        if fmt == "sell":
            assert got.identity_perm and ref.identity_perm
            _assert_same_sell(got, ref)
    with pytest.raises(ValueError, match="unknown fmt"):
        getattr(stencils, name)(*args, fmt="csr", device="cpu", **kw)


def _assert_same_sell(got, ref):
    assert len(got.bin_values) == len(ref.bin_values)
    for gv, gc, rv, rc in zip(got.bin_values, got.bin_cols, ref.bin_values,
                              ref.bin_cols):
        np.testing.assert_array_equal(_np(gv), np.asarray(rv, np.float32))
        np.testing.assert_array_equal(gc.numpy(), np.asarray(rc))
    np.testing.assert_array_equal(got.perm.numpy(), np.asarray(ref.perm))
    assert got.identity_perm == ref.identity_perm
    assert got.halo == ref.halo and got.slice_height == ref.slice_height
    assert got.max_width == ref.max_width
    assert got.storage_entries == ref.storage_entries


def test_sparse_from_dense_matches_jax():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((40, 40)).astype(np.float32)
    a[rng.random((40, 40)) < 0.85] = 0
    ref = jax_ops.SparseOperator.from_dense(a)
    got = operators.SparseOperator.from_dense(a, device="cpu")
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(ref.values))
    np.testing.assert_array_equal(got.cols.numpy(), np.asarray(ref.cols))
    assert got.halo == ref.halo and got.cols.dtype == torch.int32
    np.testing.assert_array_equal(got.todense().numpy(), a)
    wide = operators.SparseOperator.from_dense(torch.from_numpy(a), width=20,
                                               device="cpu")
    assert wide.values.shape == (40, 20)
    np.testing.assert_array_equal(wide.todense().numpy(), a)
    with pytest.raises(ValueError, match="would be dropped"):
        operators.SparseOperator.from_dense(a, width=1, device="cpu")


@pytest.mark.parametrize("build", ["from_dense", "from_ell"])
@pytest.mark.parametrize("graph", ["powerlaw", "stencil"])
def test_sliced_ell_constructors_match_jax(build, graph):
    if graph == "powerlaw":
        a = np.asarray(_jax_laplacian(256, fmt="dense").a)
    else:
        a = np.asarray(jax_stencils.poisson_2d(12, 10).todense())
    kw = dict(slice_height=32, max_bins=6)
    if build == "from_dense":
        ref = jax_ops.SlicedEllOperator.from_dense(a, **kw)
        got = operators.SlicedEllOperator.from_dense(a, device="cpu", **kw)
    else:
        ref = jax_ops.SlicedEllOperator.from_ell(
            jax_ops.SparseOperator.from_dense(a), **kw)
        got = operators.SlicedEllOperator.from_ell(
            operators.SparseOperator.from_dense(a, device="cpu"), **kw)
    assert got.identity_perm == (graph == "stencil")
    _assert_same_sell(got, ref)
    np.testing.assert_array_equal(got.todense().numpy(), a)
    ell = got.to_ell()
    vals, cols = ref.to_ell_arrays()
    np.testing.assert_array_equal(ell.values.numpy(), np.asarray(vals))
    np.testing.assert_array_equal(ell.cols.numpy(), np.asarray(cols))
    np.testing.assert_array_equal(ell.todense().numpy(), a)


def test_with_dtype_and_convert_keep_structure():
    ref = _jax_laplacian(96)
    op = convert.operator(ref, device="cpu")
    _assert_same_sell(op, ref)
    narrow = operators.with_dtype(op, torch.bfloat16)
    assert narrow.dtype == torch.bfloat16
    assert all(a is b for a, b in zip(narrow.bin_cols, op.bin_cols))
    band_j = jax_stencils.poisson_2d(5, 4, backend="pallas")
    band = convert.operator(band_j, device="cpu")
    assert band.offsets == band_j.offsets
    ell = convert.operator(band_j.to_ell(), device="cpu")
    assert ell.halo == 5 and ell.values.shape == (20, 5)
    for op_ in (band, ell, operators.DenseOperator(band.todense(),
                                                   device="cpu")):
        assert operators.with_dtype(op_, torch.float64).dtype == torch.float64
    with pytest.raises(TypeError):
        operators.with_dtype(lambda v: v, torch.float64)


@pytest.mark.parametrize("fmt,module,wrapper", [
    ("banded", spmv, "banded_matvec"), ("ell", spmv, "ell_matvec"),
    ("sell", spmv, "sell_matvec"), ("dense", matvec, "matvec")])
def test_operators_apply_through_the_kernel_wrappers(fmt, module, wrapper,
                                                     monkeypatch):
    """A stencil built with the defaults applies A through its kernel's
    wrapper, which launches the kernel on a CUDA tensor: no switch on the
    operator sends a card tensor to the plain version."""
    calls = []
    real = getattr(module, wrapper)
    monkeypatch.setattr(module, wrapper,
                        lambda *a: calls.append(wrapper) or real(*a))
    op = stencils.convection_diffusion_2d(6, 5, fmt=fmt, device="cpu")
    x = torch.from_numpy(_rhs(30))
    y = op(x)
    assert calls == [wrapper]
    dense = (op.a if fmt == "dense" else op.todense()).double()
    np.testing.assert_allclose(y.double().numpy(), (dense @ x.double()).numpy(),
                               rtol=1e-6, atol=1e-6)


def test_powerlaw_adjacency_is_bit_identical():
    got = graphs.powerlaw_adjacency(128, seed=0)
    want = jax_graphs.powerlaw_adjacency(128, seed=0)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert not np.array_equal(got, graphs.powerlaw_adjacency(128, seed=1))


def test_pagerank_system_matches_jax():
    op_j, rhs_j = jax_graphs.pagerank_system(160, seed=2)
    op_t, rhs_t = graphs.pagerank_system(160, seed=2, device="cpu")
    _assert_same_sell(op_t, op_j)
    v = np.random.default_rng(4).random(160).astype(np.float32)
    np.testing.assert_allclose(rhs_t(v).numpy(), np.asarray(rhs_j(v)),
                               rtol=1e-6, atol=1e-9)
    assert abs(float(rhs_t(v).sum()) - 0.15) < 1e-6
    with pytest.raises(ValueError, match="alpha"):
        graphs.pagerank_system(16, alpha=1.0, device="cpu")


# --------------------------------------------------------------------------
# solves
# --------------------------------------------------------------------------
def _rhs(n, seed=1):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


SYSTEMS = {
    "poisson_ell": lambda: jax_stencils.poisson_2d(12, 12, fmt="ell",
                                                   backend="pallas"),
    "convdiff_banded": lambda: jax_stencils.convection_diffusion_2d(
        10, 10, backend="pallas"),
    "laplacian_sell": lambda: _jax_laplacian(128, backend="pallas"),
}


@functools.lru_cache(maxsize=None)
def _jax_sparse_solve(system, gs):
    op = SYSTEMS[system]()
    b = _rhs(op.shape[0])
    res = jax_gmres(op, jnp.asarray(b), m=20, tol=1e-5, gs=gs,
                    max_restarts=100)
    return convert.result_to_numpy(res)


@pytest.mark.parametrize("system", sorted(SYSTEMS))
@pytest.mark.parametrize("gs", ["cgs2", "fused"])
def test_sparse_gmres_matches_jax(system, gs, monkeypatch):
    """gs="fused" on a sparse operator degrades to "cgs2_fused" in both
    packages (no fused Arnoldi step without a dense A)."""
    calls = []
    monkeypatch.setattr(arnoldi_fused, "arnoldi_step",
                        lambda *a: calls.append("fused"))
    real = cgs2.cgs2
    monkeypatch.setattr(cgs2, "cgs2",
                        lambda *a: calls.append("cgs2_fused") or real(*a))
    op_j = SYSTEMS[system]()
    op = convert.operator(op_j, device="cpu")
    b = _rhs(op.shape[0])
    res = gmres(op, torch.from_numpy(b), m=20, tol=1e-5, gs=gs,
                max_restarts=100)
    ref = _jax_sparse_solve(system, gs)
    assert res.converged and bool(ref["converged"])
    assert abs(res.restarts - int(ref["restarts"])) <= 1
    assert set(calls) == ({"cgs2_fused"} if gs == "fused" else set())
    np.testing.assert_allclose(convert.to_numpy(res.x), ref["x"], rtol=1e-4,
                               atol=1e-5)
    dense = op.todense().double()
    rel = (dense @ res.x.double() - torch.from_numpy(b).double()).norm() \
        / np.linalg.norm(b)
    assert float(rel) < 2e-5
