"""The port's pipelined single-reduce CGS2 vs the JAX package, on the CPU.

Kernels: each port wrapper runs its plain version (the tensors lie on the
CPU) against the JAX Pallas kernel in interpret mode, on inputs made with
numpy from a seed: the payload (``gs_project_norm_partial``,
``sr_payload``), the update (``gs_update``), the host recovery
(``sr_recover``) and the single-reduce block pass (``block_gs_project_gram``,
``block_gs_update``, ``block_gs_pass_single_reduce`` and its ``_ref``).

Solves: the port's ``gmres(gs="cgs2_pipelined")`` and
``gmres_sstep(gs="cgs2_pipelined")`` on operators carried across with
``convert.operator`` against the JAX solves on the same operator and b
(the systems of ``tests/test_pipelined.py``), plus the stability contracts
of that file (orthogonality against MGS, scale invariance) on the port.

Tolerances: float32 kernels rtol = atol = 3e-5 (the JAX package's kernel
contract; sums run in another order), bfloat16 storage 2e-2; the host
recovery 1e-6 (the same float32 algebra, another summation order); the
update's row-prefix call bit-equal to the full call (its rows are summed
in order, and a zero coefficient adds exactly 0); solves converged,
restarts within +-1, x within rtol 1e-3 / atol 1e-4 and the true relative
residual of the port's x below 5e-5 (the contract of
``tests/test_pipelined.py`` and ``tests/test_torch_sstep.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import arnoldi as jax_arnoldi  # noqa: E402
from repro.core import gmres as jax_gmres  # noqa: E402
from repro.core import gmres_sstep as jax_gmres_sstep  # noqa: E402
from repro.core import operators as jax_ops  # noqa: E402
from repro.core import stencils as jax_stencils  # noqa: E402
from repro.kernels import block_gs as jax_bgs  # noqa: E402
from repro.kernels import cgs2 as jax_cgs2  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import arnoldi, gmres, gmres_sstep  # noqa: E402
from repro_torch.core import operators, sstep, stencils  # noqa: E402
from repro_torch.kernels import block_gs, cgs2  # noqa: E402

F32 = dict(rtol=3e-5, atol=3e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
DTYPES = [(jnp.float32, F32), (jnp.bfloat16, BF16)]
RECOVER = dict(rtol=1e-6, atol=1e-6)
SOLVE = dict(rtol=1e-3, atol=1e-4)


def _np(t):
    return convert.to_numpy(t).astype(np.float32)


def _close(got, want, tol):
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(_np(g), np.asarray(w, np.float32), **tol)


def _basis(m1, n, j, seed):
    """(m1, n) float32: orthonormal rows 0..j, zeros after."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, j + 1)))
    v = np.zeros((m1, n), np.float32)
    v[:j + 1] = q.T
    return v


def _pair(v, dtype):
    """The same basis in JAX (at ``dtype``) and in the port."""
    v_j = jnp.asarray(v).astype(dtype)
    return v_j, convert.tensor(v_j, "cpu")


def _gram(m1, seed):
    """A symmetric near-identity (m1, m1) float32 Gram matrix."""
    e = np.random.default_rng(seed).standard_normal((m1, m1)) * 1e-3
    return (np.eye(m1) + e + e.T).astype(np.float32)


# --------------------------------------------------------------------------
# the pipelined step's kernels and recovery
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("j", [0, 8, 16])
def test_payload_matches_pallas(j, dtype, tol):
    """n = 300 (ragged), m1 = 17: j = 0, mid and m."""
    m1, n = 17, 300
    v_j, v_t = _pair(_basis(m1, n, j, seed=j), dtype)
    z = np.random.default_rng(100 + j).standard_normal(n).astype(np.float32)
    mask = (jnp.arange(m1) <= j).astype(jnp.float32)
    w2 = jnp.stack([jnp.asarray(z), v_j[j].astype(jnp.float32)], axis=1)
    want = jax_cgs2.gs_project_norm_partial(v_j, w2, mask, interpret=True)
    got = cgs2.gs_project_norm_partial(v_t, torch.from_numpy(z), j)
    assert got.shape == (m1 + 1, 2) and got.dtype == torch.float32
    _close([got], [want], tol)
    assert not got[j + 1:m1].any()            # masked rows
    _close([arnoldi.sr_payload(v_t, torch.from_numpy(z), j)],
           [jax_arnoldi.sr_payload(v_j, jnp.asarray(z), j)], tol)
    _close([arnoldi.sr_payload_ref(v_t, torch.from_numpy(z), j)],
           [jax_arnoldi.sr_payload_ref(v_j, jnp.asarray(z), j)], tol)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("j", [0, 8, 16])
def test_update_matches_pallas_and_prefix_is_exact(j, dtype, tol):
    m1, n = 17, 300
    rng = np.random.default_rng(200 + j)
    v_j, v_t = _pair(rng.standard_normal((m1, n)).astype(np.float32), dtype)
    w = rng.standard_normal(n).astype(np.float32)
    h = rng.standard_normal(m1).astype(np.float32)
    want = jax_cgs2.gs_update(v_j, jnp.asarray(w), jnp.asarray(h),
                              interpret=True)
    got = cgs2.gs_update(v_t, torch.from_numpy(w), torch.from_numpy(h))
    assert got.dtype == torch.float32
    _close([got], [want], tol)
    # the pipelined cycle's call: h zero past row j, V cut to rows 0..j
    h[j + 1:] = 0
    full = cgs2.gs_update(v_t, torch.from_numpy(w), torch.from_numpy(h))
    prefix = cgs2.gs_update(v_t[:j + 1], torch.from_numpy(w),
                            torch.from_numpy(h[:j + 1]))
    assert torch.equal(prefix, full)


@pytest.mark.parametrize("j", [0, 5, 16])
def test_sr_recover_matches_jax(j):
    """The same payload and Gram matrix: h_tot, ||w''||, ||z||^2 and the
    Gram matrix with row and column j overwritten by the measured row."""
    m1, n = 17, 300
    v = _basis(m1, n, m1 - 1, seed=300 + j)
    v[j + 1:] = 0
    z = np.random.default_rng(j).standard_normal(n).astype(np.float32)
    payload = _np(arnoldi.sr_payload_ref(torch.from_numpy(v),
                                         torch.from_numpy(z), j))
    gram = _gram(m1, seed=j)
    want = jax_arnoldi.sr_recover(jnp.asarray(payload), jnp.asarray(gram), j)
    got = arnoldi.sr_recover(payload.copy(), gram.copy(), j)
    assert got[0].dtype == np.float32 and got[3].dtype == np.float32
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), **RECOVER)
    np.testing.assert_array_equal(got[3][j], payload[:m1, 1]
                                  * (np.arange(m1) <= j))
    np.testing.assert_array_equal(got[3][:, j], got[3][j])


def test_step_rejects_pipelined_scheme_as_jax_does():
    """arnoldi.step is a per-step API: the whole-cycle scheme raises the
    JAX package's ValueError."""
    with pytest.raises(ValueError, match="cgs2_pipelined") as got:
        arnoldi.step("cgs2_pipelined")
    with pytest.raises(ValueError) as want:
        jax_arnoldi.step("cgs2_pipelined")
    assert str(got.value) == str(want.value)


# --------------------------------------------------------------------------
# the single-reduce block pass
# --------------------------------------------------------------------------
def _block_inputs(m1, k_start, s, dtype):
    n = 300
    rng = np.random.default_rng(m1 * 100 + k_start * 10 + s)
    v_j, v_t = _pair(_basis(m1, n, k_start, seed=m1 + k_start), dtype)
    w = rng.standard_normal((s, n)).astype(np.float32)
    tin = np.triu(rng.standard_normal((s, s))).astype(np.float32)
    tin += 2 * np.eye(s, dtype=np.float32)
    return v_j, v_t, w, tin, _gram(m1, seed=k_start)


BLOCK_CASES = [(9, 0), (9, 4), (9, 8), (17, 0), (17, 8), (17, 16)]


@pytest.mark.parametrize("s", [2, 4])
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("m1,k_start", BLOCK_CASES)
def test_block_pair_kernels_match_pallas(m1, k_start, dtype, tol, s):
    v_j, v_t, w, tin, _ = _block_inputs(m1, k_start, s, dtype)
    want = jax_bgs.block_gs_project_gram(v_j, jnp.asarray(w),
                                         jnp.asarray(tin), interpret=True)
    got = block_gs.block_gs_project_gram(v_t, torch.from_numpy(w),
                                         torch.from_numpy(tin))
    _close(got, want, tol)
    q = np.array(want[0])
    c = np.random.default_rng(s).standard_normal((m1, s)).astype(np.float32)
    want = jax_bgs.block_gs_update(v_j, jnp.asarray(q), jnp.asarray(c),
                                   interpret=True)
    got = block_gs.block_gs_update(v_t, torch.from_numpy(q),
                                   torch.from_numpy(c))
    assert all(t.dtype == torch.float32 for t in got)
    _close(got, want, tol)


@pytest.mark.parametrize("s", [2, 4])
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("m1,k_start", BLOCK_CASES)
def test_single_reduce_pass_matches_pallas_and_ref(m1, k_start, dtype, tol,
                                                    s):
    """The port's pass reads only rows 0..k_start (the rows past them are
    zero here, as in the s-step cycle) against the JAX kernel pass and its
    jnp reference over every row; the port's own ref likewise."""
    v_j, v_t, w, tin, gram = _block_inputs(m1, k_start, s, dtype)
    mask = (jnp.arange(m1) <= k_start).astype(jnp.float32)
    args_j = (v_j, jnp.asarray(w), jnp.asarray(tin), mask, jnp.asarray(gram))
    args_t = (v_t, torch.from_numpy(w), torch.from_numpy(tin), k_start,
              torch.from_numpy(gram))
    want = jax_bgs.block_gs_pass_single_reduce(*args_j, interpret=True)
    got = block_gs.block_gs_pass_single_reduce(*args_t)
    assert [tuple(t.shape) for t in got] == [(m1, s), (s, 300), (s, s),
                                             (m1, s)]
    _close(got, want, tol)
    _close(got, jax_bgs.block_gs_pass_single_reduce_ref(*args_j), tol)
    _close(block_gs.block_gs_pass_single_reduce_ref(*args_t),
           jax_bgs.block_gs_pass_single_reduce_ref(*args_j), tol)
    assert not got[0][k_start + 1:].any()


def test_single_reduce_kernels_raise_on_bad_shapes():
    v = torch.ones(5, 20)
    with pytest.raises(TypeError, match="tin"):
        block_gs.block_gs_project_gram(v, torch.ones(2, 20), torch.eye(3))
    with pytest.raises(TypeError, match="c"):
        block_gs.block_gs_update(v, torch.ones(2, 20), torch.ones(4, 2))
    with pytest.raises(ValueError, match="k_start"):
        block_gs.block_gs_pass_single_reduce(v, torch.ones(2, 20),
                                             torch.eye(2), 5, torch.eye(5))
    with pytest.raises(TypeError, match="h"):
        cgs2.gs_update(v, torch.ones(20), torch.ones(4))
    with pytest.raises(ValueError, match="j = 5"):
        cgs2.gs_project_norm_partial(v, torch.ones(20), 5)


# --------------------------------------------------------------------------
# solves
# --------------------------------------------------------------------------
def _system(fmt, nx=8, seed=0):
    """The systems of tests/test_pipelined.py: dense random_diagdom, the
    nx x nx banded Poisson stencil and its ELL copy; b from numpy."""
    n = nx * nx
    if fmt == "dense":
        a = operators.random_diagdom(n, seed=seed, device="cpu").numpy()
        op_j = jax_ops.DenseOperator(jnp.asarray(a), backend="pallas")
    elif fmt == "banded":
        op_j = jax_stencils.poisson_2d(nx, nx, backend="pallas")
    else:
        op_j = jax_stencils.poisson_2d(nx, nx, backend="pallas").to_ell()
    b = np.random.default_rng(seed + 1).standard_normal(n).astype(np.float32)
    return op_j, convert.operator(op_j, "cpu"), b


def _relres(op_t, x, b):
    a = op_t.todense().double() if hasattr(op_t, "todense") \
        else op_t.a.double()
    r = a @ x.double() - torch.from_numpy(b).double()
    return float(r.norm() / np.linalg.norm(b))


def _assert_parity(want, got):
    assert bool(want.converged) and got.converged
    assert abs(int(want.restarts) - got.restarts) <= 1
    np.testing.assert_allclose(_np(got.x), np.asarray(want.x, np.float32),
                               **SOLVE)


@pytest.mark.parametrize("fmt", ["dense", "banded", "ell"])
def test_gmres_pipelined_matches_jax(fmt):
    op_j, op_t, b = _system(fmt)
    kw = dict(m=16, tol=1e-5, max_restarts=100, gs="cgs2_pipelined")
    want = jax_gmres(op_j, jnp.asarray(b), **kw)
    got = gmres(op_t, torch.from_numpy(b), **kw)
    _assert_parity(want, got)
    assert _relres(op_t, got.x, b) < 5e-5
    assert got.diagnostics.residual_history[-1] == np.float32(got.residual)


def test_gmres_pipelined_jacobi_precond_matches_jax():
    """A callable Jacobi M^-1 on both sides: op = A M^-1 and
    x = x0 + M^-1 dx, as JAX applies it."""
    op_j = jax_stencils.convection_diffusion_2d(8, 8, beta=(0.3, 0.2),
                                                backend="pallas")
    op_t = convert.operator(op_j, "cpu")
    d = np.asarray(op_j.bands[op_j.offsets.index(0)], np.float32)
    inv_j, inv_t = jnp.asarray(1 / d), torch.from_numpy(1 / d)
    b = np.random.default_rng(3).standard_normal(64).astype(np.float32)
    kw = dict(m=16, tol=1e-5, max_restarts=100, gs="cgs2_pipelined")
    want = jax_gmres(op_j, jnp.asarray(b), precond=lambda v: inv_j * v, **kw)
    got = gmres(op_t, torch.from_numpy(b), precond=lambda v: inv_t * v, **kw)
    _assert_parity(want, got)
    assert _relres(op_t, got.x, b) < 5e-5


@pytest.mark.parametrize("fmt", ["dense", "banded"])
def test_gmres_sstep_single_reduce_matches_jax(fmt):
    op_j, op_t, b = _system(fmt, seed=14)
    kw = dict(s=4, blocks=4, tol=1e-5, max_restarts=60, gs="cgs2_pipelined")
    want = jax_gmres_sstep(op_j, jnp.asarray(b), **kw)
    got = gmres_sstep(op_t, torch.from_numpy(b), **kw)
    _assert_parity(want, got)
    split = gmres_sstep(op_t, torch.from_numpy(b),
                        **dict(kw, gs="cgs2"))
    assert abs(split.restarts - got.restarts) <= 1


@pytest.mark.parametrize("nx", [64, 128])
def test_pipelined_schemes_match_their_split_schemes_on_a_stencil(nx):
    """The port alone, on the convection-diffusion stencil of the card's
    cells at 64^2 and 128^2 (256^2 runs on the card,
    tests/test_torch_cuda.py): the pipelined solve against cgs2_fused and
    the single-reduce s-step against the split one: restarts within +-1
    (another summation order moves an s-step solve by one), x within 1e-4
    (norm-wise)."""
    op = stencils.convection_diffusion_2d(nx, nx, beta=(0.5, 0.25),
                                          device="cpu")
    b = torch.from_numpy(np.random.default_rng(1).standard_normal(nx * nx)
                         .astype(np.float32))
    kw = dict(tol=1e-5, max_restarts=300)
    for pair in ((gmres, dict(m=30, gs="cgs2_fused")),
                 (gmres_sstep, dict(s=5, blocks=6, gs="cgs2"))):
        solve, args = pair
        ref = solve(op, b, **kw, **args)
        got = solve(op, b, **kw, **dict(args, gs="cgs2_pipelined"))
        assert ref.converged and got.converged
        assert abs(got.restarts - ref.restarts) <= 1
        assert float((got.x - ref.x).norm() / ref.x.norm()) < 1e-4


def test_sstep_basis_rows_past_k_start_are_zero(monkeypatch):
    """The single-reduce pass reads only rows 0..k_start: every call in a
    solve must find the rows past k_start zero (the cycle's fresh
    ``torch.zeros`` basis)."""
    orig = block_gs.block_gs_pass_single_reduce
    seen = []

    def spy(v, w, tin, k_start, gram):
        assert not v[k_start + 1:].any(), k_start
        seen.append(k_start)
        return orig(v, w, tin, k_start, gram)

    monkeypatch.setattr(block_gs, "block_gs_pass_single_reduce", spy)
    _, op_t, b = _system("banded", seed=18)
    res = gmres_sstep(op_t, torch.from_numpy(b), s=2, blocks=4, tol=1e-5,
                      max_restarts=40, gs="cgs2_pipelined")
    assert res.converged
    assert seen[:8] == [0, 0, 2, 2, 4, 4, 6, 6]
    assert len(seen) == 8 * res.restarts


def test_pipelined_orthogonality_loss_bounded_vs_mgs(monkeypatch):
    """CGS2-class orthogonality of the basis the port's pipelined cycle
    builds: ||I - V V^T|| within 10x the MGS loss on the same Krylov space
    (the contract of tests/test_pipelined.py)."""
    n, m = 96, 20
    a = operators.random_diagdom(n, dominance=1.5, seed=5, device="cpu")
    b = torch.from_numpy(np.random.default_rng(6).standard_normal(n)
                         .astype(np.float32))
    bases = []
    orig = arnoldi.sr_payload

    def spy(v, z, j):
        if not bases:
            bases.append(v)          # the cycle fills this tensor in place
        return orig(v, z, j)

    monkeypatch.setattr(arnoldi, "sr_payload", spy)
    res = gmres(a, b, m=m, tol=1e-30, max_restarts=1, gs="cgs2_pipelined")
    k = res.inner_steps + 1
    vp = bases[0][:k].double()
    vm = torch.zeros(k, n, dtype=torch.float32)
    vm[0] = b / b.norm()
    for j in range(k - 1):
        w = a @ vm[j]
        for i in range(j + 1):
            w = w - torch.dot(vm[i], w) * vm[i]
        vm[j + 1] = w / w.norm()
    vm = vm.double()
    eye = torch.eye(k, dtype=torch.float64)
    loss_pipe = float(torch.linalg.norm(eye - vp @ vp.T))
    loss_mgs = float(torch.linalg.norm(eye - vm @ vm.T))
    eps = float(np.finfo(np.float32).eps)
    assert k > 10
    assert loss_pipe <= max(10.0 * loss_mgs, 100 * eps * (m + 1)), \
        (loss_pipe, loss_mgs)


@pytest.mark.parametrize("c", [1e-6, 1e6])
def test_pipelined_scale_invariant(c):
    """The relative guards (the done test, the breakdown floor) hold at
    extreme system scales."""
    n = 100
    a = operators.random_diagdom(n, seed=7, device="cpu")
    b = torch.from_numpy(np.random.default_rng(8).standard_normal(n)
                         .astype(np.float32))
    kw = dict(m=16, tol=1e-5, max_restarts=100, gs="cgs2_pipelined")
    ref = gmres(a, b, **kw)
    scaled = gmres(a * c, b * c, **kw)
    assert bool(torch.isfinite(scaled.x).all()), f"non-finite x at c={c}"
    assert scaled.converged and ref.converged
    assert float((scaled.x - ref.x).norm() / ref.x.norm()) < 1e-3
    assert scaled.restarts == ref.restarts


def test_pipelined_dispatch_hits_both_kernels(monkeypatch):
    """Every step runs one payload and two updates; no fused GS pass."""
    calls = {"payload": 0, "update": 0, "project": 0}

    def spy(key, fn):
        def wrapped(*args):
            calls[key] += 1
            return fn(*args)
        return wrapped

    monkeypatch.setattr(cgs2, "gs_project_norm_partial",
                        spy("payload", cgs2.gs_project_norm_partial))
    monkeypatch.setattr(cgs2, "gs_update", spy("update", cgs2.gs_update))
    monkeypatch.setattr(cgs2, "gs_project", spy("project", cgs2.gs_project))
    _, op_t, b = _system("dense", seed=10)
    res = gmres(op_t, torch.from_numpy(b), m=12, tol=1e-5, max_restarts=100,
                gs="cgs2_pipelined")
    assert res.converged
    assert calls == {"payload": res.inner_steps,
                     "update": 2 * res.inner_steps, "project": 0}


def test_bf16_basis_pipelined_matches_jax():
    op_j, op_t, b = _system("banded", seed=4)
    kw = dict(m=16, tol=1e-4, max_restarts=100, gs="cgs2_pipelined")
    want = jax_gmres(op_j, jnp.asarray(b), compute_dtype=jnp.bfloat16, **kw)
    got = gmres(op_t, torch.from_numpy(b), compute_dtype=torch.bfloat16,
                **kw)
    assert bool(want.converged) and got.converged
    assert abs(int(want.restarts) - got.restarts) <= 1
    np.testing.assert_allclose(_np(got.x), np.asarray(want.x, np.float32),
                               **BF16)
    assert _relres(op_t, got.x, b) <= 2e-4


def test_sstep_single_reduce_rejects_unknown_gs():
    _, op_t, b = _system("banded", seed=19)
    with pytest.raises(ValueError, match="unknown gs"):
        gmres_sstep(op_t, torch.from_numpy(b), s=2, blocks=2, gs="mgs")
    assert sstep._make_block_fns(op_t, 2, torch.float32,
                                 "cgs2_pipelined")[1] \
        is block_gs.block_gs_pass_single_reduce
