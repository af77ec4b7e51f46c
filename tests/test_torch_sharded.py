"""The port's row-sharded slice in one process, on the CPU.

Kernels: the plain versions of the per-shard kernels (the wrappers run
them for CPU tensors) against the JAX Pallas kernels in interpret mode, on
inputs made with numpy from a seed: ``gs_project_partial`` (the split
projection of the sharded CGS2 step), ``block_gs_project`` (the sharded
block pass's projection), ``banded_powers_halo`` (the communication-
avoiding powers of one shard), and the halo modes ``banded_matvec_halo`` /
``ell_matvec_halo``.  Tolerances: float32 rtol = atol = 3e-5 (the JAX
package's kernel contract; sums run in another order), bfloat16 storage
2e-2.

Solves: ``gmres_sharded`` / ``gmres_sstep_sharded`` on a one-rank gloo
group (``init_method="file://..."`` in a temporary directory) against the
JAX package's solve on the in-process singleton mesh (its
``tests/test_distributed.py`` counterpart) and against the port's
single-device solve; JAX's scale-invariance case of the s-step
communication-avoiding path at 1e-4 and 1e4.  Bars (``tests/test_sharded
.py``'s): converged, true relative residual below 5e-5, x within 2e-3
(norm-wise relative), restarts within +-1.  The four-rank group is
``tests/test_torch_distributed.py``.

Also: ``GmresResult`` unpacks and ``_replace``s as JAX's does; a string
``axis_name``, a group that does not match the device, and a card that is
missing are refused; Chebyshev under a shard context runs its reference
recurrence over the operator's (halo) mat-vec, never the fused kernel.
The new kernels are held to their plain versions on the card by
``tests/test_torch_cuda.py`` (no JAX there) and ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402

from repro.compat import make_mesh  # noqa: E402
from repro.core import gmres as jax_gmres  # noqa: E402
from repro.core import gmres_sharded as jax_gmres_sharded  # noqa: E402
from repro.core import gmres_sstep_sharded as jax_sstep_sharded  # noqa: E402
from repro.core import operators as jax_ops  # noqa: E402
from repro.kernels import block_gs as jax_bgs  # noqa: E402
from repro.kernels import cgs2 as jax_cgs2  # noqa: E402
from repro.kernels import matrix_powers as jax_mp  # noqa: E402
from repro.kernels import spmv as jax_spmv  # noqa: E402
from repro_torch.core import (GmresResult, gmres, gmres_sharded,  # noqa: E402
                              gmres_sstep, gmres_sstep_sharded, operators,
                              preconditioners, stencils)
from repro_torch.kernels import block_gs, cgs2, spmv, tuning  # noqa: E402
from repro_torch.kernels import matrix_powers as mp  # noqa: E402

F32 = dict(rtol=3e-5, atol=3e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
DTYPES = [(torch.float32, jnp.float32, F32),
          (torch.bfloat16, jnp.bfloat16, BF16)]
SOLVE_RTOL = 2e-3
OFFSETS = (-3, -1, 0, 1, 3)


def _np(t):
    return t.detach().float().numpy()


def _basis(m1, n, j, seed):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, j + 1)))
    v = np.zeros((m1, n), np.float32)
    v[:j + 1] = q.T
    return v


def _mask(m1, j):
    return (np.arange(m1) <= j).astype(np.float32)


# --------------------------------------------------------------------------
# the per-shard kernels' plain versions vs the JAX kernels (interpret)
# --------------------------------------------------------------------------
@pytest.mark.parametrize("tdt,jdt,tol", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("j", [0, 4, 8])
def test_gs_project_partial_matches_jax(tdt, jdt, tol, j):
    v = _basis(9, 300, j, seed=j)
    w = np.random.default_rng(10 + j).standard_normal(300).astype(np.float32)
    want = jax_cgs2.gs_project_partial(jnp.asarray(v, jdt), jnp.asarray(w),
                                       jnp.asarray(_mask(9, j)),
                                       interpret=True)
    vt = torch.from_numpy(v).to(tdt)
    before = cgs2.gs_project_partial.launches
    got = cgs2.gs_project_partial(vt, torch.from_numpy(w), j)
    assert cgs2.gs_project_partial.launches == before   # CPU: no kernel
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **tol)
    np.testing.assert_array_equal(
        _np(got), _np(cgs2.gs_project_partial_plain(vt, torch.from_numpy(w),
                                                    j)))


@pytest.mark.parametrize("tdt,jdt,tol", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("k_start", [0, 5])
def test_block_gs_project_matches_jax(tdt, jdt, tol, k_start):
    rng = np.random.default_rng(20 + k_start)
    s = 4
    v = _basis(13, 300, k_start, seed=k_start)
    w = rng.standard_normal((s, 300)).astype(np.float32)
    tin = (np.eye(s) + 0.1 * rng.standard_normal((s, s))).astype(np.float32)
    q_j, c_j = jax_bgs.block_gs_project(
        jnp.asarray(v, jdt), jnp.asarray(w), jnp.asarray(tin),
        jnp.asarray(_mask(13, k_start)), interpret=True)
    q, c = block_gs.block_gs_project(torch.from_numpy(v).to(tdt),
                                     torch.from_numpy(w),
                                     torch.from_numpy(tin), k_start)
    np.testing.assert_allclose(_np(q), np.asarray(q_j, np.float32), **F32)
    np.testing.assert_allclose(_np(c), np.asarray(c_j, np.float32), **tol)
    assert not c[k_start + 1:].any()


@pytest.mark.parametrize("tdt,jdt,tol", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("s", [2, 4])
def test_banded_powers_halo_matches_jax(tdt, jdt, tol, s):
    rng = np.random.default_rng(30 + s)
    halo = max(abs(o) for o in OFFSETS)
    width = 40 + 2 * s * halo
    # a diagonally dominant stack scaled to ||B||_inf <= 1, as the solver
    # pre-scales it
    bands = rng.uniform(-0.1, 0.1, (5, width)).astype(np.float32)
    bands[2] = 0.5
    x = rng.standard_normal(width).astype(np.float32)
    z_j, n_j = jax_mp.banded_powers_halo(jnp.asarray(bands, jdt),
                                         jnp.asarray(x), OFFSETS, s,
                                         interpret=True)
    z, nrm = mp.banded_powers_halo(torch.from_numpy(bands).to(tdt),
                                   torch.from_numpy(x), OFFSETS, s)
    assert tuple(z.shape) == (s, 40) and tuple(nrm.shape) == (s,)
    np.testing.assert_allclose(_np(z), np.asarray(z_j, np.float32), **tol)
    np.testing.assert_allclose(_np(nrm), np.asarray(n_j, np.float32),
                               rtol=tol["rtol"], atol=tol["atol"])


@pytest.mark.parametrize("tdt,jdt,tol", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("k", [1, 3])
def test_banded_matvec_halo_matches_jax(tdt, jdt, tol, k):
    rng = np.random.default_rng(40 + k)
    bands = rng.standard_normal((5, 50)).astype(np.float32)
    shape = (56,) if k == 1 else (56, k)
    x = rng.standard_normal(shape).astype(np.float32)
    want = jax_spmv.banded_matvec_halo(jnp.asarray(bands, jdt),
                                       jnp.asarray(x), OFFSETS,
                                       interpret=True)
    got = spmv.banded_matvec_halo(torch.from_numpy(bands).to(tdt),
                                  torch.from_numpy(x), OFFSETS)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("tdt,jdt,tol", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("k", [1, 2])
def test_ell_matvec_halo_matches_jax(tdt, jdt, tol, k):
    rng = np.random.default_rng(50 + k)
    values = rng.standard_normal((50, 4)).astype(np.float32)
    cols = rng.integers(0, 56, (50, 4)).astype(np.int32)
    shape = (56,) if k == 1 else (56, k)
    x = rng.standard_normal(shape).astype(np.float32)
    want = jax_spmv.ell_matvec_halo(jnp.asarray(values, jdt),
                                    jnp.asarray(cols), jnp.asarray(x),
                                    interpret=True)
    got = spmv.ell_matvec_halo(torch.from_numpy(values).to(tdt),
                               torch.from_numpy(cols), torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **tol)


def test_halo_wrappers_check_shapes():
    bands = torch.zeros(5, 50)
    with pytest.raises(TypeError):
        spmv.banded_matvec_halo(bands, torch.zeros(50), OFFSETS)
    with pytest.raises(TypeError):
        spmv.ell_matvec_halo(torch.zeros(50, 4), torch.zeros(50, 4,
                                                               dtype=torch.int32),
                             torch.zeros(49))
    with pytest.raises(TypeError):
        mp.banded_powers_halo(torch.zeros(5, 20), torch.zeros(20), OFFSETS,
                              4)


# --------------------------------------------------------------------------
# one rank: the gloo group in this process vs JAX's singleton mesh
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def group(tmp_path_factory):
    if dist.is_initialized():
        pytest.skip("a process group is already initialized in this worker")
    path = tmp_path_factory.mktemp("gloo1") / "pg"
    dist.init_process_group("gloo", init_method=f"file://{path}", rank=0,
                            world_size=1)
    yield dist.group.WORLD
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def mesh():
    return make_mesh((1,), ("rows",))


def _b(n, seed=1):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def _check(port, jx, single, a_dense, b):
    assert port.converged and bool(jx.converged)
    assert abs(port.restarts - int(jx.restarts)) <= 1
    assert abs(port.restarts - single.restarts) <= 1
    x = port.x.double().numpy()
    rel = np.linalg.norm(a_dense @ x - b) / np.linalg.norm(b)
    assert rel < 5e-5, rel
    for other in (np.asarray(jx.x, np.float64), single.x.double().numpy()):
        err = np.linalg.norm(x - other) / np.linalg.norm(other)
        assert err < SOLVE_RTOL, err


@pytest.mark.parametrize("fmt,gs", [("banded", "cgs2_fused"),
                                    ("ell", "mgs"),
                                    ("dense", "cgs2_pipelined")])
def test_one_rank_solve_matches_jax_singleton_mesh(group, mesh, fmt, gs):
    if fmt == "dense":
        a = operators.random_diagdom(256, dominance=0.1, seed=0, device="cpu")
        op = operators.DenseOperator(a, device="cpu")
        jop = jax_ops.DenseOperator(jnp.asarray(a.numpy()), "pallas")
        a_dense = a.double().numpy()
    else:
        op = stencils.convection_diffusion_2d(16, 16, device="cpu")
        jop = jax_ops.BandedOperator(jnp.asarray(op.bands.numpy()),
                                     op.offsets, "pallas")
        a_dense = op.todense().double().numpy()
        if fmt == "ell":
            op, jop = op.to_ell(), jop.to_ell()
    b = _b(256)
    port = gmres_sharded(group, op, b, m=16, tol=1e-5, max_restarts=150,
                         gs=gs, device="cpu")
    jx = jax.jit(lambda bb: jax_gmres_sharded(
        mesh, "rows", jop, bb, m=16, tol=1e-5, max_restarts=150,
        gs=gs))(jnp.asarray(b))
    single = gmres(op, torch.from_numpy(b), m=16, tol=1e-5,
                   max_restarts=150, gs=gs)
    _check(port, jx, single, a_dense, b)


@pytest.mark.parametrize("gs", ["cgs2", "cgs2_pipelined"])
def test_one_rank_sstep_runs_the_ca_kernel(group, mesh, monkeypatch, gs):
    calls = {"banded_powers_halo": 0, "block_gs_project": 0}
    for mod, name in ((mp, "banded_powers_halo"),
                      (block_gs, "block_gs_project")):
        orig = getattr(mod, name)

        def spy(*a, _orig=orig, _name=name, **k):
            calls[_name] += 1
            return _orig(*a, **k)

        monkeypatch.setattr(mod, name, spy)
    op = stencils.convection_diffusion_2d(16, 16, device="cpu")
    jop = jax_ops.BandedOperator(jnp.asarray(op.bands.numpy()), op.offsets,
                                 "pallas")
    b = _b(256)
    port = gmres_sstep_sharded(group, op, b, s=4, blocks=4, tol=1e-5,
                               max_restarts=60, gs=gs, device="cpu")
    jx = jax.jit(lambda bb: jax_sstep_sharded(
        mesh, "rows", jop, bb, s=4, blocks=4, tol=1e-5, max_restarts=60,
        gs=gs))(jnp.asarray(b))
    single = gmres_sstep(op, torch.from_numpy(b), s=4, blocks=4, tol=1e-5,
                         max_restarts=60, gs=gs)
    _check(port, jx, single, op.todense().double().numpy(), b)
    assert calls["banded_powers_halo"] == 4 * port.restarts
    assert calls["block_gs_project"] == (8 * port.restarts
                                         if gs == "cgs2" else 0)


@pytest.mark.parametrize("scale", [1e-4, 1e4])
def test_sstep_sharded_scale_invariant_through_ca_kernel(group, mesh, scale):
    """JAX's case (tests/test_sharded.py): the raw powers of the CA path
    would overflow float32 at scale 1e4 with s = 8 without the theta
    pre-scaling."""
    base = stencils.poisson_2d(16, 16, device="cpu")
    op = operators.BandedOperator(base.bands * scale, base.offsets,
                                  device="cpu")
    jop = jax_ops.BandedOperator(jnp.asarray(op.bands.numpy()), op.offsets,
                                 "pallas")
    b = (np.sin(np.arange(256) * 0.37) * scale).astype(np.float32)
    sh = gmres_sstep_sharded(group, op, b, s=8, blocks=2, tol=1e-4,
                             max_restarts=60, device="cpu")
    ref = gmres_sstep(op, torch.from_numpy(b), s=8, blocks=2, tol=1e-4,
                      max_restarts=60)
    jx = jax.jit(lambda bb: jax_sstep_sharded(
        mesh, "rows", jop, bb, s=8, blocks=2, tol=1e-4,
        max_restarts=60))(jnp.asarray(b))
    assert bool(torch.isfinite(sh.x).all()), f"NaN at scale {scale}"
    assert sh.converged == ref.converged == bool(jx.converged)
    assert abs(sh.restarts - int(jx.restarts)) <= 1
    for other in (ref.x.numpy(), np.asarray(jx.x)):
        err = np.linalg.norm(sh.x.numpy() - other) / np.linalg.norm(other)
        assert err < SOLVE_RTOL, (scale, err)


def test_chebyshev_under_a_shard_runs_the_reference_recurrence(
        group, monkeypatch):
    op = stencils.convection_diffusion_2d(16, 16, device="cpu")
    pc = preconditioners.chebyshev(op)
    v = torch.from_numpy(_b(256, seed=3))
    single = pc(v)

    def boom(*a, **k):
        raise AssertionError("the fused Chebyshev kernel ran under a shard")

    monkeypatch.setattr(mp, "banded_cheb_apply", boom)
    tuning.COLLECTIVES["halo"] = 0
    with tuning.shard_context(group):
        got = pc.rebind(op)(v)
    assert tuning.COLLECTIVES["halo"] == len(pc.rhos)   # one per mat-vec
    np.testing.assert_allclose(got.numpy(), single.numpy(), rtol=1e-5,
                               atol=1e-6)


# --------------------------------------------------------------------------
# the result type and the refusals
# --------------------------------------------------------------------------
def test_gmres_result_unpacks_and_replaces_as_in_jax():
    a = operators.random_diagdom(32, device="cpu")
    b = _b(32)
    port = gmres(a, torch.from_numpy(b), m=8)
    jx = jax_gmres(jnp.asarray(a.numpy()), jnp.asarray(b), m=8)
    assert GmresResult._fields == type(jx)._fields
    for res in (port, jx):
        x, residual, restarts, converged, inner_steps, done, diag = res
        assert bool(converged) and bool(done) and diag is not None
        assert res._replace(x=None).x is None
        assert res._replace(x=None).restarts == restarts
    assert GmresResult(x=None, residual=0.0, restarts=0, converged=True,
                       inner_steps=0).done is None


def test_axis_name_must_be_a_process_group():
    a = operators.random_diagdom(16, device="cpu")
    b = torch.ones(16)
    with pytest.raises(TypeError, match="ProcessGroup"):
        gmres(a, b, axis_name="rows")
    with pytest.raises(TypeError, match="ProcessGroup"):
        gmres_sstep(a, b, s=2, blocks=2, axis_name="rows")
    with pytest.raises(TypeError, match="ProcessGroup"):
        gmres_sharded("rows", a, b, device="cpu")


def test_sharded_entry_points_need_a_card_unless_told(group, monkeypatch):
    op = stencils.poisson_2d(4, device="cpu")
    b = np.ones(16, np.float32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gmres_sharded(group, op, b)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gmres_sstep_sharded(group, op, b)
    # a card's tensors need an NCCL group: gloo is refused, not switched
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="nccl"):
        gmres_sharded(group, op, b)
    res = gmres_sharded(group, op, b, device="cpu")
    assert res.converged and res.x.device.type == "cpu"
