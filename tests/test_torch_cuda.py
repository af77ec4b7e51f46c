"""The port's CUDA kernels vs their plain versions, on the card.

Marked ``cuda``: without an NVIDIA GPU every test here skips (the decision
is made in a fixture, at run time).  On a machine with one:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances are relative to the largest entry of the plain result: 1e-4 for
float32 (the kernels sum in another order, over up to 10^4 terms) and
2e-2 for bfloat16 storage.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import gmres, operators  # noqa: E402
from repro_torch.kernels import arnoldi_fused, cgs2, matvec  # noqa: E402

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only there)")
    return torch.device("cuda")


def _relerr(got, want):
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def _basis(n, m1, j, dtype, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, _ = torch.linalg.qr(torch.randn(n, min(m1, n), device=dev, generator=g))
    v = torch.zeros(m1, n, device=dev)
    v[:min(m1, n)] = q.T
    v[j + 1:] = 0
    return v.to(dtype).contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,k", [(97, 1), (200, 6), (10_000, 1), (10_000, 4)])
def test_block_matvec_kernel_matches_plain(dev, n, k, dtype):
    g = torch.Generator(device=dev).manual_seed(n + k)
    a = torch.randn(n, n, device=dev, generator=g).to(dtype)
    x = torch.randn(n, k, device=dev, generator=g)
    before = matvec.block_matvec.launches
    y = matvec.block_matvec(a, x)
    torch.cuda.synchronize()
    assert matvec.block_matvec.launches == before + 1
    assert _relerr(y, matvec.block_matvec_plain(a, x)) < TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,m1,j", [(160, 31, 7), (300, 12, 5),
                                    (10_000, 31, 0), (10_000, 31, 29)])
def test_gs_project_and_arnoldi_kernels_match_plain(dev, n, m1, j, dtype):
    v = _basis(n, m1, j, dtype, dev)
    w = torch.randn(n, device=dev)
    h, w1 = cgs2.gs_project(v, w, j)
    hp, wp = cgs2.gs_project_plain(v, w, j)
    assert _relerr(h, hp) < TOL[dtype] and _relerr(w1, wp) < TOL[dtype]
    a = (torch.randn(n, n, device=dev) / n ** 0.5).to(dtype)
    h, w2 = arnoldi_fused.arnoldi_step(a, v, j)
    hp, wp = arnoldi_fused.arnoldi_step_plain(a, v, j)
    torch.cuda.synchronize()
    assert _relerr(h, hp) < TOL[dtype] and _relerr(w2, wp) < TOL[dtype]


def test_kernels_reject_unsupported_dtype(dev):
    a = torch.zeros(8, 8, device=dev, dtype=torch.float64)
    with pytest.raises(TypeError):
        matvec.block_matvec(a, torch.zeros(8, 1, device=dev))
    with pytest.raises(TypeError):
        arnoldi_fused.arnoldi_step(a, torch.zeros(4, 8, device=dev), 0)


@pytest.mark.parametrize("gs", ["cgs2", "cgs2_fused", "fused"])
def test_gmres_on_card_matches_cpu(dev, gs):
    a = operators.random_diagdom(400, dominance=0.3, seed=1, device="cpu")
    b = torch.from_numpy(np.random.default_rng(2).standard_normal(400)
                         .astype(np.float32))
    ref = gmres(operators.DenseOperator(a, device="cpu"), b, m=20, gs=gs)
    res = gmres(operators.DenseOperator(a, backend="cuda", device=dev),
                b.to(dev), m=20, gs=gs)
    assert res.converged and ref.converged
    assert abs(res.restarts - ref.restarts) <= 1
    torch.testing.assert_close(res.x.cpu(), ref.x, rtol=1e-4, atol=1e-5)


# --------------------------------------------------------------------------
# the sparse slice: SpMV kernels, batched CGS2, sparse and batched solves
# --------------------------------------------------------------------------
def _ell(n, width, dtype, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    vals = torch.randn(n, width, device=dev, generator=g)
    cols = torch.randint(0, n, (n, width), device=dev, generator=g,
                         dtype=torch.int32)
    vals[:, width // 2:] *= (torch.rand(n, 1, device=dev, generator=g)
                             < 0.5)           # ragged rows: padding slots
    cols[vals == 0] = 0
    return vals.to(dtype).contiguous(), cols


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 4, 11])
def test_spmv_kernels_match_plain(dev, k, dtype):
    from repro_torch.core import graphs, stencils
    from repro_torch.kernels import spmv

    n = 100_003
    g = torch.Generator(device=dev).manual_seed(k)
    x = torch.randn(n, k, device=dev, generator=g)
    vals, cols = _ell(n, 7, dtype, dev)
    assert _relerr(spmv.ell_matvec(vals, cols, x),
                   spmv.ell_matvec_plain(vals, cols, x)) < TOL[dtype]
    bands = torch.randn(5, n, device=dev, generator=g).to(dtype)
    for offsets in ((-317, -1, 0, 1, 317), (-7, -2, 0, 3, 40)):
        before = spmv.banded_matvec.launches
        y = spmv.banded_matvec(bands, x, offsets)
        assert spmv.banded_matvec.launches == before + -(-k // 8)
        assert _relerr(y, spmv.banded_matvec_plain(bands, x, offsets)) \
            < TOL[dtype]
    op = graphs.pagerank_system(2048, seed=0, device=dev)[0]
    op = operators.with_dtype(op, dtype)
    assert not op.identity_perm and len(op.bin_values) > 1
    xs = torch.randn(2048, k, device=dev, generator=g)
    before = spmv.sell_matvec.launches
    y = spmv.sell_matvec(op.bin_values, op.bin_cols, xs)
    assert spmv.sell_matvec.launches == before + len(op.bin_values) * -(-k // 8)
    assert _relerr(y, spmv.sell_matvec_plain(op.bin_values, op.bin_cols, xs)) \
        < TOL[dtype]
    torch.cuda.synchronize()
    st = stencils.poisson_2d(40, 30, fmt="sell", device=dev)
    assert st.identity_perm


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,n,js", [(4, 50_000, (0, 7, 15, 29)),
                                    (8, 8192, (30, -1, 3, 3, 0, 12, 29, 1)),
                                    (3, 300, (0, 5, 11))])
def test_batched_cgs2_kernel_matches_plain(dev, k, n, js, dtype):
    from repro_torch.kernels import block_gs

    m1 = 31
    v = torch.stack([_basis(n, m1, max(j, 0), torch.float32, dev, seed=i)
                     for i, j in enumerate(js)]).to(dtype).contiguous()
    w = torch.randn(k, n, device=dev)
    before = block_gs.batched_cgs2.launches
    h, w2 = block_gs.batched_cgs2(v, w, js)
    hp, wp = block_gs.batched_cgs2_plain(v, w, js)
    torch.cuda.synchronize()
    assert block_gs.batched_cgs2.launches == before + 1
    assert _relerr(h, hp) < TOL[dtype] and _relerr(w2, wp) < TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("j", [0, 29])
def test_gs_project_streams_a_large_basis(dev, j, dtype):
    """At n = 2^20 a block's basis slice does not fit shared memory, and
    gs_project takes its streamed variant."""
    n, m1 = 1 << 20, 31
    shape = cgs2.launch_shape(dtype, m1, n)
    assert shape["smem_bytes"] < 4 * m1 * shape["cols"]
    v = _basis(n, m1, j, dtype, dev)
    w = torch.randn(n, device=dev)
    h, w1 = cgs2.gs_project(v, w, j)
    hp, wp = cgs2.gs_project_plain(v, w, j)
    torch.cuda.synchronize()
    assert _relerr(h, hp) < TOL[dtype] and _relerr(w1, wp) < TOL[dtype]


def test_sparse_and_batched_solves_count_launches(dev):
    from repro_torch.core import gmres_batched, stencils
    from repro_torch.kernels import block_gs, spmv

    op = stencils.convection_diffusion_2d(64, 64, device=dev)
    b = torch.from_numpy(np.random.default_rng(1).standard_normal(4096)
                         .astype(np.float32)).to(dev)
    before = spmv.banded_matvec.launches
    res = gmres(op, b, m=30, tol=1e-5, max_restarts=200, gs="cgs2_fused")
    assert res.converged
    assert spmv.banded_matvec.launches - before == \
        res.inner_steps + res.restarts + 1
    ref = gmres(stencils.convection_diffusion_2d(64, 64, device="cpu"),
                b.cpu(), m=30, tol=1e-5, max_restarts=200)
    assert abs(res.restarts - ref.restarts) <= 1
    torch.testing.assert_close(res.x.cpu(), ref.x, rtol=1e-4, atol=1e-5)

    bs = torch.stack([b, b.flip(0), b.roll(7), b * 0.5])
    before = (spmv.banded_matvec.launches, block_gs.batched_cgs2.launches)
    res = gmres_batched(op, bs, m=30, tol=1e-5, max_restarts=200)
    d_spmv = spmv.banded_matvec.launches - before[0]
    d_gs = block_gs.batched_cgs2.launches - before[1]
    assert res.converged.all() and d_gs > 0
    assert d_spmv == d_gs + int(res.restarts.max()) + 1
