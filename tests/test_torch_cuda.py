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
    assert spmv.sell_matvec.launches == before + -(-k // 8)
    assert _relerr(y, spmv.sell_matvec_plain(op.bin_values, op.bin_cols, xs)) \
        < TOL[dtype]
    torch.cuda.synchronize()
    st = stencils.poisson_2d(40, 30, fmt="sell", device=dev)
    assert st.identity_perm


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 8, 11])
@pytest.mark.parametrize("with_perm", [False, True])
def test_sell_bin_table_kernel_matches_plain(dev, k, dtype, with_perm):
    """The bin-table kernel against the plain version: each bin alone (a
    one-bin table), then the whole table in one launch per chunk of 8
    columns, in the sorted frame or written through perm."""
    from repro_torch.core import graphs
    from repro_torch.kernels import spmv

    op = operators.with_dtype(graphs.pagerank_system(2048, seed=0,
                                                     device=dev)[0], dtype)
    g = torch.Generator(device=dev).manual_seed(k)
    x = torch.randn(2048, k, device=dev, generator=g)
    perm = op.perm if with_perm else None
    want = spmv.sell_matvec_plain(op.bin_values, op.bin_cols, x)
    r0 = 0
    for bv, bc in zip(op.bin_values, op.bin_cols):
        rows = bv.shape[0]
        sub = None if perm is None else \
            torch.arange(rows, dtype=torch.int32, device=dev).flip(0)
        got = spmv.sell_matvec((bv,), (bc,), x, sub)
        part = want[r0:r0 + rows]
        if sub is not None:
            part = part.flip(0)
        assert _relerr(got, part) < TOL[dtype], (bv.shape, with_perm)
        r0 += rows
    before = spmv.sell_matvec.launches
    got = spmv.sell_matvec(op.bin_values, op.bin_cols, x, perm)
    torch.cuda.synchronize()
    assert spmv.sell_matvec.launches == before + -(-k // 8)
    if perm is not None:
        want = torch.zeros_like(want).index_copy_(0, perm.long(), want)
    assert _relerr(got, want) < TOL[dtype]
    if with_perm:
        assert _relerr(op(x), want) < TOL[dtype]


def test_sell_hub_bin_at_every_width_and_the_table_limit(dev):
    from repro_torch.core import graphs
    from repro_torch.kernels import spmv

    op = graphs.pagerank_system(2048, seed=0, device=dev)[0]
    bv, bc = op.bin_values[0], op.bin_cols[0]
    x = torch.randn(2048, 3, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(0))
    want = spmv.ell_matvec_plain(bv, bc, x)
    for tpr in (1, 2, 4, 8, 16, 32, 64, 128, 256):
        y = torch.empty(bv.shape[0], 3, device=dev)
        spmv._launch_sell((bv,), (bc,), x, y, None, "hub bin", (tpr,))
        torch.cuda.synchronize()
        assert _relerr(y, want) < TOL[torch.float32], tpr
    n = spmv.MAX_SELL_BINS
    y = spmv.sell_matvec((bv,) * n, (bc,) * n, x)
    assert _relerr(y, want.repeat(n, 1)) < TOL[torch.float32]
    with pytest.raises(ValueError, match="bins"):
        spmv.sell_matvec((bv,) * (n + 1), (bc,) * (n + 1), x)


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
    gs_project takes the streamed kernel (one launch, 16-byte pieces).
    w is seeded and has a part in the basis's span, as an Arnoldi step's
    has (``_krylov_w``)."""
    n, m1 = 1 << 20, 31
    shape = cgs2.launch_shape(dtype, m1, n)
    assert shape["smem_bytes"] < 4 * m1 * shape["cols"]
    assert shape["route"] == "vec"
    v = _basis(n, m1, j, dtype, dev)
    w = _krylov_w(v, j, j)
    before = (cgs2.gs_project.launches, dict(cgs2.gs_project.routes))
    h, w1 = cgs2.gs_project(v, w, j)
    hp, wp = cgs2.gs_project_plain(v, w, j)
    torch.cuda.synchronize()
    assert cgs2.gs_project.launches == before[0] + 1
    assert cgs2.gs_project.routes["vec"] == before[1]["vec"] + 1
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


# --------------------------------------------------------------------------
# the s-step slice: matrix powers, block Gram-Schmidt, s-step solves
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [2, 5, 8])
def test_powers_kernels_match_plain(dev, s, dtype):
    from repro_torch.core import stencils
    from repro_torch.kernels import matrix_powers as mp

    op = operators.with_dtype(
        stencils.convection_diffusion_2d(100, 77, device=dev), dtype)
    ell = op.to_ell()
    n = op.shape[0]
    g = torch.Generator(device=dev).manual_seed(s)
    x = torch.randn(n, device=dev, generator=g)
    for shifts in (None, torch.linspace(0.5, 7.5, s, device=dev)):
        before = (mp.banded_powers.launches, mp.ell_powers.launches)
        u, sig = mp.banded_powers(op.bands, x, op.offsets, s, shifts=shifts)
        ue, sige = mp.ell_powers(ell.values, ell.cols, x, s, shifts=shifts)
        assert (mp.banded_powers.launches, mp.ell_powers.launches) == \
            (before[0] + 1, before[1] + 1)
        up, sigp = mp.banded_powers_plain(op.bands, x, op.offsets, s,
                                          shifts=shifts)
        torch.cuda.synchronize()
        assert _relerr(u, up) < TOL[dtype] and _relerr(sig, sigp) < TOL[dtype]
        # one row partition and one order: the same bits in both formats
        assert torch.equal(u, ue) and torch.equal(sig, sige)
    a = (torch.randn(3001, 3001, device=dev, generator=g) / 3001 ** 0.5
         + 2 * torch.eye(3001, device=dev)).to(dtype)
    x = torch.randn(3001, device=dev, generator=g)
    u, sig = mp.dense_powers(a, x, s)
    up, sigp = mp.dense_powers_plain(a, x, s)
    torch.cuda.synchronize()
    assert _relerr(u, up) < TOL[dtype] and _relerr(sig, sigp) < TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [2, 5, 8])
@pytest.mark.parametrize("n,k_start", [(300, 0), (10_000, 10),
                                       (100_003, 25)])
def test_block_gs_pass_kernel_matches_plain(dev, n, k_start, s, dtype):
    from repro_torch.kernels import block_gs

    m1 = 31
    v = _basis(n, m1, k_start, dtype, dev)
    g = torch.Generator(device=dev).manual_seed(n + s)
    w = torch.randn(s, n, device=dev, generator=g)
    tin = torch.triu(torch.randn(s, s, device=dev, generator=g)) \
        + 2 * torch.eye(s, device=dev)
    before = block_gs.block_gs_pass.launches
    got = block_gs.block_gs_pass(v, w, tin, k_start)
    want = block_gs.block_gs_pass_plain(v, w, tin, k_start)
    torch.cuda.synchronize()
    assert block_gs.block_gs_pass.launches == before + 1
    assert not got[0][k_start + 1:].any()
    for gt, wt in zip(got, want):
        assert _relerr(gt, wt) < TOL[dtype]


def test_sstep_kernels_reject_float64(dev):
    from repro_torch.kernels import block_gs
    from repro_torch.kernels import matrix_powers as mp

    f64 = dict(device=dev, dtype=torch.float64)
    with pytest.raises(TypeError):
        mp.dense_powers(torch.eye(8, **f64), torch.ones(8, device=dev), 2)
    with pytest.raises(TypeError):
        mp.banded_powers(torch.ones(1, 8, **f64), torch.ones(8, device=dev),
                         (0,), 2)
    with pytest.raises(TypeError):
        block_gs.block_gs_pass(torch.zeros(4, 8, **f64),
                               torch.zeros(2, 8, device=dev),
                               torch.eye(2, device=dev), 0)


@pytest.mark.parametrize("fmt", ["banded", "ell", "sell", "dense"])
@pytest.mark.parametrize("basis", ["monomial", "newton"])
def test_sstep_solves_count_launches(dev, fmt, basis):
    from repro_torch.core import gmres_sstep, stencils
    from repro_torch.kernels import block_gs, spmv
    from repro_torch.kernels import matrix_powers as mp

    s, blocks = 5, 6
    if fmt == "dense":
        a = operators.random_diagdom(1000, dominance=0.3, seed=1,
                                     device="cpu")
        op_c = operators.DenseOperator(a, backend="cuda", device=dev)
        op_h = operators.DenseOperator(a, device="cpu")
    else:
        op_c = stencils.convection_diffusion_2d(32, 32, fmt=fmt, device=dev)
        op_h = stencils.convection_diffusion_2d(32, 32, fmt=fmt,
                                                device="cpu")
    n = op_c.shape[0]
    b = torch.from_numpy(np.random.default_rng(1).standard_normal(n)
                         .astype(np.float32))
    counters = {"banded": mp.banded_powers, "ell": mp.ell_powers,
                "dense": mp.dense_powers, "gs": block_gs.block_gs_pass,
                "sell": spmv.sell_matvec, "gemv": matvec.block_matvec}
    before = {k: f.launches for k, f in counters.items()}
    res = gmres_sstep(op_c, b.to(dev), s=s, blocks=blocks, tol=1e-5,
                      max_restarts=200, basis=basis)
    d = {k: f.launches - before[k] for k, f in counters.items()}
    ref = gmres_sstep(op_h, b, s=s, blocks=blocks, tol=1e-5,
                      max_restarts=200, basis=basis)
    assert res.converged and ref.converged
    assert abs(res.restarts - ref.restarts) <= 1
    diff = float((res.x.cpu() - ref.x).norm() / ref.x.norm())
    assert diff <= 1e-3
    cycles = res.restarts
    assert d["gs"] == 2 * blocks * cycles
    kernel = {"banded": "banded", "ell": "ell", "dense": "dense"}.get(fmt)
    if fmt == "dense" and basis == "newton":
        kernel = None                   # reference powers over the GEMV
    for name in ("banded", "ell", "dense"):
        assert d[name] == (blocks * cycles if name == kernel else 0)
    residuals = cycles + 1
    if fmt == "sell":                   # one launch per mat-vec
        assert d["sell"] == s * blocks * cycles + residuals
    if fmt == "dense":
        assert d["gemv"] == residuals + (s * blocks * cycles
                                         if kernel is None else 0)


def test_cuda_tensors_never_reach_plain_versions(dev, monkeypatch):
    from repro_torch.core import gmres_sstep, stencils
    from repro_torch.kernels import block_gs
    from repro_torch.kernels import matrix_powers as mp

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached a plain version")

    for name in ("banded_powers_plain", "ell_powers_plain",
                 "dense_powers_plain"):
        monkeypatch.setattr(mp, name, refuse)
    for name in ("block_gs_pass_plain", "block_gs_project_gram_plain",
                 "block_gs_update_plain", "block_gs_pass_single_reduce_ref"):
        monkeypatch.setattr(block_gs, name, refuse)
    for name in ("gs_project_norm_partial_plain", "gs_update_plain"):
        monkeypatch.setattr(cgs2, name, refuse)
    from repro_torch.core import graphs
    from repro_torch.kernels import attention as attention_k
    from repro_torch.kernels import spmv
    for name in ("sell_matvec_plain", "ell_matvec_plain"):
        monkeypatch.setattr(spmv, name, refuse)
    monkeypatch.setattr(attention_k, "attention_plain", refuse)
    pr = graphs.pagerank_system(2048, seed=0, device=dev)[0]
    res = gmres(pr, torch.ones(2048, device=dev) / 2048, m=30, tol=1e-5)
    assert res.converged
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.ones(1, 2, 64, 112, device=dev, dtype=dtype)
        assert bool(torch.isfinite(attention_k.attention(q, q, q)).all())
    b = torch.from_numpy(np.random.default_rng(2).standard_normal(1 << 16)
                         .astype(np.float32)).to(dev)
    for fmt in ("banded", "ell"):
        op = stencils.convection_diffusion_2d(256, 256, fmt=fmt, device=dev)
        for gs in ("cgs2", "cgs2_pipelined"):
            res = gmres_sstep(op, b, s=5, blocks=6, tol=1e-3, max_restarts=3,
                              gs=gs)
            assert bool(torch.isfinite(res.x).all())
        res = gmres(op, b, m=30, tol=1e-3, max_restarts=3,
                    gs="cgs2_pipelined")
        assert bool(torch.isfinite(res.x).all())
    a = operators.random_diagdom(2000, seed=2, device=dev)
    for gs in ("cgs2", "cgs2_pipelined"):
        res = gmres_sstep(a, b[:2000], s=5, blocks=6, tol=1e-5, gs=gs)
        assert res.converged
    res = gmres(operators.DenseOperator(a, backend="cuda"), b[:2000], m=30,
                tol=1e-5, gs="cgs2_pipelined")
    assert res.converged


# --------------------------------------------------------------------------
# the pipelined slice: single-reduce payload, update, block pair, solves
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,j", [(300, 0), (10_000, 15), (100_003, 29),
                                 (1 << 20, 15)])
def test_payload_and_update_kernels_match_plain(dev, n, j, dtype):
    m1 = 31
    v = _basis(n, m1, j, dtype, dev)
    g = torch.Generator(device=dev).manual_seed(n + j)
    z = torch.randn(n, device=dev, generator=g)
    before = (cgs2.gs_project_norm_partial.launches, cgs2.gs_update.launches)
    p = cgs2.gs_project_norm_partial(v, z, j)
    pp = cgs2.gs_project_norm_partial_plain(v, z, j)
    h = torch.randn(m1, device=dev, generator=g)
    h[j + 1:] = 0
    w1 = cgs2.gs_update(v, z, h)
    wp = cgs2.gs_update_plain(v, z, h)
    w_prefix = cgs2.gs_update(v[:j + 1], z, h[:j + 1])
    torch.cuda.synchronize()
    assert (cgs2.gs_project_norm_partial.launches,
            cgs2.gs_update.launches) == (before[0] + 1, before[1] + 2)
    assert not p[j + 1:m1].any()
    assert _relerr(p, pp) < TOL[dtype] and _relerr(w1, wp) < TOL[dtype]
    assert torch.equal(w_prefix, w1)
    # the same bits every run: partials reduced in one fixed order
    assert torch.equal(cgs2.gs_project_norm_partial(v, z, j), p)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [2, 5, 8])
@pytest.mark.parametrize("n,k_start", [(300, 0), (10_000, 10),
                                       (100_003, 25)])
def test_single_reduce_block_kernels_match_plain(dev, n, k_start, s, dtype):
    from repro_torch.kernels import block_gs

    m1 = 31
    v = _basis(n, m1, k_start, dtype, dev)
    g = torch.Generator(device=dev).manual_seed(n + s)
    w = torch.randn(s, n, device=dev, generator=g)
    tin = torch.triu(torch.randn(s, s, device=dev, generator=g)) \
        + 2 * torch.eye(s, device=dev)
    before = (block_gs.block_gs_project_gram.launches,
              block_gs.block_gs_update.launches)
    vp = v[:k_start + 1]
    got = block_gs.block_gs_project_gram(vp, w, tin)
    want = block_gs.block_gs_project_gram_plain(vp, w, tin)
    c = torch.randn(k_start + 1, s, device=dev, generator=g)
    got_u = block_gs.block_gs_update(vp, got[0], c)
    want_u = block_gs.block_gs_update_plain(vp, got[0], c)
    gram = torch.eye(m1, device=dev)
    got_p = block_gs.block_gs_pass_single_reduce(v, w, tin, k_start, gram)
    want_p = block_gs.block_gs_pass_single_reduce_ref(v, w, tin, k_start,
                                                      gram)
    torch.cuda.synchronize()
    assert (block_gs.block_gs_project_gram.launches,
            block_gs.block_gs_update.launches) == (before[0] + 2,
                                                   before[1] + 2)
    assert torch.equal(got[2], got[2].T)           # M symmetric to the bit
    for gt, wt in zip((*got, *got_u, *got_p), (*want, *want_u, *want_p)):
        assert _relerr(gt, wt) < TOL[dtype]


def test_single_reduce_kernels_reject_float64(dev):
    from repro_torch.kernels import block_gs

    f64 = dict(device=dev, dtype=torch.float64)
    with pytest.raises(TypeError):
        cgs2.gs_project_norm_partial(torch.zeros(4, 8, **f64),
                                     torch.zeros(8, device=dev), 0)
    with pytest.raises(TypeError):
        cgs2.gs_update(torch.zeros(4, 8, device=dev), torch.zeros(8, **f64),
                       torch.zeros(4, device=dev))
    with pytest.raises(TypeError):
        block_gs.block_gs_project_gram(torch.zeros(4, 8, **f64),
                                       torch.zeros(2, 8, device=dev),
                                       torch.eye(2, device=dev))


# --------------------------------------------------------------------------
# the streaming GEMV pair (gs_update, gs_project_partial): 16-byte pieces,
# the scalar route for misaligned operands and the ragged tail
# --------------------------------------------------------------------------
def _view(shape, dtype, dev, offset, seed):
    """A contiguous random tensor ``offset`` elements into a buffer (1: not
    16-byte aligned)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    numel = int(np.prod(shape))
    buf = torch.randn(numel + offset, device=dev, generator=g).to(dtype)
    return buf[offset:].view(shape)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "misaligned"])
@pytest.mark.parametrize("n", [1, 3, 4, 5, 31, 1000, 10_000, 10_003,
                               1 << 18, 1 << 20])
def test_gemv_pair_matches_plain_at_every_shape(dev, n, offset, dtype):
    m1 = 31
    v = _view((m1, n), dtype, dev, offset, seed=n)
    v.copy_(_basis(n, m1, m1 - 1, dtype, dev, seed=n))
    w = _view((n,), torch.float32, dev, offset, seed=n + 1)
    for j in (0, 7, 8, 15, 30):
        h = torch.randn(2, j + 1, device=dev,
                        generator=torch.Generator(device=dev)
                        .manual_seed(j))[1]        # hc[1]: a row view
        routes = (dict(cgs2.gs_update.routes),
                  dict(cgs2.gs_project_partial.routes))
        p = cgs2.gs_project_partial(v, w, j)
        u = cgs2.gs_update(v[:j + 1], w, h)
        torch.cuda.synchronize()
        assert _relerr(p, cgs2.gs_project_partial_plain(v, w, j)) < TOL[dtype]
        assert not p[j + 1:].any()
        assert _relerr(u, cgs2.gs_update_plain(v[:j + 1], w, h)) < TOL[dtype]
        # the same bits every call
        assert torch.equal(cgs2.gs_project_partial(v, w, j), p)
        assert torch.equal(cgs2.gs_update(v[:j + 1], w, h), u)
        # the route each call took, counted once per launch
        want_p = cgs2.stream_plan(v, w, j + 1)["route"]
        want_u = cgs2.stream_plan(v, w, j + 1)["route"]
        assert cgs2.gs_project_partial.routes[want_p] == routes[1][want_p] + 2
        assert cgs2.gs_update.routes[want_u] == routes[0][want_u] + 2
        aligned = offset == 0 and (j == 0 or n * v.element_size() % 16 == 0)
        vec = 16 // v.element_size()
        assert want_u == ("vec" if aligned and n >= vec else "scalar")


def test_gs_project_partial_gives_the_same_bits_on_two_streams(dev):
    n, m1, j = 1 << 18, 31, 20
    v = _basis(n, m1, m1 - 1, torch.float32, dev, seed=3)
    w = torch.randn(n, device=dev, generator=torch.Generator(device=dev)
                    .manual_seed(4))
    want = cgs2.gs_project_partial(v, w, j)
    side = torch.cuda.Stream(device=dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        got = [cgs2.gs_project_partial(v, w, j) for _ in range(4)]
    mine = [cgs2.gs_project_partial(v, w, j) for _ in range(4)]
    torch.cuda.synchronize()
    for g in got + mine:
        assert torch.equal(g, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [10_000, 10_003, 1 << 20])
def test_gs_update_prefix_and_full_call_give_the_same_bits(dev, n, dtype):
    m1 = 31
    v = _basis(n, m1, m1 - 1, dtype, dev, seed=7)
    g = torch.Generator(device=dev).manual_seed(8)
    w = torch.randn(n, device=dev, generator=g)
    for j in (0, 7, 8, 15, 29):
        h = torch.randn(m1, device=dev, generator=g)
        h[j + 1:] = 0
        assert torch.equal(cgs2.gs_update(v[:j + 1], w, h[:j + 1]),
                           cgs2.gs_update(v, w, h))


@pytest.mark.parametrize("fmt", ["dense", "banded", "ell"])
def test_pipelined_solves_count_launches(dev, fmt):
    """gmres(gs="cgs2_pipelined") on the card against the CPU: one payload
    and two updates per step, steps + 2 restarts + 1 mat-vecs (a prologue
    per cycle, a residual per restart, the initial one), no fused pass;
    gmres_sstep(gs="cgs2_pipelined"): both block kernels twice per block,
    no block_gs_pass."""
    from repro_torch.core import gmres_sstep, stencils
    from repro_torch.kernels import block_gs, spmv

    if fmt == "dense":
        a = operators.random_diagdom(1000, dominance=0.3, seed=1,
                                     device="cpu")
        op_c = operators.DenseOperator(a, backend="cuda", device=dev)
        op_h = operators.DenseOperator(a, device="cpu")
        mv = matvec.block_matvec
    else:
        op_c = stencils.convection_diffusion_2d(32, 32, fmt=fmt, device=dev)
        op_h = stencils.convection_diffusion_2d(32, 32, fmt=fmt,
                                                device="cpu")
        mv = {"banded": spmv.banded_matvec, "ell": spmv.ell_matvec}[fmt]
    n = op_c.shape[0]
    b = torch.from_numpy(np.random.default_rng(1).standard_normal(n)
                         .astype(np.float32))
    counters = {"payload": cgs2.gs_project_norm_partial,
                "update": cgs2.gs_update, "project": cgs2.gs_project,
                "mv": mv}
    before = {k: f.launches for k, f in counters.items()}
    res = gmres(op_c, b.to(dev), m=30, tol=1e-5, max_restarts=200,
                gs="cgs2_pipelined")
    d = {k: f.launches - before[k] for k, f in counters.items()}
    ref = gmres(op_h, b, m=30, tol=1e-5, max_restarts=200,
                gs="cgs2_pipelined")
    assert res.converged and ref.converged
    assert abs(res.restarts - ref.restarts) <= 1
    assert float((res.x.cpu() - ref.x).norm() / ref.x.norm()) <= 1e-3
    steps = res.inner_steps
    assert d == {"payload": steps, "update": 2 * steps, "project": 0,
                 "mv": steps + 2 * res.restarts + 1}

    counters = {"gram": block_gs.block_gs_project_gram,
                "update": block_gs.block_gs_update,
                "pass": block_gs.block_gs_pass}
    before = {k: f.launches for k, f in counters.items()}
    res = gmres_sstep(op_c, b.to(dev), s=5, blocks=6, tol=1e-5,
                      max_restarts=200, gs="cgs2_pipelined")
    d = {k: f.launches - before[k] for k, f in counters.items()}
    ref = gmres_sstep(op_h, b, s=5, blocks=6, tol=1e-5, max_restarts=200,
                      gs="cgs2_pipelined")
    assert res.converged and ref.converged
    assert abs(res.restarts - ref.restarts) <= 1
    assert float((res.x.cpu() - ref.x).norm() / ref.x.norm()) <= 1e-3
    per = 2 * 6 * res.restarts
    assert d == {"gram": per, "update": per, "pass": 0}


# --------------------------------------------------------------------------
# the preconditioning slice: Chebyshev apply, ILU(0) setup, sweeps, solves
# --------------------------------------------------------------------------
def _tri_cases(dev):
    """(name, bands, offsets, unit, lower) of every sweep direction on the
    ILU(0) and line-Jacobi factors of a stencil and a random (-2, -1, 0)
    pattern (n = 4099: chunks of 2 rows)."""
    from repro_torch.core import preconditioners, stencils
    from repro_torch.kernels import trisolve

    op = stencils.convection_diffusion_2d(64, 48, device=dev)
    cases = []
    for name, pc in (("ilu0", preconditioners.banded_ilu0(op)),
                     ("line_jacobi", preconditioners.line_jacobi(op))):
        cases.append((name, pc.l_bands, pc.l_offsets, True, True))
        cases.append((name, pc.u_bands, pc.u_offsets, False, False))
    g = torch.Generator(device=dev).manual_seed(7)
    n = 4099
    for lower, unit in ((True, True), (True, False), (False, False)):
        offs = (-2, -1, 0) if lower else (0, 1, 2)
        bands = torch.rand(3, n, device=dev, generator=g) * 0.8 + 0.2
        bands[offs.index(0)] += 2.0
        bands = trisolve._mask_oob(bands, offs).contiguous()
        cases.append(("random", bands, offs, unit, lower))
    return cases


@pytest.mark.parametrize("k", [1, 4])
def test_trisweep_kernel_matches_plain(dev, k):
    from repro_torch.kernels import trisolve

    for name, bands, offs, unit, lower in _tri_cases(dev):
        n = bands.shape[1]
        g = torch.Generator(device=dev).manual_seed(k)
        v = torch.randn(k, n, device=dev, generator=g)
        v = v[0] if k == 1 else v
        before = trisolve.banded_trisweep.launches
        z = trisolve.banded_trisweep(bands, v, offs, unit_diag=unit,
                                     lower=lower)
        assert trisolve.banded_trisweep.launches == before + 1
        zp = trisolve.banded_trisweep_plain(bands, v, offs, unit_diag=unit,
                                            lower=lower)
        torch.cuda.synchronize()
        assert z.shape == v.shape
        assert _relerr(z, zp) < TOL[torch.float32], (name, offs, unit, lower)


def _sweep_bands(dev, offs, n, dtype, seed):
    """A random band stack on the pattern ``offs``: off-diagonal entries in
    [0.1, 0.5), the diagonal in [2.2, 3), out-of-range entries zeroed."""
    from repro_torch.kernels import trisolve

    g = torch.Generator(device=dev).manual_seed(seed)
    bands = (torch.rand(len(offs), n, device=dev, generator=g) * 0.4 + 0.1)
    if 0 in offs:
        bands[offs.index(0)] = bands[offs.index(0)] * 2 + 2.0
    return trisolve._mask_oob(bands, offs).to(dtype).contiguous()


# route "scan": every |off| <= 1; n not a multiple of the 2,048-row tile,
# and 2^20 (k = 4: more tiles than blocks, rows read again)
SCAN_CASES = [((-1,), True, True), ((-1, 0), False, True),
              ((0, 1), False, False), ((1,), True, False),
              ((0,), False, True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 7, 4099, 2048 * 300 + 5, 1 << 20])
def test_trisweep_scan_route_matches_plain(dev, n, dtype):
    from repro_torch.kernels import trisolve

    for offs, unit, lower in SCAN_CASES:
        bands = _sweep_bands(dev, offs, n, dtype, seed=n)
        for k in (1, 4):
            g = torch.Generator(device=dev).manual_seed(k)
            v = torch.randn(k, n, device=dev, generator=g)
            v = v[0] if k == 1 else v
            before = dict(trisolve.banded_trisweep.routes)
            z = trisolve.banded_trisweep(bands, v, offs, unit_diag=unit,
                                         lower=lower)
            assert trisolve.banded_trisweep.routes["scan"] \
                == before["scan"] + 1
            zp = trisolve.banded_trisweep_plain(bands, v, offs,
                                                unit_diag=unit, lower=lower)
            torch.cuda.synchronize()
            assert z.shape == v.shape
            assert _relerr(z, zp) < TOL[dtype], (offs, k, n)
            # a fixed order: the same bits every call
            assert torch.equal(trisolve.banded_trisweep(
                bands, v, offs, unit_diag=unit, lower=lower), z)


# route "chunk": c = 2 (loads one chunk at a time), ILU(0)'s 1,024 with
# n a multiple of 4 (the cp.async pipeline) and not (loads), 2,048 (the
# chunk clipped to 1,024), 1,000 and 1,001 (not a multiple of the rows a
# thread), (-1500, -1000, -1) (the chunk halved), 3-D patterns: one
# with a chunk of one warp, two whose far terms from the ring lie whole
# chunks back in a chunk of eight warps (a ring that is not a multiple of
# the chunk: the warps must not drift apart by more than it holds)
CHUNK_CASES = [((-2, -1), 4099), ((-1024, -1), 1024 * 37),
               ((-1024, -1), 1024 * 37 + 2), ((-2048, -1), 2048 * 5 + 4),
               ((-1000, -1), 10_000), ((-1001, -1), 10_010),
               ((-1500, -1000, -1), 9_000), ((-2500, -50, -1), 12_500),
               ((-3000, -1000, -1), 30_000), ((-2000, -1000, -1), 20_000)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", range(len(CHUNK_CASES)))
@pytest.mark.parametrize("grid", [False, True], ids=["coupled", "grid"])
def test_trisweep_chunk_route_matches_plain(dev, case, dtype, grid):
    # grid: a grid stencil's factor, no near entry at a chunk's start (the
    # first warp then need not wait for the last one's carry)
    from repro_torch.kernels import trisolve

    lo_offs, n = CHUNK_CASES[case]
    c = min(abs(o) for o in lo_offs if abs(o) >= 2)
    for offs, unit, lower in ((lo_offs, True, True),
                              (lo_offs + (0,), False, True),
                              ((0,) + tuple(-o for o in lo_offs), False,
                               False)):
        bands = _sweep_bands(dev, offs, n, dtype, seed=case)
        if grid:
            near = [d for d, o in enumerate(offs) if abs(o) == 1]
            starts = torch.arange(0, n, c, device=dev)
            for d in near:
                bands[d, starts if lower else n - 1 - starts] = 0
        for k in (1, 4):
            g = torch.Generator(device=dev).manual_seed(k + case)
            vf = torch.randn(k, n, device=dev, generator=g)
            zp = trisolve.banded_trisweep_plain(bands, vf, offs,
                                                unit_diag=unit, lower=lower)
            plan = trisolve.sweep_plan(bands, vf, torch.empty_like(vf),
                                       offs)
            assert plan["route"] == "chunk"
            # the plan; far terms through L2 instead of the ring; fewer
            # stages in flight
            plans = [plan, dict(plan, ring=0, far_l2=1, route="chunk_l2")]
            if plan["vec"]:
                plans += [dict(plan, stages=st) for st in (2, 4)]
            for p in plans:
                z = torch.empty_like(vf)
                trisolve._launch_trisweep(bands, vf, z, offs, p, unit,
                                          lower)
                z2 = torch.empty_like(vf)
                trisolve._launch_trisweep(bands, vf, z2, offs, p, unit,
                                          lower)
                torch.cuda.synchronize()
                assert _relerr(z, zp) < TOL[dtype], (offs, k, n, p)
                assert torch.equal(z, z2)
    before = dict(trisolve.banded_trisweep.routes)
    trisolve.banded_trisweep(bands, vf, offs, unit_diag=unit, lower=lower)
    assert trisolve.banded_trisweep.routes["chunk"] == before["chunk"] + 1


def test_trisweep_chain_probe_runs(dev):
    from repro_torch.kernels import trisolve

    for offs, lower in (((-1024, -1), True), ((0, 1, 1024), False),
                        ((-3000, -1000, -1), True)):
        before = trisolve.banded_trisweep.launches
        out = trisolve.chain_probe(offs, 1 << 20, unit_diag=lower,
                                   lower=lower)
        torch.cuda.synchronize()
        assert out.shape == (1,) and bool(torch.isfinite(out).all())
        assert trisolve.banded_trisweep.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,n,k", [(10_000, 10_000, 1), (10_000, 10_000, 4),
                                   (97, 97, 1), (300, 1003, 3), (1, 8, 1),
                                   (257, 64, 8), (1000, 2048, 2),
                                   (33, 4096, 5)])
def test_block_matvec_every_launch_shape(dev, m, n, k, dtype):
    from repro_torch.kernels import tuning

    g = torch.Generator(device=dev).manual_seed(m + n + k)
    a = torch.randn(m, n, device=dev, generator=g).to(dtype)
    for off in (0, 1):          # x 16-byte aligned, and one float off
        xbuf = torch.randn(n * k + off, device=dev, generator=g)
        x = xbuf[off:].view(n, k)
        want = matvec.block_matvec_plain(a, x)
        for rows in tuning.GEMV_ROWS_CHOICES:
            for bps in (1, 2, 4):
                for u, cs in ((2, True), (2, False), (4, True), (4, False)):
                    shape = tuning.gemv_rows_shape(
                        m, n, k, a.element_size(), tuning.sm_count(dev),
                        rows=rows, blocks_per_sm=bps, unroll=u,
                        evict_first=cs)
                    y = matvec._launch_block_matvec(a, x, shape)
                    torch.cuda.synchronize()
                    assert _relerr(y, want) < TOL[dtype], (shape, off)
        before = dict(matvec.block_matvec.routes)
        y = matvec.block_matvec(a, x)
        rows = tuning.gemv_rows_shape(m, n, k, a.element_size(),
                                      tuning.sm_count(dev))["rows"]
        route = "rows" if rows > 1 else "row"
        assert matvec.block_matvec.routes[route] == before[route] + 1
        assert torch.equal(matvec.block_matvec(a, x), y)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nx", [16, 48])
def test_ilu0_kernel_matches_plain(dev, nx, dtype):
    from repro_torch.core import stencils
    from repro_torch.kernels import trisolve

    op = stencils.convection_diffusion_2d(nx, nx, device=dev)
    bands = op.bands.to(dtype)
    cases = [(bands, op.offsets), (bands[1:4].contiguous(), (-1, 0, 1))]
    if nx == 16:   # a pattern whose eliminations update lower slots
        g = torch.Generator(device=dev).manual_seed(3)
        b5 = torch.rand(5, 300, device=dev, generator=g) - 0.5
        b5[2] += 3.0
        cases.append((b5.to(dtype), (-2, -1, 0, 1, 2)))
    else:          # a 3-D stencil: 7 bands, rows 10^4 apart
        op3 = stencils.poisson_3d(100, 100, 10, device=dev)
        cases.append((op3.bands.to(dtype), op3.offsets))
    for b, offs in cases:
        before = trisolve.ilu0_factor.launches
        got = trisolve.ilu0_factor(b, offs)
        assert trisolve.ilu0_factor.launches == before + 1
        want = trisolve.ilu0_factor_plain(b.cpu(), offs)
        for g_, w_ in zip(got, want):
            assert g_.dtype == torch.float32
            assert _relerr(g_.cpu(), w_) < 1e-6, offs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("order", [1, 2, 4, 8])
def test_banded_cheb_apply_kernel_matches_plain(dev, order, dtype):
    from repro_torch.core import preconditioners, stencils
    from repro_torch.kernels import matrix_powers as mp

    for nx in (32, 256):
        op = stencils.convection_diffusion_2d(nx, nx, device=dev)
        pc = preconditioners.chebyshev(op, order=order)
        bands = op.bands.to(dtype)
        g = torch.Generator(device=dev).manual_seed(order)
        v = torch.randn(nx * nx, device=dev, generator=g)
        before = mp.banded_cheb_apply.launches
        z = mp.banded_cheb_apply(bands, v, op.offsets, theta=pc.theta,
                                 delta=pc.delta, rhos=pc.rhos)
        assert mp.banded_cheb_apply.launches == before + 1
        zp = mp.banded_cheb_apply_plain(bands, v, op.offsets, theta=pc.theta,
                                        delta=pc.delta, rhos=pc.rhos)
        torch.cuda.synchronize()
        assert _relerr(z, zp) < TOL[dtype]


@pytest.mark.parametrize("name", ["chebyshev", "banded_ilu0", "line_jacobi",
                                  "jacobi"])
def test_preconditioned_solves_count_launches(dev, name):
    """gmres with a preconditioner on the card against the CPU: one apply
    per Arnoldi step and one per cycle (x0 + M^-1 dx); Chebyshev launches
    its kernel once per apply, ILU(0) two sweeps; the setup factors once."""
    from repro_torch.core import preconditioners, stencils
    from repro_torch.kernels import matrix_powers as mp
    from repro_torch.kernels import spmv, trisolve

    op_c = stencils.convection_diffusion_2d(32, 32, device=dev)
    op_h = stencils.convection_diffusion_2d(32, 32, device="cpu")
    b = torch.from_numpy(np.random.default_rng(1).standard_normal(1024)
                         .astype(np.float32))
    counters = {"cheb": mp.banded_cheb_apply,
                "sweep": trisolve.banded_trisweep,
                "ilu": trisolve.ilu0_factor, "mv": spmv.banded_matvec}
    before = {k: f.launches for k, f in counters.items()}
    pc = preconditioners.make_preconditioner(name, op_c)
    res = gmres(op_c, b.to(dev), m=30, tol=1e-5, max_restarts=200,
                gs="cgs2_fused", precond=pc)
    d = {k: f.launches - before[k] for k, f in counters.items()}
    ref = gmres(op_h, b, m=30, tol=1e-5, max_restarts=200, gs="cgs2_fused",
                precond=preconditioners.make_preconditioner(name, op_h))
    assert res.converged and ref.converged
    assert abs(res.restarts - ref.restarts) <= 1
    assert float((res.x.cpu() - ref.x).norm() / ref.x.norm()) <= 1e-3
    applies = res.inner_steps + res.restarts
    mvs = res.inner_steps + res.restarts + 1
    if name == "chebyshev":       # + the interval's 8 power iterations
        want = {"cheb": applies, "sweep": 0, "ilu": 0, "mv": mvs + 8}
    elif name == "jacobi":
        want = {"cheb": 0, "sweep": 0, "ilu": 0, "mv": mvs}
    else:
        want = {"cheb": 0, "sweep": 2 * applies, "ilu": 1, "mv": mvs}
    assert d == want


# --------------------------------------------------------------------------
# the row-sharded slice's kernels (one shard's shapes)
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sharded_kernels_match_plain_on_card(dev, dtype):
    from repro_torch.kernels import block_gs, spmv
    from repro_torch.kernels import matrix_powers as mp
    tol = TOL[dtype]
    offsets = (-3, -1, 0, 1, 3)
    g = torch.Generator(device=dev).manual_seed(0)
    n, m1, j, s = 5000, 17, 9, 4
    v = torch.linalg.qr(torch.randn(n, j + 1, device=dev, generator=g))[0].T
    vb = torch.zeros(m1, n, device=dev)
    vb[:j + 1] = v
    vb = vb.to(dtype).contiguous()
    w = torch.randn(n, device=dev, generator=g)
    got = cgs2.gs_project_partial(vb, w, j)
    assert _relerr(got, cgs2.gs_project_partial_plain(vb, w, j)) < tol
    ws = torch.randn(s, n, device=dev, generator=g)
    tin = torch.eye(s, device=dev) + 0.1 * torch.randn(s, s, device=dev,
                                                       generator=g)
    for a, b in zip(block_gs.block_gs_project(vb, ws, tin, j),
                    block_gs.block_gs_project_plain(vb, ws, tin, j)):
        assert _relerr(a, b) < tol
    halo = 3
    bands = (0.1 * torch.randn(5, n + 2 * s * halo, device=dev,
                               generator=g)).to(dtype)
    x = torch.randn(n + 2 * s * halo, device=dev, generator=g)
    for a, b in zip(mp.banded_powers_halo(bands, x, offsets, s),
                    mp.banded_powers_halo_plain(bands, x, offsets, s)):
        assert _relerr(a, b) < tol
    xh = torch.randn(n + 2 * halo, 3, device=dev, generator=g)
    bn = bands[:, :n].contiguous()
    assert _relerr(spmv.banded_matvec_halo(bn, xh, offsets),
                spmv.banded_matvec_halo_plain(bn, xh, offsets)) < tol
    vals = torch.randn(n, 5, device=dev, generator=g).to(dtype)
    cols = torch.randint(0, n + 2 * halo, (n, 5), device=dev, generator=g,
                         dtype=torch.int32)
    assert _relerr(spmv.ell_matvec_halo(vals, cols, xh),
                spmv.ell_matvec_halo_plain(vals, cols, xh)) < tol


# --------------------------------------------------------------------------
# the model stack's kernels (zamba2): attention, SSD scan, gated RMSNorm
# --------------------------------------------------------------------------
# (b, hq, hkv, sq, skv, window, causal, d): the JAX package's attention
# sweep (tests/test_kernels.py) at d = 64, and zamba2-7b's prefill shape
ATTN_SHAPES = [(2, 4, 2, 256, 256, None, True, 64),
               (1, 8, 8, 128, 128, None, True, 64),
               (1, 8, 2, 128, 384, None, True, 64),
               (2, 4, 4, 256, 256, 64, True, 64),
               (1, 4, 2, 1, 300, None, True, 64),
               (1, 4, 4, 128, 128, None, False, 64),
               (1, 2, 2, 320, 320, 96, True, 64),
               (2, 32, 32, 512, 512, None, True, 112)]
# (batch, heads, s, p, n, chunk): the JAX sweep, the model-oracle case and
# zamba2-7b's prefill (b = 2, S = 512, 112 heads)
SSD_SHAPES = [(2, 3, 64, 16, 8, 16), (1, 2, 96, 32, 16, 32),
              (1, 1, 48, 8, 8, 48), (2, 2, 32, 8, 8, 16),
              (2, 112, 512, 64, 64, 256)]
SSD_TOL = {torch.float32: 3e-4, torch.bfloat16: 2e-2}
NORM_SHAPES = [(4, 64, 256), (100, 512), (2, 33, 384), (1024, 7168),
               (5, 7, 99)]      # the last: scalar loads (99 % 4 != 0)


def _ssd_inputs(batch, heads, s, p, n, dtype, dev):
    g = torch.Generator(device=dev).manual_seed(s + p)
    bh = batch * heads
    x = torch.randn(bh, s, p, device=dev, generator=g).to(dtype)
    dt = torch.nn.functional.softplus(torch.randn(bh, s, device=dev,
                                                  generator=g))
    lg = -torch.randn(bh, s, device=dev, generator=g).abs() * 0.1
    b = torch.randn(batch, s, n, device=dev, generator=g).to(dtype)
    c = torch.randn(batch, s, n, device=dev, generator=g).to(dtype)
    return x, dt, lg, b, c


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", ATTN_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_attention_kernel_matches_plain(dev, shape, dtype):
    from repro_torch.kernels import attention as attention_k
    b, hq, hkv, sq, skv, window, causal, d = shape
    g = torch.Generator(device=dev).manual_seed(sq + skv)
    q = torch.randn(b, hq, sq, d, device=dev, generator=g).to(dtype)
    k = torch.randn(b, hkv, skv, d, device=dev, generator=g).to(dtype)
    v = torch.randn(b, hkv, skv, d, device=dev, generator=g).to(dtype)
    route = "wgmma" if dtype == torch.bfloat16 else "simt"
    before = attention_k.attention.launches
    by_kernel = dict(attention_k.attention.launches_by_kernel)
    got = attention_k.attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert attention_k.attention.launches == before + 1
    by_kernel[route] += 1
    assert attention_k.attention.launches_by_kernel == by_kernel
    assert got.dtype == dtype and got.shape == q.shape
    want = attention_k.attention_plain(q, k, v, causal=causal, window=window)
    assert _relerr(got, want) < TOL[dtype]


def test_attention_kernel_takes_strided_views(dev):
    """The model's q/k/v are (b, s, h, d) products viewed as (b, h, s, d)."""
    from repro_torch.kernels import attention as attention_k
    g = torch.Generator(device=dev).manual_seed(1)
    q, k, v = (torch.randn(2, 40, 4, 48, device=dev, generator=g)
               .transpose(1, 2) for _ in range(3))
    got = attention_k.attention(q, k, v)
    want = attention_k.attention_plain(q.contiguous(), k.contiguous(),
                                       v.contiguous())
    assert _relerr(got, want) < TOL[torch.float32]


@pytest.mark.parametrize("d", [112, 40, 5])
def test_wgmma_attention_takes_views_and_copies_only_misaligned(dev, d):
    """bf16 (b, s, h, d) products viewed as (b, h, s, d) go to TMA as they
    are where their strides are multiples of 16 bytes (d = 112, 40); d = 5
    is copied into the aligned layout first (counted), never sent to the
    float32 kernel."""
    from repro_torch.kernels import attention as attention_k
    g = torch.Generator(device=dev).manual_seed(d)
    q, k, v = (torch.randn(2, 70, 4, d, device=dev, generator=g)
               .to(torch.bfloat16).transpose(1, 2) for _ in range(3))
    copies = attention_k.attention.layout_copies
    wgmma = attention_k.attention.launches_by_kernel["wgmma"]
    got = attention_k.attention(q, k, v)
    torch.cuda.synchronize()
    assert attention_k.attention.launches_by_kernel["wgmma"] == wgmma + 1
    assert attention_k.attention.layout_copies == copies + (3 if d % 8
                                                            else 0)
    want = attention_k.attention_plain(q.contiguous(), k.contiguous(),
                                       v.contiguous())
    assert _relerr(got, want) < TOL[torch.bfloat16]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SSD_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_ssd_scan_kernel_matches_plain(dev, shape, dtype):
    from repro_torch.kernels import ssd
    batch, heads, s, p, n, chunk = shape
    x, dt, lg, b, c = _ssd_inputs(batch, heads, s, p, n, dtype, dev)
    before = ssd.ssd_scan.launches
    got = ssd.ssd_scan(x, dt, lg, b, c, heads=heads, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd.ssd_scan.launches == before + 1
    want = ssd.ssd_scan_plain(x, dt, lg, b, c, heads=heads, chunk=chunk)
    assert got.dtype == dtype
    assert _relerr(got, want) < SSD_TOL[dtype]


# zamba2's decays: lg = dt A, A = -linspace(1, 16, heads) (its a_log), so
# cum reaches -10^3 within a chunk; zamba2's prefill, a two-chunk cut of it,
# eight chunks (the pass over several earlier states), a small sweep shape
SSD_STRONG_SHAPES = [(2, 112, 512, 64, 64, 256), (2, 8, 512, 64, 64, 256),
                     (1, 4, 2048, 64, 64, 256), (2, 3, 64, 16, 8, 16)]
# shapes off the kernels' 16-byte route and tiles: N, P, Q not multiples of
# 8 (scalar route), P > 64 (the wide instantiation), Q > 256 (G by windows
# of 256, a head a block), three tiles (a middle tile alone)
SSD_EDGE_SHAPES = [(1, 2, 40, 5, 6, 20), (1, 3, 96, 12, 10, 48),
                   (1, 2, 128, 100, 64, 64), (1, 2, 1024, 64, 64, 512),
                   (2, 5, 384, 64, 64, 192)]


def _ssd_strong_inputs(batch, heads, s, p, n, dtype, dev):
    g = torch.Generator(device=dev).manual_seed(s + heads)
    bh = batch * heads
    x = torch.randn(bh, s, p, device=dev, generator=g).to(dtype)
    dt = torch.nn.functional.softplus(torch.randn(bh, s, device=dev,
                                                  generator=g))
    a = -torch.linspace(1.0, 16.0, heads, device=dev)
    lg = (dt.view(batch, heads, s) * a[None, :, None]).reshape(bh, s)
    b = torch.randn(batch, s, n, device=dev, generator=g).to(dtype)
    c = torch.randn(batch, s, n, device=dev, generator=g).to(dtype)
    return x, dt, lg, b, c


def _ssd_call(x, dt, lg, b, c, heads, chunk):
    """One call, with the wrapper's and each kernel's launch counts (the
    pass only with three chunks or more)."""
    from repro_torch.kernels import ssd
    before = (ssd.ssd_scan.launches, dict(ssd.ssd_scan.kernel_launches))
    got = ssd.ssd_scan(x, dt, lg, b, c, heads=heads, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd.ssd_scan.launches == before[0] + 1
    passes = x.shape[1] // min(chunk, x.shape[1]) > 2
    assert ssd.ssd_scan.kernel_launches == {
        k: v + (passes or k != "ssd_pass_kernel")
        for k, v in before[1].items()}
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SSD_STRONG_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_ssd_scan_strong_decays_match_plain(dev, shape, dtype):
    from repro_torch.kernels import ssd
    batch, heads, s, p, n, chunk = shape
    args = _ssd_strong_inputs(batch, heads, s, p, n, dtype, dev)
    got = _ssd_call(*args, heads, chunk)
    want = ssd.ssd_scan_plain(*args, heads=heads, chunk=chunk)
    assert bool(torch.isfinite(got).all())
    assert _relerr(got, want) < SSD_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SSD_EDGE_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_ssd_scan_edge_shapes_match_plain(dev, shape, dtype):
    from repro_torch.kernels import ssd
    batch, heads, s, p, n, chunk = shape
    args = _ssd_strong_inputs(batch, heads, s, p, n, dtype, dev)
    route = ssd.launch_plan(args[0], args[3], heads=heads,
                            chunk=chunk)["route"]
    routes = dict(ssd.ssd_scan.routes)
    got = _ssd_call(*args, heads, chunk)
    routes[route] += 1
    assert ssd.ssd_scan.routes == routes
    want = ssd.ssd_scan_plain(*args, heads=heads, chunk=chunk)
    assert _relerr(got, want) < SSD_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_gives_the_same_bits_twice(dev, dtype):
    args = _ssd_strong_inputs(2, 112, 512, 64, 64, dtype, dev)
    first = _ssd_call(*args, 112, 256)
    assert torch.equal(first, _ssd_call(*args, 112, 256))


@pytest.mark.parametrize("s,kernels", [
    (512, ("ssd_state_kernel", "ssd_scan_kernel")),
    (2048, ("ssd_state_kernel", "ssd_pass_kernel", "ssd_scan_kernel"))])
def test_ssd_scan_runs_only_its_own_kernels(dev, s, kernels):
    """One call's profile: the hand-written kernels, once each (the pass
    with three chunks or more), and no library kernel (no GEMM, no
    copy)."""
    from torch.profiler import ProfilerActivity, profile
    args = _ssd_strong_inputs(2, 112, s, 64, 64, torch.float32, dev)
    _ssd_call(*args, 112, 256)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _ssd_call(*args, 112, 256)
    names = {e.key: e.count for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA}
    assert len(names) == len(kernels) and set(names.values()) == {1}
    assert all(any(k in key for key in names) for k in kernels)


def test_ssd_scan_takes_more_chunks_than_a_grid_axis(dev):
    """65,536 chunks of 4 (more than gridDim.y's 65,535), against the plain
    version at chunks of 1,024: the same function."""
    from repro_torch.kernels import ssd
    s = 4 * 65_536
    args = _ssd_strong_inputs(1, 2, s, 8, 8, torch.float32, dev)
    got = _ssd_call(*args, 2, 4)
    want = ssd.ssd_scan_plain(*args, heads=2, chunk=1024)
    assert _relerr(got, want) < SSD_TOL[torch.float32]


@pytest.mark.parametrize("shape", [(2, 112, 512, 64, 64, 256),
                                   (1, 2, 128, 100, 64, 64),
                                   (1, 2, 1024, 64, 64, 512),
                                   (1, 2, 1024, 128, 64, 1024)],
                         ids=lambda s: "x".join(map(str, s)))
def test_ssd_kernels_shared_memory(dev, shape):
    """The kernels' shared memory (csrc/ssd.cu's layout) fits a block at
    every width and chunk, and at zamba2's prefill leaves two output
    blocks an SM (the head groups' premise)."""
    from repro_torch.kernels import ssd, tuning
    batch, heads, s, p, n, chunk = shape
    x = torch.empty(batch * heads, s, p, device=dev)
    b = torch.empty(batch, s, n, device=dev)
    smem = ssd.kernel_smem(x, b, heads=heads, chunk=chunk)
    assert max(smem.values()) <= tuning.SMEM_LIMIT
    if shape == SSD_STRONG_SHAPES[0]:
        assert 2 * (smem["ssd_scan_kernel"] + 1024) <= 233_472


@pytest.mark.parametrize("nx", [256])
def test_pipelined_schemes_match_their_split_schemes_on_a_stencil(dev, nx):
    """The 256^2 case of tests/test_torch_pipelined.py's test of this name,
    on the card: the pipelined solve against cgs2_fused and the
    single-reduce s-step against the split one on the convection-diffusion
    stencil: restarts within +-1, x within 1e-4 (norm-wise)."""
    from repro_torch.core import gmres_sstep, stencils
    op = stencils.convection_diffusion_2d(nx, nx, beta=(0.5, 0.25),
                                          device=dev)
    b = torch.from_numpy(np.random.default_rng(1).standard_normal(nx * nx)
                         .astype(np.float32)).to(dev)
    kw = dict(tol=1e-5, max_restarts=300)
    for solve, args in ((gmres, dict(m=30, gs="cgs2_fused")),
                        (gmres_sstep, dict(s=5, blocks=6, gs="cgs2"))):
        ref = solve(op, b, **kw, **args)
        got = solve(op, b, **kw, **dict(args, gs="cgs2_pipelined"))
        assert ref.converged and got.converged
        assert abs(got.restarts - ref.restarts) <= 1
        assert float((got.x - ref.x).norm() / ref.x.norm()) < 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", NORM_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_gated_rmsnorm_kernel_matches_plain(dev, shape, dtype):
    from repro_torch.kernels import gated_norm
    g = torch.Generator(device=dev).manual_seed(shape[-1])
    y = torch.randn(shape, device=dev, generator=g).to(dtype)
    z = torch.randn(shape, device=dev, generator=g).to(dtype)
    w = torch.randn(shape[-1], device=dev, generator=g).to(dtype)
    before = gated_norm.gated_rmsnorm.launches
    got = gated_norm.gated_rmsnorm(y, z, w)
    torch.cuda.synchronize()
    assert gated_norm.gated_rmsnorm.launches == before + 1
    want = gated_norm.gated_rmsnorm_plain(y, z, w)
    assert got.dtype == dtype
    assert _relerr(got, want) < TOL[dtype]


@pytest.mark.parametrize("num_layers", [4, 5])
def test_reduced_zamba_on_card_matches_cpu(dev, num_layers):
    """Prefill and 12 decode steps of zamba2_7b.reduced() on the card (the
    three kernels) against the port on the CPU (their plain versions)."""
    from repro_torch import configs
    from repro_torch.kernels import attention as attention_k
    from repro_torch.kernels import gated_norm, ssd
    from repro_torch.models import build
    cfg = configs.get("zamba2-7b").reduced(num_layers=num_layers)
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")

    def to_card(tree):
        if isinstance(tree, dict):
            return {k: to_card(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to_card(v) for v in tree]
        return tree.to(dev)
    params_c = to_card(params)
    toks = np.random.default_rng(1).integers(2, cfg.vocab_size, (2, 32))
    kernels = (attention_k.attention, ssd.ssd_scan, gated_norm.gated_rmsnorm)
    before = [f.launches for f in kernels]
    got = model.prefill(params_c, {"tokens": toks})
    torch.cuda.synchronize()
    sites = num_layers // cfg.attn_every
    assert [f.launches - b for f, b in zip(kernels, before)] == \
        [sites, num_layers, num_layers]
    want = model.prefill(params, {"tokens": toks})
    assert _relerr(got.cpu(), want) < 1e-4
    cache_c = model.init_cache(2, 12, torch.float32, device=dev)
    cache = model.init_cache(2, 12, torch.float32, device="cpu")
    for i in range(12):
        lc, cache_c = model.decode(params_c, cache_c, toks[:, i], i)
        lh, cache = model.decode(params, cache, toks[:, i], i)
        assert _relerr(lc.cpu(), lh) < 1e-4


# --------------------------------------------------------------------------
# the fourth redesigns: the ILU(0) setup's wavefront, batched_cgs2's three
# sweeps over a work-split grid
# --------------------------------------------------------------------------
def _ilu_cases(dev):
    """(name, bands, offsets): stencils, line-Jacobi's pattern, a random
    (-2, -1, 0) pattern with zero entries, at the shapes the wavefront
    tiles differently (a tile a grid line, several lines a tile, one
    tile)."""
    from repro_torch.core import stencils

    cases = []
    for nx in (64, 128):
        op = stencils.convection_diffusion_2d(nx, nx, device=dev)
        cases.append((f"five-point {nx}^2", op.bands, op.offsets))
        cases.append((f"line-Jacobi {nx}^2", op.bands[1:4].contiguous(),
                      (-1, 0, 1)))
    op3 = stencils.poisson_3d(16, 16, 16, device=dev)
    cases.append(("seven-point 16^3", op3.bands, op3.offsets))
    g = torch.Generator(device=dev).manual_seed(21)
    n = 1 << 16
    b = torch.rand(3, n, device=dev, generator=g) - 0.5
    b[2] += 2.0
    b[:2] *= torch.rand(2, n, device=dev, generator=g) > 0.3   # zero entries
    cases.append(("random (-2, -1, 0), 2^16", b, (-2, -1, 0)))
    return cases


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ilu0_wavefront_gives_the_plain_bits(dev, dtype):
    from repro_torch.kernels import trisolve

    for name, bands, offs in _ilu_cases(dev):
        b = bands.to(dtype).contiguous()
        before = trisolve.ilu0_factor.launches
        got = trisolve.ilu0_factor(b, offs)
        torch.cuda.synchronize()
        assert trisolve.ilu0_factor.launches == before + 1
        want = trisolve.ilu0_factor_plain(b.cpu(), offs)
        for g_, w_ in zip(got, want):
            assert g_.dtype == torch.float32
            assert torch.equal(g_.cpu(), w_), name


@pytest.mark.parametrize("n", [1, 33])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ilu0_wavefront_tiny_systems(dev, n, dtype):
    from repro_torch.kernels import trisolve

    g = torch.Generator(device=dev).manual_seed(n)
    offs = (-2, -1, 0, 1)
    b = torch.rand(4, n, device=dev, generator=g) - 0.5
    b[2] += 2.0
    b = b.to(dtype)
    got = trisolve.ilu0_factor(b, offs)
    want = trisolve.ilu0_factor_plain(b.cpu(), offs)
    torch.cuda.synchronize()
    for g_, w_ in zip(got, want):
        assert torch.equal(g_.cpu(), w_)


def test_ilu0_wavefront_repeats_without_a_hang(dev):
    """20 launches back to back (each with its own zeroed flags): no hang,
    the same bits every time."""
    from repro_torch.core import stencils
    from repro_torch.kernels import trisolve

    op = stencils.convection_diffusion_2d(256, 256, device=dev)
    outs = [trisolve.ilu0_factor(op.bands, op.offsets) for _ in range(20)]
    torch.cuda.synchronize()
    for out in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(out, outs[0]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,n,js", [
    (4, 1 << 20, (0, 7, 15, 29)),
    (4, 1 << 20, (15, 15, 15, 15)),
    (8, 8192, (0, 3, 7, 12, 15, 20, 25, 29)),
    (3, 5000, (-1, -1, -1)),
    (5, 1001, (4, -1, 30, 0, 9)),                 # n off the 16-byte grid
    (2, 40_000, (40, 3)),                         # a lane of 41 rows
    (3, 65_536, (16, 2, 1))])                     # 17 rows: two chunks
def test_batched_cgs2_three_sweeps_match_plain(dev, k, n, js, dtype):
    from repro_torch.kernels import block_gs

    m1 = max(31, max(js) + 1)
    v = torch.stack([_basis(n, m1, max(j, 0), torch.float32, dev, seed=i)
                     for i, j in enumerate(js)]).to(dtype).contiguous()
    w = torch.randn(k, n, device=dev)
    before = dict(block_gs.batched_cgs2.routes)
    h, w2 = block_gs.batched_cgs2(v, w, js)
    hp, wp = block_gs.batched_cgs2_plain(v, w, js)
    torch.cuda.synchronize()
    route = "vec" if (n * v.element_size()) % 16 == 0 else "scalar"
    assert block_gs.batched_cgs2.routes[route] == before[route] + 1
    assert _relerr(h, hp) < TOL[dtype] and _relerr(w2, wp) < TOL[dtype]
    for lane, j in enumerate(js):
        if j < 0:
            assert torch.equal(w2[lane], w[lane])
            assert not h[lane].any()
    h2, w22 = block_gs.batched_cgs2(v, w, js)
    assert torch.equal(h, h2) and torch.equal(w2, w22)


def test_batched_cgs2_kernel_keeps_the_splits_rule(dev):
    """The split (tuning) copies the kernel's buckets, pieces at once and
    block size; the capacity is at most two blocks an SM."""
    from repro_torch.kernels import block_gs, tuning

    for elem in (2, 4):
        for rows in range(1, 65):
            r, u = tuning.batched_unroll(rows, elem)
            assert block_gs.kernel_unroll(rows, elem) == (
                r, u, tuning.BATCHED_THREADS), (rows, elem)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for dtype in (torch.float32, torch.bfloat16):
        v = torch.zeros(1, 31, 8, device=dev, dtype=dtype)
        assert 1 <= block_gs.capacity(v) <= 2 * sms


def test_batched_cgs2_misaligned_view_takes_the_scalar_route(dev):
    from repro_torch.kernels import block_gs

    k, n, m1 = 2, 4096, 9
    buf = torch.randn(k * n + 1, device=dev)
    w = buf[1:].view(k, n)                        # 4 bytes off 16
    v = torch.stack([_basis(n, m1, 8, torch.float32, dev, seed=i)
                     for i in range(k)]).contiguous()
    before = block_gs.batched_cgs2.routes["scalar"]
    h, w2 = block_gs.batched_cgs2(v, w, (8, 5))
    hp, wp = block_gs.batched_cgs2_plain(v, w, (8, 5))
    torch.cuda.synchronize()
    assert block_gs.batched_cgs2.routes["scalar"] == before + 1
    assert _relerr(h, hp) < TOL[torch.float32]
    assert _relerr(w2, wp) < TOL[torch.float32]


# --------------------------------------------------------------------------
# the streamed cgs2 (one launch, three sweeps) and the block pass at
# stream rate: kernel against plain at the edge shapes
# --------------------------------------------------------------------------
def _krylov_w(v, j, seed, off=0):
    """w as an Arnoldi step meets it (w = A v_j): a part in the span of
    basis rows 0..j as large as the part outside it, from a seeded
    generator, ``off`` elements into a buffer of its own.  (With w
    random alone, h is ~ 1e-3 of |w| at n = 2^20 and a relative bar on h
    measures the summation noise of both versions.)"""
    g = torch.Generator(device=v.device).manual_seed(seed)
    n = v.shape[1]
    c = torch.randn(j + 1, device=v.device, generator=g)
    buf = torch.randn(n + off, device=v.device, generator=g)
    buf[off:] += n ** 0.5 * (c @ v[:j + 1].float())
    return buf[off:]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,m1,j,off", [
    (1 << 20, 31, 0, 0), (1 << 20, 31, 1, 0), (1 << 20, 31, 15, 0),
    (1 << 20, 31, 30, 0),                          # j = m1 - 1
    ((1 << 20) + 3, 31, 15, 0),                    # n not a multiple of 4
    (1 << 20, 31, 15, 1),                          # w 4 bytes off 16
    (300_000, 40, 39, 0)])                         # a basis of 40 rows
def test_streamed_cgs2_is_one_launch_and_matches_plain(dev, n, m1, j, off,
                                                       dtype):
    v = _basis(n, m1, j, dtype, dev)
    w = _krylov_w(v, j, n + j, off)
    route = "vec" if off == 0 and (n * v.element_size()) % 16 == 0 \
        else "scalar"
    for fn, plain in ((cgs2.cgs2, cgs2.cgs2_plain),
                      (cgs2.gs_project, cgs2.gs_project_plain)):
        before = (fn.launches, dict(fn.routes),
                  cgs2.gs_project.launches)
        h, w2 = fn(v, w, j)
        hp, wp = plain(v, w, j)
        torch.cuda.synchronize()
        assert fn.launches == before[0] + 1
        assert fn.routes[route] == before[1][route] + 1
        if fn is cgs2.cgs2:                        # no gs_project launch
            assert cgs2.gs_project.launches == before[2]
        assert _relerr(h, hp) < TOL[dtype] and _relerr(w2, wp) < TOL[dtype]
        assert not h[j + 1:].any()
        h2, w22 = fn(v, w, j)
        assert torch.equal(h, h2) and torch.equal(w2, w22)


def test_dense_cgs2_keeps_its_two_shared_memory_passes(dev):
    """At n = 10,000 a block's slice fits shared memory: cgs2 is two
    gs_project launches on the "smem" route, no streamed launch."""
    n, m1, j = 10_000, 31, 15
    v = _basis(n, m1, j, torch.float32, dev)
    w = _krylov_w(v, j, 0)
    before = (cgs2.cgs2.launches, cgs2.gs_project.launches,
              cgs2.gs_project.routes["smem"])
    h, w2 = cgs2.cgs2(v, w, j)
    hp, wp = cgs2.cgs2_plain(v, w, j)
    torch.cuda.synchronize()
    assert (cgs2.cgs2.launches, cgs2.gs_project.launches,
            cgs2.gs_project.routes["smem"]) == (before[0], before[1] + 2,
                                                before[2] + 2)
    assert _relerr(h, hp) < 1e-4 and _relerr(w2, wp) < 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,k_start,s,off", [
    (1 << 20, 0, 1, 0), (1 << 20, 30, 8, 0), (1 << 20, 25, 5, 0),
    (1 << 20, 12, 8, 0), (10_000, 30, 1, 0), (10_000, 0, 8, 0),
    ((1 << 20) + 3, 25, 5, 0),                     # n not a multiple of 4
    (1 << 20, 25, 5, 1)])                          # W 4 bytes off 16
def test_block_gs_pass_at_stream_rate_matches_plain(dev, n, k_start, s, off,
                                                    dtype):
    from repro_torch.kernels import block_gs

    m1 = 31
    v = _basis(n, m1, k_start, dtype, dev)
    g = torch.Generator(device=dev).manual_seed(n + s)
    w = torch.randn(s * n + off, device=dev, generator=g)[off:].view(s, n)
    tin = torch.triu(torch.randn(s, s, device=dev, generator=g)) \
        + 2 * torch.eye(s, device=dev)
    route = "vec" if off == 0 and n % 8 == 0 else "scalar"
    before = dict(block_gs.block_gs_pass.routes)
    got = block_gs.block_gs_pass(v, w, tin, k_start)
    want = block_gs.block_gs_pass_plain(v, w, tin, k_start)
    torch.cuda.synchronize()
    assert block_gs.block_gs_pass.routes[route] == before[route] + 1
    assert not got[0][k_start + 1:].any()
    for gt, wt in zip(got, want):
        assert _relerr(gt, wt) < TOL[dtype]
    again = block_gs.block_gs_pass(v, w, tin, k_start)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert torch.equal(got[2], got[2].T)


# --------------------------------------------------------------------------
# the sixth redesigns: the ELL powers with the table kept on chip (row 17)
# and the payload on the projection's column sweep (row 5)
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [2, 5, 8])
def test_ell_powers_resident_route_gives_the_banded_bits(dev, s, dtype):
    """The 1024^2 stencil: the table kept on chip (most of it) and the
    banded kernel's row partition, so the banded kernel's bits, shifted or
    not; against plain."""
    from repro_torch.core import stencils
    from repro_torch.kernels import matrix_powers as mp

    op = operators.with_dtype(
        stencils.convection_diffusion_2d(1024, 1024, device=dev), dtype)
    ell = op.to_ell()
    n = op.shape[0]
    g = torch.Generator(device=dev).manual_seed(s)
    x = torch.randn(n, device=dev, generator=g)
    for shifts in (None, torch.linspace(0.5, 7.5, s, device=dev)):
        routes = dict(mp.ell_powers.routes)
        u, sig = mp.ell_powers(ell.values, ell.cols, x, s, shifts=shifts)
        assert {r: c - routes[r] for r, c in mp.ell_powers.routes.items()} \
            == {"resident": 1, "stream": 0}
        ub, sigb = mp.banded_powers(op.bands, x, op.offsets, s,
                                    shifts=shifts)
        up, sigp = mp.ell_powers_plain(ell.values, ell.cols, x, s,
                                       shifts=shifts)
        torch.cuda.synchronize()
        assert torch.equal(u, ub) and torch.equal(sig, sigb)
        assert _relerr(u, up) < TOL[dtype] and _relerr(sig, sigp) < TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ell_powers_stream_route_on_a_wide_table(dev, dtype):
    """A table too wide for one chunk of 32 rows in shared memory (width
    1,200, ragged rows) streams every power; against plain, the same bits
    twice."""
    from repro_torch.kernels import matrix_powers as mp

    vals, cols = _ell(3001, 1200, torch.float32, dev, seed=23)
    vals = (vals / 1200 ** 0.5).to(dtype).contiguous()
    x = torch.randn(3001, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(1))
    assert mp.ell_plan(vals, cols)["route"] == "stream"
    before = mp.ell_powers.routes["stream"]
    got = mp.ell_powers(vals, cols, x, 5)
    again = mp.ell_powers(vals, cols, x, 5)
    want = mp.ell_powers_plain(vals, cols, x, 5)
    torch.cuda.synchronize()
    assert mp.ell_powers.routes["stream"] == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert all(_relerr(a, b) < TOL[dtype] for a, b in zip(got, want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,off,j,route", [
    (1 << 20, 0, 0, "vec"), (1 << 20, 0, 15, "vec"), (1 << 20, 0, 29, "vec"),
    (10_000, 0, 15, "row"), (10_000, 0, 30, "row"),
    (1 << 20, 1, 15, "scalar"), (100_003, 0, 9, "scalar")])
def test_payload_routes_match_plain(dev, n, off, j, route, dtype):
    """The payload on the column sweep (16-byte pieces, or the scalar route
    for a z one float off 16 bytes or an odd row stride) and a block a row
    (n = 10^4): against plain, its route, the same bits twice."""
    m1 = 31
    v = _basis(n, m1, j, dtype, dev)
    g = torch.Generator(device=dev).manual_seed(n + j)
    z = torch.randn(n + off, device=dev, generator=g)[off:]
    routes = dict(cgs2.gs_project_norm_partial.routes)
    p = cgs2.gs_project_norm_partial(v, z, j)
    again = cgs2.gs_project_norm_partial(v, z, j)
    want = cgs2.gs_project_norm_partial_plain(v, z, j)
    torch.cuda.synchronize()
    assert {r: c - routes[r] for r, c in
            cgs2.gs_project_norm_partial.routes.items() if c != routes[r]} \
        == {route: 2}
    assert torch.equal(p, again) and not p[j + 1:m1].any()
    assert torch.equal(p[j, 1], p[m1, 1])          # v_j.v_j, one sum
    assert _relerr(p, want) < TOL[dtype]


def _fma32(a, b, c):
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def _warp_sums(x):
    """common.cuh's warp_sum on axis -1 split into warps of 32 lanes."""
    x = np.asarray(x, np.float32).reshape(*np.shape(x)[:-1], -1, 32)
    lanes = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        x = (x + x[..., lanes ^ o]).astype(np.float32)
    return x[..., 0]


def _in_order(x):
    """Sum along axis -1 one term at a time from 0."""
    s = np.zeros(np.shape(x)[:-1], np.float32)
    for k in range(np.shape(x)[-1]):
        s = (s + np.asarray(x, np.float32)[..., k]).astype(np.float32)
    return s


def _row4_replay(v, w, plan):
    """gs_project_partial's order (row 4, as it was before the payload
    shared its kernels): each thread's
    fmaf chain over its columns (rounds of U pieces, then the scalar
    columns), the warps' shuffles, the warps in order; on the column sweep
    the blocks' partials summed as reduce_partials_kernel sums them."""
    rows, n = v.shape
    vec, pieces = plan["vec"], plan["pieces"]
    if plan["by_row"]:
        threads, g, u = 256, 256, 1
    else:
        threads, u = plan["threads"], plan["unroll"]
        g = threads * plan["blocks"]
    cols = []
    for t in range(g):
        mine = []
        for p0 in range(t, pieces, u * g):
            for k in range(u):
                if p0 + k * g < pieces:
                    p = p0 + k * g
                    mine.extend(range(p * vec, p * vec + vec))
        mine.extend(range(pieces * vec + t, n, g))
        cols.append(mine)
    width = max(len(c) for c in cols)
    idx = np.array([c + [-1] * (width - len(c)) for c in cols])
    acc = np.zeros((rows, g), np.float32)
    for k in range(width):
        c = idx[:, k]
        live = c >= 0
        cc = np.where(live, c, 0)
        acc = np.where(live, _fma32(v[:, cc], w[cc], acc), acc)
    warps = _warp_sums(acc)                        # (rows, g / 32)
    blocks = _in_order(warps.reshape(rows, -1, threads // 32))
    if plan["by_row"]:
        return blocks[:, 0]
    lanes = np.zeros((rows, 32), np.float32)
    for lane in range(min(32, blocks.shape[1])):
        lanes[:, lane] = _in_order(blocks[:, lane::32])
    return _warp_sums(lanes)[:, 0]


@pytest.mark.parametrize("n", [1 << 16, 10_000])
def test_gs_project_partial_keeps_row4s_summation_order(dev, n):
    """Row 4's kernels, now generic in the right-hand columns, at K = 1:
    the bits of its fixed order (a numpy replay of it), on the column
    sweep (n = 2^16) and a block a row (n = 10^4)."""
    from repro_torch.kernels import tuning

    j, m1 = 15, 31
    rng = np.random.default_rng(n)
    v = np.zeros((m1, n), np.float32)
    v[:j + 1] = np.linalg.qr(rng.standard_normal((n, j + 1)))[0].T
    w = rng.standard_normal(n).astype(np.float32)
    vt, wt = torch.from_numpy(v).to(dev), torch.from_numpy(w).to(dev)
    plan = tuning.gemv_partial_shape(cgs2.stream_plan(vt, wt, j + 1), j + 1)
    assert plan["by_row"] == (n == 10_000)
    got = cgs2.gs_project_partial(vt, wt, j).cpu().numpy()
    want = _row4_replay(v[:j + 1], w, plan)
    assert np.array_equal(got[:j + 1], want) and not got[j + 1:].any()


# --------------------------------------------------------------------------
# the seventh redesigns: the banded powers (row 14) and the Chebyshev apply
# (row 18) with the band stack on chip and the operand divided once into a
# shared tile
# --------------------------------------------------------------------------
def _route_case(name, dev):
    """A band stack on each route of ``matrix_powers.banded_plan``, with the
    plan's route, residency (by storage) and 16-byte flag."""
    from repro_torch.core import stencils

    g = torch.Generator(device=dev).manual_seed(24)
    big = 1 << 20
    if name == "resident":
        op = stencils.convection_diffusion_2d(1024, 1024, device=dev)
        return op.bands, op.offsets, "tile", ("all", "all"), 1
    if name == "partly resident":
        return (torch.randn(9, big, device=dev, generator=g) / 3,
                tuple(range(-4, 5)), "tile", ("partly", "all"), 1)
    if name == "far":
        return (torch.randn(5, big, device=dev, generator=g) / 3,
                (-300_000, -1, 0, 1, 300_000), "far", ("all", "all"), 1)
    if name == "scalar":
        op = stencils.convection_diffusion_2d(1023, 1021, device=dev)
        return op.bands, op.offsets, "tile", ("all", "all"), 0
    return (torch.randn(3, 8_000_000, device=dev, generator=g) / 2,
            (-1, 0, 1), "l2", ("partly", "partly"), 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["resident", "partly resident", "far",
                                  "scalar", "l2"])
def test_banded_kernels_each_route_match_plain(dev, case, dtype):
    """banded_powers (shifted) and banded_cheb_apply on each route of their
    plan against the plain versions, the route counted, the same bits
    twice."""
    from repro_torch.kernels import matrix_powers as mp

    bands, offsets, route, resident, vec = _route_case(case, dev)
    bands = bands.to(dtype).contiguous()
    n = bands.shape[1]
    x = torch.randn(n, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(3))
    plan = mp.banded_plan(bands, offsets, x)
    assert plan["route"] == route and plan["vec"] == vec
    assert (plan["res_seg"] == plan["per"]) == \
        (resident[dtype == torch.bfloat16] == "all")
    sh = torch.linspace(0.5, 1.5, 5, device=dev)
    before = dict(mp.banded_powers.routes)
    got = mp.banded_powers(bands, x, offsets, 5, shifts=sh)
    again = mp.banded_powers(bands, x, offsets, 5, shifts=sh)
    want = mp.banded_powers_plain(bands, x, offsets, 5, shifts=sh)
    kw = dict(theta=3.0, delta=2.0, rhos=((0.5, 0.0), (0.6, 0.5),
                                          (0.7, 0.6)))
    cb = dict(mp.banded_cheb_apply.routes)
    z = mp.banded_cheb_apply(bands, x, offsets, **kw)
    z2 = mp.banded_cheb_apply(bands, x, offsets, **kw)
    zp = mp.banded_cheb_apply_plain(bands, x, offsets, **kw)
    torch.cuda.synchronize()
    assert {r: c - before[r] for r, c in mp.banded_powers.routes.items()
            if c != before[r]} == {route: 2}
    assert {r: c - cb[r] for r, c in mp.banded_cheb_apply.routes.items()
            if c != cb[r]} == {route: 2}
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert torch.equal(z, z2)
    assert _relerr(got[0], want[0]) < TOL[dtype]
    assert _relerr(got[1], want[1]) < TOL[dtype]
    assert _relerr(z, zp) < TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_banded_launch_shape_is_the_kernels_layout(dev, dtype):
    """launch_shape reports the plan and the kernels' own account of it:
    one block an SM co-resident at the plan's shared memory, the layout's
    bytes equal to the plan's, the Chebyshev's kKeepRows rows in
    registers."""
    from repro_torch.kernels import matrix_powers as mp
    from repro_torch.kernels import tuning

    offs = (-1024, -1, 0, 1, 1024)
    for kind in ("banded", "cheb"):
        shape = mp.launch_shape(kind, dtype, 1 << 20, offs)
        assert shape["kernel_smem"] == shape["smem"] <= tuning.SMEM_BUDGET
        assert shape["co_resident"] >= 1
        assert shape["kernel_reg_rows"] == (tuning.KEEP_ROWS
                                            if kind == "cheb" else 0)
        assert (shape["segments"], shape["blocks"], shape["threads"],
                shape["route"]) == (4 * tuning.sm_count(dev), tuning.sm_count(
                    dev), 1024, "tile")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("order", [1, 2, 4, 8, 32])
def test_banded_cheb_apply_on_the_1024_squared_stencil(dev, order, dtype):
    """The main path's shape: 8 rows a thread, all kept in registers, the
    whole stack on chip; against plain, the same bits twice."""
    from repro_torch.core import preconditioners, stencils
    from repro_torch.kernels import matrix_powers as mp

    op = stencils.convection_diffusion_2d(1024, 1024, device=dev)
    pc = preconditioners.chebyshev(op, order=order)
    bands = op.bands.to(dtype)
    v = torch.randn(op.shape[0], device=dev,
                    generator=torch.Generator(device=dev).manual_seed(order))
    kw = dict(theta=pc.theta, delta=pc.delta, rhos=pc.rhos)
    z = mp.banded_cheb_apply(bands, v, op.offsets, **kw)
    zp = mp.banded_cheb_apply_plain(bands, v, op.offsets, **kw)
    torch.cuda.synchronize()
    assert torch.equal(z, mp.banded_cheb_apply(bands, v, op.offsets, **kw))
    assert _relerr(z, zp) < TOL[dtype]


# --------------------------------------------------------------------------
# the ninth redesign: block_gs_project_gram (row 12) and block_gs_project
# (row 10) on block_gs_pass's projection sweep
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,m1,k_start,s,off", [
    (1 << 20, 31, 25, 5, 0), (1 << 20, 31, 0, 1, 0),
    (1 << 20, 70, 69, 8, 0),                       # two sets of rows
    (10_000, 31, 25, 2, 0), (100_003, 31, 12, 3, 0),
    (1027, 70, 66, 4, 0), (300, 9, 8, 6, 0),
    (1 << 20, 31, 25, 7, 1)])                      # W 4 bytes off 16
def test_projections_match_plain_on_both_routes(dev, n, m1, k_start, s, off,
                                                dtype):
    """Rows 12 and 10 against plain; row 10 never reads the rows past
    k_start (NaN there) and writes C's rows past it as zeros; M symmetric
    to the bit; the same bits twice; Q the same bits in both kernels."""
    from repro_torch.kernels import block_gs

    v = _basis(n, m1, k_start, dtype, dev)
    g = torch.Generator(device=dev).manual_seed(n + s)
    w = torch.randn(s * n + off, device=dev, generator=g)[off:].view(s, n)
    tin = torch.triu(torch.randn(s, s, device=dev, generator=g)) \
        + 2 * torch.eye(s, device=dev)
    rows = k_start + 1
    route = "vec" if off == 0 and (n * v.element_size()) % 16 == 0 \
        and n % 4 == 0 else "scalar"
    vp = v[:rows]
    v_nan = v.clone()
    v_nan[rows:] = float("nan")
    before = (block_gs.block_gs_project_gram.launches,
              block_gs.block_gs_project.launches,
              dict(block_gs.block_gs_project_gram.routes),
              dict(block_gs.block_gs_project.routes))
    gram = block_gs.block_gs_project_gram(vp, w, tin)
    proj = block_gs.block_gs_project(v_nan, w, tin, k_start)
    torch.cuda.synchronize()
    assert (block_gs.block_gs_project_gram.launches,
            block_gs.block_gs_project.launches) == (before[0] + 1,
                                                    before[1] + 1)
    assert block_gs.block_gs_project_gram.routes[route] == before[2][route] + 1
    assert block_gs.block_gs_project.routes[route] == before[3][route] + 1
    for got, want in ((gram, block_gs.block_gs_project_gram_plain(vp, w,
                                                                  tin)),
                      (proj, block_gs.block_gs_project_plain(v, w, tin,
                                                             k_start))):
        for a, b in zip(got, want):
            assert _relerr(a, b) < TOL[dtype]
    assert not proj[1][rows:].any()
    assert torch.equal(gram[2], gram[2].T)
    assert torch.equal(gram[0], proj[0])
    again = (*block_gs.block_gs_project_gram(vp, w, tin),
             *block_gs.block_gs_project(v_nan, w, tin, k_start))
    assert all(torch.equal(a, b) for a, b in zip((*gram, *proj), again))


@pytest.mark.parametrize("gram", [True, False])
def test_projections_run_only_their_own_kernels(dev, gram):
    """One call's profile: the projection kernel and its reduction, once
    each; no library kernel (no GEMM, no copy)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import block_gs

    n, m1, k_start, s = 1 << 20, 31, 25, 5
    v = _basis(n, m1, k_start, torch.float32, dev)
    g = torch.Generator(device=dev).manual_seed(5)
    w = torch.randn(s, n, device=dev, generator=g)
    tin = torch.eye(s, device=dev)

    def call():
        if gram:
            return block_gs.block_gs_project_gram(v[:k_start + 1], w, tin)
        return block_gs.block_gs_project(v, w, tin, k_start)
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    names = {e.key: e.count for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA}
    assert len(names) == 2 and set(names.values()) == {1}, names
    assert any("block_gs_project_gram_kernel" in k for k in names)
    assert any("reduce_partials_kernel" in k for k in names)
