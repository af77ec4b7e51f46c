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
