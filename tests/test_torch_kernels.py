"""The port's kernel wrappers vs the JAX package's Pallas kernels.

On the CPU each port wrapper runs its kernel's plain version (the tensor
lies on the CPU); the JAX side runs the Pallas kernel in interpret mode.
Inputs are made with numpy from a seed and handed to both.

Tolerances: float32 rtol = atol = 3e-5, the JAX package's own kernel
contract (sum order differs between the two); bfloat16 storage 2e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import arnoldi_fused as jax_arnoldi  # noqa: E402
from repro.kernels import cgs2 as jax_cgs2  # noqa: E402
from repro.kernels import matvec as jax_matvec  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels import arnoldi_fused, cgs2, matvec  # noqa: E402

F32 = dict(rtol=3e-5, atol=3e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)


def _pair(arr, dtype=jnp.float32):
    """The same values as a JAX array and a CPU tensor (dtype preserved)."""
    j = jnp.asarray(arr, jnp.float32).astype(dtype)
    return j, convert.tensor(j, "cpu")


def _np(t):
    return convert.to_numpy(t).astype(np.float32)


def _basis(n, m1, j, seed=1):
    """(m1, n) basis: orthonormal rows 0..j (as far as n allows), then 0."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, min(m1, n))))
    v = np.zeros((m1, n), np.float32)
    v[:min(m1, n)] = q.T
    v[j + 1:] = 0.0
    return v


@pytest.mark.parametrize("k", [1, 6])
@pytest.mark.parametrize("dtype,tol", [(jnp.float32, F32),
                                       (jnp.bfloat16, BF16)])
def test_block_matvec_matches_pallas(k, dtype, tol):
    n = 200                                   # ragged: JAX pads, port masks
    rng = np.random.default_rng(k)
    a_j, a_t = _pair(rng.standard_normal((n, n)) / np.sqrt(n), dtype)
    x_j, x_t = _pair(rng.standard_normal((n, k)))
    y_j = jax_matvec.block_matvec(a_j, x_j, interpret=True)
    y_t = matvec.block_matvec(a_t, x_t)
    assert y_t.dtype == torch.float32 and y_t.shape == (n, k)
    np.testing.assert_allclose(_np(y_t), np.asarray(y_j, np.float32), **tol)
    if k == 1:
        np.testing.assert_allclose(_np(matvec.matvec(a_t, x_t[:, 0])),
                                   np.asarray(y_j[:, 0], np.float32), **tol)


@pytest.mark.parametrize("n,m1,j", [(160, 31, 7), (300, 12, 5)])
@pytest.mark.parametrize("dtype,tol", [(jnp.float32, F32),
                                       (jnp.bfloat16, BF16)])
def test_gs_project_and_cgs2_match_pallas(n, m1, j, dtype, tol):
    v_j, v_t = _pair(_basis(n, m1, j), dtype)
    w_j, w_t = _pair(np.random.default_rng(3).standard_normal(n))
    mask = (jnp.arange(m1) <= j).astype(jnp.float32)
    h1, w1 = jax_cgs2.gs_project(v_j, w_j, mask, interpret=True)
    h1_t, w1_t = cgs2.gs_project(v_t, w_t, j)
    np.testing.assert_allclose(_np(h1_t), np.asarray(h1), **tol)
    np.testing.assert_allclose(_np(w1_t), np.asarray(w1), **tol)
    h2, w2 = jax_cgs2.cgs2(v_j, w_j, mask, interpret=True)
    h2_t, w2_t = cgs2.cgs2(v_t, w_t, j)
    np.testing.assert_allclose(_np(h2_t), np.asarray(h2), **tol)
    np.testing.assert_allclose(_np(w2_t), np.asarray(w2), **tol)


@pytest.mark.parametrize("n,m1,j,a_dtype,v_dtype,tol", [
    (160, 31, 0, jnp.float32, jnp.float32, F32),
    (160, 31, 7, jnp.float32, jnp.float32, F32),
    (300, 12, 5, jnp.float32, jnp.float32, F32),   # n not a lane multiple
    (96, 97, 40, jnp.float32, jnp.float32, F32),   # full memory: m1 > n
    (256, 17, 9, jnp.bfloat16, jnp.bfloat16, BF16),
])
def test_arnoldi_step_matches_pallas(n, m1, j, a_dtype, v_dtype, tol):
    rng = np.random.default_rng(n + j)
    a_j, a_t = _pair(rng.standard_normal((n, n)) / np.sqrt(n), a_dtype)
    v_j, v_t = _pair(_basis(n, m1, j, seed=j), v_dtype)
    h, w = jax_arnoldi.arnoldi_step(a_j, v_j, j, interpret=True)
    h_t, w_t = arnoldi_fused.arnoldi_step(a_t, v_t, j)
    assert h_t.shape == (m1,) and w_t.shape == (n,)
    assert h_t.dtype == w_t.dtype == torch.float32
    np.testing.assert_allclose(_np(h_t), np.asarray(h), **tol)
    np.testing.assert_allclose(_np(w_t), np.asarray(w), **tol)
    assert not np.any(_np(h_t)[j + 1:])          # rows past j stay zero


def test_wrappers_validate_shapes():
    a = torch.zeros(8, 8)
    with pytest.raises(TypeError):
        matvec.block_matvec(a, torch.zeros(7, 1))
    with pytest.raises(ValueError):
        cgs2.gs_project(torch.zeros(4, 8), torch.zeros(8), 4)
    with pytest.raises(TypeError):
        arnoldi_fused.arnoldi_step(a, torch.zeros(4, 7), 0)
