"""The streaming GEMV pair (``gs_update``, ``gs_project_partial``), on the CPU.

The kernels run only on the card (``tests/test_torch_cuda.py``); what
surrounds them is pure Python and is held here:

- the launch shape rule (``tuning.gemv_stream_shape``): the kernels'
  loops over 16-byte pieces and scalar columns, replayed in numpy, cover
  [0, n) exactly once at every n, storage type and alignment, on an H100's
  SMs and on one SM (every thread then takes many pieces, two at once);
- the projection's block-a-row launch for short rows
  (``tuning.gemv_partial_shape``), which also covers each row once;
- the route (``cgs2.stream_plan``): 16-byte pieces only where V, w and
  the row stride are 16-byte aligned (the stride only where more than one
  row is read), else the scalar route;
- both wrappers on the CPU (their plain versions) against the JAX kernels
  at ``interpret=True`` for a misaligned view of w and, for the update,
  the pipelined cycle's ``hc[1]`` row view of h.  Tolerances:
  ``tests/test_torch_sharded.py``'s (float32 3e-5, the JAX package's
  kernel contract; bfloat16 storage 2e-2).
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import cgs2 as jax_cgs2  # noqa: E402
from repro_torch.kernels import cgs2, tuning  # noqa: E402

F32 = dict(rtol=3e-5, atol=3e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
DTYPES = [(torch.float32, jnp.float32, F32),
          (torch.bfloat16, jnp.bfloat16, BF16)]
# n up to 2^20, and a quarter of it (one of four shards of the 1024^2
# stencil; the same as 2^18)
SIZES = (1, 3, 4, 5, 31, 1000, 10_000, 10_003, 1 << 18, 1 << 20,
         (1 << 20) // 4)
# the block of the projection's block-a-row kernel (csrc/common.cuh's
# kThreads); the C side takes it, not the shape rule
ROW_BLOCK = 256


def _hits(shape, n):
    """How often the kernels' loops visit each column: thread t takes the
    pieces p0 = t, t + U G, ... and p0 + k G (k < U), then the scalar
    columns pieces * vec + t, + G, ..."""
    g = shape["threads"] * shape["blocks"]
    u, vec, pieces = shape["unroll"], shape["vec"], shape["pieces"]
    hits = np.zeros(n, np.int64)
    t = np.arange(g)
    for p0 in range(0, max(pieces, 1), u * g):
        for k in range(u):
            p = p0 + t + k * g
            p = p[p < pieces]
            for c in range(vec):
                np.add.at(hits, p * vec + c, 1)
    for c0 in range(pieces * vec, n, g):
        c = c0 + t
        np.add.at(hits, c[c < n], 1)
    return hits


@pytest.mark.parametrize("sms", [tuning.H100_SMS, 1])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("elem_size", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("n", sorted(set(SIZES)))
def test_stream_shape_covers_every_column_once(n, elem_size, aligned, sms):
    shape = tuning.gemv_stream_shape(n, elem_size, aligned, sms)
    vec = 16 // elem_size
    assert shape["vec"] == vec
    assert shape["pieces"] * vec + shape["tail"] == n
    assert shape["tail"] < vec if aligned else shape["pieces"] == 0
    assert shape["route"] == ("vec" if shape["pieces"] else "scalar")
    assert shape["threads"] in (tuning.STREAM_THREADS,
                                tuning.STREAM_SMALL_THREADS)
    items = max(shape["pieces"], shape["tail"])
    assert shape["blocks"] == min(max(1, -(-items // shape["threads"])),
                                  tuning.GEMV_BLOCKS_PER_SM * sms)
    assert (shape["unroll"] == 2) == (items > shape["blocks"]
                                      * shape["threads"])
    assert (_hits(shape, n) == 1).all()


def test_stream_shape_spreads_small_calls_over_the_sms():
    # n = 10^4: 2,500 f32 pieces in 64-thread blocks on 40 SMs
    s = tuning.gemv_stream_shape(10_000, 4, True, tuning.H100_SMS)
    assert (s["threads"], s["blocks"], s["pieces"]) == (64, 40, 2500)
    s = tuning.gemv_stream_shape(1 << 20, 4, True, tuning.H100_SMS)
    assert s["threads"] == 256
    assert s["blocks"] == tuning.GEMV_BLOCKS_PER_SM * tuning.H100_SMS


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("elem_size", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [1, 5, 10_000, 10_003, 1 << 15, 1 << 20])
def test_partial_takes_a_block_a_row_for_short_rows(n, elem_size, aligned):
    shape = tuning.gemv_stream_shape(n, elem_size, aligned, tuning.H100_SMS)
    got = tuning.gemv_partial_shape(shape, rows=16)
    items = max(shape["pieces"], shape["tail"])
    if items <= tuning.PARTIAL_ROW_MAX_ITEMS:
        assert got["by_row"] == 1 and got["blocks"] == 16
        assert got["threads"] == 0 and got["unroll"] == 1
        # a block's threads stride its row: pieces, then the scalar columns
        hits = np.zeros(n, np.int64)
        for t in range(ROW_BLOCK):
            for p in range(t, got["pieces"], ROW_BLOCK):
                hits[p * got["vec"]:(p + 1) * got["vec"]] += 1
            hits[got["pieces"] * got["vec"] + t::ROW_BLOCK] += 1
        assert (hits == 1).all()
    else:
        assert got == dict(shape, by_row=0)
    assert not (aligned and n == 10_000) or got["by_row"] == 1
    assert n != 1 << 20 or got["by_row"] == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stream_plan_takes_the_scalar_route_when_misaligned(dtype):
    n = 1024
    v = torch.zeros(4, n, dtype=dtype)
    buf = torch.zeros(n + 4)
    assert cgs2.stream_plan(v, buf[:n], 4)["route"] == "vec"
    # w four bytes off
    assert cgs2.stream_plan(v, buf[1:n + 1], 4)["route"] == "scalar"
    # V one element off (a view into a larger buffer)
    vb = torch.zeros(4 * n + 1, dtype=dtype)[1:].view(4, n)
    assert vb.data_ptr() % 16 != 0
    assert cgs2.stream_plan(vb, buf[:n], 4)["route"] == "scalar"
    # a row stride of 5 elements: scalar past one row, pieces for one row
    v5 = torch.zeros(3, 5, dtype=dtype)
    assert cgs2.stream_plan(v5, torch.zeros(5), 3)["route"] == "scalar"
    one = cgs2.stream_plan(v5, torch.zeros(5), 1)
    vec = 16 // v5.element_size()
    assert (one["pieces"], one["tail"]) == (5 // vec, 5 % vec)


def _basis(m1, n, j, seed):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, j + 1)))
    v = np.zeros((m1, n), np.float32)
    v[:j + 1] = q.T
    return v


@pytest.mark.parametrize("tdt,jdt,tol", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("j", [0, 8, 16])
def test_gemv_pair_on_views_matches_jax(tdt, jdt, tol, j):
    """A w one float into a buffer and the pipelined cycle's h = hc[1]
    (row 1 of a (2, j + 1) block) give the JAX kernels' results."""
    m1, n = 17, 301
    v = _basis(m1, n, j, seed=400 + j)
    rng = np.random.default_rng(500 + j)
    wbuf = rng.standard_normal(n + 1).astype(np.float32)
    hc = rng.standard_normal((2, j + 1)).astype(np.float32)
    vt = torch.from_numpy(v).to(tdt)
    w = torch.from_numpy(wbuf)[1:]
    h = torch.from_numpy(hc)[1]
    assert w.data_ptr() % 16 != 0 and h.storage_offset() == j + 1
    vj = jnp.asarray(v, jdt)
    mask = (np.arange(m1) <= j).astype(np.float32)
    want = jax_cgs2.gs_project_partial(vj, jnp.asarray(wbuf[1:]),
                                       jnp.asarray(mask), interpret=True)
    got = cgs2.gs_project_partial(vt, w, j)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)
    want = jax_cgs2.gs_update(vj[:j + 1], jnp.asarray(wbuf[1:]),
                              jnp.asarray(hc[1]), interpret=True)
    got = cgs2.gs_update(vt[:j + 1], w, h)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               **tol)
