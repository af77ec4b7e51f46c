"""The redesigned sliced-ELL and attention launches, on the CPU.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``);
what surrounds them is pure Python and is held here:

- the sliced-ELL bin-table planner (``spmv.sell_plan``,
  ``spmv.threads_per_row``): every sorted row covered exactly once, each
  bin's first output row and first block, the table's limit;
- ``SlicedEllOperator.__call__`` through the permuted-output path
  (``sell_matvec(..., perm)``; on a CPU tensor its plain version and the
  scatter) against the JAX package's ``SlicedEllOperator``, float32,
  relative tolerance 1e-5 (another summation order over at most 689
  terms);
- the attention launch planner (``attention.launch_plan``): which kernel,
  d_pad, the TMA boxes and whether a tensor needs an alignment copy, at
  every shape of the JAX package's attention sweep and zamba2-7b's
  prefill, in both storage types.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import graphs as jax_graphs  # noqa: E402
from repro.core import stencils as jax_stencils  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import graphs, stencils  # noqa: E402
from repro_torch.kernels import attention as attention_k  # noqa: E402
from repro_torch.kernels import spmv  # noqa: E402

# (b, hq, hkv, sq, skv, window, causal, d): the JAX package's attention
# sweep (tests/test_kernels.py) at d = 64, and zamba2-7b's prefill
ATTN_SHAPES = [(2, 4, 2, 256, 256, None, True, 64),
               (1, 8, 8, 128, 128, None, True, 64),
               (1, 8, 2, 128, 384, None, True, 64),
               (2, 4, 4, 256, 256, 64, True, 64),
               (1, 4, 2, 1, 300, None, True, 64),
               (1, 4, 4, 128, 128, None, False, 64),
               (1, 2, 2, 320, 320, 96, True, 64),
               (2, 32, 32, 512, 512, None, True, 112)]


@functools.lru_cache(maxsize=None)
def _pagerank(n):
    return graphs.pagerank_system(n, seed=0, fmt="sell", device="cpu")[0]


def _check_covers(plan, shapes):
    """Rows and blocks of the plan follow each other, and each block's
    rows (by the kernel's own arithmetic) hit every sorted row once."""
    assert [(p["rows"], p["width"]) for p in plan] == \
        [tuple(s) for s in shapes]
    row0 = block0 = 0
    hits = np.zeros(sum(r for r, _ in shapes), np.int64)
    for p in plan:
        assert p["row0"] == row0 and p["block0"] == block0
        t = p["threads_per_row"]
        assert t == spmv.threads_per_row(p["width"])
        per_block = spmv.SELL_THREADS // t
        assert p["blocks"] == -(-p["rows"] // per_block)
        for blk in range(p["blocks"]):
            for g in range(per_block):      # the kernel's row of group g
                r = blk * per_block + g
                if r < p["rows"]:
                    hits[p["row0"] + r] += 1
        row0 += p["rows"]
        block0 += p["blocks"]
    assert (hits == 1).all()


@pytest.mark.parametrize("system", ["pagerank", "stencil"])
def test_sell_plan_covers_every_row_once(system):
    if system == "pagerank":
        op = _pagerank(2048)
        assert not op.identity_perm and len(op.bin_values) > 1
    else:
        op = stencils.poisson_2d(40, 30, fmt="sell", device="cpu")
        assert op.identity_perm
    shapes = [tuple(v.shape) for v in op.bin_values]
    _check_covers(spmv.sell_plan(shapes), shapes)


def test_sell_plan_pagerank_8192_tables():
    """The PageRank burst's operator (pagerank_system(8192)'s bins, as
    chip_smoke.py's sparse_build line prints them; building it here would
    take a dense 0.5 GB intermediate): the hub bin gets a whole block a
    row, the narrow bins a thread a row, and the grid is 113 blocks."""
    shapes = [(64, 689), (64, 37), (256, 23), (512, 12), (768, 8),
              (2432, 6), (2304, 4), (1792, 3)]
    plan = spmv.sell_plan(shapes)
    _check_covers(plan, shapes)
    assert [p["threads_per_row"] for p in plan] == [256, 16, 8, 4, 1, 1, 1,
                                                   1]
    assert sum(p["blocks"] for p in plan) == 113


@pytest.mark.parametrize("width,want", [(1, 1), (3, 1), (8, 1), (9, 4),
                                        (12, 4), (23, 8), (37, 16),
                                        (128, 32), (689, 256), (5000, 256)])
def test_threads_per_row_rule(width, want):
    t = spmv.threads_per_row(width)
    assert t == want
    assert t & (t - 1) == 0 and 1 <= t <= spmv.SELL_THREADS
    if t > 1 and t < spmv.SELL_THREADS:     # each lane walks <= 4 slots
        assert -(-width // t) <= spmv.SELL_SLOTS


def test_sell_plan_table_limit_and_overrides():
    rng = np.random.default_rng(0)
    shapes = [(int(r), int(w)) for r, w in
              zip(rng.integers(1, 300, spmv.MAX_SELL_BINS + 1),
                  rng.integers(1, 700, spmv.MAX_SELL_BINS + 1))]
    at_limit = shapes[:spmv.MAX_SELL_BINS]
    _check_covers(spmv.sell_plan(at_limit), at_limit)
    with pytest.raises(ValueError, match="bins"):
        spmv.sell_plan(shapes)
    with pytest.raises(ValueError, match="bins"):
        spmv.sell_plan([])
    plan = spmv.sell_plan([(64, 689)], tpr=(32,))
    assert plan[0]["threads_per_row"] == 32 and plan[0]["blocks"] == 8
    with pytest.raises(ValueError, match="power of two"):
        spmv.sell_plan([(64, 689)], tpr=(48,))


@functools.lru_cache(maxsize=None)
def _jax_op(system):
    if system == "pagerank":
        return jax_graphs.pagerank_system(512, seed=0, fmt="sell")[0]
    return jax_stencils.convection_diffusion_2d(24, 20, fmt="sell")


@pytest.mark.parametrize("system", ["pagerank", "stencil"])
@pytest.mark.parametrize("k", [1, 3, 8, 11])
def test_sliced_ell_operator_permuted_path_matches_jax(system, k):
    op_j = _jax_op(system)
    op_t = convert.operator(op_j, device="cpu")
    assert op_t.identity_perm == (system == "stencil")
    n = op_t.shape[0]
    x = np.random.default_rng(k).standard_normal((n, k)).astype(np.float32)
    x = x[:, 0] if k == 1 else x
    want = np.asarray(op_j(jnp.asarray(x)), np.float32)
    got = op_t(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-5 * scale
    # the wrapper's perm path is the operator's: sorted product, scattered
    perm = None if op_t.identity_perm else op_t.perm
    direct = spmv.sell_matvec(op_t.bin_values, op_t.bin_cols,
                              torch.from_numpy(x), perm)
    torch.testing.assert_close(direct, torch.from_numpy(got), rtol=0,
                               atol=0)


def test_sell_matvec_perm_is_checked():
    op = _pagerank(2048)
    x = torch.ones(2048)
    with pytest.raises(TypeError, match="perm"):
        spmv.sell_matvec(op.bin_values, op.bin_cols, x, op.perm[:-1])


def _attn_tensors(shape, dtype):
    b, hq, hkv, sq, skv, _, _, d = shape
    return (torch.zeros(b, hq, sq, d, dtype=dtype),
            torch.zeros(b, hkv, skv, d, dtype=dtype),
            torch.zeros(b, hkv, skv, d, dtype=dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", ATTN_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_attention_launch_plan(shape, dtype):
    q, k, v = _attn_tensors(shape, dtype)
    plan = attention_k.launch_plan(q, k, v)
    d = shape[-1]
    no_copy = {"q": False, "k": False, "v": False}
    if dtype == torch.float32:
        assert plan == {"kernel": "simt", "d_pad": None, "box_cols": [],
                        "box_valid": [], "copy": no_copy}
        return
    boxes = 1 if d <= 64 else 2
    assert plan["kernel"] == "wgmma"
    assert plan["d_pad"] == 64 * boxes
    assert plan["box_cols"] == [64] * boxes
    assert plan["box_valid"] == ([64] if d == 64 else [64, 48])
    assert plan["copy"] == no_copy


def test_attention_plan_of_the_models_views():
    """zamba2's q/k/v: (b, s, h, d) buffers viewed as (b, h, s, d): strides
    of 7,168 and 224 bytes, no copy; ragged or misaligned ones are copied
    into TMA's layout, and d > 128 raises."""
    qkv = torch.zeros(2, 512, 32, 112, dtype=torch.bfloat16).transpose(1, 2)
    plan = attention_k.launch_plan(qkv, qkv, qkv)
    assert plan["kernel"] == "wgmma" and not any(plan["copy"].values())
    assert qkv.stride(2) * 2 == 7168 and qkv.stride(1) * 2 == 224
    odd = torch.zeros(1, 2, 70, 5, dtype=torch.bfloat16)
    assert attention_k.launch_plan(odd, odd, odd)["copy"] == \
        {"q": True, "k": True, "v": True}
    base = torch.zeros(1 + 2 * 64 * 64, dtype=torch.bfloat16)
    shifted = base[1:].view(1, 2, 64, 64)           # 2-byte offset
    plan = attention_k.launch_plan(
        shifted, torch.zeros(1, 2, 64, 64, dtype=torch.bfloat16), shifted)
    assert plan["copy"] == {"q": True, "k": False, "v": True}
    noncontig = torch.zeros(1, 2, 64, 128, dtype=torch.bfloat16)[..., ::2]
    assert attention_k.launch_plan(noncontig, noncontig,
                                   noncontig)["copy"]["q"]
    big = torch.zeros(1, 1, 4, 130, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        attention_k.launch_plan(big, big, big)


def test_tma_layout_copy_keeps_values_and_aligns():
    g = torch.Generator().manual_seed(0)
    t = torch.randn(1, 3, 7, 5, generator=g).to(torch.bfloat16)
    before = attention_k.attention.layout_copies
    c = attention_k._tma_layout(t)
    assert attention_k.attention.layout_copies == before + 1
    torch.testing.assert_close(c, t, rtol=0, atol=0)
    assert not attention_k._needs_copy(c)
    assert all(st * 2 % 16 == 0 for st in attention_k._tma_strides(c))
    one = torch.zeros(1, 1, 1, 64, dtype=torch.bfloat16)
    assert attention_k._tma_strides(one) == [64, 64, 64]
