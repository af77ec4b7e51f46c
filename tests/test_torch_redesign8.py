"""The SSD scan's chunk-parallel tensor-core design, on the CPU.

The kernels (``csrc/ssd.cu``) run only on the card (``tests/test_torch_cuda.py``);
what surrounds them is held here:

- a plain torch model of the kernels' decomposition: every chunk's state
  contribution S = B^T diag(e^{total - cum} dt) x at once, then the pass
  H_{c+1} = e^{total_c} H_c + S_c, then the outputs with G = C B^T formed
  once per (batch row, chunk) and shared by its heads, against
  ``ssd_scan_plain`` and JAX's ``ssd_scan_ref`` at the JAX sweep's shapes
  (and the JAX kernel in interpret mode at the smallest), also with
  zamba2's decays (lg = dt A, A from -1 to -16 as its ``a_log``, cum down
  to -10^3 within a chunk);
- the float32 route's arithmetic: operands rounded to TF32 by their
  mantissa bits, each product as three TF32 passes (split TF32) meets the
  3e-4 bar at zamba2's decays and width, where one TF32 pass does not;
- the launch plan (``tuning.ssd_plan``): tiles, pairs of tiles of equal
  reach, head groups, G's window, grids, scratch bytes, launches, for
  every test shape, zamba2's and one of 65,536 chunks (the
  kernels' shared memory is the C side's: held on the card); and the
  output kernel's stage order
  (``ssd_scan_kernel``'s cursor, replayed): every u row of every head's
  tile once, G's columns formed before they are read.

Bars, relative to the largest entry of the reference: the model against
the plain version 1e-5 and against JAX 1e-5 (float32; other summation
orders); the TF32 route 3e-4, the kernel's bar on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.ssd import ssd_scan as jssd  # noqa: E402
from repro.kernels.ssd import ssd_scan_ref  # noqa: E402
from repro_torch.kernels import ssd, tuning  # noqa: E402

# (batch, heads, s, p, n, chunk): the JAX sweep (tests/test_torch_model.py)
# and the card's extra two-chunk case
SSD_SHAPES = [(2, 3, 64, 16, 8, 16), (1, 2, 96, 32, 16, 32),
              (1, 1, 48, 8, 8, 48), (2, 2, 32, 8, 8, 16)]
ZAMBA = (2, 112, 512, 64, 64, 256)          # zamba2-7b's prefill
MODEL_BAR = 1e-5
CARD_BAR = 3e-4


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _inputs(batch, heads, s, p, n, seed=0, strong=False):
    """x, dt, lg, b, c from numpy.  ``strong``: zamba2's decays, lg = dt A
    with A = -linspace(1, 16, heads) per head (its ``a_log``)."""
    rng = np.random.default_rng(seed)
    bh = batch * heads
    x = rng.standard_normal((bh, s, p), np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((bh, s)))).astype(np.float32)
    if strong:
        a = -np.linspace(1.0, 16.0, heads, dtype=np.float32)
        lg = (dt.reshape(batch, heads, s) * a[None, :, None]).reshape(bh, s)
    else:
        lg = -np.abs(rng.standard_normal((bh, s))) * 0.1
    b = rng.standard_normal((batch, s, n), np.float32)
    c = rng.standard_normal((batch, s, n), np.float32)
    return x, dt, lg.astype(np.float32), b, c


def _model(x, dt, lg, b, c, *, heads, chunk, mm=torch.matmul):
    """The kernels' decomposition in plain torch, products through ``mm``:
    chunk states in parallel, the pass over chunks, the outputs."""
    bh, s, p = x.shape
    n = b.shape[-1]
    q = min(chunk, s)
    nc, batch = s // q, bh // heads
    xf = x.float().reshape(bh, nc, q, p)
    dtf = dt.float().reshape(bh, nc, q)
    cum = torch.cumsum(lg.double().reshape(bh, nc, q), dim=-1)
    total = cum[..., -1]
    bb = b.float().reshape(batch, nc, q, n)
    cc = c.float().reshape(batch, nc, q, n)
    # 1. every chunk's own state contribution at once (ssd_state_kernel)
    w = torch.exp((total[..., None] - cum).float()) * dtf
    states = mm(bb.repeat_interleave(heads, 0).transpose(-1, -2),
                w[..., None] * xf)                          # (bh, nc, n, p)
    # 2. the pass: the state entering each chunk
    hs = [torch.zeros(bh, n, p)]
    for ci in range(nc - 1):
        hs.append(torch.exp(total[:, ci].float())[:, None, None] * hs[-1]
                  + states[:, ci])
    h_in = torch.stack(hs, dim=1)                            # (bh, nc, n, p)
    # 3. the outputs: G once per (batch row, chunk), shared by its heads
    g = mm(cc, bb.transpose(-1, -2)).repeat_interleave(heads, 0)
    tri = torch.tril(torch.ones(q, q, dtype=torch.bool))
    decay = (cum[..., :, None] - cum[..., None, :]).float().masked_fill(
        ~tri, float("-inf"))                                 # masked, then exp
    wmat = g * torch.exp(decay) * dtf[..., None, :]
    ce = cc.repeat_interleave(heads, 0) * torch.exp(cum.float())[..., None]
    y = mm(wmat, xf) + mm(ce, h_in)
    return y.reshape(bh, s, p).to(x.dtype)


def _tf32(t):
    """t rounded to TF32 (10 mantissa bits) to nearest, ties away from 0:
    cvt.rna.tf32.f32 on the magnitude's bits."""
    i = t.float().contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def _mm_split(a, b):
    """The card's float32 product: a = ah + al, b = bh + bl (all TF32),
    al bh + ah bl + ah bh, each exact, summed (in double)."""
    ah, bh_ = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh_)
    d = torch.float64
    return (al.to(d) @ bh_.to(d) + ah.to(d) @ bl.to(d)
            + ah.to(d) @ bh_.to(d)).float()


def _mm_single(a, b):
    """One TF32 pass."""
    return (_tf32(a).double() @ _tf32(b).double()).float()


def _torch(arrs):
    return [torch.from_numpy(a) for a in arrs]


# --------------------------------------------------------------------------
# the decomposition
# --------------------------------------------------------------------------
@pytest.mark.parametrize("strong", [False, True], ids=["mild", "zamba2"])
@pytest.mark.parametrize("shape", SSD_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_decomposition_matches_plain_and_jax_ref(shape, strong):
    batch, heads, s, p, n, q = shape
    arrs = _inputs(batch, heads, s, p, n, seed=s + p, strong=strong)
    got = _model(*_torch(arrs), heads=heads, chunk=q)
    plain = ssd.ssd_scan_plain(*_torch(arrs), heads=heads, chunk=q)
    assert _rel(got, plain) < MODEL_BAR
    if not strong:   # JAX's float32 cumulative sums lose digits at -10^3
        want = ssd_scan_ref(*map(jnp.asarray, arrs), heads=heads, chunk=q)
        assert _rel(got, want) < MODEL_BAR


def test_decomposition_matches_jax_interpret_kernel():
    batch, heads, s, p, n, q = 1, 1, 48, 8, 8, 48   # the smallest shape
    arrs = _inputs(batch, heads, s, p, n, seed=4)
    want = jssd(*map(jnp.asarray, arrs), heads=heads, chunk=q,
                interpret=True)
    got = _model(*_torch(arrs), heads=heads, chunk=q)
    assert _rel(got, want) < MODEL_BAR


def test_split_tf32_meets_the_float32_bar_where_one_pass_does_not():
    """zamba2's width (P = N = 64, Q = 256, two chunks) and decays, four
    heads of one batch row: three TF32 passes a product stay near float32
    rounding; one pass loses the bar."""
    batch, heads, s, p, n, q = 1, 4, 512, 64, 64, 256
    args = _torch(_inputs(batch, heads, s, p, n, seed=11, strong=True))
    plain = ssd.ssd_scan_plain(*args, heads=heads, chunk=q)
    split = _rel(_model(*args, heads=heads, chunk=q, mm=_mm_split), plain)
    single = _rel(_model(*args, heads=heads, chunk=q, mm=_mm_single), plain)
    assert split < CARD_BAR / 10
    assert single > CARD_BAR


def test_tf32_rounding_keeps_ten_mantissa_bits():
    v = torch.tensor([1.0, 1 + 2.0 ** -10, 1 + 2.0 ** -11, 1 + 2.0 ** -12,
                      -(1 + 3 * 2.0 ** -12), 3.0e-39, 1e30])
    got = _tf32(v)
    want = torch.tensor([1.0, 1 + 2.0 ** -10, 1 + 2.0 ** -10, 1.0,
                         -(1 + 2.0 ** -10), got[5].item(), got[6].item()])
    assert torch.equal(got, want)
    assert (got.view(torch.int32) & 0x1FFF == 0).all()
    # hi + lo keeps about 21 bits: float32's 24 less the two roundings
    x = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    hi = _tf32(x)
    assert float(((hi + _tf32(x - hi) - x).abs() / x.abs()).max()) < 2 ** -20


# --------------------------------------------------------------------------
# the plan and the stage order
# --------------------------------------------------------------------------
def _steps(plan, q, chunk_index, hg):
    """ssd_scan_kernel's cursor (``advance``) for one block with ``hg``
    heads, both tiles of pair 0..pairs-1: a list per pair of (tile, head,
    phase, window, chunk)."""
    nt, wu = plan["tiles"], plan["window"]
    nh = tuning.SSD_N // tuning.SSD_STAGE if chunk_index > 0 else 0
    out = []
    for pair in range(plan["pairs"]):
        tiles = [nt - 1 - pair] + ([pair] if nt - 1 - pair != pair else [])
        steps = []
        for ti, tile in enumerate(tiles):
            span = min(tile * tuning.SSD_TILE + tuning.SSD_TILE, q)
            wins = -(-span // wu)
            for h in range(hg):
                steps += [(ti, h, "H", 0, k) for k in range(nh)]
                for w in range(wins):
                    ln = -(-min(wu, span - w * wu) // tuning.SSD_STAGE)
                    if h == 0:
                        steps += [(ti, h, "B", w, k) for k in range(ln)]
                    steps += [(ti, h, "X", w, k) for k in range(ln)]
        out.append((tiles, steps))
    return out


PLAN_SHAPES = SSD_SHAPES + [ZAMBA, (2, 112, 2048, 64, 64, 256),
                            (1, 2, 40, 5, 6, 20), (1, 2, 128, 100, 64, 64),
                            (1, 2, 1024, 64, 64, 512),
                            (1, 2, 4 * 65_536, 8, 8, 4)]


@pytest.mark.parametrize("shape", PLAN_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_plan_covers_every_tile_head_and_u_row_once(shape):
    batch, heads, s, p, n, q = shape
    plan = tuning.ssd_plan(batch, heads, s, p, n, q)
    nt = -(-q // 64)
    assert plan["tiles"] == nt and plan["pairs"] == -(-nt // 2)
    assert plan["chunks"] == s // q
    assert plan["launches"] == (2 if s // q <= 2 else 3)   # the pass
    hg, groups = plan["head_group"], plan["groups"]
    assert groups * hg >= heads > (groups - 1) * hg
    # one grid axis each: the chunks may pass gridDim.y's 65,535
    assert plan["grid_states"] == batch * heads * (s // q)
    assert plan["grid_pass"] == batch * heads * plan["pc"] // 16
    assert plan["grid_scan"] == groups * plan["pairs"] * (s // q) * batch
    assert max(plan["grid_states"], plan["grid_pass"],
               plan["grid_scan"]) <= tuning.MAX_GRID
    assert plan["window"] % tuning.SSD_STAGE == 0
    assert plan["window"] <= tuning.SSD_WINDOW
    if q > plan["window"]:
        assert hg == 1                    # G by windows: a head a block
    bh, nc = batch * heads, s // q
    pc, qp = plan["pc"], plan["qp"]
    assert pc == (64 if p <= 64 else 128) >= p
    assert plan["scratch_bytes"] == (12 * bh * nc * qp + 4 * bh * nc
                                     + 4 * bh * (nc - 1) * 64 * pc)
    tiles_seen = []
    for tiles, steps in _steps(plan, q, 1, min(hg, heads)):
        tiles_seen += tiles
        x_work = 0
        for ti, tile in enumerate(tiles):
            span = min(tile * 64 + 64, q)
            for h in range(min(hg, heads)):
                mine = [st for st in steps if st[:2] == (ti, h)]
                assert [st[4] for st in mine if st[2] == "H"] == list(
                    range(tuning.SSD_N // 32))
                rows = []
                formed = set()
                for _, _, ph, w, k in mine:
                    u0 = w * plan["window"] + k * 32
                    if ph == "B":
                        formed.add(u0)
                    if ph == "X":
                        # G's columns are formed before they are read: by
                        # this head's B stage, or head 0's of this tile
                        assert u0 in formed or (h > 0 and plan["windows"]
                                                == 1)
                        rows += range(u0, min(u0 + 32, q))
                        x_work += 1
                assert sorted(rows) == list(range(span))
        if nt % 2 == 0 or tiles[0] != tiles[-1]:
            # every full pair reaches the same u rows
            assert x_work == min(hg, heads) * sum(
                -(-min(t * 64 + 64, q) // 32) for t in tiles)
    assert sorted(tiles_seen) == list(range(nt))


def test_plan_at_zamba2s_prefill():
    """224 rows, S = 512, Q = 256: 4 heads share G, 224 blocks of the output
    kernel, 448 of the state kernel, 5 MB of scratch."""
    plan = tuning.ssd_plan(*ZAMBA)
    assert (plan["tiles"], plan["pairs"], plan["window"]) == (4, 2, 256)
    assert (plan["head_group"], plan["groups"]) == (4, 28)
    assert plan["grid_scan"] == 56 * 2 * 2
    assert plan["grid_states"] == 224 * 2
    assert plan["scratch"] == {"cum": 917_504, "dt": 458_752,
                               "totals": 1_792, "states": 3_670_016}
    assert plan["scratch_bytes"] == 5_048_064


def test_head_groups_fill_two_blocks_an_sm():
    """Blocks of the output launch: close to two an SM where the heads
    allow, never more groups than heads."""
    for sms in (132, 114, 1):
        for shape in (ZAMBA, (1, 112, 512, 64, 64, 256),
                      (8, 112, 4096, 64, 64, 256)):
            batch, heads, s, p, n, q = shape
            plan = tuning.ssd_plan(batch, heads, s, p, n, q, sms)
            per = batch * (s // q) * plan["pairs"]
            assert plan["groups"] <= heads
            if heads * per >= 2 * sms:
                assert plan["groups"] * per >= min(heads * per,
                                                   2 * sms) // 2


def test_wrapper_routes_and_runs_plain_on_the_cpu():
    x, dt, lg, b, c = _torch(_inputs(1, 2, 40, 5, 6, seed=3))
    assert ssd.launch_plan(x, b, heads=2, chunk=20)["route"] == "scalar"
    x2, _, _, b2, _ = _torch(_inputs(1, 2, 32, 8, 8, seed=3))
    assert ssd.launch_plan(x2, b2, heads=2, chunk=16)["route"] == "vec"
    assert ssd.launch_plan(x2.bfloat16(), b2.bfloat16(), heads=2,
                           chunk=16)["route"] == "vec"
    assert ssd.launch_plan(x2[..., :4].contiguous().bfloat16(),
                           b2.bfloat16(), heads=2, chunk=16)["route"] \
        == "scalar"
    before = (ssd.ssd_scan.launches, dict(ssd.ssd_scan.kernel_launches))
    got = ssd.ssd_scan(x, dt, lg, b, c, heads=2, chunk=20)
    assert (ssd.ssd_scan.launches, ssd.ssd_scan.kernel_launches) == before
    assert _rel(got, _model(x, dt, lg, b, c, heads=2, chunk=20)) < MODEL_BAR
