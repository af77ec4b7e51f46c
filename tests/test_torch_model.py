"""The port's zamba2 serving slice against the JAX package, on the CPU.

Both frameworks see the same inputs: kernel operands and tokens from numpy
seeds, model weights drawn by JAX and carried across with
``repro_torch.convert.model_params``.  The port's wrappers run their plain
versions here (the tensors lie on the CPU); the JAX side runs as its own
tests run it: the Pallas kernels in interpret mode, or the jnp references.

Bars, relative to the largest entry of the JAX result:
- kernels vs JAX's references: 1e-5 (float32), 2e-2 (bfloat16 storage,
  where one f32 difference may flip a bf16 rounding of the output);
- prefill vs the JAX interpret path 1e-4, vs its ref path the JAX test's
  own rtol = atol = 2e-3 (the ref path gates in another order);
- 12 teacher-forced decode steps, logits and caches: 1e-4 with a float32
  KV cache, 2e-3 with the default bfloat16 one.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.kernels import ops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.attention import attention as jattention  # noqa: E402
from repro.kernels.gated_norm import gated_rmsnorm as jgated  # noqa: E402
from repro.kernels.gated_norm import gated_rmsnorm_ref  # noqa: E402
from repro.kernels.ssd import ssd_scan as jssd  # noqa: E402
from repro.kernels.ssd import ssd_scan_ref  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import param_count as jparam_count  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402

from repro_torch import configs, convert  # noqa: E402
from repro_torch.kernels import attention as attention_k  # noqa: E402
from repro_torch.kernels import gated_norm, ssd  # noqa: E402
from repro_torch.launch import make_prefill_step, make_serve_step  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import build, layers as L, param_count  # noqa: E402

BF16 = {"float32": (jnp.float32, torch.float32),
        "bfloat16": (jnp.bfloat16, torch.bfloat16)}
KERNEL_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _relerr(got, want) -> float:
    got = np.asarray(convert.to_numpy(got), np.float64)
    want = np.asarray(convert.to_numpy(want), np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _both(arr, dtype):
    """One numpy array as a JAX array and a CPU tensor of ``dtype``."""
    jdt, tdt = BF16[dtype]
    return jnp.asarray(arr).astype(jdt), torch.from_numpy(arr).to(tdt)


# --------------------------------------------------------------------------
# kernels: the port's plain versions (CPU wrappers) vs JAX
# --------------------------------------------------------------------------
# the attention sweep of tests/test_kernels.py: (b, hq, hkv, sq, skv,
# window, causal), d = 64
ATTN_SHAPES = [(2, 4, 2, 256, 256, None, True),
               (1, 8, 8, 128, 128, None, True),
               (1, 8, 2, 128, 384, None, True),
               (2, 4, 4, 256, 256, 64, True),
               (1, 4, 2, 1, 300, None, True),
               (1, 4, 4, 128, 128, None, False),
               (1, 2, 2, 320, 320, 96, True)]
SSD_SHAPES = [(2, 3, 64, 16, 8, 16), (1, 2, 96, 32, 16, 32),
              (1, 1, 48, 8, 8, 48)]
NORM_SHAPES = [((4, 64, 256), "float32"), ((100, 512), "float32"),
               ((2, 33, 384), "bfloat16")]


def _attn_inputs(shape, seed=0):
    b, hq, hkv, sq, skv, _, _ = shape
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, sq, 64), np.float32),
            rng.standard_normal((b, hkv, skv, 64), np.float32),
            rng.standard_normal((b, hkv, skv, 64), np.float32))


def _ssd_inputs(batch, heads, s, p, n, seed=0):
    rng = np.random.default_rng(seed)
    bh = batch * heads
    x = rng.standard_normal((bh, s, p), np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((bh, s)))).astype(np.float32)
    lg = (-np.abs(rng.standard_normal((bh, s))) * 0.1).astype(np.float32)
    b = rng.standard_normal((batch, s, n), np.float32)
    c = rng.standard_normal((batch, s, n), np.float32)
    return x, dt, lg, b, c


def _norm_inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape, np.float32),
            rng.standard_normal(shape, np.float32),
            rng.standard_normal(shape[-1:], np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", ATTN_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_attention_plain_matches_jax_ref(shape, dtype):
    window, causal = shape[5], shape[6]
    (qj, qt), (kj, kt), (vj, vt) = (_both(a, dtype)
                                    for a in _attn_inputs(shape))
    want = jref.attention(qj, kj, vj, causal=causal, window=window)
    got = attention_k.attention(qt, kt, vt, causal=causal, window=window)
    assert got.dtype == BF16[dtype][1]
    assert _relerr(got, np.asarray(want, np.float32)) < KERNEL_TOL[dtype]


def test_attention_q_chunk_matches_whole():
    q, k, v = (torch.from_numpy(a) for a in
               _attn_inputs((1, 4, 2, 256, 256, None, True), seed=3))
    whole = attention_k.attention_plain(q, k, v)
    chunked = attention_k.ref.attention(q, k, v, q_chunk=64)
    assert _relerr(chunked, whole) < 1e-6


def test_attention_plain_matches_jax_interpret_kernel():
    shape = (1, 4, 2, 1, 300, None, True)       # the smallest sweep shape
    q, k, v = _attn_inputs(shape, seed=1)
    want = jattention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      causal=True, interpret=True)
    got = attention_k.attention(*(torch.from_numpy(a) for a in (q, k, v)))
    assert _relerr(got, want) < KERNEL_TOL["float32"]


@pytest.mark.parametrize("shape", SSD_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_ssd_scan_plain_matches_jax_ref(shape):
    batch, heads, s, p, n, q = shape
    arrs = _ssd_inputs(batch, heads, s, p, n)
    want = ssd_scan_ref(*map(jnp.asarray, arrs), heads=heads, chunk=q)
    got = ssd.ssd_scan(*map(torch.from_numpy, arrs), heads=heads, chunk=q)
    assert _relerr(got, want) < KERNEL_TOL["float32"]


def test_ssd_scan_plain_matches_model_oracle():
    """The port's scan == the JAX models/ssm.py production scan."""
    batch, heads, s, p, n, q = 2, 2, 32, 8, 8, 16
    x, dt, _, b, c = _ssd_inputs(batch, heads, s, p, n, seed=2)
    bh = batch * heads
    xh = jnp.asarray(x).reshape(batch, heads, s, p).transpose(0, 2, 1, 3)
    dth = jnp.asarray(dt).reshape(batch, heads, s).transpose(0, 2, 1)
    want, _ = jssm._ssd_chunk_scan(
        xh, dth, jnp.zeros(heads), jnp.asarray(b), jnp.asarray(c),
        jnp.zeros((batch, heads, n, p), jnp.float32), q)
    want = want.transpose(0, 2, 1, 3).reshape(bh, s, p)
    # a_log = 0 -> lg = dt * (-exp(0)) = -dt
    got = ssd.ssd_scan(torch.from_numpy(x), torch.from_numpy(dt),
                       -torch.from_numpy(dt), torch.from_numpy(b),
                       torch.from_numpy(c), heads=heads, chunk=q)
    assert _relerr(got, want) < KERNEL_TOL["float32"]


def test_ssd_scan_plain_matches_jax_interpret_kernel():
    batch, heads, s, p, n, q = 1, 1, 48, 8, 8, 48   # the smallest shape
    arrs = _ssd_inputs(batch, heads, s, p, n, seed=4)
    want = jssd(*map(jnp.asarray, arrs), heads=heads, chunk=q,
                interpret=True)
    got = ssd.ssd_scan(*map(torch.from_numpy, arrs), heads=heads, chunk=q)
    assert _relerr(got, want) < KERNEL_TOL["float32"]


@pytest.mark.parametrize("shape,dtype", NORM_SHAPES,
                         ids=lambda s: "x".join(map(str, s))
                         if isinstance(s, tuple) else s)
def test_gated_rmsnorm_plain_matches_jax_ref(shape, dtype):
    (yj, yt), (zj, zt), (wj, wt) = (_both(a, dtype)
                                    for a in _norm_inputs(shape))
    want = gated_rmsnorm_ref(yj, zj, wj)
    got = gated_norm.gated_rmsnorm(yt, zt, wt)
    assert got.dtype == BF16[dtype][1]
    assert _relerr(got, np.asarray(want, np.float32)) < KERNEL_TOL[dtype]


def test_gated_rmsnorm_plain_matches_jax_interpret_kernel():
    shape, dtype = NORM_SHAPES[2]                # the smallest shape
    (yj, yt), (zj, zt), (wj, wt) = (_both(a, dtype)
                                    for a in _norm_inputs(shape, seed=5))
    want = jgated(yj, zj, wj, interpret=True)
    got = gated_norm.gated_rmsnorm(yt, zt, wt)
    assert _relerr(got, np.asarray(want, np.float32)) < KERNEL_TOL[dtype]


def test_kernel_wrappers_refuse_bad_shapes():
    x = torch.zeros(4, 32, 8)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssd.ssd_scan(x, torch.zeros(4, 32), torch.zeros(4, 32),
                     torch.zeros(2, 32, 8), torch.zeros(2, 32, 8), heads=2,
                     chunk=24)
    with pytest.raises(TypeError, match="does not cover"):
        ssd.ssd_scan(x, torch.zeros(4, 32), torch.zeros(4, 32),
                     torch.zeros(1, 32, 8), torch.zeros(1, 32, 8), heads=2,
                     chunk=16)
    with pytest.raises(TypeError, match="hq % hkv"):
        attention_k.attention(torch.zeros(1, 3, 4, 8), torch.zeros(1, 2, 4, 8),
                              torch.zeros(1, 2, 4, 8))
    with pytest.raises(ValueError, match="window"):
        attention_k.attention(torch.zeros(1, 2, 4, 8), torch.zeros(1, 2, 4, 8),
                              torch.zeros(1, 2, 4, 8), window=0)
    with pytest.raises(TypeError, match="z must match y"):
        gated_norm.gated_rmsnorm(torch.zeros(2, 8), torch.zeros(2, 4),
                                 torch.zeros(8))


# --------------------------------------------------------------------------
# configs and layers
# --------------------------------------------------------------------------
@pytest.mark.parametrize("overrides", [{}, {"num_layers": 5}, None],
                         ids=["reduced", "reduced-tail", "full"])
def test_config_and_param_count_match_jax(overrides):
    cj, ct = jconfigs.get("zamba2-7b"), configs.get("zamba2-7b")
    if overrides is not None:
        cj, ct = cj.reduced(**overrides), ct.reduced(**overrides)
    assert dataclasses.asdict(ct) == dataclasses.asdict(cj)
    assert param_count(ct) == jparam_count(cj)


def test_configs_get_aliases_and_unported_archs():
    assert configs.get("zamba2_7b") is configs.get("zamba2-7b")
    assert param_count(configs.get("zamba2-7b")) == 6_751_130_832
    with pytest.raises(NotImplementedError, match="item 12"):
        configs.get("tinyllama-1.1b")
    with pytest.raises(KeyError):
        configs.get("gpt-5")
    other = dataclasses.replace(configs.get("zamba2-7b"), family="dense")
    with pytest.raises(NotImplementedError, match="item 12"):
        build(other)


def test_layers_match_jax():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 3, 5, 32), np.float32)
    w = rng.standard_normal((32,), np.float32)
    pos = np.broadcast_to(np.arange(5, dtype=np.int32), (2, 3, 5)).copy()
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    assert _relerr(L.rmsnorm(xt, wt, 1e-5),
                   JL.rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-5)) < 1e-6
    assert _relerr(L.apply_rope(xt, torch.from_numpy(pos), 10_000.0),
                   JL.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                 10_000.0)) < 1e-5
    mlp = {k: rng.standard_normal(s, np.float32) / 8 for k, s in
           (("w_gate", (32, 48)), ("w_up", (32, 48)), ("w_down", (48, 32)))}
    assert _relerr(
        L.mlp_apply({k: torch.from_numpy(v) for k, v in mlp.items()}, xt,
                    torch.float32),
        JL.mlp_apply({k: jnp.asarray(v) for k, v in mlp.items()},
                     jnp.asarray(x), jnp.float32)) < 1e-5


# --------------------------------------------------------------------------
# the slice: zamba2_7b.reduced() (4 layers) and reduced(num_layers=5) (a
# 1-layer tail), batch 2, s = 32, chunk 16, float32
# --------------------------------------------------------------------------
@pytest.fixture(scope="module", params=[4, 5], ids=["reduced",
                                                    "reduced-tail"])
def zamba(request):
    cj = jconfigs.get("zamba2_7b").reduced(num_layers=request.param)
    ct = configs.get("zamba2_7b").reduced(num_layers=request.param)
    mj = jbuild(cj)
    pj = mj.init(jax.random.PRNGKey(0))
    toks = np.random.default_rng(1).integers(
        2, cj.vocab_size, (2, 32)).astype(np.int32)
    want_ref = mj.prefill(pj, {"tokens": jnp.asarray(toks)})
    with ops.use_kernels("interpret"):
        want_kernels = mj.prefill(pj, {"tokens": jnp.asarray(toks)})
    pt = convert.model_params(pj, ct, device="cpu")
    return dict(cj=cj, ct=ct, mj=mj, pj=pj, pt=pt, toks=toks,
                want_ref=np.asarray(want_ref),
                want_kernels=np.asarray(want_kernels),
                got=make_prefill_step(ct)(pt, {"tokens": toks}))


def test_converted_params_have_init_structure(zamba):
    """convert.model_params keeps every JAX leaf (unstacked) and matches the
    port's own init in structure, shapes, dtypes and fixed values."""
    own = build(zamba["ct"]).init(torch.Generator().manual_seed(0),
                                  device="cpu")

    def spec(tree):
        if isinstance(tree, dict):
            return {k: spec(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [spec(v) for v in tree]
        return (tuple(tree.shape), tree.dtype)
    assert spec(own) == spec(zamba["pt"])
    # a_log = log(linspace(1, 16, h)): the same up to float32 rounding
    a_log = zamba["pt"]["groups"][0][1]["block"]["a_log"]
    np.testing.assert_array_equal(
        a_log.numpy(), np.asarray(zamba["pj"]["groups"]["block"]["a_log"][0, 1]))
    np.testing.assert_allclose(own["groups"][0][1]["block"]["a_log"].numpy(),
                               a_log.numpy(), rtol=1e-6)


def test_prefill_matches_jax_interpret(zamba):
    assert zamba["got"].shape == (2, zamba["ct"].vocab_size)
    assert zamba["got"].dtype == torch.float32
    assert _relerr(zamba["got"], zamba["want_kernels"]) < 1e-4


def test_prefill_matches_jax_ref(zamba):
    np.testing.assert_allclose(zamba["got"].numpy(), zamba["want_ref"],
                               rtol=2e-3, atol=2e-3)


def _stack_ssm(states):
    return (np.stack([convert.to_numpy(s.conv) for s in states]),
            np.stack([convert.to_numpy(s.h) for s in states]))


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_decode_matches_jax(zamba, cache_dtype):
    """12 teacher-forced decode steps: logits every step, then every cache
    (Mamba conv and SSM states, each site's K, V and slot positions)."""
    tol = {"float32": 1e-4, "bfloat16": 2e-3}[cache_dtype]
    jdt, tdt = BF16[cache_dtype]
    mj, mt = zamba["mj"], build(zamba["ct"])
    steps = 12
    cj = mj.init_cache(2, steps, jdt)
    ct = mt.init_cache(2, steps, tdt, device="cpu")
    decode = jax.jit(mj.decode)
    for i in range(steps):
        tok = zamba["toks"][:, i]
        lj, cj = decode(zamba["pj"], cj, jnp.asarray(tok), jnp.int32(i))
        lt, ct = mt.decode(zamba["pt"], ct, torch.from_numpy(tok), i)
        assert _relerr(lt, lj) < tol, i
    ng, g = len(ct.group_ssm), len(ct.group_ssm[0])
    conv, h = _stack_ssm([s for row in ct.group_ssm for s in row])
    assert _relerr(conv, np.asarray(cj.group_ssm.conv, np.float32)
                   .reshape(ng * g, *conv.shape[1:])) < tol
    assert _relerr(h, np.asarray(cj.group_ssm.h)
                   .reshape(ng * g, *h.shape[1:])) < tol
    if ct.tail_ssm is not None:
        conv, h = _stack_ssm(ct.tail_ssm)
        assert _relerr(conv, np.asarray(cj.tail_ssm.conv, np.float32)) < tol
        assert _relerr(h, np.asarray(cj.tail_ssm.h)) < tol
    else:
        assert cj.tail_ssm is None
    for field in ("k", "v"):
        got = np.stack([convert.to_numpy(getattr(kv, field))
                        for kv in ct.attn])
        assert _relerr(got, np.asarray(getattr(cj.attn, field),
                                       np.float32)) < tol
    np.testing.assert_array_equal(
        np.stack([kv.kpos.numpy() for kv in ct.attn]), np.asarray(cj.attn.kpos))


def test_prefill_matches_own_decode_replay(zamba):
    mt = build(zamba["ct"])
    s = 12
    toks = zamba["toks"][:, :s]
    want = mt.prefill(zamba["pt"], {"tokens": toks})
    cache = mt.init_cache(2, s, device="cpu")
    for i in range(s):
        got, cache = mt.decode(zamba["pt"], cache, toks[:, i], i)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-2,
                               atol=2e-2)


def test_greedy_serving_matches_jax(zamba):
    """The port's serving loop (4 prompt steps, 8 greedy tokens) gives the
    tokens of JAX's decode followed by argmax, on the same weights, with
    the JAX serving driver's loop."""
    mj, cfg = zamba["mj"], zamba["ct"]
    prompt, gen = zamba["toks"][:, :4], 8
    got = serve.generate(cfg, zamba["pt"], prompt, gen, device="cpu")
    cache = mj.init_cache(2, prompt.shape[1] + gen)
    decode = jax.jit(mj.decode)
    for i in range(prompt.shape[1]):
        logits, cache = decode(zamba["pj"], cache, jnp.asarray(prompt[:, i]),
                               jnp.int32(i))
    # as repro/launch/serve.py: the token after the prompt is fed, and the
    # tokens each generation step predicts are kept
    want = []
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    for i in range(gen):
        logits, cache = decode(zamba["pj"], cache, tok,
                               jnp.int32(prompt.shape[1] + i))
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        want.append(np.asarray(tok))
    np.testing.assert_array_equal(got, np.stack(want, axis=1))
    step = make_serve_step(cfg)
    tok, _ = step(zamba["pt"], build(cfg).init_cache(2, 1, device="cpu"),
                  torch.from_numpy(prompt[:, 0]), 0)
    assert tok.dtype == torch.int32 and tok.shape == (2,)


def test_serve_cli_runs_on_cpu():
    gen = serve.main(["--arch", "zamba2-7b", "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "8", "--gen", "4"])
    assert gen.shape == (2, 4) and gen.dtype == np.int32
    assert ((gen >= 0) & (gen < configs.get("zamba2-7b").reduced()
                          .vocab_size)).all()
