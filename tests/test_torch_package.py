"""Package rules of the PyTorch port.

- The port and ``chip_smoke.py`` import neither JAX nor the JAX package.
- Entry points run on the card unless the caller asks for the CPU: without
  a card they raise, they never fall back.
- A JAX-style string ``axis_name`` is refused with ``TypeError``: the
  row-sharded solves take a ``torch.distributed`` process group.
- A failed kernel build raises with the compiler's message.
"""
import pathlib
import re
import subprocess
import sys

import jax  # noqa: F401  (both frameworks in one process, as in the suite)
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import device as device_mod  # noqa: E402
from repro_torch.core import gmres, gmres_batched, graphs  # noqa: E402
from repro_torch.core import gmres_sstep  # noqa: E402
from repro_torch.core import operators, stencils, strategies  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
    .removesuffix(".__init__")
    for p in PORT.rglob("*.py"))


def test_port_imports_no_jax():
    code = ("import sys\n"
            f"for name in {MODULES!r}:\n"
            "    __import__(name)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m == 'jax' or m.startswith(('jax.', 'jaxlib'))\n"
            "             or m == 'repro' or m.startswith('repro.'))\n"
            "assert not bad, bad\n"
            "print(len(sys.modules))\n")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert len(MODULES) >= 41


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_sources_name_no_jax(path):
    src = path.read_text()
    pattern = r"^\s*(import (jax|repro)\b|from (jax|repro)(\.| import))"
    assert not re.search(pattern, src, re.M), path


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_card(no_card):
    a = np.eye(8, dtype=np.float32)
    b = np.ones(8, np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        operators.random_diagdom(8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        operators.DenseOperator(a)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        strategies.device_resident(a, b)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        strategies.offload_matvec(a, b)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stencils.poisson_2d(4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graphs.pagerank_system(16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        operators.SparseOperator.from_dense(a)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gmres_batched(a, np.ones((2, 8), np.float32))
    assert stencils.poisson_2d(4, device="cpu").bands.device.type == "cpu"
    res = strategies.device_resident(a, b, device="cpu")
    assert res.converged and res.x.device.type == "cpu"
    assert device_mod.resolve("cpu").type == "cpu"


def test_sstep_entry_points_raise_without_card(no_card):
    a = np.eye(8, dtype=np.float32) * 2
    b = np.ones(8, np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gmres_sstep(a, b, s=2, blocks=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        strategies.device_resident_sstep(a, b, m=4, s=2)
    res = gmres_sstep(torch.from_numpy(a), torch.from_numpy(b), s=2,
                      blocks=2)
    assert res.converged and res.x.device.type == "cpu"
    res = strategies.device_resident_sstep(a, b, m=4, s=2, device="cpu")
    assert res.converged and res.x.device.type == "cpu"


def test_model_entry_points_raise_without_card(no_card):
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.models import build as jbuild

    from repro_torch import configs, convert
    from repro_torch.launch import serve
    from repro_torch.models import build

    cfg = configs.get("zamba2-7b").reduced()
    model = build(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_cache(2, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "zamba2-7b", "--reduced", "--gen", "1"])
    jcfg = jconfigs.get("zamba2-7b").reduced()
    jparams = jbuild(jcfg).init(jax.random.PRNGKey(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.model_params(jparams, cfg)
    params = convert.model_params(jparams, cfg, device="cpu")
    logits = model.prefill(params, {"tokens": jnp.ones((1, 16), jnp.int32)})
    assert logits.device.type == "cpu"
    assert model.init_cache(1, 4, device="cpu").attn[0].k.device.type == "cpu"


def test_unported_paths_raise():
    a = operators.random_diagdom(16, device="cpu")
    b = torch.ones(16)
    res = gmres(a, b, gs="cgs2_pipelined")     # ported: runs and converges
    assert res.converged and res.x.device.type == "cpu"
    with pytest.raises(TypeError, match="ProcessGroup"):
        gmres(a, b, axis_name="rows")
    with pytest.raises(ValueError, match="unknown gram-schmidt"):
        gmres(a, b, gs="householder")


def test_tf32_is_pinned_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_failed_build_raises_with_compiler_stderr(tmp_path, monkeypatch):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: simulated compile failure' >&2\n"
                    "exit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    with pytest.raises(RuntimeError, match="simulated compile failure"):
        _build.build()
