"""Dense GEMV / multi-RHS GEMM: Y = A X with one stream of A.

Counterpart of ``repro/kernels/matvec.py`` (``block_matvec``, ``matvec``).
The kernel is ``csrc/matvec.cu``; its source note gives the design and the
bound.  A is float32 or bfloat16 (widened in registers), X is taken as
float32, and every sum accumulates in float32; the result has the dtype
``A @ X`` would promote to.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref, tuning

MAX_K = 8            # accumulators per thread; wider blocks are a later slice
STORAGE = (torch.float32, torch.bfloat16)


def block_matvec_plain(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    out = torch.promote_types(a.dtype, x.dtype)
    return ref.matvec(a, x).to(out)


def _check(a: torch.Tensor, x: torch.Tensor) -> None:
    if a.ndim != 2 or x.ndim != 2 or x.shape[0] != a.shape[1]:
        raise TypeError(f"block_matvec: a {tuple(a.shape)} @ x "
                        f"{tuple(x.shape)} — x must be (n, k) with "
                        f"n = {a.shape[1] if a.ndim == 2 else '?'}")
    if a.device != x.device:
        raise ValueError(f"block_matvec: a on {a.device}, x on {x.device}")


def block_matvec(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Y = A @ X.  a: (m, n), x: (n, k) with 1 <= k <= 8."""
    _check(a, x)
    if a.device.type == "cpu":
        return block_matvec_plain(a, x)
    if a.device.type != "cuda":
        raise ValueError(f"block_matvec: unsupported device {a.device}")
    if a.dtype not in STORAGE or x.dtype not in STORAGE:
        raise TypeError(f"block_matvec: storage must be float32 or bfloat16, "
                        f"got a {a.dtype}, x {x.dtype}")
    if not a.is_contiguous():
        raise ValueError("block_matvec: a must be contiguous (row-major)")
    m, n = a.shape
    k = x.shape[1]
    if not 1 <= k <= MAX_K:
        raise ValueError(f"block_matvec: k = {k} columns; the kernel takes "
                         f"1..{MAX_K}")
    xf = x.to(torch.float32).contiguous()
    y = torch.empty((m, k), dtype=torch.float32, device=a.device)
    grid, threads = tuning.gemv_launch(m)
    rc = _build.library().repro_block_matvec(
        a.data_ptr(), int(a.dtype == torch.bfloat16), xf.data_ptr(),
        y.data_ptr(), m, n, k, grid, threads, _build.stream_ptr(a))
    _build.check("block_matvec", rc)
    block_matvec.launches += 1
    return y.to(torch.promote_types(a.dtype, x.dtype))


block_matvec.launches = 0


def matvec(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x.  a: (m, n), x: (n,)."""
    return block_matvec(a, x[:, None])[:, 0]
