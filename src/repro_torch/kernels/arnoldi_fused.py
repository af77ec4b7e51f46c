"""One fused Arnoldi step (mat-vec + CGS2) per launch.

Counterpart of ``repro/kernels/arnoldi_fused.py`` (``arnoldi_step``,
``arnoldi_step_ref``).  The kernel is ``csrc/arnoldi_fused.cu``: one
persistent cooperative launch that streams A once, keeps each block's
column slice of the basis and of w in shared memory, and runs both CGS2
passes with one grid sync each.  Whether a shape fits is
``tuning.fused_step_fits``, which ``core/gmres.py`` checks before it picks
this path.

A and V are float32 or bfloat16 (independently); v_j is rounded to A's
dtype before the product, as in the TPU kernel, and every sum accumulates
in float32.  Returns ``(h, w)``: h (m+1,) float32 with entries > j zero,
and the unnormalised w'' (n,) float32.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref, tuning

STORAGE = (torch.float32, torch.bfloat16)


def arnoldi_step_plain(a: torch.Tensor, v_basis: torch.Tensor, j: int):
    """matvec + masked CGS2, unnormalised (the kernel's arithmetic)."""
    m1 = v_basis.shape[0]
    vj = v_basis[j].to(a.dtype)
    w = ref.matvec(a, vj).to(torch.float32)
    mask = ref.row_mask(m1, j, device=v_basis.device)
    return ref.cgs2(v_basis.to(torch.float32), w, mask)


def _check(a: torch.Tensor, v: torch.Tensor, j: int) -> None:
    if a.ndim != 2 or a.shape[0] != a.shape[1] or v.ndim != 2 \
            or v.shape[1] != a.shape[0]:
        raise TypeError(f"arnoldi_step: a {tuple(a.shape)}, v_basis "
                        f"{tuple(v.shape)} — need a (n, n) and v (m1, n)")
    if not 0 <= j < v.shape[0]:
        raise ValueError(f"arnoldi_step: j = {j} outside 0..{v.shape[0] - 1}")
    if a.device != v.device:
        raise ValueError(f"arnoldi_step: a on {a.device}, v on {v.device}")


def arnoldi_step(a: torch.Tensor, v_basis: torch.Tensor, j: int):
    """One fused Arnoldi step: ``h, w'' = cgs2(V, A @ V[j])``."""
    j = int(j)
    _check(a, v_basis, j)
    if a.device.type == "cpu":
        return arnoldi_step_plain(a, v_basis, j)
    if a.device.type != "cuda":
        raise ValueError(f"arnoldi_step: unsupported device {a.device}")
    if a.dtype not in STORAGE or v_basis.dtype not in STORAGE:
        raise TypeError(f"arnoldi_step: storage must be float32 or bfloat16, "
                        f"got a {a.dtype}, v {v_basis.dtype}")
    if not (a.is_contiguous() and v_basis.is_contiguous()):
        raise ValueError("arnoldi_step: a and v_basis must be contiguous")
    m1, n = v_basis.shape
    h = torch.empty(m1, dtype=torch.float32, device=a.device)
    w = torch.empty(n, dtype=torch.float32, device=a.device)
    cap = tuning.partial_blocks(a.device, tuning.FUSED_BLOCKS_PER_SM)
    part = torch.empty(2 * cap * m1, dtype=torch.float32, device=a.device)
    rc = _build.library().repro_arnoldi_step(
        a.data_ptr(), int(a.dtype == torch.bfloat16), v_basis.data_ptr(),
        int(v_basis.dtype == torch.bfloat16), h.data_ptr(), w.data_ptr(),
        part.data_ptr(), cap, m1, n, j, tuning.SMEM_BUDGET,
        tuning.FUSED_BLOCKS_PER_SM, _build.stream_ptr(a))
    _build.check("arnoldi_step", rc)
    arnoldi_step.launches += 1
    return h, w


arnoldi_step.launches = 0


def launch_shape(a_dtype, v_dtype, m1: int, n: int) -> dict:
    """The grid arnoldi_step launches at this shape on the current card."""
    return _build.shape("repro_arnoldi_step_shape",
                        int(a_dtype == torch.bfloat16),
                        int(v_dtype == torch.bfloat16), m1, n,
                        tuning.SMEM_BUDGET, tuning.FUSED_BLOCKS_PER_SM)
