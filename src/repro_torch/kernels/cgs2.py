"""Fused Gram-Schmidt projection pass: h = mask*(V w); w' = w - h V.

Counterpart of ``repro/kernels/cgs2.py::gs_project`` / ``cgs2`` (the fused
single-shard pass only; the split-phase and payload kernels come with the
distributed and pipelined solvers).  The kernel is ``csrc/cgs2.cu``; its
source note gives the design and the bound.  A basis whose column slices
do not fit shared memory (the sparse solver's n = 2^20) takes the kernel's
streamed variant, chosen from the shape on the C side.

The mask is the prefix of valid basis rows, so the wrappers take ``j``
(rows 0..j valid) instead of a mask vector: the kernel then reads only
those j+1 rows of V.  V is float32 or bfloat16, w is taken as float32 and
h and w' come back in float32 (w' in w's dtype).

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref, tuning

STORAGE = (torch.float32, torch.bfloat16)


def gs_project_plain(v: torch.Tensor, w: torch.Tensor, j: int):
    mask = ref.row_mask(v.shape[0], j, device=v.device)
    h, w1 = ref.gs_project(v, w, mask)
    return h, w1.to(w.dtype)


def _check(v: torch.Tensor, w: torch.Tensor, j: int) -> None:
    if v.ndim != 2 or w.shape != (v.shape[1],):
        raise TypeError(f"gs_project: v {tuple(v.shape)}, w {tuple(w.shape)}"
                        f" — need v (m1, n) and w (n,)")
    if not 0 <= j < v.shape[0]:
        raise ValueError(f"gs_project: j = {j} outside 0..{v.shape[0] - 1}")
    if v.device != w.device:
        raise ValueError(f"gs_project: v on {v.device}, w on {w.device}")


def gs_project(v: torch.Tensor, w: torch.Tensor, j: int):
    """One fused GS pass over basis rows 0..j.  v: (m1, n), w: (n,)."""
    j = int(j)
    _check(v, w, j)
    if v.device.type == "cpu":
        return gs_project_plain(v, w, j)
    if v.device.type != "cuda":
        raise ValueError(f"gs_project: unsupported device {v.device}")
    if v.dtype not in STORAGE or w.dtype not in STORAGE:
        raise TypeError(f"gs_project: storage must be float32 or bfloat16, "
                        f"got v {v.dtype}, w {w.dtype}")
    if not v.is_contiguous():
        raise ValueError("gs_project: v must be contiguous (row-major)")
    m1, n = v.shape
    wf = w.to(torch.float32).contiguous()
    h = torch.empty(m1, dtype=torch.float32, device=v.device)
    w_out = torch.empty(n, dtype=torch.float32, device=v.device)
    cap = tuning.partial_blocks(v.device, max(tuning.GS_BLOCKS_PER_SM,
                                              tuning.STREAM_BLOCKS_PER_SM))
    part = torch.empty(cap * m1, dtype=torch.float32, device=v.device)
    rc = _build.library().repro_gs_project(
        v.data_ptr(), int(v.dtype == torch.bfloat16), wf.data_ptr(),
        h.data_ptr(), w_out.data_ptr(), part.data_ptr(), cap, m1, n, j,
        tuning.SMEM_BUDGET, tuning.GS_BLOCKS_PER_SM,
        tuning.STREAM_BLOCKS_PER_SM, _build.stream_ptr(v))
    _build.check("gs_project", rc)
    gs_project.launches += 1
    return h, w_out.to(w.dtype)


gs_project.launches = 0


def launch_shape(v_dtype, m1: int, n: int) -> dict:
    """The grid gs_project launches at this shape on the current card."""
    return _build.shape("repro_gs_project_shape",
                        int(v_dtype == torch.bfloat16), m1, n,
                        tuning.SMEM_BUDGET, tuning.GS_BLOCKS_PER_SM,
                        tuning.STREAM_BLOCKS_PER_SM)


def cgs2(v: torch.Tensor, w: torch.Tensor, j: int):
    """Reorthogonalized (two-pass) fused Gram-Schmidt; returns (h, w'')."""
    h1, w1 = gs_project(v, w, j)
    h2, w2 = gs_project(v, w1, j)
    return h1 + h2, w2
