"""Per-lane CGS2 for the block multi-RHS solver (``gmres_batched``).

Counterpart of ``repro/kernels/block_gs.py::batched_cgs2`` (the s-step
block Gram-Schmidt kernels of that module come with a later slice).  The
kernel is ``csrc/batched_cgs2.cu``: one cooperative launch runs both CGS2
passes for every lane; its source note gives the design and the bound.

The JAX wrapper takes a (k, m1) 0/1 mask of valid basis rows.  A lane's
valid rows are always the prefix 0..j, so the port takes the per-lane step
index ``j`` instead (host ints, one per lane), and ``j = -1`` skips a lane
(h = 0, w'' = w): the solver passes it for lanes that are done.  V is
float32 or bfloat16; w is taken as float32; h (k, m1) and the unnormalised
w'' (k, n) come back in float32.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.  There is no size gate: the kernel streams
the bases from global memory, so no basis is too large for it.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build, tuning

STORAGE = (torch.float32, torch.bfloat16)


def _lane_steps(j, k: int, m1: int) -> np.ndarray:
    """j as a host int32 (k,) array, each in -1..m1-1."""
    if isinstance(j, torch.Tensor):
        j = j.detach().cpu()
    j = np.asarray(j).astype(np.int64).reshape(-1)
    if j.shape != (k,):
        raise TypeError(f"batched_cgs2: j has {j.shape[0]} entries for "
                        f"{k} lanes")
    if j.size and (j.min() < -1 or j.max() >= m1):
        raise ValueError(f"batched_cgs2: j {j.tolist()} outside "
                         f"-1..{m1 - 1}")
    return j.astype(np.int32)


def row_masks(j, m1: int, device="cpu") -> torch.Tensor:
    """(k, m1) float32 masks, row i of lane l valid iff i <= j[l] (the JAX
    kernel's ``mask`` argument)."""
    jt = torch.as_tensor(np.asarray(j), device=device).reshape(-1, 1)
    return (torch.arange(m1, device=device)[None, :] <= jt).to(torch.float32)


def batched_cgs2_plain(v: torch.Tensor, w: torch.Tensor, j):
    """Both CGS2 passes per lane: h = h1 + h2 and w'' (the kernel's
    arithmetic, summed in float32 or wider)."""
    k, m1, _ = v.shape
    acc = torch.promote_types(w.dtype, torch.float32)
    mask = row_masks(j, m1, v.device).to(acc)
    vf, wf = v.to(acc), w.to(acc)
    h1 = (vf @ wf[:, :, None])[:, :, 0] * mask
    w1 = wf - (h1[:, None, :] @ vf)[:, 0]
    h2 = (vf @ w1[:, :, None])[:, :, 0] * mask
    w2 = w1 - (h2[:, None, :] @ vf)[:, 0]
    return h1 + h2, w2


def _check(v: torch.Tensor, w: torch.Tensor) -> None:
    if v.ndim != 3 or w.shape != (v.shape[0], v.shape[2]):
        raise TypeError(f"batched_cgs2: v {tuple(v.shape)}, w "
                        f"{tuple(w.shape)} — need v (k, m1, n) and w (k, n)")
    if v.device != w.device:
        raise ValueError(f"batched_cgs2: v on {v.device}, w on {w.device}")


def batched_cgs2(v: torch.Tensor, w: torch.Tensor, j):
    """Per-lane CGS2.  v: (k, m1, n) bases; w: (k, n); j: (k,) host ints,
    rows 0..j[l] of lane l valid (-1: skip the lane).  Returns (h, w'')."""
    _check(v, w)
    k, m1, n = v.shape
    j = _lane_steps(j, k, m1)
    if v.device.type == "cpu":
        return batched_cgs2_plain(v, w, j)
    if v.device.type != "cuda":
        raise ValueError(f"batched_cgs2: unsupported device {v.device}")
    if v.dtype not in STORAGE or w.dtype not in STORAGE:
        raise TypeError(f"batched_cgs2: storage must be float32 or bfloat16, "
                        f"got v {v.dtype}, w {w.dtype}")
    if not v.is_contiguous():
        raise ValueError("batched_cgs2: v must be contiguous")
    cap = tuning.partial_blocks(v.device, tuning.STREAM_BLOCKS_PER_SM)
    per_lane = cap // k
    if per_lane < 1:
        raise ValueError(f"batched_cgs2: {k} lanes exceed the {cap} "
                         f"co-resident blocks of one cooperative launch")
    wf = w.to(torch.float32).contiguous()
    jd = torch.from_numpy(j).to(v.device)
    h = torch.empty((k, m1), dtype=torch.float32, device=v.device)
    w_out = torch.empty((k, n), dtype=torch.float32, device=v.device)
    part = torch.empty(2 * k * m1 * per_lane, dtype=torch.float32,
                       device=v.device)
    rc = _build.library().repro_batched_cgs2(
        v.data_ptr(), int(v.dtype == torch.bfloat16), wf.data_ptr(),
        jd.data_ptr(), h.data_ptr(), w_out.data_ptr(), part.data_ptr(),
        per_lane, k, m1, n, tuning.STREAM_BLOCKS_PER_SM,
        _build.stream_ptr(v))
    _build.check("batched_cgs2", rc)
    batched_cgs2.launches += 1
    return h, w_out


batched_cgs2.launches = 0


def launch_shape(v_dtype, k: int, m1: int, n: int) -> dict:
    """The grid batched_cgs2 launches at this shape on the current card."""
    return _build.shape("repro_batched_cgs2_shape",
                        int(v_dtype == torch.bfloat16), k, m1, n,
                        tuning.STREAM_BLOCKS_PER_SM)
