"""Mamba2 SSD chunked scan (the zamba2 backbone's sequence mixer).

Counterpart of ``repro/kernels/ssd.py`` (``ssd_scan``, ``ssd_scan_ref``).
The kernels are ``csrc/ssd.cu``; its source note gives the design and the
bound: two launches a call (``ssd_state_kernel``: each chunk's cumulative
sums and state contribution, all chunks in parallel; ``ssd_scan_kernel``:
the outputs, with C B^T formed once per batch row, chunk and t tile and
shared by a group of heads), and between them, with three chunks or more,
``ssd_pass_kernel`` (the states entering the chunks); every product in
split TF32 on the tensor cores, planned by ``tuning.ssd_plan``.  x, b and
c share one storage type, float32 or bfloat16; dt and lg are read as
float32; every sum is float32 but the chunk's cumulative sum of lg
(float64, see ``ssd_scan_plain``); y has x's dtype.

Layout: x (BH, S, P) with BH = batch * heads, head-major within a batch row;
dt and lg (BH, S), lg the log-decay dt * A (negative); b and c (B, S, N),
shared by the ``heads`` rows of a batch row.  S is a multiple of the chunk
min(chunk, S).

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, tuning

STORAGE = (torch.float32, torch.bfloat16)
MAX_N = 64                    # state width the kernel's tiles hold
MAX_P = 128                   # head width


def _check(x, dt, lg, b, c, heads, chunk) -> int:
    if x.ndim != 3 or b.ndim != 3 or c.shape != b.shape:
        raise TypeError(f"ssd_scan: x {tuple(x.shape)}, b {tuple(b.shape)}, "
                        f"c {tuple(c.shape)} — x must be (BH, S, P) and b, c "
                        f"(B, S, N)")
    bh, s, _ = x.shape
    if dt.shape != (bh, s) or lg.shape != (bh, s):
        raise TypeError(f"ssd_scan: dt {tuple(dt.shape)}, lg "
                        f"{tuple(lg.shape)} — both must be ({bh}, {s})")
    if b.shape[0] * heads != bh or b.shape[1] != s:
        raise TypeError(f"ssd_scan: b {tuple(b.shape)} with heads = {heads} "
                        f"does not cover x {tuple(x.shape)}")
    q = min(chunk, s)
    if q < 1 or s % q:
        raise ValueError(f"ssd_scan: S = {s} is not a multiple of the chunk "
                         f"{q}")
    if len({t.device for t in (x, dt, lg, b, c)}) != 1:
        raise ValueError("ssd_scan: operands on different devices")
    return q


def ssd_scan_plain(x, dt, lg, b, c, *, heads: int, chunk: int = 256):
    """The chunk recurrence of ``ssd_scan_ref``, all rows at once.

    The chunk's cumulative sums of lg are taken in float64, and their
    differences (the log-decays) rounded to float32 once: in a zamba2 chunk
    the sums reach -10^3, and float32 sums would lose four digits to the
    cancellation (JAX's reference takes them in float32).  The kernel does
    the same."""
    bh, s, p_dim = x.shape
    n = b.shape[-1]
    q = min(chunk, s)
    bb = b.float().repeat_interleave(heads, dim=0)          # (BH, S, N)
    cc = c.float().repeat_interleave(heads, dim=0)
    xf, dtf, lgf = x.float(), dt.float(), lg.float()
    tri = torch.tril(torch.ones(q, q, dtype=torch.bool, device=x.device))
    h = torch.zeros(bh, n, p_dim, device=x.device)
    ys = []
    for c0 in range(0, s, q):
        xc, dtc = xf[:, c0:c0 + q], dtf[:, c0:c0 + q]
        bc, ccx = bb[:, c0:c0 + q], cc[:, c0:c0 + q]
        cum = torch.cumsum(lgf[:, c0:c0 + q].double(), dim=1)   # (BH, q)
        total = cum[:, -1]
        cb = ccx @ bc.transpose(1, 2)                       # (BH, q, q)
        decay = (cum[:, :, None] - cum[:, None, :]).float().masked_fill(
            ~tri, float("-inf"))                            # masked, then exp
        y = (cb * torch.exp(decay) * dtc[:, None, :]) @ xc
        y = y + (ccx * torch.exp(cum.float())[..., None]) @ h
        su = (torch.exp((total[:, None] - cum).float()) * dtc)[..., None]
        h = (torch.exp(total.float())[:, None, None] * h
             + bc.transpose(1, 2) @ (su * xc))
        ys.append(y)
    return torch.cat(ys, dim=1).to(x.dtype)


def launch_plan(x, b, *, heads: int, chunk: int = 256) -> dict:
    """The kernels' plan for these operands (``tuning.ssd_plan`` on x's
    device), with ``route``: "vec" where x, b and c may be read in 16-byte
    pieces (N and P whole pieces of the storage type), else "scalar"."""
    bh, s, p_dim = x.shape
    n = b.shape[-1]
    plan = tuning.ssd_plan(bh // heads, heads, s, p_dim, n, min(chunk, s),
                           tuning.sm_count(x.device))
    piece = 16 // x.element_size()
    plan["route"] = ("vec" if p_dim % piece == 0 and n % piece == 0
                     else "scalar")
    return plan


def ssd_scan(x, dt, lg, b, c, *, heads: int, chunk: int = 256):
    """Chunked SSD.  x: (BH, S, P); dt/lg: (BH, S); b/c: (B, S, N).

    Returns y (BH, S, P) in x's dtype: the scan's output without the D skip
    term (the model adds it)."""
    q = _check(x, dt, lg, b, c, heads, chunk)
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, lg, b, c, heads=heads, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: unsupported device {x.device}")
    if x.dtype not in STORAGE or b.dtype != x.dtype or c.dtype != x.dtype:
        raise TypeError(f"ssd_scan: x, b and c must share float32 or "
                        f"bfloat16 storage, got {x.dtype}, {b.dtype}, "
                        f"{c.dtype}")
    bh, s, p_dim = x.shape
    n = b.shape[-1]
    if n > MAX_N or p_dim > MAX_P:
        raise ValueError(f"ssd_scan: N = {n}, P = {p_dim}; the kernel takes "
                         f"N <= {MAX_N}, P <= {MAX_P}")
    plan = launch_plan(x, b, heads=heads, chunk=chunk)
    grid = max(plan["grid_states"], plan["grid_pass"], plan["grid_scan"])
    if grid > tuning.MAX_GRID:
        raise ValueError(f"ssd_scan: {bh} rows of {s // q} chunks need "
                         f"{grid} blocks on one grid, more than "
                         f"{tuning.MAX_GRID}")
    xc, bc, cc = x.contiguous(), b.contiguous(), c.contiguous()
    dtf, lgf = dt.float().contiguous(), lg.float().contiguous()
    y = torch.empty_like(xc)
    if y.numel() == 0:
        return y
    vec = plan["route"] == "vec" and all(
        t.data_ptr() % 16 == 0 for t in (xc, bc, cc))
    nc, qp = plan["chunks"], plan["qp"]
    dev = x.device
    cum = torch.empty(bh, nc, qp, dtype=torch.float64, device=dev)
    dtp = torch.empty(bh, nc, qp, device=dev)
    tot = torch.empty(bh, nc, device=dev)
    states = torch.empty(bh, nc - 1, tuning.SSD_N, plan["pc"], device=dev)
    rc = _build.library().repro_ssd_scan(
        xc.data_ptr(), int(x.dtype == torch.bfloat16), dtf.data_ptr(),
        lgf.data_ptr(), bc.data_ptr(), cc.data_ptr(), y.data_ptr(),
        cum.data_ptr(), dtp.data_ptr(), tot.data_ptr(), states.data_ptr(),
        bh, s, p_dim, n, heads, q, plan["pc"], qp, plan["head_group"],
        int(vec), _build.stream_ptr(x))
    _build.check("ssd_scan", rc)
    ssd_scan.launches += 1
    for name in KERNELS:
        if name != "ssd_pass_kernel" or nc > 2:
            ssd_scan.kernel_launches[name] += 1
    ssd_scan.routes["vec" if vec else "scalar"] += 1
    return y


def kernel_smem(x, b, *, heads: int, chunk: int = 256) -> dict:
    """The shared memory (bytes) of the state and output kernels for these
    operands, as csrc/ssd.cu lays it out (``repro_ssd_smem``)."""
    plan = launch_plan(x, b, heads=heads, chunk=chunk)
    out = (ctypes.c_int * 2)()
    _build.check("ssd_scan smem", _build.library().repro_ssd_smem(
        plan["pc"], plan["qp"], out))
    return {"ssd_state_kernel": out[0], "ssd_scan_kernel": out[1]}


# the kernels of a call (csrc/ssd.cu); the pass only with three chunks or
# more
KERNELS = ("ssd_state_kernel", "ssd_pass_kernel", "ssd_scan_kernel")
ssd_scan.launches = 0             # calls that launched the kernels
ssd_scan.kernel_launches = dict.fromkeys(KERNELS, 0)
ssd_scan.routes = {"vec": 0, "scalar": 0}
