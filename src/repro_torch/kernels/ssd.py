"""Mamba2 SSD chunked scan (the zamba2 backbone's sequence mixer).

Counterpart of ``repro/kernels/ssd.py`` (``ssd_scan``, ``ssd_scan_ref``).
The kernel is ``csrc/ssd.cu``; its source note gives the design and the
bound.  x, b and c share one storage type, float32 or bfloat16; dt and lg
are read as float32; every sum is float32 but the chunk's cumulative sum
of lg (float64, see ``ssd_scan_plain``); y has x's dtype.

Layout: x (BH, S, P) with BH = batch * heads, head-major within a batch row;
dt and lg (BH, S), lg the log-decay dt * A (negative); b and c (B, S, N),
shared by the ``heads`` rows of a batch row.  S is a multiple of the chunk
min(chunk, S).

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, tuning

STORAGE = (torch.float32, torch.bfloat16)
MAX_N = 64                    # state width the kernel's register tiles hold
MAX_P = 128                   # head width
TILE = 64                     # rows of the kernel's t and u tiles


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
    smem = 8 * q + 4 * (n * p_dim + q + 2 * TILE * (n + 1) + TILE * p_dim
                        + TILE * (TILE + 1))
    if smem > tuning.SMEM_LIMIT:
        raise ValueError(f"ssd_scan: chunk {q} needs {smem} bytes of shared "
                         f"memory, more than a block has")
    xc, bc, cc = x.contiguous(), b.contiguous(), c.contiguous()
    dtf, lgf = dt.float().contiguous(), lg.float().contiguous()
    y = torch.empty_like(xc)
    if y.numel() == 0:
        return y
    rc = _build.library().repro_ssd_scan(
        xc.data_ptr(), int(x.dtype == torch.bfloat16), dtf.data_ptr(),
        lgf.data_ptr(), bc.data_ptr(), cc.data_ptr(), y.data_ptr(), bh, s,
        p_dim, n, heads, q, _build.stream_ptr(x))
    _build.check("ssd_scan", rc)
    ssd_scan.launches += 1
    return y


ssd_scan.launches = 0
