"""The paper's package comparison, recast as offload strategies on a GPU.

Counterpart of ``repro/core/strategies.py``.  The paper benchmarks four
implementations of the same restarted GMRES(m); a fifth row goes beyond
its strategy space:

  =================  ========================================================
  paper              this module
  =================  ========================================================
  pracma::gmres      ``serial_numpy``      pure host NumPy, MGS
  gmatrix            ``offload_matvec``    A resident on the card; every
                                           mat-vec ships v there and the
                                           result back; the rest on the host
  gputools           ``transfer_per_call`` operands on the host; every
                                           mat-vec re-ships A to the card
  gpuR (vcl)         ``device_resident``   the solver of core/gmres.py on
                                           the card
  (beyond)           ``device_resident_sstep``  the s-step cycle of
                                           core/sstep.py on the card: s
                                           powers per matrix-powers launch,
                                           block Gram-Schmidt, one
                                           Hessenberg copy per cycle
  =================  ========================================================

``offload_matvec`` and ``transfer_per_call`` keep the JAX package's plain
device product (``a_dev @ v`` through XLA there, ``torch.mv`` here): the
strategies measure where the data lives, not a kernel.

The host solver below is plain NumPy with Python loops; it mirrors
pracma::gmres (MGS + dense Givens LS) operation for operation.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.core.gmres import GmresResult, gmres
from repro_torch.core.operators import DenseOperator
from repro_torch.core.sstep import gmres_sstep


def _host_gmres(matvec: Callable[[np.ndarray], np.ndarray], b, x0, m, tol,
                max_restarts):
    n = b.shape[0]
    dtype = b.dtype
    x = np.array(x0, dtype=dtype, copy=True)
    bnorm = np.linalg.norm(b)
    tol_abs = tol * bnorm if bnorm > 0 else tol
    restarts = 0
    inner = 0

    for restarts in range(1, max_restarts + 1):
        r = b - matvec(x)
        beta = np.linalg.norm(r)
        if beta <= tol_abs:
            restarts -= 1
            break
        v = np.zeros((m + 1, n), dtype=dtype)
        v[0] = r / beta
        h = np.zeros((m + 1, m), dtype=dtype)
        cs = np.ones(m, dtype=dtype)
        sn = np.zeros(m, dtype=dtype)
        g = np.zeros(m + 1, dtype=dtype)
        g[0] = beta
        k = m
        for j in range(m):
            inner += 1
            w = matvec(v[j])
            for i in range(j + 1):            # MGS — pracma's scheme
                h[i, j] = np.dot(v[i], w)
                w = w - h[i, j] * v[i]
            h[j + 1, j] = np.linalg.norm(w)
            if h[j + 1, j] > 1e-30:
                v[j + 1] = w / h[j + 1, j]
            for i in range(j):                 # apply old rotations
                t = cs[i] * h[i, j] + sn[i] * h[i + 1, j]
                h[i + 1, j] = -sn[i] * h[i, j] + cs[i] * h[i + 1, j]
                h[i, j] = t
            denom = np.hypot(h[j, j], h[j + 1, j])
            if denom > 1e-30:
                cs[j], sn[j] = h[j, j] / denom, h[j + 1, j] / denom
            else:
                cs[j], sn[j] = 1.0, 0.0
            h[j, j], h[j + 1, j] = denom, 0.0
            g[j + 1] = -sn[j] * g[j]
            g[j] = cs[j] * g[j]
            if abs(g[j + 1]) <= tol_abs:
                k = j + 1
                break
        y = np.zeros(k, dtype=dtype)
        for i in range(k - 1, -1, -1):         # back-substitution
            y[i] = (g[i] - h[i, i + 1:k] @ y[i + 1:k]) / h[i, i]
        x = x + y @ v[:k]
    r = b - matvec(x)
    beta = float(np.linalg.norm(r))
    return x, beta, restarts, beta <= tol_abs, inner


def serial_numpy(a: np.ndarray, b: np.ndarray, x0=None, *, m=30, tol=1e-5,
                 max_restarts=50):
    """pracma::gmres analogue — everything on the host."""
    a = np.asarray(a)
    b = np.asarray(b)
    x0 = np.zeros_like(b) if x0 is None else np.asarray(x0)
    return _host_gmres(lambda v: a @ v, b, x0, m, tol, max_restarts)


def offload_matvec(a: np.ndarray, b: np.ndarray, x0=None, *, m=30, tol=1e-5,
                   max_restarts=50, device="cuda"):
    """gmatrix analogue: A device-resident, per-call v H2D + result D2H."""
    dev = device_mod.resolve(device)
    a_dev = device_mod.as_tensor(a, dev)

    def matvec(v):
        out = torch.mv(a_dev, torch.as_tensor(v, device=dev))
        return out.cpu().numpy()           # D2H sync — the offload boundary

    b = np.asarray(b)
    x0 = np.zeros_like(b) if x0 is None else np.asarray(x0)
    return _host_gmres(matvec, b, x0, m, tol, max_restarts)


def transfer_per_call(a: np.ndarray, b: np.ndarray, x0=None, *, m=30,
                      tol=1e-5, max_restarts=50, device="cuda"):
    """gputools analogue: operands host-resident; EVERY call re-ships A."""
    dev = device_mod.resolve(device)
    a_host = np.require(a, requirements=["C", "W"])

    def matvec(v):
        a_dev = torch.as_tensor(a_host, device=dev)   # the H2D wall
        out = torch.mv(a_dev, torch.as_tensor(v, device=dev))
        return out.cpu().numpy()

    b = np.asarray(b)
    x0 = np.zeros_like(b) if x0 is None else np.asarray(x0)
    return _host_gmres(matvec, b, x0, m, tol, max_restarts)


def device_resident(a, b, x0=None, *, m=30, tol=1e-5, max_restarts=50,
                    gs="cgs2", backend="torch", device="cuda") -> GmresResult:
    """gpuR/vcl analogue: the solve runs on the card.

    A, b, x, the Krylov basis and every mat-vec and orthogonalization stay
    on the device.  It is not one device program, as the JAX version is:
    per Arnoldi step m+1 scalars (the Hessenberg column) cross to the host
    for the Givens update and the early-exit test, m values (y) return per
    cycle and one norm per restart.  ``gs="fused"`` / ``"cgs2_fused"`` and
    ``backend="cuda"`` run the hot loop through the port's kernels.
    """
    op = DenseOperator(a, backend=backend, device=device)
    b = device_mod.as_tensor(b, op.a.device)
    if x0 is not None:
        x0 = device_mod.as_tensor(x0, op.a.device)
    return gmres(op, b, x0, m=m, tol=tol, max_restarts=max_restarts, gs=gs)


def device_resident_sstep(a, b, x0=None, *, m=30, tol=1e-5, max_restarts=50,
                          s=4, backend="torch", device="cuda") -> GmresResult:
    """Communication-avoiding s-step GMRES on the card.

    Beyond the paper's strategy space: the restart length is quantized to
    ``s * (m // s)`` and the whole cycle runs the s-step block algebra
    through the matrix-powers and block Gram-Schmidt kernels (see
    core/sstep.py; ``backend`` selects the residual mat-vec's path, as in
    ``device_resident``).  The monomial-basis caveat applies: practical s
    is 2..8.
    """
    op = DenseOperator(a, backend=backend, device=device)
    b = device_mod.as_tensor(b, op.a.device)
    if x0 is not None:
        x0 = device_mod.as_tensor(x0, op.a.device)
    return gmres_sstep(op, b, x0, s=s, blocks=max(m // s, 1), tol=tol,
                       max_restarts=max_restarts)


STRATEGIES = {
    "serial_numpy": serial_numpy,
    "offload_matvec": offload_matvec,
    "transfer_per_call": transfer_per_call,
    "device_resident": device_resident,
    "device_resident_sstep": device_resident_sstep,
}
