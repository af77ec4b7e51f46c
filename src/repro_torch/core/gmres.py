"""Restarted GMRES(m), eager PyTorch with early exit.

Counterpart of ``repro/core/gmres.py::gmres`` (and ``_make_step_fn``,
``_gmres_cycle``, ``GmresResult``, ``Diagnostics``,
``classify_residuals``).  The algorithm is the paper's (Kelley 1995):

  1.  r0 = b - A x0, v1 = r0/||r0||
  2.  m Arnoldi steps building V_m, H~_m          (arnoldi.py)
  8.  y_m = argmin || beta e1 - H~_m y ||         (givens.py, incremental QR)
  9.  restart with x_m = x0 + V_m y_m until ||r|| < eps

Where the data lives.  The JAX solver is one XLA program with no host sync.
In eager PyTorch the early-exit test of each Arnoldi step needs its result
on the host, so this solver keeps A, the basis V and w on the device and
copies one Hessenberg column (m+1 values) to the host per step; that copy
is the step's only sync and also the input of the host-side Givens QR
(O(m) scalars, see givens.py).  y (m values) goes back once per cycle, and
the true residual norm once per restart.

Kernel-backed paths: ``gs="fused"`` runs each Arnoldi step as one launch
(``kernels/arnoldi_fused.py``), ``gs="cgs2_fused"`` runs the fused GS
kernel (``kernels/cgs2.py``), and ``DenseOperator(backend="cuda")`` runs
every mat-vec through the GEMV kernel.  On CPU tensors each wrapper runs
its plain version.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import arnoldi, givens
from repro_torch.core.operators import DenseOperator, as_operator
from repro_torch.kernels import arnoldi_fused, tuning

# Cycle-level health taxonomy (see repro/core/gmres.py).
HEALTHY = 0     # converging (or already converged)
NAN_INF = 1     # residual left the reals — poisoned arithmetic
STAGNATED = 2   # no meaningful decrease across the history window
BREAKDOWN = 3   # residual GREW across a cycle (orthogonalization collapse)
STATUS_NAMES = ("HEALTHY", "NAN_INF", "STAGNATED", "BREAKDOWN")

BREAKDOWN_GROWTH = 10.0    # beta_k > 10 * beta_{k-1}  ->  BREAKDOWN
STAGNATION_RTOL = 0.99     # beta_k >= 0.99 * beta_{k-window}  ->  STAGNATED


@dataclasses.dataclass
class Diagnostics:
    """Post-solve health report attached to ``GmresResult.diagnostics``.

    ``residual_history`` is a bounded ring of TRUE per-cycle residual norms
    in chronological order — oldest first, current residual last, ``inf``
    padding on the left until the window fills.
    """
    status: int                    # HEALTHY / NAN_INF / ...
    residual_history: np.ndarray   # (window,) chronological, inf-padded
    history_len: int               # valid trailing entries


def classify_residuals(history, *, converged: bool) -> int:
    """Classify a residual-history ring into a health status code.

    Priority NAN_INF > BREAKDOWN > STAGNATED; a converged solve is HEALTHY.
    """
    history = np.asarray(history)
    last = history[-1]
    prev = history[-2] if history.shape[0] > 1 else last
    oldest = history[0]
    if not np.isfinite(last):
        return NAN_INF
    if np.isfinite(prev) and last > BREAKDOWN_GROWTH * prev and not converged:
        return BREAKDOWN
    if (np.isfinite(oldest) and last >= STAGNATION_RTOL * oldest
            and not converged):
        return STAGNATED
    return HEALTHY


@dataclasses.dataclass
class GmresResult:
    x: torch.Tensor          # solution, on b's device
    residual: float          # final true residual norm ||b - A x||
    restarts: int            # number of restart cycles executed
    converged: bool
    inner_steps: int         # total Arnoldi steps actually taken
    done: bool               # converged OR restart budget exhausted
    diagnostics: Optional[Diagnostics] = None

    @property
    def residual_history(self):
        """Convergence trace shortcut: ``diagnostics.residual_history``."""
        return None if self.diagnostics is None \
            else self.diagnostics.residual_history


_FUSED_STEP_SCHEMES = ("fused", "arnoldi_fused")


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype of the host-side scalars (problem dtype f32 / f64)."""
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"gmres: b must be float32 or float64, got {dtype}; "
                        f"use compute_dtype= for a narrow basis")
    return np.dtype(str(dtype).removeprefix("torch."))


def _make_step_fn(matvec, precond, gs: str, *, identity_precond: bool,
                  m: int, n: int, basis_dtype) -> Callable:
    """Build ``step_fn(v_basis, j) -> ArnoldiStep`` for the inner loop.

    ``gs="fused"`` needs an unpreconditioned ``DenseOperator`` whose basis
    slices fit the kernel's shared memory (``tuning.fused_step_fits``);
    otherwise it degrades to ``"cgs2_fused"``.  The choice is made here,
    from shapes, before any launch.
    """
    if gs in _FUSED_STEP_SCHEMES:
        dev = matvec.a.device if isinstance(matvec, DenseOperator) else None
        if (identity_precond and dev is not None
                and tuning.fused_step_fits(m + 1, n, tuning.sm_count(dev))):
            # A compute dtype narrower than A's storage also narrows the A
            # stream; cast once per solve, outside the loop.  The
            # per-restart true residual still uses the full-precision A.
            a_k = matvec.a
            if basis_dtype.itemsize < a_k.dtype.itemsize:
                a_k = a_k.to(basis_dtype)
            a_k = a_k.contiguous()

            def fused_step(v_basis, j):
                h, w = arnoldi_fused.arnoldi_step(a_k, v_basis, j)
                return arnoldi.finalize(w, h, j)

            return fused_step
        gs = "cgs2_fused"

    gs_step = arnoldi.step(gs)

    def step(v_basis, j):
        w = matvec(precond(v_basis[j]))
        return gs_step(v_basis, w, j)

    return step


def _gmres_cycle(step_fn, x0, r0, beta, m, tol_abs, precond, basis_dtype):
    """One restart cycle: up to m Arnoldi steps + triangular solve.

    Early exit costs one host sync per step: the Hessenberg column comes to
    the host for the Givens update, and the convergence test reads it.
    """
    n = x0.shape[0]
    np_dtype = _np_dtype(x0.dtype)
    eps = np_dtype.type(np.finfo(np_dtype).tiny ** 0.5)

    v = torch.zeros((m + 1, n), dtype=basis_dtype, device=x0.device)
    v[0] = (r0 / float(max(beta, eps))).to(basis_dtype)
    giv = givens.init(m, beta, np_dtype)
    done = beta <= tol_abs
    steps = 0
    while not done and steps < m:
        j = steps
        st = step_fn(v, j)
        v[j + 1] = st.v_next.to(basis_dtype)
        h = st.h.to(x0.dtype).cpu().numpy()       # the step's one sync
        givens.update(giv, h, j, active=True)
        resid = givens.residual_norm(giv, j)
        happy = h[j + 1] <= eps * 100
        done = resid <= tol_abs or happy
        steps = j + 1
    y = torch.from_numpy(givens.solve(giv, steps)).to(x0.device)
    dx = y @ v[:m].to(x0.dtype)                   # V^T y with row basis
    return x0 + precond(dx), steps


def check_precond(precond) -> None:
    """Reject a non-callable ``precond`` early, with the argument named."""
    if precond is not None and not callable(precond):
        raise ValueError(
            f"precond must be callable (a plain M^-1 apply fn), got "
            f"{type(precond).__name__} {precond!r}")


def gmres(
    a,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    m: int = 30,
    tol: float = 1e-5,
    max_restarts: int = 50,
    gs: str = "cgs2",
    precond: Optional[Callable] = None,
    axis_name: Optional[str] = None,
    compute_dtype=None,
    history: int = 8,
) -> GmresResult:
    """Right-preconditioned restarted GMRES(m) on ``b``'s device.

    Args:
      a: a ``DenseOperator`` / ``FunctionOperator``, a bare matvec callable,
        or a dense (n, n) matrix (wrapped as a "torch"-backend operator on
        b's device).
      b: right-hand side, shape (n,); the solve runs on its device.
      x0: initial guess (zeros by default).
      m: restart length (Krylov subspace dimension per cycle).
      tol: relative residual target, ||b - Ax|| <= tol * ||b||.
      max_restarts: restart-cycle budget.
      gs: "cgs" | "mgs" | "cgs2" | "cgs2_fused" (fused GS kernel) |
        "fused" (whole Arnoldi step in one kernel; needs an
        unpreconditioned ``DenseOperator`` whose basis slices fit shared
        memory, degrades to "cgs2_fused" otherwise).
      precond: right preconditioner M^{-1} as a callable (identity default).
      axis_name: row-sharded solves are not ported yet; must be None.
      compute_dtype: Krylov-basis storage dtype (e.g. ``torch.bfloat16``);
        reductions still accumulate in f32 and the per-restart true
        residual bounds the rounding.  With ``gs="fused"`` a narrower
        compute dtype also narrows the A stream.
      history: length of the per-cycle residual-history ring; also the
        stagnation window.

    Returns GmresResult; residual is the TRUE residual recomputed from x.
    """
    if axis_name is not None:
        raise NotImplementedError(
            "gmres(axis_name=...): row-sharded solves are not ported yet; "
            "they arrive with the torch.distributed slice")
    matvec = as_operator(a, device=b.device)
    if x0 is None:
        x0 = torch.zeros_like(b)
    check_precond(precond)
    identity_precond = (precond is None
                        or getattr(precond, "is_identity", False))
    if precond is None:
        precond = lambda v: v  # noqa: E731
    basis_dtype = b.dtype if compute_dtype is None else compute_dtype
    step_fn = _make_step_fn(matvec, precond, gs,
                            identity_precond=identity_precond, m=m,
                            n=b.shape[0], basis_dtype=basis_dtype)

    np_dtype = _np_dtype(b.dtype)
    tol_abs = max(np_dtype.type(tol) * np_dtype.type(arnoldi.norm(b).item()),
                  np_dtype.type(0))

    def resid_of(x):
        r = b - matvec(x)
        return r, np_dtype.type(arnoldi.norm(r).item())

    r, beta = resid_of(x0)
    # Chronological ring, inf-padded on the left, seeded with ||b - A x0||.
    hist = np.full((history,), np.inf, np_dtype)
    hist[-1] = beta
    x, k, steps = x0, 0, 0
    while beta > tol_abs and k < max_restarts:
        x, inner = _gmres_cycle(step_fn, x, r, beta, m, tol_abs, precond,
                                basis_dtype)
        r, beta = resid_of(x)
        hist = np.roll(hist, -1)
        hist[-1] = beta
        k += 1
        steps += inner
    converged = bool(beta <= tol_abs)
    diags = Diagnostics(
        status=classify_residuals(hist, converged=converged),
        residual_history=hist,
        history_len=min(k + 1, history),
    )
    return GmresResult(x=x, residual=float(beta), restarts=k,
                       converged=converged, inner_steps=steps,
                       done=converged or k >= max_restarts,
                       diagnostics=diags)
