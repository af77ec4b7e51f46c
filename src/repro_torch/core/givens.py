"""Incremental Givens QR for the GMRES Hessenberg least-squares problem.

Counterpart of ``repro/core/givens.py``.  The state is O(m) scalars, and
the rotation loop is sequential over the column: on the card it would be
about 6 m tiny launches per Arnoldi step, far more than the step's GEMV.
So the port keeps the state on the host, as numpy arrays in the problem
dtype (the arithmetic rounds as the JAX version does), and the solver
copies one Hessenberg column (m+1 values) to the host per step.

Unlike the JAX version, ``update`` works in place on the state and returns
it: the state is host memory owned by one cycle.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class GivensState:
    """Rotations + rotated RHS for the first ``j`` Hessenberg columns.

    r:  (m, m)   upper-triangular factor (rows/cols beyond j untouched)
    cs: (m,)     rotation cosines (identity-initialized: cs=1)
    sn: (m,)     rotation sines   (identity-initialized: sn=0)
    g:  (m + 1,) rotated RHS; ``|g[j]|`` is the current LS residual norm
    """

    r: np.ndarray
    cs: np.ndarray
    sn: np.ndarray
    g: np.ndarray


def init(m: int, beta, dtype=np.float32) -> GivensState:
    g = np.zeros((m + 1,), dtype=dtype)
    g[0] = beta
    # R starts as the identity: columns never written (early-exited steps)
    # stay e_j, keeping the triangular solve nonsingular with y_j = 0.
    return GivensState(r=np.eye(m, dtype=dtype), cs=np.ones((m,), dtype),
                       sn=np.zeros((m,), dtype), g=g)


def _rotation(a, b, eps):
    """Stable Givens rotation zeroing ``b`` against ``a``."""
    denom = np.sqrt(a * a + b * b)
    if denom > eps:
        return a / denom, b / denom, denom
    one = np.ones((), a.dtype)[()]
    return one, one * 0, a


def update(state: GivensState, h, j: int, *, active=True) -> GivensState:
    """Fold Hessenberg column ``h`` (length m+1, entries > j+1 zero) in as
    column j, in place.

    ``active=False`` writes the identity column e_j instead (and zeroes
    g[j]), so the final triangular solve stays nonsingular with y_j = 0.
    """
    dtype = state.g.dtype
    m = state.cs.shape[0]
    if not active:
        state.r[:, j] = 0
        state.r[j, j] = 1
        state.cs[j], state.sn[j], state.g[j] = 1, 0, 0
        return state
    eps = dtype.type(np.finfo(dtype).tiny ** 0.5)
    col = np.asarray(h, dtype=dtype).copy()
    # Rotations at indices >= j are the identity, so only 0..j-1 apply.
    cs, sn = state.cs, state.sn
    for i in range(j):
        c, s = cs[i], sn[i]
        hi, hi1 = col[i], col[i + 1]
        col[i] = c * hi + s * hi1
        col[i + 1] = -s * hi + c * hi1
    c, s, rjj = _rotation(col[j], col[j + 1], eps)
    gj = state.g[j]
    col[j] = rjj
    col[j + 1] = 0
    state.r[:, j] = col[:m]
    cs[j], sn[j] = c, s
    state.g[j] = c * gj
    state.g[j + 1] = -s * gj
    return state


def residual_norm(state: GivensState, j: int):
    """|g[j+1]| — the LS residual after folding column j (Saad Prop. 6.9)."""
    return abs(state.g[j + 1])


def solve(state: GivensState, steps=None) -> np.ndarray:
    """Back-substitute ``R y = g[:m]``.

    ``steps`` = number of Arnoldi steps actually taken; g entries at or
    beyond it are zeroed so identity-filled (never-run) columns yield
    y_j = 0 and ``x = x0 + V^T y`` is correct for any early-stop point.
    """
    m = state.cs.shape[0]
    g = state.g[:m].copy()
    if steps is not None:
        g[steps:] = 0
    y = np.zeros_like(g)
    r = state.r
    for i in range(m - 1, -1, -1):
        y[i] = (g[i] - r[i, i + 1:] @ y[i + 1:]) / r[i, i]
    return y
