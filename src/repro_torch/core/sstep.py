"""s-step (communication-avoiding) GMRES, eager PyTorch.

Counterpart of ``repro/core/sstep.py`` (``_leja_perm``, ``_newton_shifts``,
``_make_block_fns``, ``_block_step`` -- here split into ``_block_orth`` on
the card and ``_hessenberg_block`` on the host -- and ``gmres_sstep``).
The method (Chronopoulos' s-step line, which the paper cites): each block
builds s Krylov directions with s mat-vecs and no inner products between
them, then orthogonalizes the whole block at once with block CGS2 +
CholQR, and recovers the block's s Hessenberg columns exactly from the
power recurrence.  The module docstring of the JAX package derives the
reconstruction.

Kernels on the card (``_make_block_fns``; the JAX dispatch without its
VMEM gates, ``tuning.powers_fits`` and friends):

  powers    an unpreconditioned ``BandedOperator`` runs ``banded_powers``,
            a ``SparseOperator`` ``ell_powers`` (both shifted for the Newton
            basis), a ``DenseOperator`` ``dense_powers`` (monomial only);
            every other case (dense Newton, sliced ELL, a preconditioner, a
            matrix-free operator) runs ``matrix_powers_ref`` over the
            operator, whose mat-vecs launch its own GEMV or SpMV kernels.
  block GS  ``block_gs_pass``, twice per block; under
            ``gs="cgs2_pipelined"`` ``block_gs_pass_single_reduce`` twice
            per block (``block_gs_project_gram`` + ``block_gs_update``).

Row-sharded (``axis_name`` a process group, inside the distributed
wrapper's ``tuning.shard_context``; JAX ``core/sstep.py:128-225``):

  powers    an unpreconditioned ``BandedOperator`` with s * halo <= n_local
            and the monomial basis runs the communication-avoiding block:
            the band stack's (s-1) halo neighbour columns exchanged once
            per solve and pre-scaled by theta = max row sum (all-reduced
            with max), then per block one halo exchange of u_0 at width
            s halo, ``banded_powers_halo`` and one all-reduce of the s
            squared norms, sigma_j = theta ||z_j|| / ||z_{j-1}||.  Every
            other operator runs ``matrix_powers_ref`` with one all-reduce
            per power.
  block GS  ``block_gs_pass_sharded`` (project, all-reduce C, update,
            all-reduce G) twice per block; under ``gs="cgs2_pipelined"``
            the single-reduce pass with one stacked all-reduce per pass.

Where the data lives.  The JAX solver is one XLA program.  Here every
block of a cycle is enqueued on b's device with no host sync between
them (``_block_orth``): the powers, both block-GS passes and the (s, s)
CholQR (``cholesky_ex`` and ``solve_triangular``, neither of which checks
an info flag on the host), in ``b``'s dtype.  The convergence test of the
s-step method is per cycle, so the blocks' small factors (C, R and sigma,
(2 m1 s + 2 s^2 + s) values per block) cross to the host once per cycle;
there the Hessenberg reconstruction (``_hessenberg_block``) and the
incremental Givens QR of the standard solver (``givens.py``, with the JAX
cycle's ``done`` latch) run on the host.  y (m values) goes back to the
card and the true residual norm comes to the host once per restart:
three syncs per cycle of m steps, where the standard solver makes m + 2.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import arnoldi, givens
from repro_torch.core.gmres import (Diagnostics, GmresResult, _np_dtype, _rhs,
                                    check_precond, classify_residuals)
from repro_torch.core.operators import (EXPLICIT_OPERATORS, BandedOperator,
                                        DenseOperator, SparseOperator,
                                        as_operator, with_dtype)
from repro_torch.core.preconditioners import spectral_bounds
from repro_torch.kernels import block_gs, spmv, tuning
from repro_torch.kernels import matrix_powers as mp


def _leja_perm(s: int) -> tuple:
    """Leja-style ordering of the s Chebyshev points.

    Greedy max-product-of-distances on the reference points
    cos((2k+1) pi / 2s).  Leja ordering keeps every Newton-basis prefix well
    spread over the interval; consecutive nearby shifts would bring back the
    monomial basis's conditioning growth.
    """
    pts = [math.cos(math.pi * (2 * k + 1) / (2 * s)) for k in range(s)]
    perm = [0]
    remaining = set(range(1, s))
    while remaining:
        nxt = max(remaining, key=lambda j: (
            math.prod(abs(pts[j] - pts[i]) for i in perm), -j))
        perm.append(nxt)
        remaining.discard(nxt)
    return tuple(perm)


def _newton_shifts(op, s: int) -> torch.Tensor:
    """Newton-basis shifts: Leja-ordered Chebyshev points of A's Gershgorin
    interval [lo, hi], float32 on the operator's device."""
    lo, hi = spectral_bounds(op)
    k = torch.arange(s, dtype=torch.float32, device=lo.device)
    pts = ((lo + hi) / 2
           + (hi - lo) / 2 * torch.cos(math.pi * (2 * k + 1) / (2 * s)))
    perm = torch.tensor(_leja_perm(s), device=lo.device)
    return pts[perm].to(torch.float32)


def _make_block_fns(op, s: int, dtype, gs: str = "cgs2", precond=None,
                    shifts=None, axis_name=None):
    """Dispatch: ``(powers_fn, gs_pass)`` for the block step.

    ``powers_fn(u0) -> (u (s, n), sigma (s,))``; ``gs_pass(v, w, tin,
    k_start) -> (c, w', g)`` for ``gs="cgs2"`` (``block_gs_pass``), and
    ``gs_pass(v, w, tin, k_start, gram) -> (c, w', g, c_hat)`` for
    ``gs="cgs2_pipelined"`` (``block_gs_pass_single_reduce``: one stacked
    payload per pass, the CholQR Gram recovered against the maintained
    basis Gram matrix).  No size sends a CUDA tensor to a plain version:
    the kernel wrappers launch or raise.
    """
    if gs not in ("cgs2", "cgs2_pipelined"):
        raise ValueError(f"gmres_sstep: unknown gs {gs!r}; options: "
                         f"['cgs2', 'cgs2_pipelined']")
    guard = mp.guard(dtype)
    # Right preconditioning powers B = A M^{-1}: the powers kernels stream
    # A's own storage, so a non-identity M^{-1} takes the reference powers
    # over the composed mat-vec.
    identity_pc = precond is None or getattr(precond, "is_identity", False)
    powers_fn = None
    if identity_pc and axis_name is None:
        if isinstance(op, BandedOperator):
            powers_fn = lambda u0: mp.banded_powers(  # noqa: E731
                op.bands, u0, op.offsets, s, shifts=shifts)
        elif isinstance(op, SparseOperator):
            powers_fn = lambda u0: mp.ell_powers(  # noqa: E731
                op.values, op.cols, u0, s, shifts=shifts)
        elif isinstance(op, DenseOperator) and shifts is None:
            powers_fn = lambda u0: mp.dense_powers(op.a, u0, s)  # noqa: E731
    elif (identity_pc and shifts is None and isinstance(op, BandedOperator)
          and axis_name is not None and tuning.shard_axis() is axis_name):
        powers_fn = _halo_powers_fn(op, s, axis_name, guard)
    if powers_fn is None:
        pmatvec = op if identity_pc else (lambda v: op(precond(v)))
        powers_fn = lambda u0: mp.matrix_powers_ref(  # noqa: E731
            pmatvec, u0, s, guard, axis_name, shifts=shifts)
    if axis_name is None:
        return powers_fn, (block_gs.block_gs_pass_single_reduce
                           if gs == "cgs2_pipelined"
                           else block_gs.block_gs_pass)
    if gs == "cgs2_pipelined":
        return powers_fn, lambda v, w, tin, k, gram: \
            block_gs.block_gs_pass_single_reduce(v, w, tin, k, gram,
                                                 axis_name)
    return powers_fn, lambda v, w, tin, k: \
        block_gs.block_gs_pass_sharded(v, w, tin, k, axis_name)


def _halo_powers_fn(op: BandedOperator, s: int, group, guard: float):
    """The communication-avoiding powers of one shard of a banded operator
    (None where a shard is narrower than s halos: the reference powers
    then carry the block)."""
    halo = max(abs(o) for o in op.offsets)
    if s * halo > op.bands.shape[1]:
        return None
    # The bands do not change during the solve: exchange the (s-1) halo
    # neighbour columns once, here, and zero-pad the outer halo margin.
    bands_ex = spmv.halo_exchange(op.bands.T, (s - 1) * halo, group).T
    bands_pad = torch.nn.functional.pad(bands_ex, (halo, halo))
    # The raw powers grow like ||A||^s, enough to overflow float32 for a
    # scaled system: pre-scale by theta >= ||A||_inf (the row sums, the
    # max over ranks), so the kernel powers B = A / theta with
    # ||B||_inf <= 1, and recover sigma_j = theta ||z_j|| / ||z_{j-1}||
    # exactly.  This also makes the path scale-invariant.
    row_sums = op.bands.float().abs().sum(dim=0)
    theta = tuning.all_reduce(row_sums.max(), group, op="max")
    theta = torch.clamp(theta, min=guard)
    bands_pad = (bands_pad.float() / theta).to(op.bands.dtype).contiguous()

    def powers_fn(u0):
        # One neighbour exchange and one all-reduce for all s powers.
        x_halo = spmv.halo_exchange(u0.to(torch.float32), s * halo, group)
        z, nrm = mp.banded_powers_halo(bands_pad, x_halo, op.offsets, s)
        znorm = torch.sqrt(tuning.all_reduce(nrm, group))
        prev = torch.cat([torch.ones(1, dtype=znorm.dtype,
                                     device=znorm.device), znorm[:-1]])
        sigma = theta.to(znorm.dtype) * znorm / torch.clamp(prev, min=guard)
        return z / torch.clamp(znorm, min=guard)[:, None], sigma

    return powers_fn


def _block_orth(powers_fn, gs_pass, v_basis: torch.Tensor, k_start: int,
                s: int, eps: float, hdt, gram=None) -> torch.Tensor:
    """The device half of one s-step block at offset k_start, in place.

    v_basis: (m+1, n) basis, rows 0..k_start valid, rows past them zero.
    Builds the s powers of row k_start, orthogonalizes them by block CGS2 +
    CholQR and writes them to basis rows k_start+1..k_start+s.  Returns
    what the Hessenberg reconstruction needs, flattened in ``hdt``: C1 and
    C2 (m1, s), R1 and R2 (s, s), sigma (s,).  The streams (basis rows, the
    power block) are in the basis dtype, the (s, s) algebra in ``hdt``;
    nothing syncs.

    ``gram`` (single-reduce mode): the maintained (m+1, m+1) basis Gram
    matrix on the card, in ``hdt``.  Each pass then pays one stacked
    payload, and after CholQR the s new basis rows' inner products extend
    ``gram`` in place:

        Gamma_cross = V Q_new^T = (C_hat_2 - Gamma C_2) R_2^{-1}
        Gamma_diag  = Q_new Q_new^T = R_2^{-T} G_2 R_2^{-1}

    -- (m x s) algebra on the card, no sync.
    """
    dev = v_basis.device
    dtype = v_basis.dtype

    # ---- s mat-vecs, no inner products ----------------------------------
    u_cols, sigma = powers_fn(v_basis[k_start])
    u_cols = u_cols.to(dtype)            # (s, n): A u_{j-1} = sigma_j u_j

    # ---- block CGS2 + CholQR ----------------------------------------------
    eye_s = torch.eye(s, dtype=hdt, device=dev)
    guard = float(torch.finfo(hdt).tiny) ** 0.5

    def cholqr_factor(g):
        # A ridge scaled to the Gram's magnitude keeps Cholesky PSD when the
        # block is (near-)degenerate; its floor is the scale-free guard.
        g = g.to(hdt)
        ridge = torch.clamp(torch.diagonal(g).max(), min=guard) * eps
        low, _ = torch.linalg.cholesky_ex(g + ridge * eye_s)
        return low.mT                                      # upper

    pass_args = () if gram is None else (gram,)
    c1, w1, g1, *_ = gs_pass(v_basis, u_cols, eye_s, k_start, *pass_args)
    r1 = cholqr_factor(g1)
    # T = inv(R^T) folds each CholQR back-substitution into a product: the
    # first into pass 2's stream, the second into the basis rows.  (A
    # triangular solve over the block's n columns, as the JAX package
    # does it, takes seconds on an H100 at n = 2^20 in
    # torch.linalg.solve_triangular.)
    t1 = torch.linalg.solve_triangular(r1.mT, eye_s, upper=False)
    c2, w2, g2, *c_hat2 = gs_pass(v_basis, w1.to(dtype), t1, k_start,
                                  *pass_args)
    r2 = cholqr_factor(g2)
    t2 = torch.linalg.solve_triangular(r2.mT, eye_s, upper=False)
    v_basis[k_start + 1:k_start + 1 + s] = (t2 @ w2.to(hdt)).to(dtype)
    if gram is not None:
        # Extend the maintained Gram matrix (in hdt) by the s rows just built.
        cross = (c_hat2[0].to(hdt) - gram @ c2.to(hdt)) @ t2.mT   # (m1, s)
        new = slice(k_start + 1, k_start + 1 + s)
        gram[:, new] = cross
        gram[new, :] = cross.mT
        gram[new, new] = t2 @ g2.to(hdt) @ t2.mT
    return torch.cat([c1.to(hdt).reshape(-1), c2.to(hdt).reshape(-1),
                      r1.reshape(-1), r2.reshape(-1), sigma.to(hdt)])


def _hessenberg_block(h: torch.Tensor, k_start: int, s: int,
                      parts: torch.Tensor, shifts=None) -> None:
    """Hessenberg columns k_start..k_start+s-1 of one block, in place, from
    ``_block_orth``'s output (the exact power-recurrence reconstruction of
    the JAX package; replicated (m, s) algebra, run on the host).

    h: (m+1, m), columns >= k_start zero.
    """
    m1 = h.shape[0]
    hdt = h.dtype
    n_c = m1 * s
    c1 = parts[:n_c].reshape(m1, s)
    c2 = parts[n_c:2 * n_c].reshape(m1, s)
    r1 = parts[2 * n_c:2 * n_c + s * s].reshape(s, s)
    r2 = parts[2 * n_c + s * s:2 * n_c + 2 * s * s].reshape(s, s)
    sigma = parts[2 * n_c + 2 * s * s:]
    c_tot = c1 + c2 @ r1                                   # (m1, s)
    r_tot = r2 @ r1                                        # (s, s) upper

    # X_j: coefficients of u_j in the basis (q_l at row k_start+1+l).
    x0 = torch.zeros((m1,), dtype=hdt)
    x0[k_start] = 1
    xs = [x0]                                              # X_0 = e_k
    for j in range(1, s + 1):
        xj = c_tot[:, j - 1].clone()
        xj[k_start + 1:k_start + 1 + s] = r_tot[:, j - 1]
        xs.append(xj)
    s1 = torch.stack(xs[:s], dim=1)                        # (m1, s)
    # Newton basis: A u_{j-1} = sigma_j u_j + shift_j u_{j-1}
    if shifts is None:
        s2_cols = [sigma[j - 1] * xs[j] for j in range(1, s + 1)]
    else:
        sh = shifts.to(hdt)
        s2_cols = [sigma[j - 1] * xs[j] + sh[j - 1] * xs[j - 1]
                   for j in range(1, s + 1)]
    s2 = torch.stack(s2_cols, dim=1)
    s1r = s1[k_start:k_start + s]                          # invertible tri
    keep = (torch.arange(m1) < k_start).to(hdt)
    corr = h @ (s1 * keep[:, None])[:h.shape[1]]           # (m1, s)
    h[:, k_start:k_start + s] = torch.linalg.solve(s1r.T, (s2 - corr).T).T


def gmres_sstep(a, b, x0=None, *, s: int = 4, blocks: int = 5,
                tol: float = 1e-5, max_restarts: int = 30,
                axis_name: Optional[str] = None, gs: str = "cgs2",
                history: int = 8, precond: Optional[Callable] = None,
                basis: str = "monomial", compute_dtype=None) -> GmresResult:
    """Restarted s-step GMRES(m = s * blocks) on ``b``'s device.

    ``a`` may be any operator ``gmres`` accepts; explicit operators run the
    powers kernels (see the module docstring), anything else the reference
    powers.  A numpy ``b`` goes to the card (raising without one).

    ``gs``: "cgs2" (two fused block passes per block) or "cgs2_pipelined"
    (two single-reduce passes per block, each one projection launch and
    one update launch, with the basis Gram matrix maintained on the card).
    ``axis_name``: None, or the process group of a row-sharded solve (see
    the module docstring; ``core/distributed.py`` is the entry point); any
    other value raises ``TypeError``.
    ``precond``: right preconditioner ``v -> M^{-1} v``;
    the power block is built over ``A M^{-1}`` by the reference powers and
    the update un-preconditions, ``x += M^{-1} (y V)``.  ``basis``:
    "monomial" | "newton" (Leja-ordered Chebyshev shifts of A's Gershgorin
    interval, in the same powers kernels).  ``compute_dtype``: storage of
    the basis and the power block (e.g. ``torch.bfloat16``); a narrower
    dtype than A's storage also narrows A's stream in the powers.  The
    CholQR, Hessenberg and Givens algebra and the per-restart residual stay
    in ``b.dtype``.
    """
    tuning.check_group(axis_name)
    if basis not in ("monomial", "newton"):
        raise ValueError(f"gmres_sstep: unknown basis {basis!r}; options: "
                         f"['monomial', 'newton']")
    check_precond(precond)
    b = _rhs(b)
    matvec = as_operator(a, device=b.device)
    x = torch.zeros_like(b) if x0 is None else x0
    n = b.shape[0]
    dtype = b.dtype
    np_dtype = _np_dtype(dtype)
    basis_dtype = dtype if compute_dtype is None else compute_dtype
    eps = float(np_dtype.type(np.finfo(np_dtype).eps * 100))  # relative
    guard = np_dtype.type(np.finfo(np_dtype).tiny ** 0.5)
    m = s * blocks
    bnorm = arnoldi.norm(b, axis_name).item()
    tol_abs = max(np_dtype.type(tol) * np_dtype.type(bnorm),
                  np_dtype.type(0))
    shifts = _newton_shifts(matvec, s) if basis == "newton" else None
    identity_pc = precond is None or getattr(precond, "is_identity", False)
    # A compute dtype narrower than A's storage also narrows the A stream in
    # the powers; the original operator keeps the per-restart residual.
    power_op = matvec
    if (isinstance(matvec, EXPLICIT_OPERATORS)
            and basis_dtype.itemsize < matvec.dtype.itemsize):
        power_op = with_dtype(matvec, basis_dtype)
    powers_fn, gs_pass = _make_block_fns(power_op, s, basis_dtype, gs,
                                         precond=precond, shifts=shifts,
                                         axis_name=axis_name)
    happy_eps = np_dtype.type(eps)

    host_shifts = None if shifts is None else shifts.cpu()

    def cycle(x, r, beta):
        # A fresh zero basis every cycle: the single-reduce pass reads only
        # rows 0..k_start because the rows past them are zero.
        v = torch.zeros((m + 1, n), dtype=basis_dtype, device=b.device)
        v[0] = (r / float(max(beta, guard))).to(basis_dtype)
        # Identity init is exact where it matters: rows beyond the current
        # block are only ever touched against zero (masked) columns.
        gram = (torch.eye(m + 1, dtype=dtype, device=b.device)
                if gs == "cgs2_pipelined" else None)
        parts = [_block_orth(powers_fn, gs_pass, v, blk * s, s, eps, dtype,
                             gram)
                 for blk in range(blocks)]
        parts = torch.stack(parts).cpu()       # the cycle's one copy back
        h = torch.zeros((m + 1, m), dtype=dtype)
        for blk in range(blocks):
            _hessenberg_block(h, blk * s, s, parts[blk], host_shifts)
        hh = h.numpy()
        # Fold the m columns through the incremental Givens QR.  Once the
        # LS residual meets tol or a subdiagonal collapses against its own
        # column (the Krylov space is exhausted, at any system scale), the
        # remaining columns fold as identity with y_j = 0.
        giv = givens.init(m, beta, np_dtype)
        done = bool(beta <= tol_abs)
        for j in range(m):
            col = hh[:, j]
            givens.update(giv, col, j, active=not done)
            happy = abs(col[j + 1]) <= happy_eps * np.max(np.abs(col))
            done = (done or bool(givens.residual_norm(giv, j) <= tol_abs)
                    or bool(happy))
        y = torch.from_numpy(givens.solve(giv)).to(b.device)
        dx = y @ v[:m].to(dtype)
        return x + (dx if identity_pc else precond(dx))

    def resid_of(x):
        r = b - matvec(x)
        return r, np_dtype.type(arnoldi.norm(r, axis_name).item())

    r, beta = resid_of(x)
    # Chronological ring, inf-padded on the left, seeded with ||b - A x0||.
    hist = np.full((history,), np.inf, np_dtype)
    hist[-1] = beta
    k = 0
    while beta > tol_abs and k < max_restarts:
        x = cycle(x, r, beta)
        r, beta = resid_of(x)
        hist = np.roll(hist, -1)
        hist[-1] = beta
        k += 1
    converged = bool(beta <= tol_abs)
    diags = Diagnostics(
        status=classify_residuals(hist, converged=converged),
        residual_history=hist,
        history_len=min(k + 1, history),
    )
    return GmresResult(x=x, residual=float(beta), restarts=k,
                       converged=converged, inner_steps=k * m,
                       done=converged or k >= max_restarts,
                       diagnostics=diags)
