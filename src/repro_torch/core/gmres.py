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
kernel (``kernels/cgs2.py``), ``gs="cgs2_pipelined"`` the single-reduce
payload and update kernels (``_gmres_cycle_pipelined``: the payload is the
step's one copy to the host, and the next mat-vec runs on the card, on a
second stream, while the host recovers the step from it),
``DenseOperator(backend="cuda")`` runs its mat-vecs through the GEMV
kernel, and the sparse operators always run theirs through the SpMV
kernels.  On CPU tensors each wrapper runs its plain version.

The block multi-RHS solver (``gmres_batched``, ``gmres_batched_cycle``;
JAX's ``_make_batched_gs``, ``_block_cycle``, ``_block_matvec``,
``_batched_precond``) steps k lanes in lockstep: one (n, k) mat-vec of an
explicit operator feeds every lane, and a CGS2-family scheme runs all
lanes' Gram-Schmidt in one ``batched_cgs2`` launch
(``kernels/block_gs.py``).  The per-lane Givens states live on the host,
so one (k, m+1) copy per lockstep step is the step's sync.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.core import arnoldi, givens
from repro_torch.core.operators import (EXPLICIT_OPERATORS, DenseOperator,
                                        as_operator)
from repro_torch.kernels import arnoldi_fused, block_gs, tuning
from repro_torch.kernels import cgs2 as cgs2_k

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


class GmresResult(NamedTuple):
    """The JAX package's ``GmresResult``: a named tuple in the same field
    order, so it unpacks and ``_replace``s as the JAX one does."""
    x: torch.Tensor          # solution, on b's device
    residual: float          # final true residual norm ||b - A x||
    restarts: int            # number of restart cycles executed
    converged: bool
    inner_steps: int         # total Arnoldi steps actually taken
    # converged OR restart budget exhausted (per lane for gmres_batched)
    done: Optional[bool] = None
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


def _make_step_fn(matvec, precond, gs: str, axis_name=None, *,
                  identity_precond: bool, m: int, n: int,
                  basis_dtype) -> Callable:
    """Build ``step_fn(v_basis, j) -> ArnoldiStep`` for the inner loop.

    ``gs="fused"`` needs an unpreconditioned single-shard
    ``DenseOperator`` whose basis slices fit the kernel's shared memory
    (``tuning.fused_step_fits``); otherwise it degrades to
    ``"cgs2_fused"`` (row-sharded: the split-phase pair).  The choice is
    made here, from shapes, before any launch.
    """
    if gs in _FUSED_STEP_SCHEMES:
        dev = matvec.a.device if isinstance(matvec, DenseOperator) else None
        if (axis_name is None and identity_precond and dev is not None
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
        return gs_step(v_basis, w, j, axis_name)

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


# --------------------------------------------------------------------------
# Pipelined single-reduce cycle (gs="cgs2_pipelined")
# --------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _side_stream(index: int) -> torch.cuda.Stream:
    """The card's side stream for the pipelined mat-vec, one per process.
    Each stream has its own pool in PyTorch's caching allocator, so a new
    stream per solve (or per cycle) would pay a cudaMalloc at its first
    allocation; one kept for the process reuses its pool."""
    return torch.cuda.Stream(torch.device("cuda", index))


@dataclasses.dataclass
class _PipelineBuffers:
    """What the pipelined cycles of one solve share on a card: the side
    stream the next mat-vec runs on, and the pinned host buffer the
    update coefficients go back through (made once per solve; None on
    the CPU)."""
    side: torch.cuda.Stream
    coef: torch.Tensor

    @classmethod
    def for_device(cls, dev: torch.device, m: int, dtype):
        if dev.type != "cuda":
            return None
        index = torch.cuda.current_device() if dev.index is None \
            else dev.index
        return cls(side=_side_stream(index),
                   coef=torch.empty(2 * (m + 1), dtype=dtype,
                                    pin_memory=True))


def _beside(side, fn, x):
    """``fn(x)`` on the ``side`` stream, after the work already enqueued on
    the current one (a plain call on the CPU, where ``side`` is None).

    The caller makes the current stream wait for ``side`` before it uses
    the result.  No ``record_stream`` is needed: x's memory is reused on
    the current stream only after that wait, and the result's on ``side``
    only after the next call's wait for the current stream.
    """
    if side is None:
        return fn(x)
    side.wait_stream(torch.cuda.current_stream(x.device))
    with torch.cuda.stream(side):
        return fn(x)


def _gmres_cycle_pipelined(op, x0, r0, beta, m, tol_abs, precond,
                           basis_dtype, bufs, axis_name=None):
    """One restart cycle of depth-1 pipelined single-reduce GMRES.

    Counterpart of the JAX ``_gmres_cycle_pipelined`` (its
    ``_PipelinedState`` carry is this loop's locals).  Per Arnoldi step:

        payload_j = [mask*(V@[z_j, v_j]); z_j.z_j, v_j.v_j]   one launch
        u         = op(z_j)        the next mat-vec, on a second stream
        payload_j to the host      the step's one sync: it waits for the
                                   payload only, the mat-vec runs on
        recover h_tot, ||w''||, Gram row j from payload_j   (host, numpy)
        v_{j+1}   = (z_j - h_tot @ V) / ||w''||
        z_{j+1}   = (u - (H h_lt) @ V - h_tot[j] z_j) / ||w''||

    On one card there is no collective to hide; the host round trip plays
    that part: the card runs the next mat-vec while the host does the
    recovery, the ``hraw`` recurrence and the Givens update.  h_tot and the
    recurrence's coefficients go back in one small copy from pinned memory
    (no sync), and two update launches (``kernels/cgs2.py::gs_update``)
    form v_{j+1} and z_{j+1}.  ``op`` is A M^{-1}; ``bufs`` holds the
    solve's side stream and pinned buffer (None on the CPU).  The pinned
    buffer is rewritten only after the next step's payload copy, which
    follows the previous step's copy out of it on the same stream.  Both
    coefficient vectors are zero past row j, so the updates read only the
    row prefix V[:j+1].  As in JAX, each cycle pays a prologue mat-vec and
    a wasted speculative mat-vec at its last step, and the recurrence's
    rounding is bounded by the true residual recomputed at every restart.
    The done test is relative, ``||w''|| <= 100 eps ||z||``, so the scheme
    is scale-invariant.

    Row-sharded (``axis_name`` a process group) the payload is all-reduced,
    the step's one collective, and the mat-vec exchanges its operand.  Both
    are issued in one fixed order on every rank, as NCCL requires of
    collectives and point-to-point calls alike: the payload launch, then
    the next mat-vec (its halo exchange or all-gather) on the side stream,
    then the payload's all-reduce, so that on the card the mat-vec does
    not wait for the all-reduce (the current stream, which the side stream
    waits for, waits for the all-reduce once it is issued).  That order is
    not verified across ranks on NCCL: the tests run it on gloo across
    processes, the card on a one-rank group.
    """
    dev = x0.device
    n = x0.shape[0]
    dtype = x0.dtype
    np_dtype = _np_dtype(dtype)
    tiny = np_dtype.type(np.finfo(np_dtype).tiny ** 0.5)
    eps_rel = np_dtype.type(np.finfo(np_dtype).eps * 100)
    acc = np.promote_types(np_dtype, np.float32)    # the payload's dtype

    v0 = r0 / float(max(beta, tiny))
    v = torch.zeros((m + 1, n), dtype=basis_dtype, device=dev)
    v[0] = v0.to(basis_dtype)
    z = op(v0)                                    # pipeline prologue mat-vec
    hraw = np.zeros((m + 1, m), np_dtype)
    gram = np.eye(m + 1, dtype=acc)
    giv = givens.init(m, beta, np_dtype)
    side, coef = (bufs.side, bufs.coef) if bufs is not None else (None,
                                                                   None)
    done = beta <= tol_abs
    steps = 0
    while not done and steps < m:
        j = steps
        payload = arnoldi.sr_payload(v, z, j)
        u = _beside(side, op, z)
        payload = arnoldi._psum(payload, axis_name)
        p = payload.cpu().numpy()                 # the step's one sync
        h_tot, s_norm, zeta, gram = arnoldi.sr_recover(p, gram, j)
        h_tot = h_tot.astype(np_dtype)
        s_d = np_dtype.type(s_norm)
        sg = float(max(s_d, tiny))
        # correct the speculative mat-vec onto v_{j+1} via the recurrence
        lt = np.arange(m) < j
        c_vec = hraw @ (h_tot[:m] * lt)           # (m+1,), zero past row j
        hc = torch.from_numpy(np.stack([h_tot[:j + 1], c_vec[:j + 1]]))
        if coef is not None:                      # pinned: no sync
            coef[:hc.numel()] = hc.reshape(-1)
            hc = coef[:hc.numel()].to(dev, non_blocking=True).view(2, j + 1)
        vp = v[:j + 1]
        w2 = cgs2_k.gs_update(vp, z, hc[0])                 # w'' = z - h_tot @ V
        if side is not None:
            torch.cuda.current_stream(dev).wait_stream(side)
        z = (cgs2_k.gs_update(vp, u, hc[1]) - float(h_tot[j]) * z) / sg
        v[j + 1] = (w2 / sg).to(basis_dtype)
        hcol = h_tot.copy()
        hcol[j + 1] = s_d
        hraw[:, j] = hcol
        givens.update(giv, hcol, j, active=True)
        resid = givens.residual_norm(giv, j)
        happy = s_d <= eps_rel * np_dtype.type(np.sqrt(zeta))
        done = resid <= tol_abs or happy
        steps = j + 1
    y = torch.from_numpy(givens.solve(giv, steps)).to(dev)
    dx = y @ v[:m].to(dtype)
    return x0 + precond(dx), steps


def _rhs(b) -> torch.Tensor:
    """b as a tensor: a tensor stays where it is, anything else (numpy, a
    list) goes to the card, raising without one."""
    return b if isinstance(b, torch.Tensor) else device_mod.as_tensor(b)


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
      b: right-hand side, shape (n,); the solve runs on its device (a
        numpy b goes to the card).
      x0: initial guess (zeros by default).
      m: restart length (Krylov subspace dimension per cycle).
      tol: relative residual target, ||b - Ax|| <= tol * ||b||.
      max_restarts: restart-cycle budget.
      gs: "cgs" | "mgs" | "cgs2" | "cgs2_fused" (fused GS kernel) |
        "fused" (whole Arnoldi step in one kernel; needs an
        unpreconditioned ``DenseOperator`` whose basis slices fit shared
        memory, degrades to "cgs2_fused" otherwise) | "cgs2_pipelined"
        (single-reduce CGS2 with depth-1 pipelining: one payload copied
        to the host per step while the next mat-vec runs on the card; the
        payload and update kernels).
      precond: right preconditioner M^{-1} as a callable (identity default).
      axis_name: None, or the ``torch.distributed`` process group of a
        row-sharded solve (JAX's mesh axis): ``a`` then maps a local shard
        to a local shard (explicit operators take their per-shard paths
        inside ``tuning.shard_context``, which ``core/distributed.py``
        enters), ``b`` is the local shard, and every reduction is
        all-reduced over the group.  Anything else raises ``TypeError``.
      compute_dtype: Krylov-basis storage dtype (e.g. ``torch.bfloat16``);
        reductions still accumulate in f32 and the per-restart true
        residual bounds the rounding.  With ``gs="fused"`` a narrower
        compute dtype also narrows the A stream.
      history: length of the per-cycle residual-history ring; also the
        stagnation window.

    Returns GmresResult; residual is the TRUE residual recomputed from x.
    """
    tuning.check_group(axis_name)
    b = _rhs(b)
    matvec = as_operator(a, device=b.device)
    if x0 is None:
        x0 = torch.zeros_like(b)
    check_precond(precond)
    identity_precond = (precond is None
                        or getattr(precond, "is_identity", False))
    if precond is None:
        precond = lambda v: v  # noqa: E731
    basis_dtype = b.dtype if compute_dtype is None else compute_dtype
    pipelined = gs == "cgs2_pipelined"
    if pipelined:
        def op_fn(zv):
            return matvec(precond(zv))
        bufs = _PipelineBuffers.for_device(b.device, m, b.dtype)
    else:
        step_fn = _make_step_fn(matvec, precond, gs, axis_name,
                                identity_precond=identity_precond, m=m,
                                n=b.shape[0], basis_dtype=basis_dtype)

    np_dtype = _np_dtype(b.dtype)
    bnorm = arnoldi.norm(b, axis_name).item()
    tol_abs = max(np_dtype.type(tol) * np_dtype.type(bnorm),
                  np_dtype.type(0))

    def resid_of(x):
        r = b - matvec(x)
        return r, np_dtype.type(arnoldi.norm(r, axis_name).item())

    r, beta = resid_of(x0)
    # Chronological ring, inf-padded on the left, seeded with ||b - A x0||.
    hist = np.full((history,), np.inf, np_dtype)
    hist[-1] = beta
    x, k, steps = x0, 0, 0
    while beta > tol_abs and k < max_restarts:
        if pipelined:
            x, inner = _gmres_cycle_pipelined(op_fn, x, r, beta, m,
                                              tol_abs, precond, basis_dtype,
                                              bufs, axis_name)
        else:
            x, inner = _gmres_cycle(step_fn, x, r, beta, m, tol_abs,
                                    precond, basis_dtype)
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


# --------------------------------------------------------------------------
# Block multi-RHS solver
# --------------------------------------------------------------------------
# Schemes whose arithmetic is CGS2: their lanes' Gram-Schmidt runs through
# batched_cgs2 (the JAX ``_CGS2_FAMILY``, without its VMEM size gate).  The
# batched solver has no whole-cycle pipelining, so "cgs2_pipelined" runs
# CGS2 there, as in JAX.
_CGS2_FAMILY = ("cgs2", "cgs2_fused", "fused", "arnoldi_fused",
                "cgs2_pipelined")


def _make_batched_gs(gs: str) -> Callable:
    """Build ``batched_gs(v, w, j) -> (v_next, h, h_last)`` over k lanes.

    v: (k, m+1, n) lane bases; w: (k, n) fresh mat-vec outputs; j: host
    (k,) step indices, -1 for a lane that takes no step this time.  A
    CGS2-family scheme runs both passes of every lane in one
    ``batched_cgs2`` call; "cgs" / "mgs" run the scalar scheme lane by
    lane.  h (k, m+1) holds the projections only: the caller puts h_last
    at row j+1 on the host.
    """
    if gs in _CGS2_FAMILY:
        def kernel_gs(v, w, j):
            h, w2 = block_gs.batched_cgs2(v, w, j)
            h_last = torch.sqrt((w2 * w2).sum(dim=1))
            eps = torch.finfo(w2.dtype).tiny ** 0.5
            v_next = w2 / torch.clamp(h_last, min=eps)[:, None]
            return v_next.to(w.dtype), h.to(w.dtype), h_last.to(w.dtype)

        return kernel_gs

    gs_step = arnoldi.step(gs)

    def lane_gs(v, w, j):
        k, m1, _ = v.shape
        v_next = torch.zeros_like(w)
        h = torch.zeros((k, m1), dtype=w.dtype, device=w.device)
        h_last = torch.zeros((k,), dtype=w.dtype, device=w.device)
        for lane in np.nonzero(j >= 0)[0]:
            st = gs_step(v[lane], w[lane], int(j[lane]))
            v_next[lane], h[lane], h_last[lane] = st.v_next, st.h, st.h_last
        return v_next, h, h_last

    return lane_gs


def _lane_norms(r: torch.Tensor, np_dtype) -> np.ndarray:
    """Per-lane 2-norms of a (k, n) block, on the host (a sync)."""
    return torch.sqrt((r * r).sum(dim=1)).cpu().numpy().astype(np_dtype)


def _block_cycle(blockmv, vprecond, batched_gs, x0, r0, beta, m, tol_abs,
                 active0, basis_dtype):
    """One restart cycle over k lanes stepping in lockstep.

    Lanes carry their own basis, Givens state (host) and convergence
    latch; the one shared operand is A, which every step applies once as a
    (n, k) block mat-vec.  A done lane is a masked no-op: its mat-vec
    column is computed and dropped, the GS kernel skips it (j = -1), and
    its Givens state is not touched (the JAX cycle writes identity columns
    there, which the final solve ignores alike).  Returns the updated
    iterates and the per-lane step counts (host).
    """
    k, n = x0.shape
    dev = x0.device
    np_dtype = _np_dtype(x0.dtype)
    steps = np.zeros((k,), np.int64)
    done = ~np.asarray(active0, bool) | (beta <= tol_abs)
    if done.all():
        return x0, steps
    eps = np_dtype.type(np.finfo(np_dtype).tiny ** 0.5)

    v = torch.zeros((k, m + 1, n), dtype=basis_dtype, device=dev)
    scale = torch.from_numpy(np.maximum(beta, eps).astype(np_dtype)).to(dev)
    v[:, 0] = (r0 / scale[:, None]).to(basis_dtype)
    giv = [givens.init(m, beta[lane], np_dtype) for lane in range(k)]
    lanes = torch.arange(k, device=dev)
    while True:
        active = ~done & (steps < m)
        if not active.any():
            break
        j = steps.copy()
        jd = torch.from_numpy(j).to(dev)
        # --- the k current Krylov vectors hit A as one block mat-vec ---
        w = blockmv(vprecond(v[lanes, jd].to(x0.dtype)))
        v_next, h, h_last = batched_gs(v, w, np.where(active, j, -1))
        live = torch.from_numpy(np.nonzero(active)[0]).to(dev)
        v[live, jd[live] + 1] = v_next[live].to(basis_dtype)
        cols = torch.cat([h, h_last[:, None]], dim=1).to(x0.dtype)
        cols = cols.cpu().numpy()                 # the step's one sync
        for lane in np.nonzero(active)[0]:
            jj = int(j[lane])
            col = cols[lane, :m + 1].copy()
            col[jj + 1] = cols[lane, -1]
            givens.update(giv[lane], col, jj, active=True)
            resid = givens.residual_norm(giv[lane], jj)
            happy = cols[lane, -1] <= eps * 100
            done[lane] = resid <= tol_abs[lane] or happy
        steps += active
    y = torch.from_numpy(np.stack([givens.solve(giv[lane], int(steps[lane]))
                                   for lane in range(k)])).to(dev)
    vb = v[:, :m].to(x0.dtype)
    dx = torch.stack([y[lane] @ vb[lane] for lane in range(k)])
    return x0 + vprecond(dx), steps


def _block_matvec(op) -> Callable:
    """(k, n) -> (k, n) block mat-vec: one matrix stream for all k lanes.

    Explicit operators take an (n, k) operand natively, so the k current
    Krylov vectors hit the matrix as one GEMM or block SpMV; a matrix-free
    operator is applied lane by lane (nothing to share).
    """
    if isinstance(op, EXPLICIT_OPERATORS):
        return lambda xs: op(xs.T).T
    return lambda xs: torch.stack([op(x) for x in xs])


def _batched_precond(precond) -> Callable:
    """(k, n) -> (k, n) lane-batched M^{-1} apply: identity passes through,
    a ``batched`` attribute is used as is, a plain callable runs lane by
    lane."""
    check_precond(precond)
    if precond is None or getattr(precond, "is_identity", False):
        return lambda vs: vs
    batched = getattr(precond, "batched", None)
    if batched is not None:
        return batched
    return lambda vs: torch.stack([precond(x) for x in vs])


def _per_lane(value, k: int, dtype) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().numpy()
    return np.broadcast_to(np.asarray(value, dtype), (k,)).copy()


def gmres_batched_cycle(a, b: torch.Tensor, x: torch.Tensor, *, m: int = 30,
                        tol_abs=None, active=None, gs: str = "cgs2",
                        precond: Optional[Callable] = None,
                        compute_dtype=None):
    """One lockstep restart cycle over k lanes: the serving primitive.

    Args:
      a: shared operator (anything ``gmres`` accepts).
      b: (k, n) per-lane right-hand sides.
      x: (k, n) current iterates.
      m: restart length.
      tol_abs: (k,) or scalar ABSOLUTE residual targets (zeros default:
        never converged).
      active: (k,) bool lane mask; inactive lanes pass through untouched.
      gs / precond / compute_dtype: as in ``gmres_batched``.

    Returns ``(x', beta', inner_steps)``: updated iterates on x's device,
    and on the host the TRUE per-lane residual norms after the cycle and
    the per-lane Arnoldi steps taken.
    """
    op = as_operator(a, device=b.device)
    vprecond = _batched_precond(precond)
    basis_dtype = b.dtype if compute_dtype is None else compute_dtype
    batched_gs = _make_batched_gs(gs)
    blockmv = _block_matvec(op)
    k = b.shape[0]
    np_dtype = _np_dtype(b.dtype)
    tol_abs = _per_lane(0 if tol_abs is None else tol_abs, k, np_dtype)
    active = _per_lane(True if active is None else active, k, bool)

    r = b - blockmv(x)
    beta = _lane_norms(r, np_dtype)
    act = active & (beta > tol_abs)
    x2, inner = _block_cycle(blockmv, vprecond, batched_gs, x, r, beta, m,
                             tol_abs, act, basis_dtype)
    x = torch.where(torch.from_numpy(act).to(x.device)[:, None], x2, x)
    beta = _lane_norms(b - blockmv(x), np_dtype)
    return x, beta, inner


def gmres_batched(a, b: torch.Tensor, *, m: int = 30, tol=1e-5,
                  max_restarts=50, gs: str = "cgs2",
                  precond: Optional[Callable] = None,
                  compute_dtype=None) -> GmresResult:
    """A batch of right-hand sides, shape (k, n), shared A, solved blocked.

    The k current Krylov vectors are stacked into an (n, k) block and hit
    an explicit operator as one GEMM or block SpMV per lockstep step, and
    a CGS2-family ``gs`` ("cgs2", "cgs2_fused", "fused", "cgs2_pipelined")
    runs every lane's Gram-Schmidt in one ``batched_cgs2`` launch; "cgs" /
    "mgs" run lane by lane.  ``tol`` and ``max_restarts`` may be scalars or
    (k,) arrays: each lane latches its own convergence against its own
    ``tol * ||b_lane||`` and its own restart budget; a lane out of budget
    retires as FAILED (``done`` and not ``converged``) while the others
    cycle on.

    A numpy ``b`` goes to the card (raising without one).  Returns a
    ``GmresResult`` whose ``x`` is (k, n) on b's device and whose
    ``residual`` / ``restarts`` / ``converged`` / ``inner_steps`` / ``done``
    are per-lane host (numpy) arrays; ``diagnostics`` is None.
    """
    b = _rhs(b)
    op = as_operator(a, device=b.device)
    vprecond = _batched_precond(precond)
    basis_dtype = b.dtype if compute_dtype is None else compute_dtype
    batched_gs = _make_batched_gs(gs)
    blockmv = _block_matvec(op)
    k = b.shape[0]
    np_dtype = _np_dtype(b.dtype)
    bnorm = _lane_norms(b, np_dtype)
    tol_abs = np.maximum(_per_lane(tol, k, np_dtype) * bnorm,
                         np_dtype.type(0))
    max_restarts = _per_lane(max_restarts, k, np.int64)

    def resid_of(x):
        r = b - blockmv(x)
        return r, _lane_norms(r, np_dtype)

    x = torch.zeros_like(b)
    r, beta = resid_of(x)
    kk = np.zeros((k,), np.int64)
    steps = np.zeros((k,), np.int64)
    while True:
        active = (beta > tol_abs) & (kk < max_restarts)
        if not active.any():
            break
        x2, inner = _block_cycle(blockmv, vprecond, batched_gs, x, r, beta,
                                 m, tol_abs, active, basis_dtype)
        x = torch.where(torch.from_numpy(active).to(x.device)[:, None], x2, x)
        r, beta = resid_of(x)
        kk += active
        steps += inner
    converged = beta <= tol_abs
    return GmresResult(x=x, residual=beta, restarts=kk, converged=converged,
                       inner_steps=steps,
                       done=converged | (kk >= max_restarts))
