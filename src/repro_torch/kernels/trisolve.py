"""Banded ILU(0): the factorization and the triangular sweeps.

Counterpart of ``repro/kernels/trisolve.py``, the kernel layer behind
``core/preconditioners.BandedILU0Preconditioner`` (and its ``line_jacobi``
and ``banded_block_jacobi`` restrictions).  The kernels are
``csrc/trisolve.cu``; its source note gives the designs and the bounds.

``banded_ilu0(bands, offsets)`` is the setup: incomplete LU restricted to
the band pattern, one pass over the rows (``ilu0_factor``).  Entries whose
column falls outside [0, n) are zeroed first, rows before the first see
unit-diagonal rows, and each pivot gets the scale-relative safe
replacement ``max(max|row| eps, tiny^(1/2))`` at factor time, so the
sweeps divide unconditionally.  The factors come out in float32 (float64
for float64 bands) whatever the storage, as the JAX ``acc``.

``banded_trisweep(bands, v, offsets, unit_diag=, lower=)`` is the apply:
the banded unit-lower (or non-unit lower) forward substitution, or the
upper backward one, which is the lower one read back to front with the
offsets negated.  v is (n,) or (k, n): k right-hand sides, swept in
parallel.  The plain version splits the rows into chunks of c rows, c
the nearest far offset (|off| >= 2): inside a chunk every far term is
already solved, so z_i = a_i z_{i-1} + b_i is an affine recurrence, and a
log-depth scan of the maps (a, b) solves the chunk.  The kernel takes one
of two routes (``tuning.trisweep_plan``, counted in
``banded_trisweep.routes``): without a far band ("scan") all n rows are
one scan over every SM; with one ("chunk", or "chunk_l2" where the ring of
solved entries does not fit shared memory) a block per right-hand side
walks the chunks with their loads in flight.  The scans sum in another
order than the JAX ``lax.scan`` reference, which the tests hold them to.

On a CPU tensor a wrapper runs its plain version; on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, spmv, tuning

STORAGE = (torch.float32, torch.bfloat16)
MAX_ILU_BANDS = 16      # csrc/trisolve.cu: the ILU kernel's row in registers


def _mask_oob(bands: torch.Tensor, offsets) -> torch.Tensor:
    """Zero band entries whose column i + off falls outside [0, n)."""
    n = bands.shape[1]
    rows = torch.arange(n, device=bands.device)
    zero = torch.zeros((), dtype=bands.dtype, device=bands.device)
    return torch.stack([torch.where((rows + off >= 0) & (rows + off < n),
                                    bands[d], zero)
                        for d, off in enumerate(offsets)])


def _acc(dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


# --------------------------------------------------------------------------
# ILU(0) setup
# --------------------------------------------------------------------------
def _check_ilu(bands: torch.Tensor, offsets: tuple) -> None:
    if bands.ndim != 2 or len(offsets) != bands.shape[0]:
        raise TypeError(f"banded_ilu0: {bands.shape[0]} bands but "
                        f"{len(offsets)} offsets")
    if 0 not in offsets:
        raise ValueError("banded_ilu0: offsets must include the diagonal "
                         "(offset 0)")


def _split(fact: torch.Tensor, offsets: tuple):
    """(l_bands, u_bands) of the factored band stack: the strictly lower
    bands, most negative first, then the diagonal and the upper ones."""
    idx = {off: d for d, off in enumerate(offsets)}
    lower = sorted(o for o in offsets if o < 0)
    upper = sorted(o for o in offsets if o > 0)
    n = fact.shape[1]
    l_bands = (torch.stack([fact[idx[o]] for o in lower]) if lower
               else fact.new_zeros((0, n)))
    return l_bands, torch.stack([fact[idx[o]] for o in [0] + upper])


def _levels(deps: dict) -> list:
    """Rows grouped by dependency level: row i waits for row i + l where
    ``deps[l][i]``, so level(i) = 1 + max level(i + l); the rows of one
    level are independent.  Returns the row indices of each level."""
    n = len(next(iter(deps.values()))) if deps else 0
    level = [0] * n
    cols = [(l, dep.tolist()) for l, dep in deps.items()]
    for i in range(n):
        lv = 0
        for l, dep in cols:
            if dep[i] and level[i + l] >= lv:
                lv = level[i + l] + 1
        level[i] = lv
    lv = torch.tensor(level, dtype=torch.long)
    order = torch.sort(lv, stable=True).indices
    return list(torch.split(order, torch.bincount(lv).tolist()))


def ilu0_factor_plain(bands: torch.Tensor, offsets):
    """The JAX ``_ilu0_factor`` row recurrence: (l_bands, u_bands) in acc
    dtype.

    Row i eliminates its lower entries against the factored rows i + l
    (most negative l first; rows before 0 are unit-diagonal rows), keeps
    only the updates that land on the pattern, and guards its pivot.  Rows
    run together by dependency level (``_levels``; the anti-diagonals of a
    five-point stencil): row i waits for row i + l unless its entry at l
    is zero and no earlier elimination can fill it, and then eliminates
    against a unit-diagonal row, which changes nothing (0 / 1, and adding
    -0).  Each row's arithmetic is the JAX row's, operation for operation.
    """
    offsets = tuple(int(o) for o in offsets)
    _check_ilu(bands, offsets)
    n = bands.shape[1]
    idx = {off: d for d, off in enumerate(offsets)}
    lower = sorted(o for o in offsets if o < 0)
    upper = sorted(o for o in offsets if o > 0)
    acc = _acc(bands.dtype)
    a = _mask_oob(bands.to(acc), offsets).T.contiguous()     # (n, nbands)
    eps = torch.finfo(acc).eps
    guard = torch.tensor(torch.finfo(acc).tiny ** 0.5, dtype=acc,
                         device=bands.device)
    seed = torch.zeros(len(offsets), dtype=acc, device=bands.device)
    seed[idx[0]] = 1.0
    i0 = idx[0]
    # slots an earlier elimination can fill: row i + l is always needed
    filled = {off_u + l for l in lower for off_u in upper}
    rows_all = torch.arange(n, device=bands.device)
    deps = {l: ((a[:, idx[l]] != 0) | (l in filled)) & (rows_all + l >= 0)
            for l in lower}
    fact = torch.empty_like(a)
    for rows in _levels({l: d.cpu() for l, d in deps.items()}):
        rows = rows.to(bands.device)
        row = a[rows]
        for l in lower:
            k = rows + l
            krow = torch.where(deps[l][rows][:, None],
                               fact[k.clamp(min=0)], seed)
            lik = row[:, idx[l]] / krow[:, i0]
            row[:, idx[l]] = lik
            for off_u in upper:
                tgt = off_u + l
                if tgt in idx:
                    row[:, idx[tgt]] = (row[:, idx[tgt]]
                                        + (-lik * krow[:, idx[off_u]]))
        piv = row[:, i0]
        floor = torch.maximum(row.abs().amax(dim=1) * eps, guard)
        safe = torch.where(piv < 0, -floor, floor)
        row[:, i0] = torch.where(piv.abs() >= floor, piv, safe)
        fact[rows] = row
    return _split(fact.T, offsets)


def ilu0_factor(bands: torch.Tensor, offsets):
    """ILU(0) factors of a band stack: (l_bands, u_bands), float32 on the
    card (the kernel takes float32 or bfloat16 storage)."""
    offsets = tuple(int(o) for o in offsets)
    _check_ilu(bands, offsets)
    if bands.device.type == "cpu":
        return ilu0_factor_plain(bands, offsets)
    _check_card("ilu0_factor", bands)
    nbands, n = bands.shape
    if nbands > MAX_ILU_BANDS:
        raise ValueError(f"ilu0_factor: {nbands} bands; the kernel takes at "
                         f"most {MAX_ILU_BANDS}")
    fact = torch.empty((nbands, n), dtype=torch.float32, device=bands.device)
    offs = (ctypes.c_int * nbands)(*offsets)
    rc = _build.library().repro_ilu0_factor(
        bands.data_ptr(), int(bands.dtype == torch.bfloat16),
        ctypes.addressof(offs), nbands, fact.data_ptr(), n,
        torch.finfo(torch.float32).eps,
        torch.finfo(torch.float32).tiny ** 0.5, _build.stream_ptr(bands))
    _build.check("ilu0_factor", rc)
    ilu0_factor.launches += 1
    return _split(fact, offsets)


ilu0_factor.launches = 0


def banded_ilu0(bands: torch.Tensor, offsets):
    """ILU(0) of a banded matrix, restricted to its own band pattern.

    bands: (nbands, n) with ``a[i, i + off_d] = bands[d, i]``; offsets must
    include 0.  Returns ``(l_bands, l_offsets, u_bands, u_offsets)``: the
    strictly lower factor (unit diagonal implied) and the upper factor
    (diagonal first), in the same layout, ready for ``banded_trisweep``.
    """
    offsets = tuple(int(o) for o in offsets)
    _check_ilu(bands, offsets)
    l_offsets = tuple(sorted(o for o in offsets if o < 0))
    u_offsets = tuple([0] + sorted(o for o in offsets if o > 0))
    l_bands, u_bands = ilu0_factor(bands, offsets)
    return l_bands, l_offsets, u_bands, u_offsets


# --------------------------------------------------------------------------
# triangular sweep
# --------------------------------------------------------------------------
def _check_tri(bands, v, offsets, unit_diag, lower):
    if bands.ndim != 2 or bands.shape[0] != len(offsets):
        raise TypeError(f"banded_trisweep: {bands.shape[0]} bands but "
                        f"{len(offsets)} offsets")
    if v.ndim not in (1, 2):
        raise TypeError(f"banded_trisweep: v must be (n,) or (k, n), got "
                        f"{tuple(v.shape)}")
    if bands.numel() and bands.shape[1] != v.shape[-1]:
        raise TypeError(f"banded_trisweep: bands {tuple(bands.shape)} vs "
                        f"v {tuple(v.shape)}")
    bad = [o for o in offsets if (o > 0 if lower else o < 0)]
    if bad:
        side = "lower" if lower else "upper"
        raise ValueError(f"banded_trisweep: offsets {bad} on the wrong "
                         f"side for a {side} sweep")
    if not unit_diag and 0 not in offsets:
        raise ValueError("banded_trisweep: unit_diag=False needs the "
                         "diagonal band (offset 0)")


def chunk_rows(offsets, n: int) -> int:
    """c: the nearest far offset (|off| >= 2), n when there is none.  Rows
    i..i+c-1 reach a far term only in rows solved before i."""
    return min((abs(o) for o in offsets if abs(o) >= 2), default=max(n, 1))


def _affine_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of the maps x -> a_i x + b_i along the last axis
    (Hillis-Steele): returns (A, B) with z_i = A_i z_{-1} + B_i."""
    d, length = 1, a.shape[-1]
    while d < length:
        b = torch.cat([b[..., :d], a[..., d:] * b[..., :-d] + b[..., d:]], -1)
        a = torch.cat([a[..., :d], a[..., d:] * a[..., :-d]], -1)
        d *= 2
    return a, b


def banded_trisweep_plain(bands: torch.Tensor, v: torch.Tensor, offsets, *,
                          unit_diag: bool, lower: bool) -> torch.Tensor:
    """The sweep by chunks of ``chunk_rows`` rows and an affine scan in
    each (see the module docstring); v (n,) or (k, n)."""
    offsets = tuple(int(o) for o in offsets)
    _check_tri(bands, v, offsets, unit_diag, lower)
    out_dtype = torch.promote_types(bands.dtype, v.dtype)
    acc = _acc(out_dtype)
    n = v.shape[-1]
    vv = v.reshape(-1, n).to(acc)
    bb = bands.to(acc)
    if not lower:               # the lower sweep of the row-reversed system
        vv, bb = vv.flip(-1), bb.flip(-1)
        offsets = tuple(-o for o in offsets)
    near = offsets.index(-1) if -1 in offsets else None
    far = [(d, off) for d, off in enumerate(offsets) if off < -1]
    diag = None if unit_diag else bb[offsets.index(0)]
    c = chunk_rows(offsets, n)
    z = torch.zeros_like(vv)
    carry = torch.zeros_like(vv[:, 0])
    for s in range(0, n, c):
        e = min(s + c, n)
        rhs = vv[:, s:e].clone()
        for d, off in far:
            lo = max(s, -off)            # rows whose column i + off >= 0
            if lo < e:
                rhs[:, lo - s:] -= bb[d, lo:e] * z[:, lo + off:e + off]
        coef = (-bb[near, s:e] if near is not None
                else torch.zeros_like(rhs[0]))
        if diag is not None:
            rhs = rhs / diag[s:e]
            coef = coef / diag[s:e]
        big_a, big_b = _affine_scan(coef.expand_as(rhs), rhs)
        z[:, s:e] = big_a * carry[:, None] + big_b
        carry = z[:, e - 1]
    if not lower:
        z = z.flip(-1)
    return z.reshape(v.shape).to(out_dtype)


def banded_trisweep(bands: torch.Tensor, v: torch.Tensor, offsets, *,
                    unit_diag: bool, lower: bool) -> torch.Tensor:
    """Solve the banded triangular system for v ((n,) or (k, n)).

    ``lower``: offsets all <= 0, forward substitution; else offsets all
    >= 0, backward.  ``unit_diag``: the diagonal is 1 (no offset-0 band
    needed); else the offset-0 band divides.  The result has the dtype
    bands and v promote to.
    """
    offsets = tuple(int(o) for o in offsets)
    _check_tri(bands, v, offsets, unit_diag, lower)
    if v.device.type == "cpu":
        return banded_trisweep_plain(bands, v, offsets, unit_diag=unit_diag,
                                     lower=lower)
    out_dtype = torch.promote_types(bands.dtype, v.dtype)
    if not offsets:             # the unit triangle: nothing to solve
        return v.to(out_dtype, copy=True)
    _check_card("banded_trisweep", bands)
    if bands.device != v.device:
        raise ValueError(f"banded_trisweep: bands on {bands.device}, v on "
                         f"{v.device}")
    if v.dtype not in STORAGE:
        raise TypeError(f"banded_trisweep: v must be float32 or bfloat16 on "
                        f"the card, got {v.dtype}")
    nbands, n = bands.shape
    if nbands > spmv.MAX_BANDS:
        raise ValueError(f"banded_trisweep: {nbands} bands; the kernel takes "
                         f"at most {spmv.MAX_BANDS}")
    vf = v.reshape(-1, n).to(torch.float32).contiguous()
    z = torch.empty_like(vf)
    plan = sweep_plan(bands, vf, z, offsets)
    _launch_trisweep(bands, vf, z, offsets, plan, unit_diag, lower)
    banded_trisweep.launches += 1
    banded_trisweep.routes[plan["route"]] += 1
    return z.reshape(v.shape).to(out_dtype)


def sweep_plan(bands: torch.Tensor, vf: torch.Tensor, z: torch.Tensor,
               offsets) -> dict:
    """``tuning.trisweep_plan`` for these operands: (k, n) float32 v and z
    and the band stack, aligned where every pointer is 16-byte aligned
    and the row strides keep it so."""
    k, n = vf.shape
    s = bands.element_size()
    aligned = (all(t.data_ptr() % 16 == 0 for t in (bands, vf, z))
               and (bands.shape[0] == 1 or (n * s) % 16 == 0)
               and (k == 1 or (n * 4) % 16 == 0))
    return tuning.trisweep_plan(offsets, n, k, s, aligned)


def _launch_trisweep(bands, vf, z, offsets, plan, unit_diag, lower) -> None:
    """One launch of the sweep kernel with ``plan`` (uncounted: the wrapper
    counts; chip_smoke.py's shape sweep calls this directly)."""
    k, n = vf.shape
    nbands = bands.shape[0]
    agg = (torch.empty(plan["agg"], dtype=torch.float32, device=vf.device)
           if plan["route"] == "scan" else None)
    offs = (ctypes.c_int * nbands)(*offsets)
    rc = _build.library().repro_banded_trisweep(
        bands.data_ptr(), int(bands.dtype == torch.bfloat16),
        ctypes.addressof(offs), nbands, vf.data_ptr(), z.data_ptr(),
        agg.data_ptr() if agg is not None else None, n, k, plan["chunk"],
        plan["threads"], plan["ring"], plan["far_l2"],
        plan["stages"], int(plan["vec"]), int(unit_diag), int(not lower),
        plan["blocks_per_sm"], _build.stream_ptr(vf))
    _build.check(f"banded_trisweep ({plan})", rc)


def chain_probe(offsets, n: int, *, unit_diag: bool, lower: bool,
                device="cuda") -> torch.Tensor:
    """The chunk route's chain with nothing loaded: one block walks the
    chunks of a sweep over n rows with these (far) offsets, with the same
    registers, ring, scans and hand-offs between warps, on constants in
    registers shaped like a grid stencil's factor (no near coupling at a
    chunk's first row; csrc/trisolve.cu's probe).  Its time is the
    chain's floor.  Returns the last carry, (1,) float32.  Not counted:
    no sweep uses it."""
    offsets = tuple(int(o) for o in offsets)
    plan = tuning.trisweep_plan(offsets, n, 1, 4, True)
    if plan["route"] != "chunk":
        raise ValueError(f"chain_probe: route {plan['route']}, not a chain "
                         f"with its far terms on the card")
    out = torch.empty(1, dtype=torch.float32, device=device)
    offs = (ctypes.c_int * len(offsets))(*offsets)
    rc = _build.library().repro_trisweep_probe(
        ctypes.addressof(offs), len(offsets), out.data_ptr(), n,
        plan["chunk"], plan["threads"], plan["ring"], 0,
        int(unit_diag), int(not lower), _build.stream_ptr(out))
    _build.check("trisweep_probe", rc)
    return out


banded_trisweep.launches = 0
banded_trisweep.routes = {"scan": 0, "chunk": 0, "chunk_l2": 0}


def _check_card(name: str, bands: torch.Tensor) -> None:
    if bands.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {bands.device}")
    if bands.dtype not in STORAGE:
        raise TypeError(f"{name}: storage must be float32 or bfloat16, got "
                        f"{bands.dtype}")
    if not bands.is_contiguous():
        raise ValueError(f"{name}: the band stack must be contiguous")
