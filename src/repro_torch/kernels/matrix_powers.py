"""The s-step cycle's matrix powers: s normalized powers in one launch.

Counterpart of ``repro/kernels/matrix_powers.py`` (``banded_powers``,
``ell_powers``, ``dense_powers``, the row-sharded ``banded_powers_halo``
and the ``matrix_powers_ref`` oracle), and ``banded_cheb_apply``, the
fused Chebyshev preconditioner apply.  The
kernels are ``csrc/matrix_powers.cu``; its source note gives the designs
and the bounds.

Each computes, from u_0 = x,

    w = (A - shifts[p] I) u_{p-1};  sigma_p = ||w||;  u_p = w / max(sigma_p, eps)

for p = 1..s (``shifts=None``: the monomial basis) and returns ``(u,
sigma)``: u (s, n), row p-1 holding u_p, and sigma (s,).  eps is the
breakdown guard tiny^(1/2) of the accumulation dtype.  Matrices are
float32 or bfloat16 storage (float64 on the plain path), x any float
dtype; the results are float32 (float64 for float64 inputs), as the JAX
kernels' ``_acc_dtype`` gives them.  ``dense_powers`` takes no shifts, as
in JAX.

On a CPU tensor a wrapper runs its plain version; on a CUDA tensor it
launches the kernel or raises.  ``matrix_powers_ref(matvec, x, s, eps,
axis_name, shifts=)`` is the JAX package's sequential reference over any
mat-vec: the s-step solver runs it for the operators that have no powers
kernel, and on the card its mat-vecs launch the operator's own GEMV or
SpMV kernels; row-sharded (``axis_name`` a process group) each power's
squared norm is all-reduced, one collective per power.

``banded_powers_halo(bands_pad, x_halo, offsets, s)`` is one shard's
communication-avoiding block: the s raw (unnormalised) powers over a
halo-padded shard, returning the shard's rows of each, (s, n_local), and
their squared norms (s,), which one all-reduce completes.

``banded_cheb_apply(bands, v, offsets, theta=, delta=, rhos=)`` runs the
Chebyshev three-term recurrence from z = v / theta,

    z' = rho (2 / delta (v - A z) + rho_old (z - z_old)) + z

once per (rho, rho_old) pair, ``len(rhos)`` mat-vecs in one launch; theta,
delta and rhos are host floats (``core/preconditioners.cheb_coeffs``).
The result has the dtype bands and v promote to.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, ref, spmv, tuning

STORAGE = (torch.float32, torch.bfloat16)
MAX_CHEB_STEPS = 32     # (rho, rho_old) pairs the Chebyshev kernel takes
_KIND = {"banded": 0, "cheb": 1, "dense": 2}


def _acc_dtype(mat_dtype, x_dtype) -> torch.dtype:
    return torch.promote_types(torch.promote_types(mat_dtype, x_dtype),
                               torch.float32)


def guard(dtype) -> float:
    """The breakdown guard tiny^(1/2) of ``dtype``."""
    return float(torch.finfo(dtype).tiny) ** 0.5


def matrix_powers_ref(matvec, x: torch.Tensor, s: int, eps, axis_name=None,
                      shifts: torch.Tensor | None = None):
    """s normalized powers by s sequential mat-vecs (the JAX reference).

    Runs in the dtype the mat-vec returns; ``shifts`` (s,) selects the
    Newton basis; under ``axis_name`` (a process group) each squared norm
    is all-reduced.  Returns ``(u (s, n), sigma (s,))``.
    """
    us, sigmas = [], []
    u = x
    for p in range(s):
        w = matvec(u)
        if shifts is not None:
            w = w - shifts[p] * u
        nrm2 = ((w.float() * w.float()).sum() if w.dtype == torch.bfloat16
                else torch.dot(w, w))
        sigma = torch.sqrt(tuning.all_reduce(nrm2, axis_name))
        sigma = sigma.to(w.dtype)
        u = w / torch.clamp(sigma, min=eps)
        us.append(u)
        sigmas.append(sigma)
    return torch.stack(us), torch.stack(sigmas)


# --------------------------------------------------------------------------
# plain versions: the kernels' arithmetic, in the accumulation dtype
# --------------------------------------------------------------------------
def _plain(matvec, x, s, acc, shifts):
    sh = None if shifts is None else shifts.to(acc)
    return matrix_powers_ref(matvec, x.to(acc), s, guard(acc), shifts=sh)


def banded_powers_plain(bands, x, offsets, s: int, *, shifts=None):
    acc = _acc_dtype(bands.dtype, x.dtype)
    return _plain(lambda u: spmv.banded_matvec_plain(bands, u, offsets), x,
                  s, acc, shifts)


def ell_powers_plain(values, cols, x, s: int, *, shifts=None):
    acc = _acc_dtype(values.dtype, x.dtype)
    return _plain(lambda u: spmv.ell_matvec_plain(values, cols, u), x, s,
                  acc, shifts)


def dense_powers_plain(a, x, s: int):
    acc = _acc_dtype(a.dtype, x.dtype)
    return _plain(lambda u: ref.matvec(a, u), x, s, acc, None)


def banded_powers_halo_plain(bands_pad, x_halo, offsets, s: int):
    """s raw powers over the padded width, reads outside it zero; returns
    each power's centre rows and their squared norms (JAX's kernel
    arithmetic, in the accumulation dtype)."""
    acc = _acc_dtype(bands_pad.dtype, x_halo.dtype)
    halo = max(abs(int(o)) for o in offsets)
    center = s * halo
    ln = bands_pad.shape[1] - 2 * center
    cur = x_halo.to(acc)
    zs, nrm = [], []
    for _ in range(s):
        cur = spmv.banded_matvec_plain(bands_pad, cur, offsets).to(acc)
        zc = cur[center:center + ln]
        zs.append(zc)
        nrm.append((zc * zc).sum())
    return torch.stack(zs), torch.stack(nrm)


def banded_cheb_apply_plain(bands, v, offsets, *, theta: float,
                            delta: float, rhos):
    acc = _acc_dtype(bands.dtype, v.dtype)
    vv = v.to(acc)
    z = vv / theta
    z_old = torch.zeros_like(vv)
    for rho, rho_old in rhos:
        w = spmv.banded_matvec_plain(bands, z, offsets).to(acc)
        z_new = rho * (2.0 / delta * (vv - w) + rho_old * (z - z_old)) + z
        z_old, z = z, z_new
    return z.to(torch.promote_types(bands.dtype, v.dtype))


# --------------------------------------------------------------------------
# checks
# --------------------------------------------------------------------------
def _check_x(name: str, n: int, x: torch.Tensor, mat: torch.Tensor) -> None:
    if x.shape != (n,):
        raise TypeError(f"{name}: matrix {tuple(mat.shape)} needs x of shape "
                        f"({n},), got {tuple(x.shape)}")
    if mat.device != x.device:
        raise ValueError(f"{name}: matrix on {mat.device}, x on {x.device}")


def _check_s(name: str, s: int, shifts) -> None:
    if s < 1:
        raise ValueError(f"{name}: s = {s} must be >= 1")
    if shifts is not None and tuple(shifts.shape) != (s,):
        raise TypeError(f"{name}: shifts {tuple(shifts.shape)} must be "
                        f"({s},)")


def _check_card(name: str, mat: torch.Tensor, idx=None) -> None:
    if mat.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {mat.device}")
    if mat.dtype not in STORAGE:
        raise TypeError(f"{name}: storage must be float32 or bfloat16, got "
                        f"{mat.dtype}")
    if not mat.is_contiguous() or (idx is not None
                                   and not idx.is_contiguous()):
        raise ValueError(f"{name}: the matrix must be contiguous (row-major)")
    if idx is not None and idx.dtype != torch.int32:
        raise TypeError(f"{name}: column indices must be int32, got "
                        f"{idx.dtype}")


def _buffers(x: torch.Tensor, s: int, grid: int, shifts):
    """x as float32, the shifts on the card (or a null pointer), and the
    outputs and scratch of one launch."""
    if x.dtype not in STORAGE:
        raise TypeError(f"matrix powers: x must be float32 or bfloat16 on the "
                        f"card, got {x.dtype}")
    n = x.shape[0]
    dev = x.device
    xf = x.to(torch.float32).contiguous()
    sh = None if shifts is None else \
        shifts.to(device=dev, dtype=torch.float32).contiguous()
    u = torch.empty((s, n), dtype=torch.float32, device=dev)
    sigma = torch.empty((s,), dtype=torch.float32, device=dev)
    raw = torch.empty((2, n), dtype=torch.float32, device=dev)
    part = torch.empty((s * grid,), dtype=torch.float32, device=dev)
    return xf, sh, u, sigma, raw, part


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------
def banded_powers(bands: torch.Tensor, x: torch.Tensor, offsets, s: int, *,
                  shifts: torch.Tensor | None = None):
    """All s normalized powers of a banded operator.  bands: (nbands, n);
    offsets: one diagonal shift per band; x: (n,).  On the card the band
    stack stays in shared memory across the powers and each power's operand
    is divided once into a shared tile (``banded_plan``; the route, "tile",
    "far" or "l2", counted in ``banded_powers.routes``)."""
    offsets = tuple(int(o) for o in offsets)
    if bands.ndim != 2 or len(offsets) != bands.shape[0]:
        raise TypeError(f"banded_powers: bands {tuple(bands.shape)} but "
                        f"{len(offsets)} offsets")
    _check_x("banded_powers", bands.shape[1], x, bands)
    _check_s("banded_powers", s, shifts)
    if bands.device.type == "cpu":
        return banded_powers_plain(bands, x, offsets, s, shifts=shifts)
    _check_card("banded_powers", bands)
    nbands, n = bands.shape
    if nbands > spmv.MAX_BANDS:
        raise ValueError(f"banded_powers: {nbands} bands; the kernel takes at "
                         f"most {spmv.MAX_BANDS}")
    segs = tuning.powers_segments(n, tuning.sm_count(bands.device))
    xf, sh, u, sigma, raw, part = _buffers(x, s, segs, shifts)
    plan = banded_plan(bands, offsets, xf)
    offs = (ctypes.c_int * nbands)(*offsets)
    rc = _build.library().repro_banded_powers(
        bands.data_ptr(), int(bands.dtype == torch.bfloat16),
        ctypes.addressof(offs), nbands, xf.data_ptr(), _ptr(sh),
        u.data_ptr(), sigma.data_ptr(), raw.data_ptr(), part.data_ptr(),
        plan["segments"], n, s, guard(torch.float32),
        *_plan_args(plan),
        _build.stream_ptr(bands))
    _build.check("banded_powers", rc)
    banded_powers.launches += 1
    banded_powers.routes[plan["route"]] += 1
    return u, sigma


banded_powers.launches = 0
banded_powers.routes = {"tile": 0, "far": 0, "l2": 0}


def banded_plan(bands: torch.Tensor, offsets, operand: torch.Tensor) -> dict:
    """``tuning.banded_plan`` for this band stack on its card, with ``vec``:
    the bands and the float32 operand (x, or v) 16-byte aligned and n a
    whole number of 16-byte pieces of both (the 16-byte copies of the
    stack and the tile).  Cached by shape, offsets, storage, card and
    alignment."""
    nbands, n = bands.shape
    elem = bands.element_size()
    vec = int(bands.data_ptr() % 16 == 0 and operand.data_ptr() % 16 == 0
              and n % (16 // elem) == 0)
    return _banded_plan(n, tuple(int(o) for o in offsets), elem,
                        tuning.sm_count(bands.device), vec)


@functools.lru_cache(maxsize=64)
def _banded_plan(n: int, offsets: tuple, elem: int, sms: int,
                 vec: int) -> dict:
    return dict(tuning.banded_plan(n, offsets, elem, sms), vec=vec)


def _plan_args(plan: dict) -> tuple:
    """The plan's launch arguments, in the C entry points' order."""
    return (plan["segments"], plan["seg_per_block"], plan["blocks"],
            plan["threads"], plan["res_seg"], plan["tile_halo"],
            plan["tile_rows"], plan["vec"], plan["smem"], tuning.SMEM_BUDGET)


def banded_powers_halo(bands_pad: torch.Tensor, x_halo: torch.Tensor,
                       offsets, s: int):
    """All s raw powers of one shard of a row-sharded banded operator.

    bands_pad: (nbands, W), W = n_local + 2 s halo: the shard's band stack
    with (s - 1) halo exchanged neighbour columns each side and then halo
    zeros each side (built once per solve by ``core/sstep.py``, which also
    pre-scales it); x_halo: (W,), ``halo_exchange`` of the starting vector
    at width s halo.  Returns ``(z, nrm)``: z (s, n_local) the shard's rows
    of z_p = B^p x, nrm (s,) their squared norms, before the all-reduce.
    """
    offsets = tuple(int(o) for o in offsets)
    if bands_pad.ndim != 2 or len(offsets) != bands_pad.shape[0]:
        raise TypeError(f"banded_powers_halo: bands {tuple(bands_pad.shape)}"
                        f" but {len(offsets)} offsets")
    nbands, width = bands_pad.shape
    halo = max(abs(o) for o in offsets)
    if s < 1 or width - 2 * s * halo <= 0:
        raise TypeError(f"banded_powers_halo: padded width {width} too "
                        f"small for s={s} powers of halo={halo}")
    _check_x("banded_powers_halo", width, x_halo, bands_pad)
    if bands_pad.device.type == "cpu":
        return banded_powers_halo_plain(bands_pad, x_halo, offsets, s)
    _check_card("banded_powers_halo", bands_pad)
    if nbands > spmv.MAX_BANDS:
        raise ValueError(f"banded_powers_halo: {nbands} bands; the kernel "
                         f"takes at most {spmv.MAX_BANDS}")
    dev = bands_pad.device
    grid = tuning.persistent_grid(dev, tuning.POWERS_BLOCKS_PER_SM,
                                  -(-width // (32 * tuning.GS_WARPS)))
    if x_halo.dtype not in STORAGE:
        raise TypeError(f"banded_powers_halo: x must be float32 or bfloat16 "
                        f"on the card, got {x_halo.dtype}")
    xf = x_halo.to(torch.float32).contiguous()
    raw = torch.empty((2, width), dtype=torch.float32, device=dev)
    part = torch.empty((s * grid,), dtype=torch.float32, device=dev)
    z = torch.empty((s, width - 2 * s * halo), dtype=torch.float32,
                    device=dev)
    nrm = torch.empty((s,), dtype=torch.float32, device=dev)
    offs = (ctypes.c_int * nbands)(*offsets)
    rc = _build.library().repro_banded_powers_halo(
        bands_pad.data_ptr(), int(bands_pad.dtype == torch.bfloat16),
        ctypes.addressof(offs), nbands, xf.data_ptr(), z.data_ptr(),
        nrm.data_ptr(), raw.data_ptr(), part.data_ptr(), grid, width, s,
        tuning.POWERS_BLOCKS_PER_SM, _build.stream_ptr(bands_pad))
    _build.check("banded_powers_halo", rc)
    banded_powers_halo.launches += 1
    return z, nrm


banded_powers_halo.launches = 0


def ell_powers(values: torch.Tensor, cols: torch.Tensor, x: torch.Tensor,
               s: int, *, shifts: torch.Tensor | None = None):
    """All s normalized powers of an ELL operator.  values/cols: (n, width)
    as in ``spmv.ell_matvec``; x: (n,).  On the card the table's rows that
    fit stay in shared memory across the powers (``ell_plan``; the route,
    "resident" or "stream", counted in ``ell_powers.routes``)."""
    if values.ndim != 2 or cols.shape != values.shape:
        raise TypeError(f"ell_powers: cols {tuple(cols.shape)} must match "
                        f"values {tuple(values.shape)}")
    _check_x("ell_powers", values.shape[0], x, values)
    _check_s("ell_powers", s, shifts)
    if values.device.type == "cpu":
        return ell_powers_plain(values, cols, x, s, shifts=shifts)
    _check_card("ell_powers", values, cols)
    n, width = values.shape
    plan = ell_plan(values, cols)
    xf, sh, u, sigma, raw, part = _buffers(x, s, plan["segments"], shifts)
    rc = _build.library().repro_ell_powers(
        values.data_ptr(), int(values.dtype == torch.bfloat16),
        cols.data_ptr(), width, xf.data_ptr(), _ptr(sh), u.data_ptr(),
        sigma.data_ptr(), raw.data_ptr(), part.data_ptr(), plan["segments"],
        n, s, guard(torch.float32), plan["segments"], plan["seg_per_block"],
        plan["blocks"], plan["threads"], plan["res_seg"], plan["bucket"],
        plan["vec"], plan["smem"], tuning.SMEM_BUDGET,
        _build.stream_ptr(values))
    _build.check("ell_powers", rc)
    ell_powers.launches += 1
    ell_powers.routes[plan["route"]] += 1
    return u, sigma


def ell_plan(values: torch.Tensor, cols: torch.Tensor) -> dict:
    """``tuning.ell_powers_plan`` for this table on its card, on the banded
    powers' segments (``tuning.powers_segments``), with ``vec``: values and
    cols 16-byte aligned (the resident copy's 16-byte loads).  Cached whole
    by shape, storage, card and alignment."""
    n, width = values.shape
    vec = int(values.data_ptr() % 16 == 0 and cols.data_ptr() % 16 == 0)
    return _ell_plan(n, width, values.element_size(),
                     tuning.sm_count(values.device), vec)


@functools.lru_cache(maxsize=64)
def _ell_plan(n: int, width: int, elem: int, sms: int, vec: int) -> dict:
    return dict(tuning.ell_powers_plan(n, width, elem, sms), vec=vec)


ell_powers.launches = 0
ell_powers.routes = {"resident": 0, "stream": 0}


def dense_powers(a: torch.Tensor, x: torch.Tensor, s: int):
    """All s normalized powers of a dense (n, n) A (unshifted); x: (n,).

    The kernel keeps the current power in each block's shared memory, so n
    is at most ``tuning.SMEM_BUDGET / 4`` (51,200) on the card.
    """
    if a.ndim != 2 or a.shape[0] != a.shape[1]:
        raise TypeError(f"dense_powers: a {tuple(a.shape)} must be square")
    _check_x("dense_powers", a.shape[0], x, a)
    _check_s("dense_powers", s, None)
    if a.device.type == "cpu":
        return dense_powers_plain(a, x, s)
    _check_card("dense_powers", a)
    n = a.shape[0]
    if 4 * n > tuning.SMEM_BUDGET:
        raise ValueError(f"dense_powers: n = {n}; the kernel holds the "
                         f"operand in shared memory, n <= "
                         f"{tuning.SMEM_BUDGET // 4}")
    grid = tuning.persistent_grid(a.device, tuning.POWERS_BLOCKS_PER_SM,
                                  -(-n // tuning.GS_WARPS))
    xf, _, u, sigma, raw, part = _buffers(x, s, grid, None)
    rc = _build.library().repro_dense_powers(
        a.data_ptr(), int(a.dtype == torch.bfloat16), xf.data_ptr(),
        u.data_ptr(), sigma.data_ptr(), raw.data_ptr(), part.data_ptr(),
        grid, n, s, guard(torch.float32), tuning.SMEM_BUDGET,
        tuning.POWERS_BLOCKS_PER_SM, _build.stream_ptr(a))
    _build.check("dense_powers", rc)
    dense_powers.launches += 1
    return u, sigma


dense_powers.launches = 0


def banded_cheb_apply(bands: torch.Tensor, v: torch.Tensor, offsets, *,
                      theta: float, delta: float, rhos) -> torch.Tensor:
    """z ~= A^{-1} v by the fused Chebyshev recurrence (one launch).

    bands: (nbands, n) as in ``spmv.banded_matvec``; v: (n,); theta, delta
    and rhos ((rho, rho_old) pairs) from ``cheb_coeffs``.  On the card the
    banded powers' plan (``banded_plan``; routes counted in
    ``banded_cheb_apply.routes``).
    """
    offsets = tuple(int(o) for o in offsets)
    rhos = tuple((float(r), float(ro)) for r, ro in rhos)
    if bands.ndim != 2 or len(offsets) != bands.shape[0]:
        raise TypeError(f"banded_cheb_apply: {bands.shape[0]} bands but "
                        f"{len(offsets)} offsets")
    _check_x("banded_cheb_apply", bands.shape[1], v, bands)
    if bands.device.type == "cpu":
        return banded_cheb_apply_plain(bands, v, offsets, theta=theta,
                                       delta=delta, rhos=rhos)
    _check_card("banded_cheb_apply", bands)
    nbands, n = bands.shape
    if nbands > spmv.MAX_BANDS:
        raise ValueError(f"banded_cheb_apply: {nbands} bands; the kernel "
                         f"takes at most {spmv.MAX_BANDS}")
    if len(rhos) > MAX_CHEB_STEPS:
        raise ValueError(f"banded_cheb_apply: {len(rhos)} steps; the kernel "
                         f"takes at most {MAX_CHEB_STEPS} (order "
                         f"{MAX_CHEB_STEPS + 1})")
    if v.dtype not in STORAGE:
        raise TypeError(f"banded_cheb_apply: v must be float32 or bfloat16 "
                        f"on the card, got {v.dtype}")
    vf = v.to(torch.float32).contiguous()
    plan = banded_plan(bands, offsets, vf)
    zbuf = torch.empty((2, n), dtype=torch.float32, device=v.device)
    out = torch.empty_like(vf)
    offs = (ctypes.c_int * nbands)(*offsets)
    steps = len(rhos)
    rho = (ctypes.c_float * max(steps, 1))(*(r for r, _ in rhos))
    rho_old = (ctypes.c_float * max(steps, 1))(*(ro for _, ro in rhos))
    rc = _build.library().repro_banded_cheb_apply(
        bands.data_ptr(), int(bands.dtype == torch.bfloat16),
        ctypes.addressof(offs), nbands, vf.data_ptr(), zbuf.data_ptr(),
        out.data_ptr(), n, float(theta), 2.0 / float(delta),
        ctypes.addressof(rho), ctypes.addressof(rho_old), steps,
        *_plan_args(plan), _build.stream_ptr(bands))
    _build.check("banded_cheb_apply", rc)
    banded_cheb_apply.launches += 1
    banded_cheb_apply.routes[plan["route"]] += 1
    return out.to(torch.promote_types(bands.dtype, v.dtype))


banded_cheb_apply.launches = 0
banded_cheb_apply.routes = {"tile": 0, "far": 0, "l2": 0}


def launch_shape(kind: str, dtype, n: int, offsets=None) -> dict:
    """The launch a powers kernel makes at this size on the current card.

    "banded" (``banded_powers``) and "cheb" (``banded_cheb_apply``), with
    the band ``offsets``: ``tuning.banded_plan`` (blocks, threads, smem,
    resident rows, tile and route; ``vec`` as for an aligned operand) and
    the kernel's own account of it: ``co_resident`` blocks an SM at that
    shared memory, ``kernel_smem`` its layout's bytes (the plan's
    ``smem``), ``kernel_reg_rows`` rows of a segment a thread keeps in
    registers (the Chebyshev apply; 0 for the powers).
    "dense": {"grid", "cols" (the grid's warps), "smem_bytes"}.  The ELL
    kernel's launch is ``ell_plan``."""
    index = torch.cuda.current_device()
    if kind == "dense":
        out = (ctypes.c_int * 3)()
        _build.check("repro_matrix_powers_shape",
                     _build.library().repro_matrix_powers_shape(
                         _KIND[kind], int(dtype == torch.bfloat16), n, 0, 0,
                         0, 0, 0, tuning.POWERS_BLOCKS_PER_SM, out))
        return {"grid": out[0], "cols": out[1], "smem_bytes": out[2]}
    offsets = tuple(int(o) for o in offsets)
    elem = torch.finfo(dtype).bits // 8
    plan = _banded_plan(n, offsets, elem,
                        tuning.sm_count(torch.device("cuda", index)),
                        int(n % (16 // elem) == 0))
    out = (ctypes.c_int * 3)()
    _build.check("repro_matrix_powers_shape",
                 _build.library().repro_matrix_powers_shape(
                     _KIND[kind], int(dtype == torch.bfloat16), n,
                     len(offsets), plan["segments"], plan["seg_per_block"],
                     plan["res_seg"], plan["tile_rows"],
                     tuning.POWERS_BLOCKS_PER_SM, out))
    return dict(plan, co_resident=out[0], kernel_smem=out[1],
                kernel_reg_rows=out[2])
