"""Block Gram-Schmidt kernels: the s-step passes and per-lane CGS2.

Counterpart of ``repro/kernels/block_gs.py``: ``block_gs_pass`` (the
fused pass of the s-step cycle), the single-reduce pass of
``gs="cgs2_pipelined"`` (``block_gs_project_gram`` and ``block_gs_update``
behind ``block_gs_pass_single_reduce``, its plain version
``block_gs_pass_single_reduce_ref``) and ``batched_cgs2`` (the block
multi-RHS solver's per-lane CGS2), and the row-sharded pass
``block_gs_pass_sharded``: the projection ``block_gs_project``, the
all-reduce of C, ``block_gs_update``, the all-reduce of G
(``block_gs_pass_single_reduce`` takes a process group too: one stacked
all-reduce per pass).  The kernels are ``csrc/block_gs.cu`` and
``csrc/batched_cgs2.cu``; their source notes give the designs and the
bounds.

``block_gs_pass(v, w, tin, k_start)``: Q = T W, C = mask (V Q^T),
W' = Q - C^T V, G = W' W'^T, with mask selecting basis rows 0..k_start
(the JAX wrapper's ``mask`` argument is always that prefix, so the port
takes ``k_start`` and the kernel reads only those rows).  V is float32 or
bfloat16, w and tin are taken as float32; c (m1, s), w' (s, n) and g (s, s)
come back in float32 (float64 on the plain path for float64 inputs).  The
kernel takes s <= ``tuning.BLOCK_GS_MAX_S``.

``batched_cgs2``: the JAX wrapper takes a (k, m1) 0/1 mask of valid basis
rows.  A lane's valid rows are always the prefix 0..j, so the port takes
the per-lane step index ``j`` instead (host ints, one per lane), and
``j = -1`` skips a lane (h = 0, w'' = w): the solver passes it for lanes
that are done.  V is float32 or bfloat16; w is taken as float32; h (k, m1)
and the unnormalised w'' (k, n) come back in float32.

On a CPU tensor a wrapper runs its plain version; on a CUDA tensor it
launches the kernel or raises.  There is no size gate: the kernels stream
the bases from global memory, so no basis is too large for them.
"""
from __future__ import annotations

import ctypes
import functools

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
    wf = w.to(torch.float32).contiguous()
    h = torch.empty((k, m1), dtype=torch.float32, device=v.device)
    w_out = torch.empty((k, n), dtype=torch.float32, device=v.device)
    split, meta = _split_meta(v, wf, w_out, j)
    # j and the split's prefix sums in one host-to-device copy
    meta = torch.from_numpy(meta).to(v.device)
    part = torch.empty(2 * m1 * split["grid"], dtype=torch.float32,
                       device=v.device)
    rc = _build.library().repro_batched_cgs2(
        v.data_ptr(), int(v.dtype == torch.bfloat16), wf.data_ptr(),
        meta.data_ptr(), h.data_ptr(), w_out.data_ptr(), part.data_ptr(),
        split["grid"], k, m1, n, split["pieces"], _build.stream_ptr(v))
    _build.check("batched_cgs2", rc)
    batched_cgs2.launches += 1
    batched_cgs2.routes[split["route"]] += 1
    return h, w_out


batched_cgs2.launches = 0
batched_cgs2.routes = {"vec": 0, "scalar": 0}


def capacity(v: torch.Tensor) -> int:
    """The co-resident blocks of the kernel for this basis (the
    cooperative grid's limit) on its card."""
    return _capacity(v.device.index, v.dtype == torch.bfloat16, v.shape[1])


@functools.lru_cache(maxsize=64)
def _capacity(index: int, bf16: bool, m1: int) -> int:
    out = (ctypes.c_int * 1)()
    with torch.cuda.device(index):
        _build.check("batched_cgs2 capacity",
                     _build.library().repro_batched_cgs2_capacity(
                         int(bf16), m1, out))
    return out[0]


def kernel_unroll(rows: int, elem_size: int) -> tuple:
    """The kernel's own launch-shape rule for a lane of ``rows`` rows of
    ``elem_size``-byte V: (bucket of rows, pieces a thread takes at once,
    threads a block), which ``tuning.batched_unroll`` and
    ``tuning.BATCHED_THREADS`` copy for the split.  Needs the built
    library."""
    out = (ctypes.c_int * 3)()
    _build.check("batched_cgs2 unroll",
                 _build.library().repro_batched_cgs2_unroll(rows, elem_size,
                                                            out))
    return out[0], out[1], out[2]


def launch_plan(v: torch.Tensor, wf: torch.Tensor, w_out: torch.Tensor,
                j) -> dict:
    """``tuning.batched_cgs2_split`` for these operands on the current
    card: 16-byte pieces where V, w and w'' are 16-byte aligned and the
    row strides keep them so, else the scalar route."""
    return dict(_split_meta(v, wf, w_out, j)[0])


def _split_meta(v, wf, w_out, j):
    """(the split, its kernel argument: j then the prefix sums, int32)."""
    k, m1, n = v.shape
    aligned = tuning.stream_aligned(
        (v.data_ptr(), wf.data_ptr(), w_out.data_ptr()),
        n * v.element_size(), 2) and (n * 4) % 16 == 0
    return _split_of(tuple(int(x) for x in j), n, v.element_size(), aligned,
                     capacity(v))


@functools.lru_cache(maxsize=1024)
def _split_of(js: tuple, n: int, elem: int, aligned: bool, budget: int):
    """The split and its meta array, cached: a solve repeats a few lane
    patterns (callers only read them)."""
    split = tuning.batched_cgs2_split(js, n, elem, aligned, budget)
    meta = np.concatenate([np.asarray(js, np.int32),
                           np.asarray(split["first"], np.int32)])
    return split, meta


# --------------------------------------------------------------------------
# the s-step block pass
# --------------------------------------------------------------------------
def block_gs_pass_plain(v: torch.Tensor, w: torch.Tensor, tin: torch.Tensor,
                        k_start: int):
    """The kernel's arithmetic (JAX's ``block_gs_pass_ref``) in float32 or
    wider."""
    acc = torch.promote_types(w.dtype, torch.float32)
    mask = (torch.arange(v.shape[0], device=v.device) <= k_start).to(acc)
    vf = v.to(acc)
    q = tin.to(acc) @ w.to(acc)
    c = (vf @ q.T) * mask[:, None]
    w2 = q - c.T @ vf
    return c, w2, w2 @ w2.T


def _check_block(name: str, v, w, tin) -> None:
    if v.ndim != 2 or w.ndim != 2 or w.shape[1] != v.shape[1]:
        raise TypeError(f"{name}: v {tuple(v.shape)} and w "
                        f"{tuple(w.shape)} must share the vector length")
    s = w.shape[0]
    if tuple(tin.shape) != (s, s):
        raise TypeError(f"{name}: tin {tuple(tin.shape)} must be "
                        f"({s}, {s})")
    if w.device != v.device or tin.device != v.device:
        raise ValueError(f"{name}: v on {v.device}, w on {w.device}, "
                         f"tin on {tin.device}")


def _check_pass(v, w, tin, k_start: int,
                name: str = "block_gs_pass") -> None:
    _check_block(name, v, w, tin)
    if not 0 <= k_start < v.shape[0]:
        raise ValueError(f"{name}: k_start = {k_start} outside "
                         f"0..{v.shape[0] - 1}")


def _card_inputs(name: str, v, *fs):
    """Check a card launch's operands: v float32 or bfloat16 and
    contiguous, s within the kernel's accumulators.  Returns the float32
    operands ``fs``, contiguous."""
    if v.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {v.device}")
    if v.dtype not in STORAGE or any(f.dtype not in STORAGE for f in fs):
        raise TypeError(f"{name}: storage must be float32 or bfloat16, got "
                        f"{[v.dtype, *(f.dtype for f in fs)]}")
    if not v.is_contiguous():
        raise ValueError(f"{name}: v must be contiguous (row-major)")
    s = fs[0].shape[0]
    if not 1 <= s <= tuning.BLOCK_GS_MAX_S:
        raise ValueError(f"{name}: s = {s}; the kernel takes "
                         f"1..{tuning.BLOCK_GS_MAX_S}")
    return [f.to(torch.float32).contiguous() for f in fs]


def block_gs_plan(v: torch.Tensor, w: torch.Tensor, k_start: int) -> dict:
    """``tuning.block_gs_plan`` for these operands on their card, rows
    0..k_start read (``block_gs_pass``, ``block_gs_project``;
    ``block_gs_project_gram``: k_start = m1 - 1): 16-byte pieces where V
    and W and their row strides are 16-byte aligned (W' and Q are
    allocated aligned), else the scalar route.  Cached by shape, storage,
    card and alignment: callers read the plan and never change it."""
    m1, n = v.shape
    aligned = tuning.stream_aligned((v.data_ptr(), w.data_ptr()),
                                    n * v.element_size(), k_start + 1) \
        and (n * 4) % 16 == 0
    return _block_plan_of(m1, n, w.shape[0], k_start + 1, v.element_size(),
                          aligned, v.device)


@functools.lru_cache(maxsize=1024)
def _block_plan_of(m1, n, s, rows, elem, aligned, device) -> dict:
    return tuning.block_gs_plan(m1, n, s, rows, elem, aligned,
                                tuning.sm_count(device))


def block_gs_pass(v: torch.Tensor, w: torch.Tensor, tin: torch.Tensor,
                  k_start: int):
    """One fused block-GS pass.  v: (m1, n) basis, rows 0..k_start valid;
    w: (s, n); tin: (s, s).  Returns ``(c, w', g)``."""
    k_start = int(k_start)
    _check_pass(v, w, tin, k_start)
    if v.device.type == "cpu":
        return block_gs_pass_plain(v, w, tin, k_start)
    wf, tf = _card_inputs("block_gs_pass", v, w, tin)
    plan = block_gs_plan(v, wf, k_start)
    m1, n = v.shape
    s = w.shape[0]
    dev = v.device
    c = torch.empty((m1, s), dtype=torch.float32, device=dev)
    w_out = torch.empty((s, n), dtype=torch.float32, device=dev)
    g = torch.empty((s, s), dtype=torch.float32, device=dev)
    grid = plan["grid"]
    part = torch.empty(((m1 * s + s * (s + 1) // 2) * grid,),
                       dtype=torch.float32, device=dev)
    rc = _build.library().repro_block_gs_pass(
        v.data_ptr(), int(v.dtype == torch.bfloat16), wf.data_ptr(),
        tf.data_ptr(), c.data_ptr(), w_out.data_ptr(), g.data_ptr(),
        part.data_ptr(), grid, m1, n, s, k_start + 1, plan["pieces"],
        _build.stream_ptr(v))
    _build.check("block_gs_pass", rc)
    block_gs_pass.launches += 1
    block_gs_pass.routes[plan["route"]] += 1
    return c, w_out, g


block_gs_pass.launches = 0
block_gs_pass.routes = {"vec": 0, "scalar": 0}


def block_gs_launch_shape(v_dtype, m1: int, n: int, s: int,
                          k_start: int = 25) -> dict:
    """The grid block_gs_pass launches at this shape on the current card
    (aligned operands, rows 0..k_start) and its dynamic shared memory."""
    elem = torch.finfo(v_dtype).bits // 8
    plan = tuning.block_gs_plan(m1, n, s, k_start + 1, elem, True,
                                tuning.sm_count("cuda"))
    out = (ctypes.c_int * 1)()
    _build.check("block_gs_pass smem",
                 _build.library().repro_block_gs_pass_smem(m1, s, out))
    return {"grid": plan["grid"], "cols": -(-n // plan["grid"]),
            "smem_bytes": out[0], "route": plan["route"]}


# --------------------------------------------------------------------------
# the single-reduce s-step pass (gs="cgs2_pipelined")
# --------------------------------------------------------------------------
def block_gs_project_gram_plain(v: torch.Tensor, w: torch.Tensor,
                                tin: torch.Tensor):
    """Q = T W, the unmasked C_hat = V Q^T and M = Q Q^T, in float32 or
    wider."""
    acc = torch.promote_types(w.dtype, torch.float32)
    q = tin.to(acc) @ w.to(acc)
    return q, v.to(acc) @ q.T, q @ q.T


def launch_project(v: torch.Tensor, wf: torch.Tensor, tf: torch.Tensor,
                   rows: int, plan: dict, gram: bool):
    """One launch of the projection kernel (and its reduction) with
    ``plan`` (``block_gs_plan``), uncounted.  ``gram``
    (``block_gs_project_gram``, rows = m1): ``(q, out)`` with out =
    [C_hat; M] (m1 + s, s); else (``block_gs_project``): ``(q, c)`` with
    c's rows past rows - 1 zero.  wf and tf float32 and contiguous on v's
    card."""
    m1, n = v.shape
    s = wf.shape[0]
    dev = v.device
    grid = plan["grid"]
    q = torch.empty((s, n), dtype=torch.float32, device=dev)
    lib = _build.library()
    args = (v.data_ptr(), int(v.dtype == torch.bfloat16), wf.data_ptr(),
            tf.data_ptr(), q.data_ptr())
    if gram:
        out = torch.empty((m1 + s, s), dtype=torch.float32, device=dev)
        part = torch.empty(((m1 + s) * s * grid,), dtype=torch.float32,
                           device=dev)
        rc = lib.repro_block_gs_project_gram(
            *args, out.data_ptr(), part.data_ptr(), grid, m1, n, s,
            plan["pieces"], _build.stream_ptr(v))
    else:
        out = torch.empty((m1, s), dtype=torch.float32, device=dev)
        part = torch.empty((rows * s * grid,), dtype=torch.float32,
                           device=dev)
        rc = lib.repro_block_gs_project(
            *args, out.data_ptr(), part.data_ptr(), grid, m1, rows, n, s,
            plan["pieces"], _build.stream_ptr(v))
    _build.check("block_gs_project_gram" if gram else "block_gs_project",
                 rc)
    return q, out


def block_gs_project_gram(v: torch.Tensor, w: torch.Tensor,
                          tin: torch.Tensor):
    """Single-reduce projection over every row of v.  v: (m1, n); w: (s, n);
    tin: (s, s).  Returns ``(q, c_hat, m)``: (s, n), (m1, s), (s, s)."""
    _check_block("block_gs_project_gram", v, w, tin)
    if v.device.type == "cpu":
        return block_gs_project_gram_plain(v, w, tin)
    wf, tf = _card_inputs("block_gs_project_gram", v, w, tin)
    m1 = v.shape[0]
    plan = block_gs_plan(v, wf, m1 - 1)
    q, out = launch_project(v, wf, tf, m1, plan, gram=True)
    block_gs_project_gram.launches += 1
    block_gs_project_gram.routes[plan["route"]] += 1
    return q, out[:m1], out[m1:]


block_gs_project_gram.launches = 0
block_gs_project_gram.routes = {"vec": 0, "scalar": 0}


def block_gs_update_plain(v: torch.Tensor, q: torch.Tensor, c: torch.Tensor):
    """W' = Q - C^T V and G = W' W'^T, in float32 or wider."""
    acc = torch.promote_types(q.dtype, torch.float32)
    w2 = q.to(acc) - c.to(acc).T @ v.to(acc)
    return w2, w2 @ w2.T


def block_gs_update(v: torch.Tensor, q: torch.Tensor, c: torch.Tensor):
    """Update over every row of v.  v: (m1, n); q: (s, n); c: (m1, s).
    Returns ``(w', g)``: (s, n), (s, s)."""
    if v.ndim != 2 or q.ndim != 2 or q.shape[1] != v.shape[1] \
            or tuple(c.shape) != (v.shape[0], q.shape[0]):
        raise TypeError(f"block_gs_update: v {tuple(v.shape)} needs q (s, "
                        f"{v.shape[1]}) and c ({v.shape[0]}, s); got "
                        f"{tuple(q.shape)}, {tuple(c.shape)}")
    if q.device != v.device or c.device != v.device:
        raise ValueError(f"block_gs_update: v on {v.device}, q on "
                         f"{q.device}, c on {c.device}")
    if v.device.type == "cpu":
        return block_gs_update_plain(v, q, c)
    qf, cf = _card_inputs("block_gs_update", v, q, c)
    m1, n = v.shape
    s = q.shape[0]
    dev = v.device
    grid = tuning.sr_grid(dev, n)
    w_out = torch.empty((s, n), dtype=torch.float32, device=dev)
    g = torch.empty((s, s), dtype=torch.float32, device=dev)
    part = torch.empty((s * s * grid,), dtype=torch.float32, device=dev)
    rc = _build.library().repro_block_gs_update(
        v.data_ptr(), int(v.dtype == torch.bfloat16), qf.data_ptr(),
        cf.data_ptr(), w_out.data_ptr(), g.data_ptr(), part.data_ptr(), grid,
        m1, n, s, _build.stream_ptr(v))
    _build.check("block_gs_update", rc)
    block_gs_update.launches += 1
    return w_out, g


block_gs_update.launches = 0


def block_gs_project_plain(v: torch.Tensor, w: torch.Tensor,
                           tin: torch.Tensor, k_start: int):
    """Q = T W and C = mask (V Q^T), mask = rows 0..k_start, in float32 or
    wider."""
    acc = torch.promote_types(w.dtype, torch.float32)
    mask = (torch.arange(v.shape[0], device=v.device) <= k_start).to(acc)
    q = tin.to(acc) @ w.to(acc)
    return q, (v.to(acc) @ q.T) * mask[:, None]


def block_gs_project(v: torch.Tensor, w: torch.Tensor, tin: torch.Tensor,
                     k_start: int):
    """One shard's projection before the all-reduce.  v: (m1, n_local),
    rows 0..k_start valid; w: (s, n_local); tin: (s, s).  Returns
    ``(q, c_partial)``: (s, n_local) and (m1, s), C's rows past k_start
    zero.  Only rows 0..k_start of V are read."""
    k_start = int(k_start)
    _check_pass(v, w, tin, k_start, "block_gs_project")
    if v.device.type == "cpu":
        return block_gs_project_plain(v, w, tin, k_start)
    wf, tf = _card_inputs("block_gs_project", v, w, tin)
    plan = block_gs_plan(v, wf, k_start)
    q, c = launch_project(v, wf, tf, k_start + 1, plan, gram=False)
    block_gs_project.launches += 1
    block_gs_project.routes[plan["route"]] += 1
    return q, c


block_gs_project.launches = 0
block_gs_project.routes = {"vec": 0, "scalar": 0}


def block_gs_pass_sharded(v: torch.Tensor, w: torch.Tensor,
                          tin: torch.Tensor, k_start: int, group):
    """One row-sharded block-GS pass: ``block_gs_project``, the all-reduce
    of C over ``group``, ``block_gs_update`` on the valid rows
    V[:k_start+1] (C is zero past them), the all-reduce of G.  The
    ``(c, w', g)`` contract of ``block_gs_pass`` with c and g global and
    w' this shard's columns."""
    k_start = int(k_start)
    rows = k_start + 1
    q, c = block_gs_project(v, w, tin, k_start)
    c = tuning.all_reduce(c, group)
    w2, g = block_gs_update(v[:rows], q, c[:rows])
    return c, w2, tuning.all_reduce(g, group)


def _sr_recover_block(payload: torch.Tensor, mask: torch.Tensor,
                      gram: torch.Tensor, m1: int):
    """Recovery of (c, g, c_hat) from the stacked payload [C_hat; M].

    With Gamma = ``gram`` the maintained basis Gram matrix (~= V V^T), the
    CholQR Gram of the updated block W' = Q - C^T V is exactly

        G = M - C_hat^T C - C^T C_hat + C^T Gamma C

    so the W' W'^T reduction of the split pass is replaced by (m x s)
    algebra on the card, with no sync.
    """
    acc = torch.promote_types(payload.dtype, gram.dtype)
    payload = payload.to(acc)
    c_hat, mm = payload[:m1], payload[m1:]
    c = c_hat * mask.to(acc)[:, None]
    g = mm - c_hat.T @ c - c.T @ c_hat + c.T @ (gram.to(acc) @ c)
    return c, g, c_hat


def block_gs_pass_single_reduce(v: torch.Tensor, w: torch.Tensor,
                                tin: torch.Tensor, k_start: int,
                                gram: torch.Tensor, axis_name=None):
    """One single-reduce block-GS pass: ``(c, w', g, c_hat)``.

    The ``(c, w', g)`` contract of ``block_gs_pass`` plus the unmasked
    ``c_hat`` column, with which the caller extends the basis Gram matrix
    ``gram`` ((m1, m1), on v's device).  The projection kernel emits C_hat
    and M = Q Q^T from one stream of V and W, the CholQR Gram is recovered
    from them against ``gram`` (``_sr_recover_block``), and the update
    kernel forms W' (its own Gram output is not needed here).

    Both kernels read only the row prefix ``v[:k_start+1]``, and C_hat's
    rows past k_start are taken as zero.  That is exact because the basis
    rows past k_start are zero: the s-step cycle (``core/sstep.py``) builds
    every cycle's basis from ``torch.zeros`` and fills it block by block.

    Row-sharded (``axis_name`` a process group): the stacked payload
    [C_hat; M] is all-reduced once, the pass's one collective.
    """
    k_start = int(k_start)
    _check_pass(v, w, tin, k_start, "block_gs_pass_single_reduce")
    m1, s = v.shape[0], w.shape[0]
    rows = k_start + 1
    vp = v[:rows]
    q, c_hat_p, mm = block_gs_project_gram(vp, w, tin)
    payload = torch.zeros((m1 + s, s), dtype=c_hat_p.dtype, device=v.device)
    payload[:rows] = c_hat_p
    payload[m1:] = mm
    payload = tuning.all_reduce(payload, axis_name)      # the one collective
    mask = torch.arange(m1, device=v.device) <= k_start
    c, g, c_hat = _sr_recover_block(payload, mask, gram, m1)
    w2, _ = block_gs_update(vp, q, c[:rows])
    return c, w2, g, c_hat


def block_gs_pass_single_reduce_ref(v: torch.Tensor, w: torch.Tensor,
                                    tin: torch.Tensor, k_start: int,
                                    gram: torch.Tensor):
    """Plain version of ``block_gs_pass_single_reduce`` (JAX's
    ``block_gs_pass_single_reduce_ref``): every row of v, the same payload
    and recovery."""
    acc = torch.promote_types(w.dtype, torch.float32)
    va = v.to(acc)
    q = tin.to(acc) @ w.to(acc)
    payload = torch.cat([va @ q.T, q @ q.T])
    mask = torch.arange(v.shape[0], device=v.device) <= k_start
    c, g, c_hat = _sr_recover_block(payload, mask, gram, v.shape[0])
    return c, q - c.T @ va, g, c_hat
