"""Gram-Schmidt kernels: the fused pass and the single-reduce pair.

Counterpart of ``repro/kernels/cgs2.py``: ``gs_project`` / ``cgs2`` (the
fused single-shard pass, ``csrc/cgs2.cu``), and the pipelined step's
``gs_project_norm_partial`` (the single-reduce payload) and ``gs_update``
(``csrc/sr_payload.cu``), and the row-sharded step's split-phase
projection ``gs_project_partial`` (``csrc/sr_payload.cu``) with
``cgs2_split``, the project / all-reduce / update pair run twice.  The
source notes give the designs and the bounds.  A basis whose column
slices do not fit shared memory (the sparse solver's n = 2^20) streams
from global memory (``tuning.gs_stream_plan``, ``launch_plan``): then
``cgs2`` is one launch of three sweeps over V (``cgs2.launches``) and
``gs_project`` one of two; each counts the route it took in ``.routes``
("smem", or the streamed kernel's "vec" 16-byte pieces / "scalar" for a
misaligned V, w or row stride).

The mask is the prefix of valid basis rows, so ``gs_project`` and
``gs_project_norm_partial`` take ``j`` (rows 0..j valid) instead of a mask
vector: the kernels then read only those j+1 rows of V.  V is float32 or
bfloat16, w (z) is taken as float32 and h and w' come back in float32 (w'
in w's dtype).

``gs_project_norm_partial(v, z, j)`` returns the (m1 + 1, 2) payload
``[mask * (V [z, v_j]); z.z, v_j.v_j]`` with v_j row j of V, widened to
z's dtype as the JAX payload widens it (the JAX wrapper takes the stacked
(n, 2) block; the port reads v_j from V instead).  ``gs_update(v, w, h)``
returns w - h^T V over every row of v.  The pipelined cycle's h is zero
past row j, so it passes the row prefix ``v[:j+1]`` (contiguous in row
major) with ``h[:j+1]``: that is exact, since a zero row adds exactly 0
in the kernel's and the plain version's row-ordered sums.

``gs_update`` and ``gs_project_partial`` stream V in 16-byte pieces where
V, w and the row stride are 16-byte aligned, else take the kernels'
scalar route (``stream_plan``); each counts the route it took in
``.routes`` beside ``.launches``.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, ref, tuning

STORAGE = (torch.float32, torch.bfloat16)


def gs_project_plain(v: torch.Tensor, w: torch.Tensor, j: int):
    mask = ref.row_mask(v.shape[0], j, device=v.device)
    h, w1 = ref.gs_project(v, w, mask)
    return h, w1.to(w.dtype)


def _check(v: torch.Tensor, w: torch.Tensor, j: int,
           name: str = "gs_project") -> None:
    if v.ndim != 2 or w.shape != (v.shape[1],):
        raise TypeError(f"{name}: v {tuple(v.shape)}, w {tuple(w.shape)}"
                        f" — need v (m1, n) and w (n,)")
    if not 0 <= j < v.shape[0]:
        raise ValueError(f"{name}: j = {j} outside 0..{v.shape[0] - 1}")
    if v.device != w.device:
        raise ValueError(f"{name}: v on {v.device}, w on {w.device}")


def _storage(name: str, *ts) -> None:
    for t in ts:
        if t.dtype not in STORAGE:
            raise TypeError(f"{name}: storage must be float32 or bfloat16, "
                            f"got {t.dtype}")


def _card_operands(name: str, v, w):
    """Check a card launch's operands; w as float32, contiguous."""
    if v.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {v.device}")
    _storage(name, v, w)
    if not v.is_contiguous():
        raise ValueError(f"{name}: v must be contiguous (row-major)")
    return w.to(torch.float32).contiguous()


def stream_capacity(v: torch.Tensor) -> int:
    """The co-resident blocks of the streamed kernel for this basis on its
    card (the cooperative grid's limit)."""
    return _stream_shape(v.device.index, v.dtype == torch.bfloat16,
                         v.shape[0])[0]


@functools.lru_cache(maxsize=64)
def _stream_shape(index: int, bf16: bool, m1: int) -> tuple:
    """(co-resident blocks, dynamic shared memory bytes) of the streamed
    kernel, asked of the C side once a (card, storage, m1)."""
    out = (ctypes.c_int * 2)()
    with torch.cuda.device(index):
        _build.check("gs_project capacity",
                     _build.library().repro_gs_stream_capacity(
                         int(bf16), m1, out))
    return out[0], out[1]


def launch_plan(v: torch.Tensor, w: torch.Tensor, j: int) -> dict:
    """How ``gs_project`` / ``cgs2`` run on these operands: route "smem"
    where a block's V slice fits shared memory (``tuning.fused_step_fits``:
    the shared-memory pass), else ``tuning.gs_stream_plan``'s streamed
    kernel, on 16-byte pieces where V, w and the row stride are 16-byte
    aligned (the output is allocated aligned), else on the scalar
    route.  Cached by shape, storage, card and alignment: callers read the
    plan and never change it."""
    m1, n = v.shape
    aligned = tuning.stream_aligned((v.data_ptr(), w.data_ptr()),
                                    n * v.element_size(), j + 1)
    return _plan_of(m1, n, j, v.dtype, v.device, aligned)


@functools.lru_cache(maxsize=1024)
def _plan_of(m1: int, n: int, j: int, dtype, device, aligned: bool) -> dict:
    if tuning.fused_step_fits(m1, n, tuning.sm_count(device)):
        return {"route": "smem"}
    return tuning.gs_stream_plan(
        m1, n, j, torch.finfo(dtype).bits // 8, aligned,
        _stream_shape(device.index, dtype == torch.bfloat16, m1)[0])


def _launch_smem(v, wf, j: int):
    """One shared-memory pass (csrc/cgs2.cu's gs_project_kernel)."""
    m1, n = v.shape
    h = torch.empty(m1, dtype=torch.float32, device=v.device)
    w_out = torch.empty(n, dtype=torch.float32, device=v.device)
    cap = tuning.partial_blocks(v.device, tuning.GS_BLOCKS_PER_SM)
    part = torch.empty(cap * m1, dtype=torch.float32, device=v.device)
    rc = _build.library().repro_gs_project(
        v.data_ptr(), int(v.dtype == torch.bfloat16), wf.data_ptr(),
        h.data_ptr(), w_out.data_ptr(), part.data_ptr(), cap, m1, n, j,
        tuning.SMEM_BUDGET, tuning.GS_BLOCKS_PER_SM, _build.stream_ptr(v))
    _build.check("gs_project", rc)
    return h, w_out


def _launch_stream(v, wf, j: int, passes: int, plan: dict):
    """The streamed kernel at launch plan ``plan`` (``launch_plan``'s):
    ``passes`` = 2 is cgs2 (h = h1 + h2, w''), 1 one pass (h, w')."""
    m1, n = v.shape
    h = torch.empty(m1, dtype=torch.float32, device=v.device)
    w_out = torch.empty(n, dtype=torch.float32, device=v.device)
    part = torch.empty(passes * m1 * plan["grid"], dtype=torch.float32,
                       device=v.device)
    rc = _build.library().repro_gs_stream(
        v.data_ptr(), int(v.dtype == torch.bfloat16), wf.data_ptr(),
        h.data_ptr(), w_out.data_ptr(), part.data_ptr(), plan["grid"], m1, n,
        j, plan["pieces"], passes, _build.stream_ptr(v))
    _build.check("cgs2" if passes == 2 else "gs_project", rc)
    return h, w_out


def gs_project(v: torch.Tensor, w: torch.Tensor, j: int):
    """One fused GS pass over basis rows 0..j.  v: (m1, n), w: (n,)."""
    j = int(j)
    _check(v, w, j)
    if v.device.type == "cpu":
        return gs_project_plain(v, w, j)
    wf = _card_operands("gs_project", v, w)
    plan = launch_plan(v, wf, j)
    if plan["route"] == "smem":
        h, w_out = _launch_smem(v, wf, j)
    else:
        h, w_out = _launch_stream(v, wf, j, 1, plan)
    gs_project.launches += 1
    gs_project.routes[plan["route"]] += 1
    return h, w_out.to(w.dtype)


gs_project.launches = 0
gs_project.routes = {"smem": 0, "vec": 0, "scalar": 0}


def launch_shape(v_dtype, m1: int, n: int, j: int = 15) -> dict:
    """The grid gs_project launches at this shape on the current card
    (aligned operands): the shared-memory pass's cooperative shape, or the
    streamed kernel's plan at step j (``cols``: columns a block,
    ``smem_bytes``: its dynamic shared memory)."""
    if tuning.fused_step_fits(m1, n, tuning.sm_count("cuda")):
        return _build.shape("repro_gs_project_shape",
                            int(v_dtype == torch.bfloat16), m1, n,
                            tuning.SMEM_BUDGET, tuning.GS_BLOCKS_PER_SM)
    blocks, smem = _stream_shape(torch.cuda.current_device(),
                                 v_dtype == torch.bfloat16, m1)
    plan = tuning.gs_stream_plan(m1, n, j, torch.finfo(v_dtype).bits // 8,
                                 True, blocks)
    return {"grid": plan["grid"], "cols": -(-n // plan["grid"]),
            "smem_bytes": smem, "route": plan["route"]}


def cgs2_plain(v: torch.Tensor, w: torch.Tensor, j: int):
    """Both passes' arithmetic: h = h1 + h2 and w''."""
    h1, w1 = gs_project_plain(v, w, j)
    h2, w2 = gs_project_plain(v, w1, j)
    return h1 + h2, w2


def cgs2(v: torch.Tensor, w: torch.Tensor, j: int):
    """Reorthogonalized (two-pass) fused Gram-Schmidt; returns (h, w'').
    Where the basis streams from global memory, one launch of three sweeps
    over V (``cgs2.launches``, ``cgs2.routes``); else two shared-memory
    ``gs_project`` passes."""
    j = int(j)
    _check(v, w, j, "cgs2")
    if v.device.type == "cpu":
        return cgs2_plain(v, w, j)
    wf = _card_operands("cgs2", v, w)
    plan = launch_plan(v, wf, j)
    if plan["route"] == "smem":   # two shared-memory passes
        h1, w1 = _launch_smem(v, wf, j)
        h2, w2 = _launch_smem(v, w1, j)
        gs_project.launches += 2
        gs_project.routes["smem"] += 2
        return h1 + h2, w2.to(w.dtype)
    h, w2 = _launch_stream(v, wf, j, 2, plan)
    cgs2.launches += 1
    cgs2.routes[plan["route"]] += 1
    return h, w2.to(w.dtype)


cgs2.launches = 0
cgs2.routes = {"vec": 0, "scalar": 0}


# --------------------------------------------------------------------------
# the single-reduce pair of the pipelined step
# --------------------------------------------------------------------------
def gs_project_norm_partial_plain(v: torch.Tensor, z: torch.Tensor, j: int):
    """The payload's arithmetic (JAX's ``sr_payload_ref``), in float32 or
    wider."""
    acc = torch.promote_types(z.dtype, torch.float32)
    mask = ref.row_mask(v.shape[0], j, acc, v.device)
    w2 = torch.stack([z, v[j].to(z.dtype)], dim=1).to(acc)
    h = (v.to(acc) @ w2) * mask[:, None]
    return torch.cat([h, (w2 * w2).sum(dim=0, keepdim=True)])


def gs_project_norm_partial(v: torch.Tensor, z: torch.Tensor, j: int):
    """Single-reduce payload over basis rows 0..j.  v: (m1, n), z: (n,).
    Returns the (m1 + 1, 2) block (float32 on the card): the projection's
    kernels with the columns [z, v_j] (``tuning.gemv_partial_shape(k=2)``;
    the route counted in ``gs_project_norm_partial.routes``: "row" a block
    a row, else the column sweep's "vec" or "scalar")."""
    j = int(j)
    _check(v, z, j, "gs_project_norm_partial")
    if v.device.type == "cpu":
        return gs_project_norm_partial_plain(v, z, j)
    if v.device.type != "cuda":
        raise ValueError(f"gs_project_norm_partial: unsupported device "
                         f"{v.device}")
    _storage("gs_project_norm_partial", v, z)
    if not v.is_contiguous():
        raise ValueError("gs_project_norm_partial: v must be contiguous")
    m1, n = v.shape
    zf = z.to(torch.float32).contiguous()
    plan = tuning.gemv_partial_shape(stream_plan(v, zf, j + 1), j + 1, k=2)
    out = torch.empty((m1 + 1, 2), dtype=torch.float32, device=v.device)
    part = out if plan["by_row"] else torch.empty(
        2 * (m1 + 1) * plan["blocks"], dtype=torch.float32, device=v.device)
    rc = _build.library().repro_sr_payload(
        v.data_ptr(), int(v.dtype == torch.bfloat16), zf.data_ptr(),
        out.data_ptr(), part.data_ptr(), m1, n, j, plan["by_row"],
        plan["threads"], plan["blocks"], plan["unroll"], plan["bucket"],
        plan["pieces"], _build.stream_ptr(v))
    _build.check("gs_project_norm_partial", rc)
    gs_project_norm_partial.launches += 1
    gs_project_norm_partial.routes[
        "row" if plan["by_row"] else plan["route"]] += 1
    return out


gs_project_norm_partial.launches = 0
gs_project_norm_partial.routes = {"vec": 0, "scalar": 0, "row": 0}


def stream_plan(v: torch.Tensor, w: torch.Tensor, rows: int) -> dict:
    """The launch of the streaming GEMV kernels (``gs_update``,
    ``gs_project_partial``, the payload) on basis v (m1, n), reading its
    first ``rows`` rows, and the float32 w it is given: 16-byte pieces
    where v, w and the row stride allow (the output is allocated aligned),
    else the scalar route (``tuning.gemv_stream_shape``)."""
    n = v.shape[1]
    aligned = tuning.stream_aligned((v.data_ptr(), w.data_ptr()),
                                    n * v.element_size(), rows)
    return tuning.gemv_stream_shape(n, v.element_size(), aligned,
                                    tuning.sm_count(v.device))


def gs_update_plain(v: torch.Tensor, w: torch.Tensor, h: torch.Tensor):
    """w - h^T V with the rows summed in order, as the kernel sums them (so
    rows whose h is zero change nothing, to the bit)."""
    acc = torch.promote_types(w.dtype, torch.float32)
    vf, hf = v.to(acc), h.to(acc)
    u = torch.zeros(v.shape[1], dtype=acc, device=v.device)
    for i in range(v.shape[0]):
        u = u + hf[i] * vf[i]
    return (w.to(acc) - u).to(w.dtype)


def gs_update(v: torch.Tensor, w: torch.Tensor, h: torch.Tensor):
    """w' = w - h^T V over every row of v.  v: (m1, n), w: (n,), h: (m1,)
    on v's device.  Returns w' in w's dtype."""
    if v.ndim != 2 or w.shape != (v.shape[1],) or h.shape != (v.shape[0],):
        raise TypeError(f"gs_update: v {tuple(v.shape)}, w {tuple(w.shape)},"
                        f" h {tuple(h.shape)} — need v (m1, n), w (n,) and "
                        f"h (m1,)")
    if w.device != v.device or h.device != v.device:
        raise ValueError(f"gs_update: v on {v.device}, w on {w.device}, "
                         f"h on {h.device}")
    if v.device.type == "cpu":
        return gs_update_plain(v, w, h)
    if v.device.type != "cuda":
        raise ValueError(f"gs_update: unsupported device {v.device}")
    _storage("gs_update", v, w, h)
    if not v.is_contiguous():
        raise ValueError("gs_update: v must be contiguous (row-major)")
    wf = w.to(torch.float32).contiguous()
    plan = stream_plan(v, wf, v.shape[0])
    out = _launch_gs_update(v, wf, h.to(torch.float32).contiguous(), plan)
    gs_update.launches += 1
    gs_update.routes[plan["route"]] += 1
    return out.to(w.dtype)


def _launch_gs_update(v, wf, hf, plan: dict) -> torch.Tensor:
    """The update's kernel at launch shape ``plan`` (``stream_plan``'s)."""
    m1, n = v.shape
    out = torch.empty(n, dtype=torch.float32, device=v.device)
    rc = _build.library().repro_gs_update(
        v.data_ptr(), int(v.dtype == torch.bfloat16), wf.data_ptr(),
        hf.data_ptr(), out.data_ptr(), m1, n, plan["threads"],
        plan["blocks"], plan["unroll"], plan["pieces"], _build.stream_ptr(v))
    _build.check("gs_update", rc)
    return out


gs_update.launches = 0
gs_update.routes = {"vec": 0, "scalar": 0}


# --------------------------------------------------------------------------
# the row-sharded split-phase pair
# --------------------------------------------------------------------------
def gs_project_partial_plain(v: torch.Tensor, w: torch.Tensor, j: int):
    """mask * (V w) over rows 0..j, in float32 or wider."""
    acc = torch.promote_types(w.dtype, torch.float32)
    mask = ref.row_mask(v.shape[0], j, acc, v.device)
    return (v.to(acc) @ w.to(acc)) * mask


def gs_project_partial(v: torch.Tensor, w: torch.Tensor, j: int):
    """One shard's projection h = mask * (V_local w_local) before the
    all-reduce.  v: (m1, n_local), rows 0..j valid; w: (n_local,).
    Returns (m1,) (float32 on the card)."""
    j = int(j)
    _check(v, w, j, "gs_project_partial")
    if v.device.type == "cpu":
        return gs_project_partial_plain(v, w, j)
    if v.device.type != "cuda":
        raise ValueError(f"gs_project_partial: unsupported device "
                         f"{v.device}")
    _storage("gs_project_partial", v, w)
    if not v.is_contiguous():
        raise ValueError("gs_project_partial: v must be contiguous")
    wf = w.to(torch.float32).contiguous()
    plan = tuning.gemv_partial_shape(stream_plan(v, wf, j + 1), j + 1)
    out = _launch_gs_project_partial(v, wf, j, plan)
    gs_project_partial.launches += 1
    gs_project_partial.routes[plan["route"]] += 1
    return out


def _launch_gs_project_partial(v, wf, j: int, plan: dict) -> torch.Tensor:
    """The projection's kernels at launch shape ``plan``
    (``tuning.gemv_partial_shape``'s): a block a row, or the column sweep
    and the fixed-order reduction of its partials."""
    m1, n = v.shape
    out = torch.empty(m1, dtype=torch.float32, device=v.device)
    part = out if plan["by_row"] else torch.empty(
        m1 * plan["blocks"], dtype=torch.float32, device=v.device)
    rc = _build.library().repro_gs_project_partial(
        v.data_ptr(), int(v.dtype == torch.bfloat16), wf.data_ptr(),
        out.data_ptr(), part.data_ptr(), m1, n, j, plan["by_row"],
        plan["threads"], plan["blocks"], plan["unroll"], plan["pieces"],
        _build.stream_ptr(v))
    _build.check("gs_project_partial", rc)
    return out


gs_project_partial.launches = 0
gs_project_partial.routes = {"vec": 0, "scalar": 0}


def cgs2_split(v: torch.Tensor, w: torch.Tensor, j: int, group):
    """Row-sharded CGS2 through the split-phase pair: per pass one
    ``gs_project_partial`` launch, the all-reduce of its (m1,) result over
    ``group`` and one ``gs_update`` launch on the valid rows V[:j+1] (h is
    zero past row j: the same bits as the full update).  Two rounds, the
    collective minimum of the reorthogonalized scheme.  Returns (h, w''):
    h the global Hessenberg column, w'' this shard's rows."""
    j = int(j)
    vp = v[:j + 1]
    h1 = tuning.all_reduce(gs_project_partial(v, w, j), group)
    w1 = gs_update(vp, w, h1[:j + 1])
    h2 = tuning.all_reduce(gs_project_partial(v, w1, j), group)
    w2 = gs_update(vp, w1, h2[:j + 1])
    return (h1 + h2).to(w.dtype), w2
