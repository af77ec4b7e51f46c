"""Carry the JAX package's objects into the port and results back out:
operators, preconditioners, solver state and results, model parameters.

The two frameworks meet only as numpy arrays: every function here reads its
input with ``np.asarray`` (a JAX array, a numpy array or a CPU tensor all
qualify), so this module needs no JAX import.  bfloat16 crosses through
float32, which holds every bfloat16 value exactly.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.core import givens
from repro_torch.core import preconditioners as pc_mod
from repro_torch.core.operators import (BandedOperator, DenseOperator,
                                        SlicedEllOperator, SparseOperator)

BACKENDS = {"jnp": "torch", "pallas": "cuda"}


def tensor(arr, device="cuda") -> torch.Tensor:
    """A JAX/numpy array (b, x0, a Krylov basis V, ...) as a tensor on
    ``device``, same dtype."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return device_mod.as_tensor(arr.astype(np.float32), device).to(
            torch.bfloat16)
    return device_mod.as_tensor(arr, device)


def dense_operator(op, device="cuda") -> DenseOperator:
    """A JAX ``DenseOperator`` (matrix and backend) as the port's."""
    return DenseOperator(tensor(op.a, device), backend=BACKENDS[op.backend],
                         device=device)


def operator(op, device="cuda"):
    """A JAX explicit operator as the port's, structure kept.

    A dense operator keeps its backend; the port's sparse operators always
    run the SpMV wrappers, so the JAX "jnp" / "pallas" choice is dropped.
    Dispatches on the object's attributes, not its class, so this module
    imports nothing of JAX: ``bin_values``/``bin_cols``/``perm`` is a
    ``SlicedEllOperator`` (all bins, ``perm``, ``halo``, ``slice_height``,
    ``identity_perm``), ``bands``/``offsets`` a ``BandedOperator``,
    ``values``/``cols`` a ``SparseOperator`` (with ``halo``), ``a`` a
    ``DenseOperator``.
    """
    if hasattr(op, "bin_values"):
        return SlicedEllOperator(
            tuple(tensor(v, device) for v in op.bin_values),
            tuple(tensor(c, device) for c in op.bin_cols),
            tensor(op.perm, device), op.halo, op.slice_height,
            op.identity_perm, device=device)
    if hasattr(op, "bands"):
        return BandedOperator(tensor(op.bands, device), op.offsets,
                              device=device)
    if hasattr(op, "values"):
        return SparseOperator(tensor(op.values, device),
                              tensor(op.cols, device), op.halo,
                              device=device)
    if hasattr(op, "a"):
        return dense_operator(op, device)
    raise TypeError(f"convert.operator: {type(op).__name__} has no explicit "
                    f"storage the port knows")


def preconditioner(jax_pc, device="cuda") -> pc_mod.Preconditioner:
    """A JAX preconditioner as the port's member of the same class, its
    state carried as it is (no setup runs again): ``inv_d`` (Jacobi,
    Neumann), ``lu``/``piv`` (block Jacobi; the port's pivots are
    1-based), the interval and recurrence scalars (Chebyshev), the factors
    (ILU(0) and its restrictions).  Members that hold an operator get it
    through ``operator``.  Dispatches on the class name, so this module
    imports nothing of JAX.
    """
    name = type(jax_pc).__name__
    cls = getattr(pc_mod, name, None)
    if not (isinstance(cls, type) and issubclass(cls, pc_mod.Preconditioner)):
        raise TypeError(f"convert.preconditioner: {name} has no counterpart "
                        f"in the port")
    pc = object.__new__(cls)
    pc.n = jax_pc.n
    if hasattr(jax_pc, "op"):
        pc.op = operator(jax_pc.op, device)
    if name in ("JacobiPreconditioner", "NeumannPreconditioner"):
        pc.inv_d = tensor(jax_pc.inv_d, device)
    if name == "NeumannPreconditioner":
        pc.order, pc.omega = jax_pc.order, jax_pc.omega
    if name == "BlockJacobiPreconditioner":
        pc.lu = tensor(jax_pc.lu, device)
        pc.piv = tensor(np.asarray(jax_pc.piv) + 1, device).to(torch.int32)
        pc.block = jax_pc.block
    if name == "ChebyshevPreconditioner":
        for f in ("order", "lam_min", "lam_max", "theta", "delta"):
            setattr(pc, f, getattr(jax_pc, f))
        pc.rhos = tuple((float(r), float(ro)) for r, ro in jax_pc.rhos)
    if hasattr(jax_pc, "l_bands"):
        pc.l_bands = tensor(jax_pc.l_bands, device)
        pc.u_bands = tensor(jax_pc.u_bands, device)
        pc.l_offsets = tuple(int(o) for o in jax_pc.l_offsets)
        pc.u_offsets = tuple(int(o) for o in jax_pc.u_offsets)
        pc.pattern = jax_pc.pattern
    return pc


def model_params(jax_params, cfg, device="cuda") -> dict:
    """The JAX package's zamba2 parameters (``build(cfg).init(key)``) as the
    port's, dtypes kept.  JAX stacks the layers (``groups`` leaves are
    (ng, g, ...), ``tail`` leaves (tail, ...)); the port keeps lists:
    ``groups[i][j]`` and ``tail[t]`` are the layer dicts.  ``shared_attn``
    is one set of weights, used at every site, in both."""
    if cfg.family != "hybrid":
        raise NotImplementedError(f"convert.model_params: the {cfg.family!r} "
                                  f"family is not ported")
    dev = device_mod.resolve(device)
    host = _map(jax_params, np.asarray)

    def take(tree, index):
        return _map(tree, lambda a: tensor(a[index], dev))

    ng, g = host["groups"]["ln"].shape[:2]
    out = {name: take(host[name], ())
           for name in ("embed", "shared_attn", "final_norm", "lm_head")}
    out["groups"] = [[take(host["groups"], (i, j)) for j in range(g)]
                     for i in range(ng)]
    if "tail" in host:
        out["tail"] = [take(host["tail"], (t,))
                       for t in range(host["tail"]["ln"].shape[0])]
    return out


def _map(tree, fn):
    """``fn`` on every leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def givens_state(state) -> givens.GivensState:
    """A JAX ``GivensState`` as the port's host-side state."""
    return givens.GivensState(*(np.array(f) for f in
                                (state.r, state.cs, state.sn, state.g)))


def to_numpy(t) -> np.ndarray:
    """A tensor (any device; bfloat16 widened to float32) or array as numpy."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return np.asarray(t)


def result_to_numpy(res) -> dict:
    """A ``GmresResult`` of either package as a dict of numpy values."""
    out = {f: to_numpy(getattr(res, f))
           for f in ("x", "residual", "restarts", "converged", "inner_steps",
                     "done")}
    if res.diagnostics is not None:
        out["status"] = to_numpy(res.diagnostics.status)
        out["residual_history"] = to_numpy(res.diagnostics.residual_history)
        out["history_len"] = to_numpy(res.diagnostics.history_len)
    return out
