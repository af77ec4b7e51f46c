"""Carry the JAX package's objects into the port and results back out.

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
