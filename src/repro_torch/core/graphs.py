"""Power-law graph workloads: Laplacians and PageRank-style systems.

Counterpart of ``repro/core/graphs.py``.  The graph model is Chung-Lu with
a pinned hub: node i gets expected degree w_i = max_degree * (i + 1)^(-1 /
(gamma - 1)), edge (i, j) appears with probability min(1, w_i w_j /
sum(w)), and a ring i -- i+1 keeps the graph connected.  The adjacency is
built in numpy from ``seed`` with the JAX package's exact code, so a seed
gives the same graph bit for bit in both packages.

  ``graph_laplacian``  L = D - A + shift*I (SPD).
  ``pagerank_system``  (I - alpha*P) x = (1 - alpha) v with P = A D^-1
      column-stochastic: PageRank as a nonsymmetric linear system; each
      personalization vector v is one right-hand side.

The generators run on the host with dense (n, n) float64 intermediates, as
the JAX package's do (about 0.5 GB each at n = 8192), and return the
operator on ``device`` (default "cuda", raising without a card) in the
caller's ``fmt``; its mat-vec goes through the port's kernel wrappers.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.core.operators import (DenseOperator, SlicedEllOperator,
                                        SparseOperator, with_dtype)


def powerlaw_adjacency(n: int, *, gamma: float = 2.3,
                       max_degree: int | None = None,
                       seed: int = 0) -> np.ndarray:
    """Symmetric 0/1 Chung-Lu adjacency (numpy, deterministic in seed).

    ``max_degree`` defaults to n**0.75 and caps at n - 1.
    """
    if max_degree is None:
        max_degree = int(round(n ** 0.75))
    max_degree = min(int(max_degree), n - 1)
    ranks = np.arange(1, n + 1, dtype=np.float64)
    w = max_degree * ranks ** (-1.0 / (gamma - 1.0))
    prob = np.minimum(np.outer(w, w) / w.sum(), 1.0)
    rng = np.random.default_rng(seed)
    upper = np.triu(rng.random((n, n)) < prob, k=1)
    a = (upper | upper.T).astype(np.float64)
    ring = np.arange(n - 1)
    a[ring, ring + 1] = 1.0
    a[ring + 1, ring] = 1.0
    np.fill_diagonal(a, 0.0)
    return a


def _as_operator(a_np: np.ndarray, fmt: str, dtype, slice_height: int,
                 device):
    # bfloat16 has no numpy dtype: build in float32 (which holds the
    # rounded values exactly) and narrow the value stream afterwards.
    narrow = dtype == torch.bfloat16
    a_np = a_np.astype(np.float32 if narrow
                       else str(dtype).removeprefix("torch."))
    if fmt == "sell":
        op = SlicedEllOperator.from_dense(a_np, slice_height=slice_height,
                                          device=device)
    elif fmt == "ell":
        op = SparseOperator.from_dense(a_np, device=device)
    else:
        op = DenseOperator(a_np, "cuda", device=device)
    return with_dtype(op, dtype) if narrow else op


def _check_fmt(fmt: str) -> None:
    if fmt not in ("sell", "ell", "dense"):
        raise ValueError(f"unknown fmt {fmt!r}; options: sell, ell, dense")


def graph_laplacian(n: int, *, gamma: float = 2.3,
                    max_degree: int | None = None, seed: int = 0,
                    shift: float = 1e-2, dtype=torch.float32,
                    fmt: str = "sell", slice_height: int = 64,
                    device="cuda"):
    """Shifted graph Laplacian L = D - A + shift*I of a power-law graph."""
    _check_fmt(fmt)
    device_mod.resolve(device)
    a = powerlaw_adjacency(n, gamma=gamma, max_degree=max_degree, seed=seed)
    lap = np.diag(a.sum(axis=1) + shift) - a
    return _as_operator(lap, fmt, dtype, slice_height, device)


def pagerank_system(n: int, *, alpha: float = 0.85, gamma: float = 2.3,
                    max_degree: int | None = None, seed: int = 0,
                    dtype=torch.float32, fmt: str = "sell",
                    slice_height: int = 64, device="cuda"):
    """PageRank as a linear system: returns ``(op, make_rhs)``.

    ``op`` applies I - alpha*P (P column-stochastic on the graph);
    ``make_rhs(v)`` turns one personalization vector v (nonnegative,
    normalized here to sum 1) into the right-hand side (1 - alpha) * v on
    the operator's device.  The solution sums to 1 up to solver tolerance.
    """
    if not 0.0 < alpha < 1.0:
        raise ValueError(f"alpha must be in (0, 1), got {alpha}")
    _check_fmt(fmt)
    dev = device_mod.resolve(device)
    a = powerlaw_adjacency(n, gamma=gamma, max_degree=max_degree, seed=seed)
    deg = a.sum(axis=0)
    p_mat = a / np.maximum(deg, 1.0)[None, :]
    m = np.eye(n) - alpha * p_mat
    op = _as_operator(m, fmt, dtype, slice_height, dev)

    def make_rhs(v):
        v = device_mod.as_tensor(v, dev).to(dtype)
        v = v / torch.sum(v)
        return (1.0 - alpha) * v

    return op, make_rhs
