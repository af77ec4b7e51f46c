"""Linear operators for the solver: dense matrices and matrix-free callables.

Counterpart of ``repro/core/operators.py`` (``DenseOperator``,
``FunctionOperator``, ``as_operator`` and the test matrices).  The sparse,
banded and sliced-ELL operators come with a later slice.

``DenseOperator(backend=...)`` selects the mat-vec path:

  "torch" — ``a @ v`` (the plain path; JAX's "jnp")
  "cuda"  — the hand-written GEMV / multi-RHS kernel
            (``kernels/matvec.py``, ``csrc/matvec.cu``; JAX's "pallas").
            On a CPU tensor the kernel wrapper runs its plain version.

Constructors default to ``device="cuda"`` and raise without a card unless
the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.kernels import matvec as matvec_k

BACKENDS = ("torch", "cuda")


class DenseOperator:
    """Explicit dense (n, n) matrix operator (the paper's setting)."""

    def __init__(self, a, backend: str = "torch", device="cuda"):
        if backend not in BACKENDS:
            raise ValueError(f"DenseOperator: backend {backend!r} not in "
                             f"{BACKENDS}")
        self.a = device_mod.as_tensor(a, device)
        self.backend = backend

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        # v: (n,) or (n, k)
        if self.backend == "cuda":
            if v.ndim == 1:
                return matvec_k.matvec(self.a, v)
            return matvec_k.block_matvec(self.a, v)
        dt = torch.promote_types(self.a.dtype, v.dtype)
        return self.a.to(dt) @ v.to(dt)

    @property
    def shape(self):
        return tuple(self.a.shape)

    @property
    def dtype(self):
        return self.a.dtype


@dataclasses.dataclass
class FunctionOperator:
    """Matrix-free operator ``v -> A @ v``; ``captures`` are extra args."""

    fn: Callable[..., torch.Tensor]
    n: int
    captures: Any = ()

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        return self.fn(v, *self.captures) if self.captures else self.fn(v)

    @property
    def shape(self):
        return (self.n, self.n)


EXPLICIT_OPERATORS = (DenseOperator,)


def as_operator(a, device="cuda") -> Callable[[torch.Tensor], torch.Tensor]:
    """Normalize ``a`` to a matvec callable.

    Operators and callables pass through; a raw matrix becomes a
    ``DenseOperator`` on the "torch" backend on ``device``.
    """
    if isinstance(a, EXPLICIT_OPERATORS + (FunctionOperator,)) or callable(a):
        return a
    return DenseOperator(a, device=device)


def poisson_1d(n: int, dtype=torch.float32, device="cuda") -> torch.Tensor:
    """Dense 1-D Poisson (tridiagonal) test matrix."""
    dev = device_mod.resolve(device)
    ones = torch.ones(n - 1, dtype=dtype, device=dev)
    return (2.0 * torch.eye(n, dtype=dtype, device=dev)
            - torch.diag(ones, 1) - torch.diag(ones, -1))


def convection_diffusion(n: int, beta: float = 0.5, dtype=torch.float32,
                         device="cuda") -> torch.Tensor:
    """Nonsymmetric convection-diffusion matrix."""
    dev = device_mod.resolve(device)
    ones = torch.ones(n - 1, dtype=dtype, device=dev)
    return (2.0 * torch.eye(n, dtype=dtype, device=dev)
            + (-1.0 + beta) * torch.diag(ones, 1)
            + (-1.0 - beta) * torch.diag(ones, -1))


def random_diagdom(n: int, dtype=torch.float32, *, dominance: float = 2.0,
                   seed: int = 0, device="cuda") -> torch.Tensor:
    """Random nonsymmetric diagonally-dominant matrix.

    The JAX package's construction, ``N(0,1)/sqrt(n) + diag(dominance *
    rowsum|.|)``, drawn from a numpy seed (``jax.random`` streams cannot be
    reproduced, so parity tests bridge the JAX-built matrix instead).
    """
    dev = device_mod.resolve(device)
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n), dtype=np.float32)
    a /= np.float32(np.sqrt(n))
    rowsum = np.abs(a).sum(axis=1)
    a[np.diag_indices(n)] += np.float32(dominance) * rowsum
    return torch.from_numpy(a).to(device=dev, dtype=dtype)
