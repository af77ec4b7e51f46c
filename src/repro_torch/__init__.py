"""PyTorch/CUDA port of ``repro``: the restarted GMRES(m) solver and the
zamba2 serving path of its model stack.

The JAX package ``repro`` is the reference this package is held against;
nothing here imports it (or JAX).  Importing the package pins TF32 off
(see ``repro_torch.device``).
"""
from repro_torch import device  # noqa: F401  (pins TF32 off on import)
