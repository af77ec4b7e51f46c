"""PyTorch/CUDA port of the restarted GMRES(m) solver in ``repro``.

The JAX package ``repro`` is the reference this package is held against;
nothing here imports it (or JAX).  Importing the package pins TF32 off
(see ``repro_torch.device``).
"""
from repro_torch import device  # noqa: F401  (pins TF32 off on import)
