"""Where the port runs: device resolution and the f32 numerics pin.

Counterpart of ``repro/kernels/tuning.py::kernel_mode``.  The JAX package
picks an execution mode (compiled / interpret / ref) from the backend; the
port has no such ladder.  The mode is the tensor's device: a CUDA tensor
launches the hand-written kernels, a CPU tensor takes their plain PyTorch
versions.  Entry points default to ``device="cuda"`` and raise when no card
is present, so a missing GPU never silently turns into a CPU run.
"""
from __future__ import annotations

import numpy as np
import torch

# The f32 parity contract (rtol 3e-5 against the JAX package) needs full
# float32 products.  TF32 keeps ~3 decimal digits, so a cuBLAS or cuDNN call
# in TF32 would break parity without any error; pin both off for the process.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve(device="cuda") -> torch.device:
    """Return ``torch.device(device)``; raise if it names a missing card."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch: no CUDA device is present; pass device='cpu' "
                "to run the plain PyTorch path on the host")
    elif dev.type != "cpu":
        raise ValueError(f"repro_torch runs on 'cuda' or 'cpu', got {dev}")
    return dev


def as_tensor(x, device="cuda") -> torch.Tensor:
    """``x`` (tensor, numpy array or nested list) as a tensor on ``device``.

    A read-only numpy array (what ``np.asarray`` of a JAX array gives) is
    copied first: PyTorch does not support tensors over read-only memory.
    """
    if isinstance(x, np.ndarray):
        x = np.require(x, requirements=["C", "W"])
    return torch.as_tensor(x, device=resolve(device))
