"""Launch layer of the port: step factories and the serving driver
(counterpart of ``repro.launch``, one card, no mesh)."""
from repro_torch.launch.steps import make_prefill_step, make_serve_step

__all__ = ["make_prefill_step", "make_serve_step"]
