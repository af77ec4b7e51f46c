"""The model stack of the port: configs, layers, the zamba2 hybrid, the
unified Model API (counterpart of ``repro.models``)."""
from repro_torch.models.config import (SHAPES, ModelConfig, ShapeConfig,
                                       shape_applicable)
from repro_torch.models.model import Model, build, param_count

__all__ = [
    "ModelConfig", "ShapeConfig", "SHAPES", "shape_applicable",
    "Model", "build", "param_count",
]
