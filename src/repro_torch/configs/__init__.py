"""Architecture configurations: the port's own copy of the reference's
``repro/configs`` (pure data), so that ``get_config`` resolves the same
names to the same fields in both packages, and ``shapes.py``'s shape
cells resolve the same inputs (``models/api.py::input_specs``)."""
from repro_torch.configs.base import ArchConfig, MoESpec, SSMSpec
from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.configs.shapes import (
    SHAPES,
    ShapeSpec,
    applicable,
    reduced_shape,
)

__all__ = ["ArchConfig", "MoESpec", "SSMSpec", "ARCHS", "get_config",
           "SHAPES", "ShapeSpec", "applicable", "reduced_shape"]
