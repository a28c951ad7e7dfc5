"""Architecture configurations: the port's own copy of the reference's
``repro/configs`` (pure data), so that ``get_config`` resolves the same
names to the same fields in both packages. ``shapes.py`` (the dry-run's
shape cells) is not copied: the port has no dry run yet."""
from repro_torch.configs.base import ArchConfig, MoESpec, SSMSpec
from repro_torch.configs.registry import ARCHS, get_config

__all__ = ["ArchConfig", "MoESpec", "SSMSpec", "ARCHS", "get_config"]
