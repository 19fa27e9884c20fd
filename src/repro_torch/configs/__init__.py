"""Architecture & shape configurations: the dataclasses, the four shape
cells and the ten published model configs, resolved by name with
``get_arch``."""
from repro_torch.configs.base import (
    ALL_ARCH_MODULES, SHAPES, ArchConfig, MLAConfig, MoEConfig, ShapeConfig,
    SSMConfig, get_arch, list_archs, register,
)

__all__ = [
    "ALL_ARCH_MODULES", "SHAPES", "ArchConfig", "MLAConfig", "MoEConfig",
    "ShapeConfig", "SSMConfig", "get_arch", "list_archs", "register",
]
