"""Architecture descriptors and the zoo of published LitePose archs."""

from .manager import ArchManager
from .schema import ArchConfig, StageConfig, load_arch, make_divisible, validate_arch
from .zoo import ARCH_ZOO, get_arch

__all__ = ["ARCH_ZOO", "ArchConfig", "ArchManager", "StageConfig", "get_arch", "load_arch",
           "make_divisible", "validate_arch"]
