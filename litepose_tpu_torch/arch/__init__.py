"""Architecture descriptors and the zoo of published LitePose archs."""

from .macs import count_litepose_macs, gmacs
from .manager import ArchManager
from .schema import ArchConfig, StageConfig, load_arch, make_divisible, save_arch, validate_arch
from .zoo import ARCH_ZOO, get_arch

__all__ = ["ARCH_ZOO", "ArchConfig", "ArchManager", "StageConfig", "count_litepose_macs",
           "get_arch", "gmacs", "load_arch", "make_divisible", "save_arch", "validate_arch"]
