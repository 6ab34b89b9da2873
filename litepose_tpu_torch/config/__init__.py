from .node import ConfigNode
from .defaults import default_config, update_config, check_config

__all__ = ["ConfigNode", "default_config", "update_config", "check_config"]
