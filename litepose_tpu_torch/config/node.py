"""A minimal hierarchical config node (yacs-free).

The reference uses yacs ``CfgNode`` (``lib/config/default.py``);
yacs is not available here, so this is a small, dependency-free equivalent
supporting the same workflow: a default tree, ``merge_from_file`` (YAML),
``merge_from_list`` (``KEY.SUBKEY value`` CLI pairs), freeze/defrost, and
attribute access.
"""

from __future__ import annotations

import ast
import copy
from typing import Any, Dict, List

from . import yaml_subset


def _coerce(value: Any, default: Any) -> Any:
    """Match a YAML value to the default's type where that is lossless.

    YAML 1.1 loads exponent floats without a mantissa dot (``4e-3``) as
    strings; reference experiment YAMLs use that form for LR/WD, so numeric
    strings merging onto numeric defaults are converted."""
    if isinstance(value, str) and isinstance(default, (int, float)) \
            and not isinstance(default, bool):
        try:
            f = float(value)
        except ValueError:
            return value
        return int(f) if isinstance(default, int) and f == int(f) else f
    return value


class ConfigNode(dict):
    """Attribute-accessible dict with freeze support."""

    _FROZEN = "_is_frozen"

    def __init__(self, d: Dict[str, Any] | None = None):
        super().__init__()
        object.__setattr__(self, ConfigNode._FROZEN, False)
        if d:
            for k, v in d.items():
                self[k] = ConfigNode(v) if isinstance(v, dict) else v

    # -- attribute protocol ---------------------------------------------------

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        if object.__getattribute__(self, ConfigNode._FROZEN):
            raise AttributeError(f"config is frozen; cannot set {name}")
        self[name] = value

    # -- freezing ---------------------------------------------------------------

    def freeze(self) -> "ConfigNode":
        object.__setattr__(self, ConfigNode._FROZEN, True)
        for v in self.values():
            if isinstance(v, ConfigNode):
                v.freeze()
        return self

    def defrost(self) -> "ConfigNode":
        object.__setattr__(self, ConfigNode._FROZEN, False)
        for v in self.values():
            if isinstance(v, ConfigNode):
                v.defrost()
        return self

    def clone(self) -> "ConfigNode":
        c = ConfigNode()
        for k, v in self.items():
            c[k] = v.clone() if isinstance(v, ConfigNode) else copy.deepcopy(v)
        return c

    # -- merging ---------------------------------------------------------------

    def merge_from_dict(self, d: Dict[str, Any], allow_new: bool = True) -> None:
        for k, v in d.items():
            if isinstance(v, dict):
                if k not in self or not isinstance(self[k], ConfigNode):
                    if not allow_new and k not in self:
                        raise KeyError(f"unknown config key: {k}")
                    self[k] = ConfigNode()
                self[k].merge_from_dict(v, allow_new=allow_new)
            else:
                self[k] = _coerce(v, self.get(k))

    def merge_from_file(self, path: str, allow_new: bool = True) -> None:
        with open(path) as f:
            d = yaml_subset.loads(f.read(), path) or {}
        self.merge_from_dict(d, allow_new=allow_new)

    def merge_from_list(self, opts: List[str]) -> None:
        """Merge ``[KEY, value, KEY, value, ...]`` CLI overrides."""
        assert len(opts) % 2 == 0, f"opts must be KEY VALUE pairs, got {opts}"
        for key, raw in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                node = node[p]
            try:
                value = ast.literal_eval(raw)
            except (ValueError, SyntaxError):
                value = raw
            node[parts[-1]] = value

    def to_dict(self) -> Dict[str, Any]:
        return {
            k: (v.to_dict() if isinstance(v, ConfigNode) else v)
            for k, v in self.items()
        }

    def dump(self) -> str:
        return yaml_subset.dumps(self.to_dict())
