"""Reference PyTorch LitePose checkpoints into the port's ``LitePose`` (the
counterpart of ``strip_prefixes``, ``litepose_from_torch`` and
``load_torch_checkpoint`` in ``litepose_tpu/models/torch_convert.py``).

The port's parameter names are the reference layout
(``lib/models/pose_mobilenet.py``), so a reference state
dict loads as it is once the ``module.`` prefix of DDP and the leading
``1.`` of the reference fp16 wrapper are stripped; the keys the model does
not name (a classifier head, say) are left out, as the JAX converter leaves
them.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import torch

from ..arch import ArchConfig
from .convert import entries
from .litepose import LitePose, ModelSpec


def strip_prefixes(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """Strip ``module.`` (DDP) and a leading ``1.`` (fp16 Sequential wrapper)."""
    out = {}
    for k, v in sd.items():
        if k.startswith("module."):
            k = k[len("module."):]
        if re.match(r"^1\.", k):
            k = k[2:]
        out[k] = v
    return out


def state_dict_from_torch(sd: Mapping[str, Any], spec: ModelSpec, arch: ArchConfig,
                          with_skips: bool = True) -> Dict[str, torch.Tensor]:
    """The entries of a reference state dict that the port's ``LitePose``
    holds, prefixes stripped, fp32 (``num_batches_tracked`` int64 zeros
    where missing: eval BN never reads it).  Raises ``KeyError`` for a
    weight the model needs that the state dict lacks."""
    sd = strip_prefixes(sd)
    out = {}
    for name, which, _, _ in entries(spec, arch, with_skips):
        if name in sd:
            v = torch.as_tensor(sd[name])
            out[name] = v.to(torch.float32) if which else v.to(torch.int64)
        elif which:
            raise KeyError(f"reference state dict lacks {name!r}")
        else:
            out[name] = torch.zeros((), dtype=torch.int64)
    return out


def litepose_from_torch(sd: Mapping[str, Any], spec: ModelSpec, arch: ArchConfig,
                        with_skips: bool = True, **model_kw) -> LitePose:
    """A ``LitePose`` in eval mode (BNs folded) holding a reference state
    dict's weights (``state_dict_from_torch``)."""
    model = LitePose(spec, arch, with_skips=with_skips, **model_kw)
    model.load_state_dict(state_dict_from_torch(sd, spec, arch, with_skips), strict=True)
    return model.eval()


def load_torch_checkpoint(path: str):
    """A ``.pth[.tar]`` checkpoint file -> its flat state dict, on the CPU.

    Checkpoints are untrusted content: they load with ``weights_only=True``
    only, so no pickled code runs; a file that needs the full unpickler is
    refused."""
    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    except Exception as e:  # torch raises UnpicklingError or RuntimeError here
        raise RuntimeError(f"{path}: not loadable as weights only (it holds pickled "
                           f"objects, which are refused): {e}") from e
    if isinstance(ckpt, dict):
        for key in ("state_dict", "best_state_dict", "model"):
            if key in ckpt and isinstance(ckpt[key], dict):
                return ckpt[key]
    return ckpt
