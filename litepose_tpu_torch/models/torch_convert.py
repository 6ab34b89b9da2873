"""Reference PyTorch checkpoints into the port's models (the counterpart of
``strip_prefixes``, ``litepose_from_torch``, ``hrnet_from_torch``,
``efficient_hrnet_from_torch`` and ``load_torch_checkpoint`` in
``litepose_tpu/models/torch_convert.py``).

The port's parameter names are the reference layout
(``lib/models/pose_mobilenet.py``), so a reference state
dict loads as it is once the ``module.`` prefix of DDP and the leading
``1.`` of the reference fp16 wrapper are stripped; the keys the model does
not name (a classifier head, say) are left out, as the JAX converter leaves
them.  HigherHRNet and EfficientHRNet name their parameters as the
reference ``pose_higher_hrnet`` / ``pose_efficient_hrnet`` do, so their
reference state dicts load with ``strict=True`` once the prefixes are
stripped.  LitePose-ResNet has no reference loader: the JAX package sends a
``pose_resnet`` ``.pth`` to ``litepose_from_torch``, which cannot read it
(ROADMAP Queue 3), and the port raises instead (``RESNET_REFERENCE``).
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


RESNET_REFERENCE = ("a reference .pth / .tar for pose_resnet has no loader: the JAX package "
                    "sends it to litepose_from_torch, which needs LitePose keys "
                    "(ROADMAP Queue 3, M10); load a .msgpack instead")


def family_state_dict_from_torch(sd: Mapping[str, Any], model) -> Dict[str, torch.Tensor]:
    """A reference state dict of a baseline family, prefixes stripped, in
    the dtypes of ``model``'s state dict (fp32 weights, int64 counts); the
    keys go to ``load_state_dict(strict=True)`` as they are."""
    own = model.state_dict()
    return {k: torch.as_tensor(v).to(own[k].dtype) if k in own else torch.as_tensor(v)
            for k, v in strip_prefixes(sd).items()}


def _loaded(model, sd: Mapping[str, Any]):
    model.load_state_dict(family_state_dict_from_torch(sd, model), strict=True)
    return model.eval()


def hrnet_from_torch(sd: Mapping[str, Any], spec, **model_kw):
    """A ``HigherHRNet`` in eval mode holding a reference
    ``PoseHigherResolutionNet`` state dict."""
    from .higher_hrnet import HigherHRNet

    return _loaded(HigherHRNet(spec, **model_kw), sd)


def efficient_hrnet_from_torch(sd: Mapping[str, Any], spec, **model_kw):
    """An ``EfficientHRNet`` in eval mode holding a reference
    ``pose_efficient_hrnet`` state dict."""
    from .efficient_hrnet import EfficientHRNet

    return _loaded(EfficientHRNet(spec, **model_kw), sd)
