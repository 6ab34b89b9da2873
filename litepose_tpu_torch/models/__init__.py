"""LitePose as ``nn.Module``s, its seeded init, the weight bridges to and
from the JAX pytrees and the reference state dicts, and the ``MODEL.NAME``
registry (the counterpart of ``litepose_tpu/models/__init__.py``)."""

from __future__ import annotations

from typing import Tuple

import torch

# the families the port does not have yet, with the ROADMAP item that ports them
_WAITING = {
    "pose_resnet": "M10 (baseline families)",
    "pose_superresnet": "M10 (baseline families) and M9 (the NAS supernet)",
    "pose_higher_hrnet": "M10 (baseline families)",
    "pose_efficient_hrnet": "M10 (baseline families)",
}
# name -> with_skips of the LitePose it builds
_LITEPOSE = {"pose_mobilenet": True, "pose_simplenet": False}


def available() -> Tuple[str, ...]:
    return tuple(sorted([*_LITEPOSE, "pose_supermobilenet"]))


def get_model(name: str, cfg, arch=None, device="cuda", seed: int = 0,
              compute_dtype: torch.dtype = torch.bfloat16,
              out_dtype: torch.dtype = torch.float32):
    """The model ``MODEL.NAME`` names, for ``arch``, drawn from ``seed``
    (``models.litepose.init_litepose``) and put in eval mode on ``device``.

    ``pose_mobilenet`` is LitePose; ``pose_simplenet`` is LitePose without
    its raw/skip fusion branches; ``pose_supermobilenet`` is the NAS
    supernet (``models.super_litepose``) of the search space whose deconv
    widths are ``MODEL.EXTRA.NUM_DECONV_FILTERS``, which ignores ``arch``
    and runs the max arch unless ``forward`` gets another desc.  The families the port does not have yet
    raise ``NotImplementedError`` naming their ROADMAP item.  After loading
    weights into the returned model, call its ``fold_bn_()``."""
    from .litepose import ModelSpec, init_litepose

    if name == "pose_supermobilenet":
        from ..arch import ArchManager
        from .super_litepose import SuperDims, init_super_litepose

        dims = SuperDims.from_manager(ArchManager(
            deconv_setting=cfg.MODEL.EXTRA.NUM_DECONV_FILTERS))
        model = init_super_litepose(ModelSpec.from_config(cfg), dims,
                                    torch.Generator().manual_seed(seed),
                                    compute_dtype=compute_dtype)
        return model.to(device).eval()
    if name in _WAITING:
        raise NotImplementedError(f"model {name!r} is not ported yet: ROADMAP {_WAITING[name]}")
    if name not in _LITEPOSE:
        raise KeyError(f"unknown model {name!r}; available: {list(available())}")
    if arch is None:
        raise ValueError(f"{name} needs an arch descriptor")
    model = init_litepose(ModelSpec.from_config(cfg), arch,
                          torch.Generator().manual_seed(seed), with_skips=_LITEPOSE[name],
                          compute_dtype=compute_dtype, out_dtype=out_dtype)
    return model.to(device).eval()
