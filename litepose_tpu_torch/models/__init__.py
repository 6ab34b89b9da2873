"""LitePose and the baseline families (HigherHRNet, EfficientHRNet,
LitePose-ResNet) as ``nn.Module``s, their seeded inits, the weight bridges
to and from the JAX pytrees and the reference state dicts, and the
``MODEL.NAME`` registry (the counterpart of ``litepose_tpu/models/__init__.py``)."""

from __future__ import annotations

from typing import Tuple

import torch

# the families the port does not have yet, with the ROADMAP item that ports them
_WAITING = {
    "pose_superresnet": "M9 (the NAS supernet's ResNet search space, with M10)",
}
# name -> with_skips of the LitePose it builds
_LITEPOSE = {"pose_mobilenet": True, "pose_simplenet": False}
# the baseline families, which need no arch
FAMILIES = ("pose_higher_hrnet", "pose_efficient_hrnet", "pose_resnet")


def available() -> Tuple[str, ...]:
    return tuple(sorted([*_LITEPOSE, "pose_supermobilenet", *FAMILIES]))


def _family(name: str, cfg, generator: torch.Generator, **model_kw):
    """A freshly initialized baseline family model of ``cfg``."""
    if name == "pose_higher_hrnet":
        from .higher_hrnet import HRNetSpec, init_higher_hrnet

        return init_higher_hrnet(HRNetSpec.from_config(cfg), generator, **model_kw)
    if name == "pose_efficient_hrnet":
        from .efficient_hrnet import EffHRNetSpec, init_efficient_hrnet

        return init_efficient_hrnet(EffHRNetSpec.from_config(cfg), generator, **model_kw)
    from .litepose import ModelSpec
    from .litepose_resnet import init_litepose_resnet

    return init_litepose_resnet(ModelSpec.from_config(cfg), generator,
                                cfg.MODEL.EXTRA.NUM_DECONV_FILTERS, **model_kw)


def get_model(name: str, cfg, arch=None, device="cuda", seed: int = 0,
              compute_dtype: torch.dtype = torch.bfloat16,
              out_dtype: torch.dtype = torch.float32):
    """The model ``MODEL.NAME`` names, for ``arch``, drawn from ``seed``
    (``models.litepose.init_litepose``) and put in eval mode on ``device``.

    ``pose_mobilenet`` is LitePose; ``pose_simplenet`` is LitePose without
    its raw/skip fusion branches; ``pose_supermobilenet`` is the NAS
    supernet (``models.super_litepose``) of the search space whose deconv
    widths are ``MODEL.EXTRA.NUM_DECONV_FILTERS``, which ignores ``arch``
    and runs the max arch unless ``forward`` gets another desc.
    ``pose_higher_hrnet``, ``pose_efficient_hrnet`` and ``pose_resnet`` are
    the baseline families (``models.higher_hrnet``, ``efficient_hrnet``,
    ``litepose_resnet``), built from ``cfg`` alone.  ``pose_superresnet``
    raises ``NotImplementedError`` naming its ROADMAP item.  After loading
    weights into a returned model that has ``fold_bn_()``, call it."""
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
    if name in FAMILIES:
        model = _family(name, cfg, torch.Generator().manual_seed(seed),
                        compute_dtype=compute_dtype, out_dtype=out_dtype)
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
