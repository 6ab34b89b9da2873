"""Weight bridge from the JAX pytrees to the port's ``LitePose`` (counterpart
of ``litepose_to_torch`` in ``litepose_tpu/models/torch_convert.py``).

Layouts: a conv kernel is HWIO in JAX and OIHW here; a transposed-conv
kernel is stored spatially flipped HWIO in JAX (the lhs-dilated-conv form)
and IOHW here (``nn.ConvTranspose2d``); BN ``scale/bias/mean/var`` become
``weight/bias/running_mean/running_var``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from litepose_tpu.arch.schema import ArchConfig

from .litepose import LitePose, ModelSpec


def _conv_w(w) -> np.ndarray:
    """HWIO -> OIHW."""
    return np.asarray(w, np.float32).transpose(3, 2, 0, 1)


def _deconv_w(w) -> np.ndarray:
    """Flipped HWIO -> IOHW."""
    return np.asarray(w, np.float32)[::-1, ::-1].transpose(2, 3, 0, 1)


def state_dict_from_jax(params, state, spec: ModelSpec, arch: ArchConfig,
                        with_skips: bool = True) -> Dict[str, torch.Tensor]:
    """JAX (params, state) pytrees with numpy leaves -> the port's state
    dict (fp32 tensors; ``num_batches_tracked`` zeros, which eval BN never
    reads)."""
    sd: Dict[str, Any] = {}

    def put_bn(prefix, p_bn, s_bn):
        sd[f"{prefix}.weight"] = np.asarray(p_bn["scale"], np.float32)
        sd[f"{prefix}.bias"] = np.asarray(p_bn["bias"], np.float32)
        sd[f"{prefix}.running_mean"] = np.asarray(s_bn["mean"], np.float32)
        sd[f"{prefix}.running_var"] = np.asarray(s_bn["var"], np.float32)
        sd[f"{prefix}.num_batches_tracked"] = np.zeros((), np.int64)

    def put_conv_bn(prefix, p, s):
        sd[f"{prefix}.0.weight"] = _conv_w(p["conv"]["w"])
        put_bn(f"{prefix}.1", p["bn"], s["bn"])

    first_p, first_s = params["first"], state["first"]
    put_conv_bn("first.0", first_p["cbr0"], first_s["cbr0"])
    put_conv_bn("first.1", first_p["cbr1"], first_s["cbr1"])
    sd["first.2.weight"] = _conv_w(first_p["conv2"]["w"])
    put_bn("first.3", first_p["bn2"], first_s["bn2"])

    for si, st in enumerate(arch.backbone_setting):
        for bi in range(st.num_blocks):
            bp, bs = params["stage"][si][bi], state["stage"][si][bi]
            for ours, theirs in (("inv", "inv"), ("depth", "depth_conv"),
                                 ("point", "point_conv")):
                put_conv_bn(f"stage.{si}.{bi}.{theirs}", bp[ours], bs[ours])

    for i in range(spec.num_deconv_layers):
        sd[f"deconv_refined.{i}.weight"] = _deconv_w(params["deconv_refined"][i]["w"])
        if with_skips:
            sd[f"deconv_raw.{i}.weight"] = _deconv_w(params["deconv_raw"][i]["w"])
        put_bn(f"deconv_bnrelu.{i}.0", params["deconv_bn"][i], state["deconv_bn"][i])

    heads = ("final_refined", "final_raw") if with_skips else ("final_refined",)
    for i in range(spec.num_deconv_layers - 1):
        for head in heads:
            p, s = params[head][i], state[head][i]
            sd[f"{head}.{i}.conv.0.weight"] = _conv_w(p["dw"]["conv"]["w"])
            put_bn(f"{head}.{i}.conv.1", p["dw"]["bn"], s["dw"]["bn"])
            sd[f"{head}.{i}.conv.3.weight"] = _conv_w(p["pw"]["conv"]["w"])

    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def litepose_from_jax(params, state, spec: ModelSpec, arch: ArchConfig,
                      with_skips: bool = True, **model_kw) -> LitePose:
    """Build a ``LitePose`` in eval mode, load the JAX weights into it with
    ``strict=True`` and fold its BNs."""
    model = LitePose(spec, arch, with_skips=with_skips, **model_kw)
    model.load_state_dict(
        state_dict_from_jax(params, state, spec, arch, with_skips), strict=True)
    return model.eval().fold_bn_()
