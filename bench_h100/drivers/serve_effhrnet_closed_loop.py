"""Closed-loop serving of an EfficientHRNet: one client hands ``batch`` uint8
images at a time to ``PoseEngine.process_batch_square`` and waits for the
people.  The loop, the kept maps, the traced window and the notes are
``serve_hrnet_closed_loop.py``'s ``run``, taken as it is from a private
copy of that module whose three model hooks (``require_folding``,
``_engine``, ``_check``) are this module's; the model is built from the
configuration (``cfg["effhrnet"]``) and a seed, not read from a checkpoint.

Traffic parameters (``traffic/<name>.json``): those of the HigherHRNet
driver.

The weights (``weights``): a state dict by the reference's parameter
names, every tensor drawn with numpy from the configuration's
``weights_seed`` at the shapes ``harness/effhrnet_macs.py`` lists from the
configuration (not through the port's modules): each conv in the JAX fan-in
uniform law (the final layers' at ``head_scale`` times it, so that the fp32
reference's maps are of order 1), each conv's own bias N(0, 0.2), every
BN's affine and statistics off the identity, and each joint's heatmap bias
in every final layer set to the configuration's ``heatmap_bias_shift``
(computed once on the card from the fp32 reference, ``heatmap_bias_shift``,
``tools/calibrate_effhrnet.py --shift``, and committed).  The port loads the
state dict with ``strict=True``, so a layer of another shape fails the run,
and the reference (``reference/efficient_hrnet.py``) gets the same tensors.

The engine runs in the serving form of the other cells; the model folds its
BNs at eval (``fold_bn_``), and a port whose EfficientHRNet does not fold,
or whose kernels lack Swish, fails the run at once.
"""

from __future__ import annotations

import importlib.util
import math
import os
import time
from typing import Dict, List

import numpy as np

from harness import effhrnet_macs, scenes
from harness.core import Check

HERE = os.path.dirname(os.path.abspath(__file__))
BN_DRAWS = (("weight", "uniform", 0.5, 1.5), ("bias", "normal", 0.0, 0.2),
            ("running_mean", "normal", 0.0, 0.2), ("running_var", "uniform", 0.5, 1.5))


def effhrnet_spec(cfg: Dict):
    """The port's ``EffHRNetSpec`` of the configuration."""
    from litepose_tpu_torch.models.efficient_hrnet import EffHRNetSpec
    from litepose_tpu_torch.models.higher_hrnet import StageSpec

    eff, dc = cfg["effhrnet"], cfg["effhrnet"]["deconv"]
    stages = [StageSpec(s["num_modules"], s["num_branches"], s["block"], tuple(s["num_blocks"]),
                        tuple(s["num_channels"])) for s in eff["stages"]]
    return EffHRNetSpec(num_joints=cfg["num_joints"], tag_per_joint=cfg["tag_per_joint"],
                        with_ae_loss=tuple(cfg["with_ae"]), width_mult=eff["width_mult"],
                        depth_mult=eff["depth_mult"], scale_factor=eff["scale_factor"],
                        final_conv_kernel=eff["final_conv_kernel"], stage2=stages[0],
                        stage3=stages[1], stage4=stages[2], num_deconvs=dc["num_deconvs"],
                        deconv_channels=tuple(dc["num_channels"]),
                        deconv_kernels=tuple(dc["kernel_size"]),
                        deconv_num_basic_blocks=dc["num_basic_blocks"],
                        cat_output=tuple(dc["cat_output"]))


def weights(cfg: Dict, shift=None) -> Dict:
    """The cell's fp32 state dict on the CPU, by the reference's parameter
    names, as the module docstring says: each conv of ``effhrnet_macs``
    uniform in +-sqrt(3 / fan_in), fan_in ``k*k*cin/groups`` (``k*k*cout``
    for the transposed conv), times ``head_scale`` for a final layer; each
    conv's own bias N(0, 0.2), but the final layers', which are 0 save the
    heatmaps', ``shift`` (the configuration's ``heatmap_bias_shift`` where
    None); each BN by ``BN_DRAWS``."""
    import torch

    rng = np.random.default_rng(cfg["weights_seed"])
    J = cfg["num_joints"]
    shift = np.asarray(cfg["heatmap_bias_shift"] if shift is None else shift, np.float32)
    sd = {}
    for c in effhrnet_macs.conv_layers(cfg):
        final = c.name.startswith("final_layers.")
        if c.transposed:
            shape, fan_in = (c.cin, c.cout, c.k, c.k), c.k * c.k * c.cout
        else:
            shape, fan_in = (c.cout, c.cin // c.groups, c.k, c.k), c.k * c.k * c.cin // c.groups
        bound = math.sqrt(3.0 / fan_in) * (cfg["head_scale"] if final else 1.0)
        sd[c.name + ".weight"] = rng.uniform(-bound, bound, shape).astype(np.float32)
        if final:
            bias = np.zeros(c.cout, np.float32)
            bias[:J] = shift
            sd[c.name + ".bias"] = bias
        elif effhrnet_macs.biased(c):
            sd[c.name + ".bias"] = rng.normal(0.0, 0.2, c.cout).astype(np.float32)
        bn = effhrnet_macs.bn_of(c)
        if bn is not None:
            for name, law, a, b in BN_DRAWS:
                sd[f"{bn}.{name}"] = getattr(rng, law)(a, b, c.cout).astype(np.float32)
    sd = {k: torch.from_numpy(v) for k, v in sd.items()}
    for bn in {k[:-len(".running_mean")] for k in sd if k.endswith(".running_mean")}:
        sd[bn + ".num_batches_tracked"] = torch.tensor(0)
    return sd


def reference(sd, cfg: Dict, dev, precision: str = "fp32"):
    """The plain reference of the cell's model on ``dev``."""
    from reference.efficient_hrnet import Reference

    return Reference(sd, cfg["effhrnet"], cfg["num_joints"], dev, precision=precision)


def heatmap_bias_shift(cfg: Dict, dev) -> List[float]:
    """Per joint, the heatmap bias that leaves ``peak_share`` of each plane
    of the fp32 reference's aggregated maps above the detection threshold,
    on ``peak_scenes`` scenes drawn from ``weights_seed``: the
    configuration's ``heatmap_bias_shift``, computed on the card."""
    import torch

    from reference.efficient_hrnet import peak_shift

    ref = reference(weights(cfg, shift=np.zeros(cfg["num_joints"])), cfg, dev)
    images, _ = scenes.scene_batch(cfg["peak_scenes"], cfg["input_size"], cfg["weights_seed"],
                                   cfg["num_joints"])
    det = torch.cat([ref.maps(torch.from_numpy(images[lo:lo + 16]))[0]
                     for lo in range(0, len(images), 16)])
    return peak_shift(det, cfg["peak_share"], cfg["detection_threshold"]).tolist()


def require_folding() -> None:
    """Raise at once where the port's EfficientHRNet keeps its BNs unfolded
    at eval or its conv kernels lack Swish: the cell serves the folded model
    on K6 and K7."""
    from litepose_tpu_torch.models.efficient_hrnet import EfficientHRNet
    from litepose_tpu_torch.models.layers import FoldsBN
    from litepose_tpu_torch.ops.depthwise import ACTS

    if not issubclass(EfficientHRNet, FoldsBN) or "silu" not in ACTS:
        raise RuntimeError("this port's EfficientHRNet does not fold its BNs at eval, or its "
                           "depthwise and epilogue kernels lack Swish: the cell serves the "
                           "folded model on them")


def _engine(cfg, dev):
    import torch

    from litepose_tpu_torch.core.engine import EngineConfig, PoseEngine
    from litepose_tpu_torch.core.inference import InferenceFlags
    from litepose_tpu_torch.models.efficient_hrnet import EfficientHRNet
    from litepose_tpu_torch.ops.group import GroupParams

    sd = weights(cfg)
    model = EfficientHRNet(effhrnet_spec(cfg), compute_dtype=getattr(torch, cfg["compute_dtype"]),
                           out_dtype=getattr(torch, cfg["maps_dtype"]))
    model.load_state_dict(sd)
    model = model.to(dev).eval()  # eval folds the BNs on the card
    J = cfg["num_joints"]
    flags = InferenceFlags(num_joints=J, with_heatmaps_loss=tuple(cfg["with_heatmaps"]),
                           with_ae_loss=tuple(cfg["with_ae"]),
                           test_with_heatmaps=tuple(cfg["with_heatmaps"]),
                           test_with_ae=tuple(cfg["with_ae"]),
                           tag_per_joint=cfg["tag_per_joint"], flip_test=False)
    group = GroupParams(num_joints=J, max_num_people=cfg["max_people"],
                        detection_threshold=cfg["detection_threshold"],
                        tag_threshold=cfg["tag_threshold"],
                        use_detection_val=cfg["use_detection_val"],
                        nms_kernel=cfg["nms_kernel"], nms_padding=cfg["nms_kernel"] // 2,
                        joint_order=list(cfg["joint_order"]), max_clusters=cfg["max_clusters"])
    config = EngineConfig(input_size=cfg["input_size"], assignment="greedy",
                          topk_method="approx", with_adjust=False, with_refine=False,
                          project2image=False, decode_bf16=cfg["maps_dtype"] == "bfloat16")
    return PoseEngine(model, flags, group, config, device=dev), sd


def _check(cfg, sd, batches, kept, dev, notes):
    """After the window: the checked calls against the reference."""
    import torch

    from reference.check import numbers

    done = sorted(k for k, v in kept.items() if len(v) == 5)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    images = np.concatenate([batches[k] for k in done])
    det = torch.cat([kept[k][0] for k in done])
    tag = torch.cat([kept[k][1] for k in done])
    people, scores, counts = (np.concatenate([kept[k][2 + i] for k in done]) for i in range(3))
    t0 = time.perf_counter()
    got = numbers(reference(sd, cfg, dev), cfg, images, det, tag, people, scores, counts)
    notes.append(f"checked {len(images)} images of {len(done)} calls in "
                 f"{time.perf_counter() - t0:.3f} s")
    return [Check(name, got[name], float(limit)) for name, limit in cfg["limits"].items()]


def _loop():
    """A private copy of ``serve_hrnet_closed_loop``, its model hooks this
    module's."""
    spec = importlib.util.spec_from_file_location(
        "bench_driver_serve_effhrnet_loop", os.path.join(HERE, "serve_hrnet_closed_loop.py"))
    loop = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(loop)
    loop.require_folding, loop._engine, loop._check = require_folding, _engine, _check
    return loop


def run(ctx):
    return _loop().run(ctx)
