"""Evaluation CLI: OKS AP of a pose model (LitePose or a baseline family:
HigherHRNet, EfficientHRNet, LitePose-ResNet) on a COCO / CrowdPose split on
disk (the counterpart of ``tools/valid.py``; the reference ``valid.py``
flow, the batched eval protocol on the card).

  python -m litepose_tpu_torch.tools.valid --cfg configs/crowd_pose/mobilenet/mobile.yaml \\
      --superconfig arch.json TEST.MODEL_FILE path/to/weights.pth.tar

Arguments and outputs are ``tools/valid.py``'s: the run directory
``OUTPUT_DIR/<dataset>/<model>/<cfg name>`` with the log and
``keypoint_results.json``, and the markdown AP table.  Weights come from
``TEST.MODEL_FILE``: a ``.pth`` / ``.tar`` reference state dict
(``models.torch_convert``; none exists for ``pose_resnet``, which raises)
or a ``.msgpack`` checkpoint of either package (``train.checkpoint.load_params``).  ``TPU.COMPUTE_DTYPE`` is the model's
conv compute type (``bfloat16``, the JAX CLI's policy, or ``float32``).

``--device cuda`` (the default) runs the kernels on the card and raises
without one; ``--device cpu`` runs their plain twins.  ``--batch-size 1``
runs the per-image loop (``PoseEngine.process``), more drives
``process_indexed``.  Only one device: ``--devices`` above 1 raises.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def compute_dtype(cfg) -> torch.dtype:
    """``TPU.COMPUTE_DTYPE`` as a torch dtype (the CLIs' conv compute type)."""
    if cfg.TPU.COMPUTE_DTYPE not in _DTYPES:
        raise ValueError(f"TPU.COMPUTE_DTYPE {cfg.TPU.COMPUTE_DTYPE!r}: expected one of "
                         f"{sorted(_DTYPES)}")
    return _DTYPES[cfg.TPU.COMPUTE_DTYPE]


class EvalRun(NamedTuple):
    """What a run measured: the stats, the people and scores per image,
    and host seconds (the whole loop, and the JPEG decode within it)."""

    stats: dict
    preds: List[List[np.ndarray]]
    scores: List[List[float]]
    seconds: float
    decode_s: float


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Evaluate a pose model (PyTorch port)")
    p.add_argument("--cfg", required=True)
    p.add_argument("--superconfig", default=None)
    p.add_argument("--ann-file", default=None)
    p.add_argument("--image-dir", default=None)
    p.add_argument("--max-images", type=int, default=0, help="0 = all")
    p.add_argument("--batch-size", type=int, default=16,
                   help="images per eval batch (grouped by resize-ladder shape; "
                        "1 = the reference's per-image loop)")
    p.add_argument("--devices", type=int, default=1,
                   help="devices to evaluate on; only 1 is ported (ROADMAP M11)")
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernels; raises without a card) or cpu (their plain twins)")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    return p.parse_args(argv)


def build_model(cfg, arch, device):
    """The model ``cfg`` names (``"super"`` names run as ``pose_mobilenet``,
    as in the JAX CLI), with ``TEST.MODEL_FILE``'s weights when set (else
    the seeded init), in eval mode with its BNs folded where it folds them,
    on ``device``.  A ``.pth`` / ``.tar`` goes to the family's reference
    loader, a ``.msgpack`` to ``train.checkpoint.load_params``."""
    from ..models import FAMILIES, get_model
    from ..models.convert import family_state_dict_from_jax, state_dict_from_jax
    from ..models.litepose import ModelSpec

    name = "pose_mobilenet" if "super" in cfg.MODEL.NAME else cfg.MODEL.NAME
    model = get_model(name, cfg, arch, device="cpu", compute_dtype=compute_dtype(cfg))
    path = cfg.TEST.MODEL_FILE
    if path:
        if path.endswith((".pth", ".tar")):
            from ..models import torch_convert as tc

            if name == "pose_resnet":
                raise NotImplementedError(tc.RESNET_REFERENCE)
            ref = tc.load_torch_checkpoint(path)
            if name in FAMILIES:
                sd = tc.family_state_dict_from_torch(ref, model)
            else:
                sd = tc.state_dict_from_torch(ref, ModelSpec.from_config(cfg), arch,
                                              model.with_skips)
        else:
            from ..train.checkpoint import load_params

            if name in FAMILIES:
                sd = family_state_dict_from_jax(model, *load_params(path))
            else:
                sd = state_dict_from_jax(*load_params(path), ModelSpec.from_config(cfg), arch,
                                         model.with_skips)
        model.load_state_dict(sd, strict=True)
        if hasattr(model, "fold_bn_"):
            model.fold_bn_()
    return model.to(device)


def build_engine(cfg, model, device):
    from ..core.engine import EngineConfig, PoseEngine
    from ..core.inference import InferenceFlags
    from ..data.flip import flip_index_for
    from ..ops.group import GroupParams

    flags = InferenceFlags.from_config(
        cfg, flip_index_for(cfg.DATASET.DATASET, cfg.DATASET.WITH_CENTER))
    return PoseEngine(model, flags, GroupParams.from_config(cfg), EngineConfig.from_config(cfg),
                      device=device)


def prepare(args: argparse.Namespace):
    """What a run evaluates with: (cfg, engine, dataset, number of images,
    logger, run directory)."""
    from ..arch import ArchManager, load_arch
    from ..config import check_config, default_config, update_config
    from ..data.dataset import PoseDataset
    from ..utils.logging import create_run_dirs, setup_logger

    if args.devices > 1:
        raise NotImplementedError(f"--devices {args.devices}: evaluation on more than one "
                                  f"device is not ported yet (ROADMAP M11)")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run the plain twins on the host")

    cfg = default_config()
    update_config(cfg, args.cfg, args.opts)
    check_config(cfg)
    if cfg.MODEL.NUM_JOINTS != cfg.DATASET.NUM_JOINTS:
        # the JAX CLI fails too, in the forward's stage aggregation (a
        # broadcast of the model's planes against the dataset's joints)
        raise ValueError(f"MODEL.NUM_JOINTS {cfg.MODEL.NUM_JOINTS} != DATASET.NUM_JOINTS "
                         f"{cfg.DATASET.NUM_JOINTS}: the decode reads the model's planes "
                         f"as the dataset's joints")
    out_dir, _ = create_run_dirs(cfg, args.cfg, phase="valid")
    logger = setup_logger(out_dir, phase="valid")

    if args.superconfig:
        arch = load_arch(args.superconfig)
        # the arch JSON sets the resolution (reference valid.py:104-111)
        cfg.defrost()
        cfg.DATASET.INPUT_SIZE = arch.img_size
        cfg.DATASET.OUTPUT_SIZE = [arch.img_size // 4, arch.img_size // 2]
        cfg.freeze()
    else:
        arch = ArchManager(deconv_setting=cfg.MODEL.EXTRA.NUM_DECONV_FILTERS).fixed_sample(
            reso=cfg.DATASET.INPUT_SIZE, ratio=1.0)
    model = build_model(cfg, arch, device)
    if cfg.TEST.MODEL_FILE:
        logger.info(f"loaded weights from {cfg.TEST.MODEL_FILE}")
    engine = build_engine(cfg, model, device)

    style = "coco" if "coco" in cfg.DATASET.DATASET else "crowdpose"
    split, root = cfg.DATASET.TEST, cfg.DATASET.ROOT
    if style == "crowdpose":
        ann = args.ann_file or os.path.join(root, "json", f"crowdpose_{split}.json")
        img_dir = args.image_dir or os.path.join(root, "images")
    else:
        ann = args.ann_file or os.path.join(root, "annotations", f"person_keypoints_{split}.json")
        img_dir = args.image_dir or os.path.join(root, "images", split)
    ds = PoseDataset(ann, img_dir, cfg.DATASET.NUM_JOINTS, style=style,
                     with_center=cfg.DATASET.WITH_CENTER, filter_for_train=False)
    n = len(ds) if args.max_images == 0 else min(args.max_images, len(ds))
    ds.check_image_sizes(range(n))
    return cfg, engine, ds, n, logger, out_dir


def main(argv: Optional[Sequence[str]] = None) -> EvalRun:
    args = parse_args(argv)
    from ..utils.logging import print_name_value

    cfg, engine, ds, n, logger, out_dir = prepare(args)
    device = engine.device
    decode_s = [0.0]

    def load(i: int) -> np.ndarray:
        t = time.perf_counter()
        image = ds.load_raw(i)[0]
        decode_s[0] += time.perf_counter() - t
        return image

    all_preds, all_scores = [], []
    t0 = time.perf_counter()
    if args.batch_size > 1:
        last_logged = [0]

        def progress(done):
            if done - last_logged[0] >= max(cfg.PRINT_FREQ, 1) or done == n:
                last_logged[0] = done
                logger.info(f"eval {done}/{n} ({done / (time.perf_counter() - t0):.2f} img/s)")

        for people, scores in engine.process_indexed([ds.image_size(i) for i in range(n)], load,
                                                     batch_size=args.batch_size,
                                                     progress_cb=progress):
            all_preds.append(people)
            all_scores.append(scores)
    else:
        for i in range(n):
            people, scores = engine.process(load(i))
            all_preds.append(people)
            all_scores.append(scores)
            if i % cfg.PRINT_FREQ == 0:
                logger.info(f"eval {i}/{n} ({(i + 1) / (time.perf_counter() - t0):.2f} img/s)")
    seconds = time.perf_counter() - t0
    ds.ids = ds.ids[:n]
    stats = ds.evaluate(all_preds, all_scores, output_dir=out_dir)
    print_name_value(logger, stats, cfg.MODEL.NAME)
    logger.info(f"{n} images in {seconds:.3f} s ({n / seconds:.2f} img/s on {device}); JPEG "
                f"decode {1e3 * decode_s[0] / n:.2f} host ms per image")
    return EvalRun(stats, all_preds, all_scores, seconds, decode_s[0])


if __name__ == "__main__":
    main()
