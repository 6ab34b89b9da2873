"""Evolutionary NAS CLI (the counterpart of ``tools/search.py``, the
reference ``search.py`` flow).

  python -m litepose_tpu_torch.tools.search --cfg configs/crowd_pose/mobilenet/supermobile.yaml \\
      --ckpt output/.../checkpoint.msgpack --constraint 8.0 --ann-file ann.json \\
      --image-dir images/ [--scoring extract|masked] [--device cuda] [KEY VALUE ...]

Candidates are sampled from the config's search space under a GMACs
budget (``nas.EvolutionFinder``, seed ``SEED``) and scored by
``nas.AccuracyPredictor``: BN calibration on the split, then the eval
protocol through ``PoseEngine`` (K1, K3 and K4 on the card).  ``--ckpt`` is
a supernet ``.msgpack`` of either package's train CLI.  The result goes to
``--out`` in the reference schema ``{"0": [constraint, [AP, arch, GMACs]]}``
with the per-iteration best AP in ``<out>.history.json``; the log goes to
``OUTPUT_DIR/search``.  ``--device cuda`` (the default) raises without a
card; ``TPU.COMPUTE_DTYPE`` is the scoring forward's compute type.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import NamedTuple, Optional, Sequence

import torch

class SearchRun(NamedTuple):
    best_acc: float
    best_arch: object
    best_eff: float
    history: list
    seconds: float
    predictor: object


def build_supernet(cfg, ckpt: Optional[str], device, dtype: torch.dtype):
    """The config's ``SuperLitePose`` (deconv widths
    ``MODEL.EXTRA.NUM_DECONV_FILTERS``) with ``ckpt``'s weights (a
    ``.msgpack`` of either package), in eval mode on ``device``; raises on
    ``cuda`` without a card."""
    from ..arch import ArchManager
    from ..models.litepose import ModelSpec
    from ..models.super_litepose import SuperDims, SuperLitePose
    from ..train.checkpoint import load_model_params

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the host")
    dims = SuperDims.from_manager(ArchManager(deconv_setting=cfg.MODEL.EXTRA.NUM_DECONV_FILTERS))
    model = SuperLitePose(ModelSpec.from_config(cfg), dims, compute_dtype=dtype)
    if ckpt:
        load_model_params(ckpt, model)
    return model.to(device).eval()


def datasets(cfg, ann_file: str, image_dir: str):
    """(calibration split, search split) of one annotation file, as the JAX
    CLIs build them."""
    from ..data.dataset import PoseDataset

    style = "coco" if "coco" in cfg.DATASET.DATASET else "crowdpose"
    calib = PoseDataset(ann_file, image_dir, cfg.DATASET.NUM_JOINTS, style=style)
    search = PoseDataset(ann_file, image_dir, cfg.DATASET.NUM_JOINTS, style=style,
                         filter_for_train=False)
    return calib, search


def main(argv: Optional[Sequence[str]] = None) -> SearchRun:
    p = argparse.ArgumentParser()
    p.add_argument("--cfg", required=True)
    p.add_argument("--ckpt", required=True, help="supernet checkpoint (.msgpack)")
    p.add_argument("--constraint", type=float, default=8.0, help="GMACs budget")
    p.add_argument("--ann-file", required=True, help="annotations for calib+search split")
    p.add_argument("--image-dir", required=True)
    p.add_argument("--out", default="search_result.json")
    p.add_argument("--population", type=int, default=40)
    p.add_argument("--iterations", type=int, default=40)
    p.add_argument("--max-eval-images", type=int, default=200)
    p.add_argument("--scoring", choices=("extract", "masked"), default="extract",
                   help="masked: score candidates through the masked max-width supernet, "
                        "one engine per resolution shared by every candidate")
    p.add_argument("--device", default="cuda", help="cuda (raises without a card) or cpu")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    args = p.parse_args(argv)

    from ..arch import ArchManager
    from ..config import default_config, update_config
    from ..nas import AccuracyPredictor, EfficiencyPredictor, EvolutionFinder
    from ..utils.logging import setup_logger
    from .valid import compute_dtype

    cfg = default_config()
    update_config(cfg, args.cfg, args.opts)
    supernet = build_supernet(cfg, args.ckpt, args.device, compute_dtype(cfg))
    logger = setup_logger(os.path.join(cfg.OUTPUT_DIR or "output", "search"), phase="search")
    manager = ArchManager(deconv_setting=cfg.MODEL.EXTRA.NUM_DECONV_FILTERS, seed=cfg.SEED)
    calib, search = datasets(cfg, args.ann_file, args.image_dir)

    eff = EfficiencyPredictor(num_joints=cfg.DATASET.NUM_JOINTS)
    acc = AccuracyPredictor(supernet, calib, search, cfg, max_eval_images=args.max_eval_images,
                            scoring=args.scoring, device=args.device)
    finder = EvolutionFinder(eff, acc, manager, population_size=args.population,
                             max_time_budget=args.iterations, seed=cfg.SEED)
    t0 = time.time()
    best_acc, best_arch, history = finder.run_evolution_search(args.constraint, logger=logger)
    wall = time.time() - t0
    best_eff = eff(best_arch)
    logger.info(f"best AP {best_acc:.4f} at {best_eff:.2f} GMACs ({wall:.0f}s wall, "
                f"{len(acc.cache)} unique candidates scored, scoring={args.scoring})")
    # the reference's schema: dict[0] = (constraint, (best_acc, best_arch, best_eff))
    with open(args.out, "w") as f:
        json.dump({0: (args.constraint, (best_acc, best_arch.to_dict(), best_eff))}, f)
    with open(args.out + ".history.json", "w") as f:
        json.dump(history, f)
    logger.info(f"wrote {args.out}")
    return SearchRun(best_acc, best_arch, best_eff, history, wall, acc)


if __name__ == "__main__":
    main()
