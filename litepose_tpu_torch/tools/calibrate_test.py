"""Calibrated sub-network evaluation (the counterpart of
``tools/calibrate_test.py``, the reference ``calibrate_test.py``): a
candidate of a supernet checkpoint has its BN statistics recalibrated on
the split and its AP measured, the NAS accuracy measurement alone.

  python -m litepose_tpu_torch.tools.calibrate_test \\
      --cfg configs/crowd_pose/mobilenet/supermobile.yaml --ckpt supernet.msgpack \\
      --superconfig search-S.json --ann-file ann.json --image-dir images/ [--device cuda]

``--device cuda`` (the default) raises without a card.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> float:
    p = argparse.ArgumentParser()
    p.add_argument("--cfg", required=True)
    p.add_argument("--ckpt", required=True, help="supernet checkpoint (.msgpack)")
    p.add_argument("--superconfig", required=True, help="arch JSON to evaluate")
    p.add_argument("--ann-file", required=True)
    p.add_argument("--image-dir", required=True)
    p.add_argument("--max-eval-images", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (raises without a card) or cpu")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    args = p.parse_args(argv)

    from ..arch import load_arch
    from ..config import default_config, update_config
    from ..nas import AccuracyPredictor
    from .search import build_supernet, datasets
    from .valid import compute_dtype

    cfg = default_config()
    update_config(cfg, args.cfg, args.opts)
    arch = load_arch(args.superconfig)
    supernet = build_supernet(cfg, args.ckpt, args.device, compute_dtype(cfg))
    calib, search = datasets(cfg, args.ann_file, args.image_dir)
    acc = AccuracyPredictor(supernet, calib, search, cfg, max_eval_images=args.max_eval_images,
                            device=args.device)
    ap = acc(arch)
    print(f"calibrated AP for {args.superconfig}: {ap:.4f}")
    return ap


if __name__ == "__main__":
    main()
