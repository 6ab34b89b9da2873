"""Training CLI (the counterpart of ``tools/train.py``, the reference
``dist_train.py`` flow) on one device.

  python -m litepose_tpu_torch.tools.train --cfg configs/crowd_pose/mobilenet/mobile.yaml \\
      [--superconfig arch.json] [--teacher --teacher-arch t.json --teacher-ckpt t.msgpack] \\
      [--ann-file ann.json --image-dir images/] [--device cuda] [KEY VALUE ...]

The arch: ``--superconfig`` (at ``DATASET.INPUT_SIZE``), else the max arch
for the supernet ``pose_supermobilenet``, else ``fixed_sample(ratio=1.0)``.
The model is the registry's (``models.get_model``, seed ``SEED``, compute
type ``TPU.COMPUTE_DTYPE``), its stem and backbone loaded from
``MODEL.PRETRAINED`` when ``MODEL.INIT_WEIGHTS`` is set and the file exists;
``PoseDataset`` + ``TrainPipeline`` feed it.  A supernet trains with
elastic input sizes and a sampled arch per step, both drawn from
``np.random.default_rng((SEED, epoch))`` in the JAX order.  The run
directory ``OUTPUT_DIR/<dataset>/<model>/<cfg name>`` gets the log,
``checkpoint.msgpack`` every ``--save-freq`` epochs (auto-resumed when
``AUTO_RESUME``) and ``final_state.msgpack``; both packages read them.

``--device cuda`` (the default) raises without a card; ``--device cpu``
trains on the host.  The baseline families (``pose_higher_hrnet``,
``pose_efficient_hrnet``, ``pose_resnet``) and ``pose_superresnet`` raise
``NotImplementedError``: their training is not held to JAX's yet (ROADMAP M10).  One device only: ``--multi-host`` raises (DDP waits
for ROADMAP M8).
"""

from __future__ import annotations

import argparse
import os
from typing import List, NamedTuple, Optional, Sequence

import torch

_LITEPOSE_FAMILY = ("pose_mobilenet", "pose_simplenet", "pose_supermobilenet")


class TrainRun(NamedTuple):
    """What a run leaves: the final train state, its directory and each
    epoch's averaged metrics."""

    ts: object
    out_dir: str
    epochs: List[dict]


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Train a LitePose-family model (PyTorch port)")
    p.add_argument("--cfg", required=True, help="experiment YAML")
    p.add_argument("--superconfig", default=None, help="arch JSON (subnet shape)")
    p.add_argument("--teacher", action="store_true", help="enable distillation")
    p.add_argument("--teacher-arch", default=None, help="teacher arch JSON")
    p.add_argument("--teacher-ckpt", default=None, help="teacher weights (.msgpack or .pth)")
    p.add_argument("--ann-file", default=None, help="override annotation JSON path")
    p.add_argument("--image-dir", default=None, help="override image directory")
    p.add_argument("--save-freq", type=int, default=1, help="checkpoint every N epochs")
    p.add_argument("--multi-host", action="store_true",
                   help="multi-process training; not ported yet (ROADMAP M8)")
    p.add_argument("--device", default="cuda",
                   help="cuda (raises without a card) or cpu")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    return p.parse_args(argv)


def default_paths(cfg, style: str, split: str):
    """(annotation file, image directory) under ``DATASET.ROOT``."""
    root = cfg.DATASET.ROOT
    if style == "crowdpose":
        return os.path.join(root, "json", f"crowdpose_{split}.json"), os.path.join(root, "images")
    return (os.path.join(root, "annotations", f"person_keypoints_{split}.json"),
            os.path.join(root, "images", split))


def _teacher(args, cfg, dtype, device):
    """The frozen teacher's eval-mode LitePose, or None."""
    if not (args.teacher and args.teacher_arch and args.teacher_ckpt):
        return None
    from ..arch import load_arch
    from ..models.litepose import LitePose, ModelSpec
    from ..models.torch_convert import litepose_from_torch, load_torch_checkpoint
    from ..train.checkpoint import load_model_params

    t_arch, spec = load_arch(args.teacher_arch), ModelSpec.from_config(cfg)
    if args.teacher_ckpt.endswith((".pth", ".tar")):
        teacher = litepose_from_torch(load_torch_checkpoint(args.teacher_ckpt), spec, t_arch,
                                      compute_dtype=dtype)
    else:
        teacher = LitePose(spec, t_arch, compute_dtype=dtype)
        load_model_params(args.teacher_ckpt, teacher)
        teacher.eval()
    return teacher.to(device)


def main(argv: Optional[Sequence[str]] = None) -> TrainRun:
    args = parse_args(argv)
    if args.multi_host:
        raise NotImplementedError("--multi-host: training on more than one device is not "
                                  "ported yet (ROADMAP M8, DDP + SyncBN)")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to train on the host")

    from ..arch import ArchManager, load_arch
    from ..config import check_config, default_config, update_config
    from ..core.losses import LossConfig
    from ..data.dataset import PipelineConfig, PoseDataset, TrainPipeline, make_batch_iterator
    from ..models import FAMILIES, get_model
    from ..models.super_litepose import arch_to_mask_desc
    from ..train import optim
    from ..train.checkpoint import (auto_resume, init_train_state, load_pretrained_backbone,
                                    save_checkpoint, save_params)
    from ..train.trainer import StepFns, train_epoch
    from ..utils.logging import create_run_dirs, make_tb_writer, setup_logger
    from .valid import compute_dtype

    cfg = default_config()
    update_config(cfg, args.cfg, args.opts)
    check_config(cfg)
    if cfg.MODEL.NAME in FAMILIES or cfg.MODEL.NAME == "pose_superresnet":
        raise NotImplementedError(f"training {cfg.MODEL.NAME} is not ported yet: ROADMAP M10 "
                                  f"(the baseline families train once their steps are held "
                                  f"to JAX's)")
    out_dir, tb_dir = create_run_dirs(cfg, args.cfg)
    logger = setup_logger(out_dir)
    writer = make_tb_writer(tb_dir)
    logger.info(f"device: {device}")

    manager = ArchManager(deconv_setting=cfg.MODEL.EXTRA.NUM_DECONV_FILTERS, seed=cfg.SEED)
    is_supernet = cfg.MODEL.NAME == "pose_supermobilenet"
    if args.superconfig:
        arch = load_arch(args.superconfig).with_img_size(cfg.DATASET.INPUT_SIZE)
    elif is_supernet:
        arch = manager.max_arch(cfg.DATASET.INPUT_SIZE)
    else:
        arch = manager.fixed_sample(reso=cfg.DATASET.INPUT_SIZE, ratio=1.0)
    logger.info(f"model {cfg.MODEL.NAME}; arch: {arch.to_dict()}")

    dtype = compute_dtype(cfg)
    model = get_model(cfg.MODEL.NAME, cfg, arch, device="cpu", seed=cfg.SEED,
                      compute_dtype=dtype)
    if (cfg.MODEL.NAME in _LITEPOSE_FAMILY and cfg.MODEL.INIT_WEIGHTS and cfg.MODEL.PRETRAINED
            and os.path.isfile(cfg.MODEL.PRETRAINED)):
        from ..models.torch_convert import load_torch_checkpoint

        logger.info(f"loading backbone pretrain from {cfg.MODEL.PRETRAINED}")
        load_pretrained_backbone(model, load_torch_checkpoint(cfg.MODEL.PRETRAINED))
    model = model.to(device).train()

    style = "coco" if "coco" in cfg.DATASET.DATASET else "crowdpose"
    ann, img_dir = default_paths(cfg, style, cfg.DATASET.TRAIN)
    ds = PoseDataset(args.ann_file or ann, args.image_dir or img_dir, cfg.DATASET.NUM_JOINTS,
                     style=style, with_center=cfg.DATASET.WITH_CENTER)
    pipe = TrainPipeline(ds, PipelineConfig.from_config(cfg), seed=cfg.SEED)
    batch_size = cfg.TRAIN.IMAGES_PER_GPU
    steps_per_epoch = max(len(pipe) // batch_size, 1)
    opt, sched = optim.from_config(cfg, model.parameters(), steps_per_epoch)

    sfns = StepFns(LossConfig.from_config(cfg), base_input_size=cfg.DATASET.INPUT_SIZE,
                   base_output_sizes=list(cfg.DATASET.OUTPUT_SIZE), device=device,
                   teacher_fn=_teacher(args, cfg, dtype, device),
                   remat=bool(cfg.TPU.get("REMAT", False)))
    ts = init_train_state(model, opt, sched)
    if cfg.AUTO_RESUME:
        ts = auto_resume(out_dir, ts)
        if ts.epoch:
            logger.info(f"auto-resumed from epoch {ts.epoch}")

    elastic = list(manager.img_sizes) if is_supernet else None
    arch_sampler = None
    if is_supernet:
        def arch_sampler(rng):
            return arch_to_mask_desc(manager.random_sample(rng))

    epochs = []
    for epoch in range(ts.epoch, cfg.TRAIN.END_EPOCH):
        it = make_batch_iterator(pipe, batch_size, epoch, shuffle=cfg.TRAIN.SHUFFLE)
        ts, metrics = train_epoch(sfns, ts, it, epoch, logger=logger, print_freq=cfg.PRINT_FREQ,
                                  elastic_sizes=elastic, arch_sampler=arch_sampler,
                                  seed=cfg.SEED, writer=writer)
        ts = ts._replace(epoch=epoch + 1)
        epochs.append(metrics)
        if (epoch + 1) % args.save_freq == 0 or epoch + 1 == cfg.TRAIN.END_EPOCH:
            save_checkpoint(out_dir, ts)
        logger.info(f"epoch {epoch} done: {metrics}")
    save_params(os.path.join(out_dir, "final_state.msgpack"), ts.model)
    logger.info("training complete")
    return TrainRun(ts, out_dir, epochs)


if __name__ == "__main__":
    main()
