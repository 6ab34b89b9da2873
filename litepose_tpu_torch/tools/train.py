"""Training CLI (the counterpart of ``tools/train.py``, the reference
``dist_train.py`` flow), on one device or one process per card.

  python -m litepose_tpu_torch.tools.train --cfg configs/crowd_pose/mobilenet/mobile.yaml \\
      [--superconfig arch.json] [--teacher --teacher-arch t.json --teacher-ckpt t.msgpack] \\
      [--ann-file ann.json --image-dir images/] [--device cuda] [KEY VALUE ...]
  torchrun --nproc_per_node=N -m litepose_tpu_torch.tools.train --multi-host --cfg ... [KEY VALUE ...]

The arch: ``--superconfig`` (at ``DATASET.INPUT_SIZE``), else the max arch
for a supernet (``pose_supermobilenet``, ``pose_superresnet``), else
``fixed_sample(ratio=1.0)``; the ResNet-space models (``pose_superresnet``,
``pose_resnet``) and the HRNet families (``pose_higher_hrnet``,
``pose_efficient_hrnet``) ignore it.  The model is the registry's
(``models.get_model``, seed ``SEED``, compute type ``TPU.COMPUTE_DTYPE``);
a LitePose-family model's stem and backbone are loaded from
``MODEL.PRETRAINED`` when ``MODEL.INIT_WEIGHTS`` is set and the file exists
(no other model loads it, as in the JAX CLI: the HRNet configs' ImageNet
``hrnet_w32`` file stays unread); ``PoseDataset`` + ``TrainPipeline`` feed
it.  A config whose ``MODEL.NUM_JOINTS`` differs from
``DATASET.NUM_JOINTS`` (EfficientHRNet H-1, H-2, H-4) raises
``ValueError`` before any work: its targets have the dataset's joints and
its outputs the model's, and the JAX CLI fails at its first step's loss.
A supernet trains with elastic input sizes and a sampled desc per step,
both drawn from
``np.random.default_rng((SEED, epoch))`` in the JAX order and, for both
supernets as in the JAX CLI, from the MobileNet space's ``ArchManager``
(the ResNet space has the same stem and stage widths, so each desc is one
of its own).  The run
directory ``OUTPUT_DIR/<dataset>/<model>/<cfg name>`` gets the log,
``checkpoint.msgpack`` every ``--save-freq`` epochs (auto-resumed when
``AUTO_RESUME``) and ``final_state.msgpack``; both packages read them.

``--multi-host`` joins a process group (``parallel.init_distributed``):
torchrun's environment, or ``--coordinator host:port`` (or an init-method
URL such as ``file:///shared/rendezvous``) with ``--num-processes`` and
``--process-id``.  Each rank runs on ``cuda:LOCAL_RANK`` (NCCL), or on the
host with ``--device cpu`` (gloo), takes ``TRAIN.IMAGES_PER_GPU`` images a
step from its shard of each epoch (``make_batch_iterator``'s
``process_index`` / ``process_count``), and steps on the global batch
(SyncBN statistics, gradients and metrics averaged over the ranks:
``train.trainer``); an epoch is ``len(dataset) // (IMAGES_PER_GPU * world
size)`` steps.  Every rank starts from the same seeded weights and resumes
from the same checkpoint; rank 0 alone writes checkpoints and the final
weights, logs to the console and to TensorBoard; each rank writes its own
log file.  ``--profile-dir`` writes a ``torch.profiler`` trace of the
second epoch on rank 0 (the first is warm-up).

``--device cuda`` (the default) raises without a card; ``--device cpu``
trains on the host.
"""

from __future__ import annotations

import argparse
import contextlib
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
    p = argparse.ArgumentParser(description="Train a pose model of the registry (PyTorch port)")
    p.add_argument("--cfg", required=True, help="experiment YAML")
    p.add_argument("--superconfig", default=None, help="arch JSON (subnet shape)")
    p.add_argument("--teacher", action="store_true", help="enable distillation")
    p.add_argument("--teacher-arch", default=None, help="teacher arch JSON")
    p.add_argument("--teacher-ckpt", default=None, help="teacher weights (.msgpack or .pth)")
    p.add_argument("--ann-file", default=None, help="override annotation JSON path")
    p.add_argument("--image-dir", default=None, help="override image directory")
    p.add_argument("--save-freq", type=int, default=1, help="checkpoint every N epochs")
    p.add_argument("--multi-host", action="store_true",
                   help="one process per card: join a process group (torchrun's "
                        "environment or --coordinator)")
    p.add_argument("--coordinator", default=None,
                   help="rendezvous host:port, or an init-method URL (tcp://, file://)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of the second epoch (rank 0) here")
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
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to train on the host")
    if not args.multi_host:
        return _train(args, device)
    from ..parallel import destroy_distributed, init_distributed

    device = init_distributed(device.type, args.coordinator, args.num_processes,
                              args.process_id)
    try:
        return _train(args, device)
    finally:
        destroy_distributed()


def _train(args: argparse.Namespace, device: torch.device) -> TrainRun:
    from ..arch import ArchManager, load_arch
    from ..config import check_config, default_config, update_config
    from ..core.losses import LossConfig
    from ..data.dataset import PipelineConfig, PoseDataset, TrainPipeline, make_batch_iterator
    from ..models import get_model
    from ..models.super_litepose import arch_to_mask_desc
    from ..parallel import barrier, world
    from ..train import optim
    from ..train.checkpoint import (auto_resume, init_train_state, load_pretrained_backbone,
                                    save_checkpoint, save_params)
    from ..train.trainer import StepFns, train_epoch
    from ..utils.logging import create_run_dirs, make_tb_writer, setup_logger
    from .valid import compute_dtype

    cfg = default_config()
    update_config(cfg, args.cfg, args.opts)
    check_config(cfg)
    if cfg.MODEL.NUM_JOINTS != cfg.DATASET.NUM_JOINTS:
        raise ValueError(f"MODEL.NUM_JOINTS {cfg.MODEL.NUM_JOINTS} != DATASET.NUM_JOINTS "
                         f"{cfg.DATASET.NUM_JOINTS}: the loss compares the model's planes "
                         f"with the dataset's targets (the JAX CLI fails at its first step)")
    rank, n_ranks, backend = world()
    out_dir, tb_dir = create_run_dirs(cfg, args.cfg)
    logger = setup_logger(out_dir, rank=rank)
    writer = make_tb_writer(tb_dir) if rank == 0 else None
    logger.info(f"device: {device}; rank {rank} of {n_ranks}"
                + (f" ({backend})" if backend else ""))

    manager = ArchManager(deconv_setting=cfg.MODEL.EXTRA.NUM_DECONV_FILTERS, seed=cfg.SEED)
    is_supernet = cfg.MODEL.NAME in ("pose_supermobilenet", "pose_superresnet")
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
    steps_per_epoch = max(len(pipe) // (batch_size * n_ranks), 1)
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
    start_epoch = ts.epoch
    for epoch in range(start_epoch, cfg.TRAIN.END_EPOCH):
        # the second epoch: the first is warm-up (allocator, cuDNN plans)
        profiler = _profiler(device) if args.profile_dir and rank == 0 \
            and epoch == start_epoch + 1 else None
        it = make_batch_iterator(pipe, batch_size, epoch, shuffle=cfg.TRAIN.SHUFFLE,
                                 process_index=rank, process_count=n_ranks)
        with profiler or contextlib.nullcontext():
            ts, metrics = train_epoch(sfns, ts, it, epoch, logger=logger,
                                      print_freq=cfg.PRINT_FREQ, elastic_sizes=elastic,
                                      arch_sampler=arch_sampler, seed=cfg.SEED, writer=writer)
        ts = ts._replace(epoch=epoch + 1)
        epochs.append(metrics)
        if profiler is not None:
            os.makedirs(args.profile_dir, exist_ok=True)
            path = os.path.join(args.profile_dir, f"train_epoch{epoch}_rank{rank}.json")
            profiler.export_chrome_trace(path)
            logger.info(f"profiler trace written to {path}")
        if rank == 0 and ((epoch + 1) % args.save_freq == 0
                          or epoch + 1 == cfg.TRAIN.END_EPOCH):
            logger.info(f"checkpoint written to {save_checkpoint(out_dir, ts)}")
        logger.info(f"epoch {epoch} done: {metrics}")
    if rank == 0:
        save_params(os.path.join(out_dir, "final_state.msgpack"), ts.model)
    barrier(device)  # every rank returns once the files exist
    logger.info("training complete")
    return TrainRun(ts, out_dir, epochs)


def _profiler(device: torch.device):
    """A ``torch.profiler`` session over the host and, on a card, its kernels."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities)


if __name__ == "__main__":
    main()
