"""Default experiment configuration tree.

Same key schema as the reference defaults
(``lib/config/default.py:20-153``) so that experiment YAMLs
written for the reference load unchanged, minus layers that are obsolete on
TPU (CUDNN, FP16 loss-scaling — replaced by a mixed-precision policy knob)
plus TPU-specific additions (MESH, PRECISION).
"""

from __future__ import annotations

import os

from .node import ConfigNode


def default_config() -> ConfigNode:
    c = ConfigNode()
    c.OUTPUT_DIR = ""
    c.LOG_DIR = ""
    c.DATA_DIR = ""
    c.GPUS = (0,)  # accepted for YAML compat; unused on TPU
    c.WORKERS = 4
    c.PRINT_FREQ = 20
    c.AUTO_RESUME = True
    c.PIN_MEMORY = True
    c.RANK = 0
    c.VERBOSE = True
    c.DIST_BACKEND = "nccl"  # accepted for YAML compat; XLA collectives on TPU
    c.MULTIPROCESSING_DISTRIBUTED = True
    c.SEED = 0

    # TPU execution policy (replaces the reference FP16/CUDNN sections).
    c.TPU = ConfigNode()
    c.TPU.COMPUTE_DTYPE = "bfloat16"  # conv/matmul compute dtype
    c.TPU.PARAM_DTYPE = "float32"
    c.TPU.REMAT = False  # jax.checkpoint the forward (memory for FLOPs)
    c.TPU.MESH = ConfigNode()
    c.TPU.MESH.DATA = -1  # -1 => all available devices on the data axis

    # Accepted-but-inert reference sections (so old YAMLs parse).
    c.FP16 = ConfigNode()
    c.FP16.ENABLED = False
    c.FP16.STATIC_LOSS_SCALE = 1.0
    c.FP16.DYNAMIC_LOSS_SCALE = False
    c.CUDNN = ConfigNode()
    c.CUDNN.BENCHMARK = True
    c.CUDNN.DETERMINISTIC = False
    c.CUDNN.ENABLED = True

    c.MODEL = ConfigNode()
    c.MODEL.NAME = "pose_mobilenet"
    c.MODEL.INIT_WEIGHTS = True
    c.MODEL.PRETRAINED = ""
    c.MODEL.NUM_JOINTS = 17
    c.MODEL.TAG_PER_JOINT = True
    c.MODEL.SYNC_BN = False
    c.MODEL.EXTRA = ConfigNode()
    c.MODEL.EXTRA.FINAL_CONV_KERNEL = 1
    c.MODEL.EXTRA.PRETRAINED_LAYERS = ["*"]
    c.MODEL.EXTRA.NUM_DECONV_LAYERS = 3
    c.MODEL.EXTRA.NUM_DECONV_FILTERS = [64, 48, 32]
    c.MODEL.EXTRA.NUM_DECONV_KERNELS = [4, 4, 4]

    c.LOSS = ConfigNode()
    c.LOSS.NUM_STAGES = 1
    c.LOSS.WITH_HEATMAPS_LOSS = (True,)
    c.LOSS.HEATMAPS_LOSS_FACTOR = (1.0,)
    c.LOSS.WITH_AE_LOSS = (True,)
    c.LOSS.AE_LOSS_TYPE = "max"
    c.LOSS.PUSH_LOSS_FACTOR = (0.001,)
    c.LOSS.PULL_LOSS_FACTOR = (0.001,)

    c.DATASET = ConfigNode()
    c.DATASET.ROOT = ""
    c.DATASET.DATASET = "coco_kpt"
    c.DATASET.DATASET_TEST = "coco"
    c.DATASET.NUM_JOINTS = 17
    c.DATASET.MAX_NUM_PEOPLE = 30
    c.DATASET.TRAIN = "train2017"
    c.DATASET.TEST = "val2017"
    c.DATASET.DATA_FORMAT = "jpg"
    c.DATASET.MAX_ROTATION = 30
    c.DATASET.MIN_SCALE = 0.75
    c.DATASET.MAX_SCALE = 1.25
    c.DATASET.SCALE_TYPE = "short"
    c.DATASET.MAX_TRANSLATE = 40
    c.DATASET.INPUT_SIZE = 512
    c.DATASET.OUTPUT_SIZE = [128, 256, 512]
    c.DATASET.FLIP = 0.5
    c.DATASET.SIGMA = -1
    c.DATASET.SCALE_AWARE_SIGMA = False
    c.DATASET.BASE_SIZE = 256.0
    c.DATASET.BASE_SIGMA = 2.0
    c.DATASET.INT_SIGMA = False
    c.DATASET.WITH_CENTER = False

    c.TRAIN = ConfigNode()
    c.TRAIN.LR_FACTOR = 0.1
    c.TRAIN.LR_STEP = [90, 110]
    c.TRAIN.LR = 0.001
    c.TRAIN.OPTIMIZER = "adam"
    c.TRAIN.MOMENTUM = 0.9
    c.TRAIN.WD = 0.0001
    c.TRAIN.NESTEROV = False
    c.TRAIN.GAMMA1 = 0.99
    c.TRAIN.GAMMA2 = 0.0
    c.TRAIN.BEGIN_EPOCH = 0
    c.TRAIN.END_EPOCH = 140
    c.TRAIN.RESUME = False
    c.TRAIN.CHECKPOINT = ""
    c.TRAIN.IMAGES_PER_GPU = 32
    c.TRAIN.SHUFFLE = True

    c.TEST = ConfigNode()
    c.TEST.IMAGES_PER_GPU = 32
    c.TEST.FLIP_TEST = False
    c.TEST.ADJUST = True
    c.TEST.REFINE = True
    c.TEST.SCALE_FACTOR = [1]
    c.TEST.DETECTION_THRESHOLD = 0.2
    c.TEST.TAG_THRESHOLD = 1.0
    c.TEST.USE_DETECTION_VAL = True
    c.TEST.IGNORE_TOO_MUCH = False
    c.TEST.MODEL_FILE = ""
    c.TEST.IGNORE_CENTER = True
    c.TEST.NMS_KERNEL = 3
    c.TEST.NMS_PADDING = 1
    c.TEST.PROJECT2IMAGE = False
    c.TEST.WITH_HEATMAPS = (True,)
    c.TEST.WITH_AE = (True,)
    c.TEST.LOG_PROGRESS = False

    c.DEBUG = ConfigNode()
    c.DEBUG.DEBUG = True
    c.DEBUG.SAVE_BATCH_IMAGES_GT = False
    c.DEBUG.SAVE_BATCH_IMAGES_PRED = False
    c.DEBUG.SAVE_HEATMAPS_GT = True
    c.DEBUG.SAVE_HEATMAPS_PRED = True
    c.DEBUG.SAVE_TAGMAPS_PRED = True
    return c


def update_config(cfg: ConfigNode, cfg_file: str | None = None, opts=()) -> ConfigNode:
    """Merge a YAML experiment file and CLI opts into ``cfg``; normalize list
    fields and WITH_CENTER joint count (reference semantics,
    ``lib/config/default.py:156-196``)."""
    cfg.defrost()
    if cfg_file:
        cfg.merge_from_file(cfg_file)
    if opts:
        cfg.merge_from_list(list(opts))

    if cfg.DATASET.ROOT and not os.path.exists(cfg.DATASET.ROOT):
        cfg.DATASET.ROOT = os.path.join(cfg.DATA_DIR, cfg.DATASET.ROOT)
    if cfg.MODEL.PRETRAINED:
        cfg.MODEL.PRETRAINED = os.path.join(cfg.DATA_DIR, cfg.MODEL.PRETRAINED)
    if cfg.TEST.MODEL_FILE:
        cfg.TEST.MODEL_FILE = os.path.join(cfg.DATA_DIR, cfg.TEST.MODEL_FILE)

    if cfg.DATASET.WITH_CENTER:
        cfg.DATASET.NUM_JOINTS += 1
        cfg.MODEL.NUM_JOINTS = cfg.DATASET.NUM_JOINTS

    for key, node in (
        ("OUTPUT_SIZE", cfg.DATASET),
        ("WITH_HEATMAPS_LOSS", cfg.LOSS),
        ("HEATMAPS_LOSS_FACTOR", cfg.LOSS),
        ("WITH_AE_LOSS", cfg.LOSS),
        ("PUSH_LOSS_FACTOR", cfg.LOSS),
        ("PULL_LOSS_FACTOR", cfg.LOSS),
        ("WITH_HEATMAPS", cfg.TEST),
        ("WITH_AE", cfg.TEST),
    ):
        v = node[key]
        if isinstance(v, str):
            # YAML like "(True, True)" or "(1.0, 1.0)" parses as a string;
            # normalize.  FACTOR keys are floats — boolean parsing would
            # silently zero them.
            items = [s.strip() for s in v.strip("()[] ").split(",") if s.strip()]
            if key.endswith("_FACTOR"):
                node[key] = tuple(float(s) for s in items)
            elif key.endswith("_SIZE"):
                node[key] = tuple(int(float(s)) for s in items)
            else:
                node[key] = tuple(s in ("True", "true", "1") for s in items)
        elif not isinstance(v, (list, tuple)):
            node[key] = (v,)
    cfg.freeze()
    return cfg


def check_config(cfg: ConfigNode) -> None:
    """Per-stage list-length assertions (reference ``check_config``,
    ``lib/config/default.py:199-213``)."""
    n = cfg.LOSS.NUM_STAGES
    for name, seq in (
        ("LOSS.WITH_HEATMAPS_LOSS", cfg.LOSS.WITH_HEATMAPS_LOSS),
        ("LOSS.HEATMAPS_LOSS_FACTOR", cfg.LOSS.HEATMAPS_LOSS_FACTOR),
        ("LOSS.WITH_AE_LOSS", cfg.LOSS.WITH_AE_LOSS),
        ("LOSS.PUSH_LOSS_FACTOR", cfg.LOSS.PUSH_LOSS_FACTOR),
        ("LOSS.PULL_LOSS_FACTOR", cfg.LOSS.PULL_LOSS_FACTOR),
        ("TEST.WITH_HEATMAPS", cfg.TEST.WITH_HEATMAPS),
        ("TEST.WITH_AE", cfg.TEST.WITH_AE),
    ):
        assert n == len(seq), f"LOSS.NUM_STAGES must equal len({name})"
