"""The training input pipeline, host side (counterpart of ``TrainPipeline``
and ``make_batch_iterator`` in ``litepose_tpu/data/dataset.py``, which
needs cv2 to decode images and rasterize polygons).

A pipeline reads any source with the protocol

* ``len(source)``;
* ``source.load_raw(idx) -> (image RGB uint8, annotations, image_id)``;
* ``source.ignore_mask(image_id) -> (H, W) bool``, True where the loss
  applies (crowd regions and keypoint-less people are False);

augments each item with a per-item RNG seeded by ``(seed, epoch, idx)``,
and builds the per-scale heatmaps, masks and AE joint indices, bit-equal
to the JAX pipeline on the same source.  ``data.synthetic.SyntheticSource``
is such a source, held in memory; a COCO source on disk waits for a JPEG
decoder and a polygon rasterizer that need no cv2.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import List, NamedTuple, Tuple

import numpy as np

from .flip import flip_index_for
from .targets import HeatmapGenerator, JointsGenerator, ScaleAwareHeatmapGenerator
from .transforms import TrainTransform


class PipelineConfig(NamedTuple):
    """The ``DATASET`` part of the experiment config a pipeline reads
    (defaults are the JAX ``default_config``'s)."""

    input_size: int
    output_sizes: Tuple[int, ...]
    num_joints: int
    dataset: str = "coco_kpt"
    max_num_people: int = 30
    max_rotation: float = 30
    min_scale: float = 0.75
    max_scale: float = 1.25
    scale_type: str = "short"
    max_translate: int = 40
    flip: float = 0.5
    sigma: float = -1
    scale_aware_sigma: bool = False
    base_size: float = 256.0
    base_sigma: float = 2.0
    int_sigma: bool = False
    with_center: bool = False
    tag_per_joint: bool = True

    @staticmethod
    def from_config(cfg) -> "PipelineConfig":
        d = cfg.DATASET
        return PipelineConfig(
            input_size=d.INPUT_SIZE, output_sizes=tuple(d.OUTPUT_SIZE),
            num_joints=d.NUM_JOINTS, dataset=d.DATASET, max_num_people=d.MAX_NUM_PEOPLE,
            max_rotation=d.MAX_ROTATION, min_scale=d.MIN_SCALE, max_scale=d.MAX_SCALE,
            scale_type=d.SCALE_TYPE, max_translate=d.MAX_TRANSLATE, flip=d.FLIP,
            sigma=d.SIGMA, scale_aware_sigma=d.SCALE_AWARE_SIGMA, base_size=d.BASE_SIZE,
            base_sigma=d.BASE_SIGMA, int_sigma=d.INT_SIGMA, with_center=d.WITH_CENTER,
            tag_per_joint=cfg.MODEL.TAG_PER_JOINT)


def get_joints(anno: List[dict], num_joints: int, with_center: bool = False,
               scale_aware_sigma: bool = False, base_size: float = 256.0,
               base_sigma: float = 2.0, int_sigma: bool = False) -> np.ndarray:
    """(people, num_joints, 3 or 4) joints of the annotations: x, y, vis
    (and the person's sigma when scale-aware); a centre joint, when kept,
    is the mean of the visible ones."""
    width = 4 if scale_aware_sigma else 3
    joints = np.zeros((len(anno), num_joints, width))
    n_real = num_joints - 1 if with_center else num_joints
    for i, obj in enumerate(anno):
        joints[i, :n_real, :3] = np.array(obj["keypoints"]).reshape(-1, 3)
        if with_center:
            vis = joints[i, :-1, 2] > 0
            if vis.any():
                joints[i, -1, :2] = joints[i, :-1, :2][vis].mean(axis=0)
                joints[i, -1, 2] = 1
        if scale_aware_sigma:
            box = obj["bbox"]
            sigma = max(box[2], box[3]) / base_size * base_sigma
            if int_sigma:
                sigma = int(np.round(sigma + 0.5))
            joints[i, :, 3] = sigma
    return joints


class TrainPipeline:
    """Augmentation + target generation over a source."""

    def __init__(self, source, cfg: PipelineConfig, seed: int = 0):
        self.source = source
        self.cfg = cfg
        self.seed = seed
        style = "coco" if "coco" in cfg.dataset else "crowd_pose"
        self.transform = TrainTransform(
            input_size=cfg.input_size, output_sizes=cfg.output_sizes,
            max_rotation=cfg.max_rotation, min_scale=cfg.min_scale,
            max_scale=cfg.max_scale, scale_type=cfg.scale_type,
            max_translate=cfg.max_translate, flip_prob=cfg.flip,
            flip_index=flip_index_for(style, cfg.with_center),
            scale_aware_sigma=cfg.scale_aware_sigma)
        if cfg.scale_aware_sigma:
            self.heatmap_gens = [ScaleAwareHeatmapGenerator(r, cfg.num_joints)
                                 for r in cfg.output_sizes]
        else:
            self.heatmap_gens = [HeatmapGenerator(r, cfg.num_joints, cfg.sigma)
                                 for r in cfg.output_sizes]
        self.joints_gens = [JointsGenerator(cfg.max_num_people, cfg.num_joints, r,
                                            cfg.tag_per_joint) for r in cfg.output_sizes]

    def __len__(self):
        return len(self.source)

    def get(self, idx: int, epoch: int = 0):
        """(image (S, S, 3) uint8, [heatmaps (K, R, R)], [masks (R, R)],
        [joint indices (P, K, 2) int32]) of item ``idx`` in ``epoch``."""
        cfg = self.cfg
        rng = np.random.default_rng((self.seed, epoch, idx))
        img, anno, image_id = self.source.load_raw(idx)
        mask = self.source.ignore_mask(image_id).astype(np.float64)
        anno = [o for o in anno if o.get("iscrowd", 0) == 0 or o.get("num_keypoints", 0) > 0]
        joints = get_joints(anno, cfg.num_joints, cfg.with_center, cfg.scale_aware_sigma,
                            cfg.base_size, cfg.base_sigma, cfg.int_sigma)
        n_scales = len(cfg.output_sizes)
        masks = [mask.copy() for _ in range(n_scales)]
        joints_l = [joints.copy() for _ in range(n_scales)]
        img, masks, joints_l = self.transform(img, masks, joints_l, rng)
        heatmaps, joint_idx = [], []
        for s in range(n_scales):
            heatmaps.append(self.heatmap_gens[s](joints_l[s]).astype(np.float32))
            joint_idx.append(self.joints_gens[s](joints_l[s]).astype(np.int32))
            masks[s] = masks[s].astype(np.float32)
        return img, heatmaps, masks, joint_idx


def _stack(items) -> dict:
    n_scales = len(items[0][1])
    return {
        "images": np.stack([b[0] for b in items]),
        "heatmaps": [np.stack([b[1][s] for b in items]) for s in range(n_scales)],
        "masks": [np.stack([b[2][s] for b in items]) for s in range(n_scales)],
        "joints": [np.stack([b[3][s] for b in items]) for s in range(n_scales)],
    }


def make_batch_iterator(pipeline: TrainPipeline, batch_size: int, epoch: int,
                        shuffle: bool = True, process_index: int = 0,
                        process_count: int = 1, drop_last: bool = True,
                        prefetch: int = 2, num_workers: int = 4):
    """Host-sharded, prefetching batch iterator: the JAX iterator's order
    and stacks.

    Yields dicts of stacked numpy arrays: images (B,H,W,3) u8; per-scale
    heatmaps (B,K,R,R), masks (B,R,R), joints (B,P,K,2).  ``num_workers``
    threads build items in parallel (numpy releases the GIL in its array
    loops); an item's failure is raised in the consumer."""
    n = len(pipeline)
    order = np.arange(n)
    if shuffle:
        np.random.default_rng((pipeline.seed, epoch)).shuffle(order)
    # shard across hosts; every host yields the same number of batches
    if drop_last:
        per_shard = n // process_count // batch_size * batch_size
        order = order[: per_shard * process_count]
    order = order[process_index::process_count]
    if drop_last:
        order = order[: len(order) // batch_size * batch_size]

    q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = threading.Event()
    done = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        pool = ThreadPoolExecutor(max_workers=max(num_workers, 1))
        try:
            batch = []
            for item in pool.map(lambda i: pipeline.get(int(i), epoch), order):
                batch.append(item)
                if len(batch) == batch_size:  # a short last batch is dropped, as in JAX
                    if not put(_stack(batch)):
                        return
                    batch = []
            put(done)
        except Exception as e:  # handed to the consumer, which raises it
            put(e)
        finally:
            pool.shutdown(wait=False, cancel_futures=True)

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is done:
                return
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        stop.set()
        t.join(timeout=60)
