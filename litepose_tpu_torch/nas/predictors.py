"""Efficiency and accuracy predictors of the evolutionary search
(counterpart of ``litepose_tpu/nas/predictors.py``).

``EfficiencyPredictor``: GMACs by arithmetic over the arch descriptor.

``AccuracyPredictor``: a candidate's AP: its BN statistics recalibrated on
a calibration split, then the eval protocol through ``PoseEngine.
process_indexed`` on a search split (CrowdPose flags from the config,
Hungarian grouping, adjust, refine, projection), so on the card each
candidate's scoring batches launch K1, K3 and K4.  Two scoring modes:

* ``extract``: the candidate is extracted into a fixed ``LitePose``
  (``models.super_litepose.extract_subnet``), calibrated, BNs folded, and
  gets an engine of its own;
* ``masked``: the candidate runs through the shared ``SuperLitePose`` at
  max width under its mask descriptor.  One engine per image size serves
  every candidate of that size: its ``apply_fn`` reads the current desc,
  the candidate's calibrated BN statistics are loaded into the supernet for
  its eval, and the supernet's own statistics are put back after, so
  nothing cached is keyed on a candidate's weights.  Candidates need the
  full kernel.

Calibration batches are center-resized squares of the calibration split's
images, ``cv2.resize``'s INTER_LINEAR bit for bit (``data.resize``).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..arch import ArchConfig, gmacs
from ..core.engine import EngineConfig, PoseEngine
from ..core.inference import InferenceFlags, normalize_images
from ..data.flip import flip_index_for
from ..data.resize import resize_linear
from ..models.super_litepose import SuperLitePose, arch_to_mask_desc, extract_subnet
from ..ops.group import GroupParams
from .calibrate import bn_state, calibrate_bn, load_bn_state, module_train_fn


class EfficiencyPredictor:
    """GMACs of a candidate (at its own img_size)."""

    def __init__(self, num_joints: int = 14):
        self.num_joints = num_joints

    def __call__(self, arch: ArchConfig) -> float:
        return gmacs(arch, self.num_joints)


class AccuracyPredictor:
    """Real-AP accuracy of a candidate of ``supernet`` (already on
    ``device``, its compute dtype the scoring's: bf16 as the JAX predictor,
    fp32 for parity).  ``timings`` keeps, per scored candidate, the host
    seconds of calibration and of the eval (synchronized on the card)."""

    def __init__(self, supernet: SuperLitePose, calib_dataset, search_dataset, cfg,
                 n_calib_batches: int = 10, calib_batch_size: int = 16,
                 max_eval_images: int = 0, cache: Optional[dict] = None,
                 scoring: str = "extract", device="cuda"):
        if scoring not in ("extract", "masked"):
            raise ValueError(f"scoring {scoring!r}: expected 'extract' or 'masked'")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("AccuracyPredictor: no CUDA device; pass device=\"cpu\" to "
                               "score on the host with the kernels' plain twins")
        self.supernet = supernet
        self.super_state = bn_state(supernet)
        self.calib = calib_dataset
        self.search = search_dataset
        self.cfg = cfg
        self.n_calib_batches = n_calib_batches
        self.calib_batch_size = calib_batch_size
        self.max_eval_images = max_eval_images
        self.cache = cache if cache is not None else {}
        self.scoring = scoring
        self.timings: List[Dict[str, float]] = []
        self._masked_engines: Dict[int, PoseEngine] = {}
        self._desc: Optional[torch.Tensor] = None

    def _calib_batches(self, img_size: int):
        """Resized square calibration batches, uint8 (B, S, S, 3)."""
        n = min(len(self.calib), self.n_calib_batches * self.calib_batch_size)
        batch = []
        for i in range(n):
            img, _, _ = self.calib.load_raw(i)
            batch.append(resize_linear(img, (img_size, img_size)))
            if len(batch) == self.calib_batch_size:
                yield torch.from_numpy(np.stack(batch)).to(self.device)
                batch = []

    def _engine(self, apply_fn: Callable, img_size: int) -> PoseEngine:
        cfg = self.cfg
        flags = InferenceFlags.from_config(
            cfg, flip_index_for(cfg.DATASET.DATASET, cfg.DATASET.WITH_CENTER))
        return PoseEngine(apply_fn, flags, GroupParams.from_config(cfg),
                          EngineConfig(input_size=img_size,
                                       scale_factors=tuple(cfg.TEST.SCALE_FACTOR),
                                       project2image=cfg.TEST.PROJECT2IMAGE),
                          device=self.device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _ap(self, engine: PoseEngine) -> float:
        n = len(self.search) if not self.max_eval_images else min(
            self.max_eval_images, len(self.search))
        results = engine.process_indexed(
            [self.search.image_size(i) for i in range(n)],
            lambda i: self.search.load_raw(i)[0], batch_size=self.calib_batch_size)
        ids_backup = self.search.ids
        self.search.ids = ids_backup[:n]
        try:
            stats = self.search.evaluate([p for p, _ in results], [s for _, s in results])
        finally:
            self.search.ids = ids_backup
        return stats["AP"]

    def __call__(self, arch: ArchConfig) -> float:
        key = str(sorted(arch.to_dict().items()))
        if key in self.cache:
            return self.cache[key]
        t0 = time.perf_counter()
        if self.scoring == "masked":
            engine, restore = self._calibrate_masked(arch)
        else:
            engine, restore = self._calibrate_extract(arch), None
        self._sync()
        t1 = time.perf_counter()
        try:
            acc = self._ap(engine)
        finally:
            if restore is not None:
                restore()
        self.timings.append({"calib_s": t1 - t0, "eval_s": time.perf_counter() - t1})
        self.cache[key] = acc
        return acc

    def _calibrate_extract(self, arch: ArchConfig) -> PoseEngine:
        sub = extract_subnet(self.supernet, arch)
        fwd = module_train_fn(sub, lambda u8: sub(normalize_images(u8)))
        state = calibrate_bn(fwd, bn_state(sub), self._calib_batches(arch.img_size))
        load_bn_state(sub, state)
        sub.train()
        sub.eval()  # refolds the calibrated statistics
        return self._engine(sub, arch.img_size)

    def _calibrate_masked(self, arch: ArchConfig):
        """Calibrate the candidate's statistics through the masked forward
        and load them into the supernet; returns (the size's engine, a
        callable putting the supernet's statistics back)."""
        kmax = self.supernet.dims.kernel
        for st in arch.backbone_setting:
            for _t, k in st.block_setting:
                if k != kmax:
                    raise ValueError("masked scoring requires full-kernel candidates "
                                     f"(got kernel {k}, max {kmax})")
        net = self.supernet
        desc = arch_to_mask_desc(arch).to(self.device)
        fwd = module_train_fn(net, lambda u8: net(normalize_images(u8), desc))
        state = calibrate_bn(fwd, self.super_state, self._calib_batches(arch.img_size))
        load_bn_state(net, state)
        net.eval()
        self._desc = desc
        if arch.img_size not in self._masked_engines:
            self._masked_engines[arch.img_size] = self._engine(
                lambda x: net(x, self._desc), arch.img_size)
        return self._masked_engines[arch.img_size], lambda: load_bn_state(net, self.super_state)
