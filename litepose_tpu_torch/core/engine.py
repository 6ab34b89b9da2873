"""PoseEngine: uint8 images -> people (counterpart of
``litepose_tpu/core/engine.py``).

A batch runs normalization, the forward pass (with flip test), stage
aggregation, the projection to the input size and the decode on the
engine's device: NMS + top-M peaks (kernel K1), greedy (K2) or exact
Hungarian (K3) grouping, adjust, the person scores and refine (K4).  Only
the fixed-size people arrays come back to the host.

- ``process_batch_square``: serving, images already resized to a square.
- ``process``: the eval protocol for one image of any size: warp onto the
  64-px resize ladder, single- or multi-scale, people in source-image
  coordinates.
- ``process_indexed`` / ``process_many``: the same for many images,
  bucketed by warped shape and run in batches, the host's warps of the
  next batch overlapping the card's work on the current one.

With ``mesh=`` (a sequence of devices, ``parallel.make_mesh``) the engine
is data-parallel, as the JAX engine under ``shard_map`` is: the model is
copied to every device, and ``process_batch_square`` and
``process_indexed`` split each batch into one equal shard a device, each
shard running the whole single-device program (forward and decode, its
kernels on its own card) on a host thread of its own, under that device
and a stream of its own.  Threads, because the decode waits for the card
mid-way (the peak counts decide the grouping's work): one host thread
driving every device would run them in turn.  A shard's people equal,
bit for bit, the single-device engine's on the same chunk of images.

Under ``torch.profiler`` each call is a tree of ``litepose.engine.*``
ranges (``utils.spans``): ``call`` (the engine's call number and the batch
size in its ``args``) over ``upload``, ``forward``, ``decode`` and
``readback``; on a mesh one ``shard`` a shard, on the shard's thread.
With no profiler on, a range costs one flag check.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.affine import (get_affine_transform, get_final_preds,
                           get_multi_scale_size, warp_image)
from ..ops.group import GroupParams, StaticGroupCfg, parse_batch
from ..parallel.mesh import gather, replicate, shard_batch
from ..utils.spans import span
from .inference import InferenceFlags, make_infer_fn, resize_bilinear


@dataclasses.dataclass
class EngineConfig:
    """Mirror of the JAX ``EngineConfig``, with its eval defaults: exact
    Hungarian grouping, adjust, refine and projection.  Serving sets
    assignment="greedy", topk_method="approx", no adjust, refine or
    projection, and decode_bf16."""

    input_size: int = 448
    scale_factors: Tuple[float, ...] = (1.0,)
    with_adjust: bool = True
    with_refine: bool = True
    project2image: bool = True
    assignment: str = "hungarian"  # or "greedy"
    topk_method: str = "exact"  # or "approx"; both run exact top-M here
    decode_bf16: bool = False

    @staticmethod
    def from_config(cfg) -> "EngineConfig":
        """The eval configuration ``tools/valid.py`` builds from the
        experiment config."""
        return EngineConfig(
            input_size=cfg.DATASET.INPUT_SIZE,
            scale_factors=tuple(cfg.TEST.SCALE_FACTOR),
            with_adjust=cfg.TEST.ADJUST,
            with_refine=cfg.TEST.REFINE,
            project2image=cfg.TEST.PROJECT2IMAGE,
        )


Result = Tuple[List[np.ndarray], List[float]]


class PoseEngine:
    """Batched pose estimation on one device, or data-parallel over a mesh.

    Args:
      apply_fn: ``(B, 3, H, W) normalized images -> [NCHW stage outputs]``,
        for example a ``LitePose`` in eval mode, already on ``device``.
        With a mesh, the ``nn.Module`` itself (it is copied to each device).
      flags: stage aggregation and flip-test configuration.
      group: decode thresholds and joint order.
      config: EngineConfig.
      device: where the batch runs, the card unless the caller names
        another: CUDA launches the kernels, ``device="cpu"`` runs their
        plain twins.  A CUDA device without a card raises here.
      mesh: devices to split each batch over (``device`` is then ignored);
        a device may appear more than once (replicas sharing a card, each
        on its own stream).  Call :meth:`close` to stop its threads.
    """

    def __init__(self, apply_fn: Callable[[torch.Tensor], List[torch.Tensor]],
                 flags: InferenceFlags, group: GroupParams,
                 config: EngineConfig, device="cuda",
                 mesh: Optional[Sequence[torch.device]] = None):
        self.mesh = None if mesh is None else tuple(torch.device(d) for d in mesh)
        self.device = self.mesh[0] if self.mesh else torch.device(device)
        if any(d.type == "cuda" for d in self.mesh or (self.device,)) \
                and not torch.cuda.is_available():
            raise RuntimeError("PoseEngine: no CUDA device; pass device=\"cpu\" to run "
                               "the plain twins on the host")
        self.apply_fn = apply_fn
        if config.decode_bf16:
            flags = flags._replace(decode_bf16=True)
        self.flags = flags
        self.group_cfg = StaticGroupCfg.from_params(
            group, assignment=config.assignment, topk_method=config.topk_method)
        self.config = config
        self._calls = itertools.count(1)  # the call numbers in the spans' args
        self._local = threading.local()  # .call: the call open on this thread
        self._infer: Dict[Tuple[Tuple[int, int], Optional[Tuple[int, int]]], Callable] = {}
        if self.mesh is not None:
            if not isinstance(apply_fn, torch.nn.Module):
                raise TypeError("PoseEngine(mesh=...) copies the model to each device: pass "
                                "the nn.Module, not a function")
            self._shards = [PoseEngine(m, flags, group, config, device=d)
                            for m, d in zip(replicate(apply_fn, self.mesh), self.mesh)]
            self._streams = [torch.cuda.Stream(d) if d.type == "cuda" else None
                             for d in self.mesh]
            # one thread a shard: a shard's batches run in order, on its stream
            self._threads = [ThreadPoolExecutor(1, thread_name_prefix=f"PoseEngine-shard{i}")
                             for i in range(len(self.mesh))]

    def close(self) -> None:
        """Stop the mesh's shard threads (a no-op on one device)."""
        if self.mesh is not None:
            for t in self._threads:
                t.shutdown(wait=True)

    def infer_fn(self, in_hw: Tuple[int, int],
                 out_hw: Optional[Tuple[int, int]]) -> Callable:
        key = (in_hw, out_hw)
        if key not in self._infer:
            self._infer[key] = make_infer_fn(self.apply_fn, self.flags, project_hw=out_hw)
        return self._infer[key]

    @contextlib.contextmanager
    def _call(self, batch: int):
        """The ``litepose.engine.call`` span of a call of ``batch`` images,
        unless this thread is inside one of the engine's calls already."""
        if getattr(self._local, "call", None) is not None:
            yield
            return
        self._local.call = next(self._calls)
        try:
            with span("litepose.engine.call", f"call={self._local.call} batch={batch}"):
                yield
        finally:
            self._local.call = None

    def _upload(self, images_u8) -> torch.Tensor:
        with span("litepose.engine.upload"):
            x = torch.as_tensor(images_u8)
            if x.dtype != torch.uint8 or x.dim() != 4 or x.shape[3] != 3:
                raise ValueError(f"expected uint8 images (B, H, W, 3), got {x.dtype} "
                                 f"{tuple(x.shape)}")
            return x.to(self.device, non_blocking=True)

    @torch.inference_mode()
    def _maps(self, images_u8, project: bool):
        """uint8 (B, H, W, 3) -> det (B, J, h, w), tag (B, J, T, h, w) on the
        device; projected to (H, W) when ``project``."""
        x = self._upload(images_u8)
        hw = (int(x.shape[1]), int(x.shape[2]))
        with span("litepose.engine.forward"):
            return self.infer_fn(hw, hw if project else None)(x)

    @torch.inference_mode()
    def _decode(self, det: torch.Tensor, tag: torch.Tensor):
        with span("litepose.engine.decode"):
            return parse_batch(det, tag, self.group_cfg, self.config.with_adjust,
                               self.config.with_refine, tag_layout="thw")

    def run_batch(self, images_u8):
        """uint8 (B, H, W, 3) images -> (det, tag, people, scores, counts),
        all on the engine's device: det (B, J, h, w), tag (B, J, T, h, w),
        people (B, P, K, 3+T) in heatmap coordinates (the maps are projected
        to (H, W) when ``project2image``).  On a mesh the shards' outputs
        are gathered on its first device."""
        with self._call(len(images_u8)):
            return self._run_batch(images_u8)

    def _run_batch(self, images_u8):
        """``run_batch`` inside a call's span."""
        if self.mesh is not None:
            parts = [f.result() for f in self._submit(self._shard_batch, images_u8)]
            return tuple(gather([p[i] for p in parts]) for i in range(5))
        det, tag = self._maps(images_u8, self.config.project2image)
        return (det, tag) + tuple(self._decode(det, tag))

    # -- the mesh ---------------------------------------------------------------

    def _submit(self, fn: Callable, images_u8) -> List[Future]:
        """``fn(shard index, call number, shard)`` for each equal shard of
        the batch, on the shard's thread; raises when the batch does not
        divide.  The call number is that of the call open on this thread,
        else a new one."""
        shards = shard_batch(images_u8, len(self.mesh))
        call = getattr(self._local, "call", None) or next(self._calls)
        return [t.submit(fn, i, call, x)
                for i, (t, x) in enumerate(zip(self._threads, shards))]

    def _on_shard(self, i: int):
        """The shard's device and stream made current on this thread."""
        stack = contextlib.ExitStack()
        if self._streams[i] is not None:
            stack.enter_context(torch.cuda.device(self.mesh[i]))
            stack.enter_context(torch.cuda.stream(self._streams[i]))
        return stack

    def _shard_batch(self, i: int, call: int, images_u8, to_host: bool = False):
        """Shard ``i``'s ``run_batch`` for call number ``call``, its stream
        drained so that other threads and streams may read the outputs;
        with ``to_host``, its people on the host (``_host_people``)."""
        with span("litepose.engine.shard", f"call={call} shard={i}"), self._on_shard(i):
            out = self._shards[i]._run_batch(images_u8)
            if self._streams[i] is not None:
                self._streams[i].synchronize()
            if to_host:
                det, _, people, scores, n = out
                return _host_people(det, people, scores, n)
            return out

    def _shard_people(self, i: int, call: int, images_u8):
        """Shard ``i``'s people on the host: (heatmap (h, w), people,
        scores, counts as numpy)."""
        return self._shard_batch(i, call, images_u8, to_host=True)

    @staticmethod
    def _gather_people(futures: Sequence[Future]):
        """The shards' host people put back together: (hm_hw, people,
        scores, counts)."""
        parts = [f.result() for f in futures]
        return (parts[0][0],) + tuple(gather([p[i] for p in parts]) for i in (1, 2, 3))

    def process_batch_square(self, images_u8):
        """Serving path: a batch of images pre-resized to the square
        ``input_size``.  Returns numpy (people (B, P, K, 3+T) in heatmap
        coordinates, scores (B, P), counts (B,)); callers map coordinates
        with their own inverse affines.  On a mesh the batch must divide
        into one equal shard a device."""
        size = self.config.input_size
        shape = tuple(np.shape(images_u8))
        if len(shape) != 4 or shape[1:] != (size, size, 3):
            raise ValueError(f"expected images (B, {size}, {size}, 3), got {shape}")
        with self._call(shape[0]):
            if self.mesh is not None:
                return self._gather_people(self._submit(self._shard_people, images_u8))[1:]
            det, _, people, scores, n = self.run_batch(images_u8)
            return _host_people(det, people, scores, n)[1:]

    # -- the eval protocol ----------------------------------------------------

    def _ladder(self, image_hw: Tuple[int, int], scale_factor: float):
        """((w, h) on the 64-px resize ladder, center, scale) of an image of
        ``image_hw`` at ``scale_factor``."""
        return get_multi_scale_size(image_hw, self.config.input_size, scale_factor,
                                    min(self.config.scale_factors))

    def _warp(self, image: np.ndarray, scale_factor: float):
        """Warp onto the resize ladder: (warped image, center, scale)."""
        size, center, scale = self._ladder(image.shape[:2], scale_factor)
        mat = get_affine_transform(center, scale, 0, size)
        return warp_image(image, mat, size), center, scale

    @staticmethod
    def _finalize_one(people: np.ndarray, scores: np.ndarray, n: int, center,
                      scale, hm_hw: Tuple[int, int]) -> Result:
        """The first n people, mapped from the (h, w) heatmap grid back to
        source-image coordinates."""
        people, scores = people[:n], scores[:n].tolist()
        return get_final_preds(people, center, scale, (hm_hw[1], hm_hw[0])), scores

    def process(self, image_rgb_u8: np.ndarray) -> Result:
        """Multi-scale + flip eval of one image (reference ``valid.py``
        semantics).  Returns (people: list of (K, 3+T) arrays in source
        coordinates, scores).  On a mesh, one image runs on its first
        device."""
        if self.mesh is not None:
            with self._on_shard(0):
                return self._shards[0].process(image_rgb_u8)
        with self._call(1):
            return self._process(image_rgb_u8)

    def _process(self, image_rgb_u8: np.ndarray) -> Result:
        """``process`` on one device, inside a call's span."""
        scales = sorted(self.config.scale_factors, reverse=True)
        if scales == [1.0]:
            img, center, scale = self._warp(image_rgb_u8, 1.0)
            det, _, people, scores, n = self.run_batch(img[None])
            hm_hw, people, scores, n = _host_people(det, people, scores, n)
            return self._finalize_one(people[0], scores[0], int(n[0]), center, scale, hm_hw)
        if len(scales) > 1 and 1.0 not in scales:
            raise ValueError(f"multi-scale eval takes its tags at scale 1.0, "
                             f"got scales {scales}")

        # heatmaps accumulate over the scales, tags come from scale 1 (from
        # the only scale when there is one).  With projection every scale is
        # already at the base size; without it the first (largest) scale's
        # grid is the accumulation grid (reference aggregate_results)
        base, _, _ = self._ladder(image_rgb_u8.shape[:2], 1.0)
        project_hw = (int(base[1]), int(base[0])) if self.config.project2image else None
        accum_hw = project_hw
        heat_sum = tag_keep = None
        with torch.inference_mode():
            for s in scales:
                img, center, scale = self._warp(image_rgb_u8, s)
                x = self._upload(img[None])
                with span("litepose.engine.forward"):
                    heat, tag = self.infer_fn(img.shape[:2], project_hw)(x)
                if accum_hw is None:
                    accum_hw = tuple(heat.shape[-2:])
                if tuple(heat.shape[-2:]) != accum_hw:
                    heat = resize_bilinear(heat, accum_hw)
                heat_sum = heat if heat_sum is None else heat_sum + heat
                if s == 1.0 or len(scales) == 1:
                    if tuple(tag.shape[-2:]) != accum_hw:
                        n, j, t = tag.shape[:3]
                        tag = resize_bilinear(tag.reshape(n, j * t, *tag.shape[3:]),
                                              accum_hw).reshape(n, j, t, *accum_hw)
                    tag_keep = tag
            heat = heat_sum / torch.full((), float(len(scales)), device=heat_sum.device)
        people, scores, n = self._decode(heat, tag_keep)
        _, people, scores, n = _host_people(heat, people, scores, n)
        return self._finalize_one(people[0], scores[0], int(n[0]), center, scale, accum_hw)

    def process_indexed(self, shapes: Sequence[Tuple[int, int]],
                        load_fn: Callable[[int], np.ndarray],
                        batch_size: int = 16,
                        progress_cb: Optional[Callable[[int], None]] = None) -> List[Result]:
        """The eval protocol over many images of any size, loaded lazily.

        The whole index set is bucketed by warped shape up front, from
        ``shapes`` alone ((height, width) per image); each bucket runs in
        ``batch_size`` chunks, only its last chunk zero-padded, so a bucket
        keeps one batch shape.  ``load_fn(i)`` is called once per image when
        its batch is assembled.  The drive is double-buffered: batch k is
        launched, batch k+1 is warped on the host while the card works, and
        only then are batch k's people copied back.  Per-image results equal
        :meth:`process`.  Multi-scale configurations run image by image.

        On a mesh, ``batch_size`` is rounded down to a multiple of the
        device count (at least one image a device), as in JAX, and each
        batch's shards run on their threads while the host warps the next
        batch.

        Returns ``(people, scores)`` per image, in input order."""
        if tuple(self.config.scale_factors) != (1.0,):
            out = []
            for i in range(len(shapes)):
                out.append(self.process(load_fn(i)))
                if progress_cb is not None:
                    progress_cb(i + 1)
            return out

        metas = []
        buckets: Dict[Tuple[int, int], List[int]] = {}
        for i, src_hw in enumerate(shapes):
            size, center, scale = self._ladder(tuple(src_hw), 1.0)
            metas.append((size, center, scale))
            buckets.setdefault((int(size[1]), int(size[0])), []).append(i)

        if self.mesh is not None:
            n_dev = len(self.mesh)
            batch_size = max(n_dev, batch_size // n_dev * n_dev)
        results: List[Optional[Result]] = [None] * len(shapes)
        done = 0
        pin = self.device.type == "cuda"

        def drain(pending) -> int:
            chunk, fetch = pending
            hm_hw, people, scores, n = fetch()
            for j, i in enumerate(chunk):
                _, center, scale = metas[i]
                results[i] = self._finalize_one(people[j], scores[j], int(n[j]),
                                                center, scale, hm_hw)
            return len(chunk)

        pending = None
        for hw, idxs in buckets.items():
            for lo in range(0, len(idxs), batch_size):
                chunk = idxs[lo:lo + batch_size]
                # pinned host memory: the upload does not wait for the card
                batch = torch.zeros((batch_size, hw[0], hw[1], 3), dtype=torch.uint8,
                                    pin_memory=pin)
                view = batch.numpy()
                for j, i in enumerate(chunk):
                    size, center, scale = metas[i]
                    mat = get_affine_transform(center, scale, 0, size)
                    view[j] = warp_image(load_fn(i), mat, size)
                if self.mesh is not None:
                    fetch = functools.partial(self._gather_people,
                                              self._submit(self._shard_people, batch))
                else:
                    det, _, people, scores, n = self.run_batch(batch)
                    fetch = functools.partial(_host_people, det, people, scores, n)
                if pending is not None:
                    done += drain(pending)
                    if progress_cb is not None:
                        progress_cb(done)
                pending = (chunk, fetch)
        if pending is not None:
            done += drain(pending)
            if progress_cb is not None:
                progress_cb(done)
        return results

    def process_many(self, images: Sequence[np.ndarray], batch_size: int = 16,
                     progress_cb: Optional[Callable[[int], None]] = None) -> List[Result]:
        """:meth:`process_indexed` over an in-memory list of images."""
        return self.process_indexed([img.shape[:2] for img in images],
                                    lambda i: images[i], batch_size=batch_size,
                                    progress_cb=progress_cb)


def _host_people(det: torch.Tensor, people: torch.Tensor, scores: torch.Tensor,
                 n: torch.Tensor):
    """A batch's (heatmap (h, w), people, scores, counts) on the host: the
    one read-back of every path, which waits for the device's work."""
    with span("litepose.engine.readback"):
        return (tuple(det.shape[-2:]), people.cpu().numpy(), scores.cpu().numpy(),
                n.cpu().numpy())
