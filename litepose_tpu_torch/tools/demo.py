"""Deployment demo: pose estimation over images (the counterpart of
``tools/demo.py``, the reference's ``nano_demo``).

Serving settings (single scale, no flip, adjust, refine or projection:
greedy grouping, as the reference demo's get_cfg sets them), a square
centre crop resized as ``cv2.resize`` does, skeletons drawn as cv2 draws
them (``utils.vis``), each written as ``<stem>.png``:

  python -m litepose_tpu_torch.tools.demo --weights ckpt.msgpack --arch auto-XS \\
      --input photos/ --output out/ [--device cuda|cpu] [--backend gpu|native]

``--device cuda`` (the default) runs the forward on the card and raises
without one; ``--device cpu`` runs it on the host.  ``--backend gpu`` (the
default) decodes with K1 and K2 on the card, or their plain twins with
``--device cpu``; ``--backend native`` (the JAX demo's) decodes each image
on the host with the C++ peak finder and grouping
(``native.NativeHeatmapParser`` over ``csrc/fast_group.cpp``) from the
forward's maps, scaled from heatmap pixels to the square by its width over
the maps', and prints the host ms a decode.  Inputs are a JPEG file or a
directory: files the JPEG decoder refuses are skipped and counted.  Video
files, cameras and ``--live`` (with its ``--no-display`` and
``--max-frames``) need a video decoder the port does not have (ROADMAP
M11) and raise before any work.
"""

from __future__ import annotations

import argparse
import glob
import os
import time
from typing import Optional, Sequence

import numpy as np

VIDEO_SUFFIXES = (".mp4", ".avi", ".mov")
NO_VIDEO = ("the port has no video decoder or camera capture (ROADMAP M11): "
            "give a JPEG file or a directory")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--weights", default=None,
                   help=".msgpack or .pth weights (random init if absent)")
    p.add_argument("--arch", default="auto-XS", help="zoo name or arch JSON path")
    p.add_argument("--input", required=True,
                   help="JPEG file or directory (a video or a camera index raises)")
    p.add_argument("--output", required=True, help="output directory")
    p.add_argument("--num-joints", type=int, default=14)
    p.add_argument("--dataset", default="CROWDPOSE", choices=["CROWDPOSE", "COCO"])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the forward runs: cuda (raises without a card) or cpu")
    p.add_argument("--backend", default="gpu", choices=["gpu", "native"],
                   help="gpu: decode with the kernels on --device (their plain twins on the "
                        "CPU); native: decode on the host with the C++ decoder")
    p.add_argument("--input-size", type=int, default=448)
    p.add_argument("--live", action="store_true", help="not ported: raises (ROADMAP M11)")
    p.add_argument("--no-display", action="store_true",
                   help="live mode only: not ported, raises (ROADMAP M11)")
    p.add_argument("--max-frames", type=int, default=0,
                   help="live mode only: not ported, raises (ROADMAP M11)")
    return p.parse_args(argv)


def center_crop_square(image: np.ndarray, size: int) -> np.ndarray:
    """720p-style center crop + resize (reference start.py:34-41)."""
    from ..data.resize import resize_linear

    h, w = image.shape[:2]
    s = min(h, w)
    y0, x0 = (h - s) // 2, (w - s) // 2
    return resize_linear(image[y0:y0 + s, x0:x0 + s], (size, size))


def _setup(args: argparse.Namespace):
    """(device, model, flags, group) of the demo at ``--input-size``: bf16
    convs, fp32 maps, no flip."""
    from ..core.inference import InferenceFlags
    from ..data.flip import flip_index_for
    from ..ops.group import GroupParams
    from .export import check_device, load_litepose, resolve_arch

    dev = check_device(args.device)
    arch = resolve_arch(args.arch, args.input_size)
    model = load_litepose(arch, args.weights, args.num_joints, dev)
    flags = InferenceFlags(
        num_joints=args.num_joints,
        with_heatmaps_loss=(True, True), with_ae_loss=(True, False),
        test_with_heatmaps=(True, True), test_with_ae=(True, False),
        flip_test=False, flip_index=tuple(flip_index_for(args.dataset.lower())),
    )
    group = GroupParams(num_joints=args.num_joints, detection_threshold=0.1,
                        nms_kernel=5, nms_padding=2)
    return dev, model, flags, group


def build_engine(args: argparse.Namespace):
    """The serving engine of the demo (``--backend gpu``): greedy grouping."""
    from ..core.engine import EngineConfig, PoseEngine

    dev, model, flags, group = _setup(args)
    return PoseEngine(
        model, flags, group,
        EngineConfig(input_size=args.input_size, scale_factors=(1.0,),
                     with_adjust=False, with_refine=False, project2image=False,
                     assignment="greedy", topk_method="approx"),
        device=dev,
    )


class NativeBackend:
    """``--backend native``: the forward's maps on ``--device`` (``infer``
    of ``core.inference.make_infer_fn``), then ``NativeHeatmapParser`` on
    the host, image by image, as the JAX demo's native backend.
    ``decode_s``: the host seconds of each decode."""

    def __init__(self, args: argparse.Namespace):
        from ..core.inference import make_infer_fn
        from ..native import NativeHeatmapParser

        self.device, model, flags, group = _setup(args)
        self.infer = make_infer_fn(model, flags)
        self.parser = NativeHeatmapParser(group)
        self.decode_s = []

    def process(self, img_sq: np.ndarray):
        """(H, W, 3) uint8 square -> (people (K, 3+T) arrays in its pixels,
        scores)."""
        import torch

        with torch.inference_mode():
            det, tag = self.infer(torch.from_numpy(img_sq[None]).to(self.device))
            det = det[0].float().cpu().numpy()
            tag = tag[0].float().permute(0, 2, 3, 1).cpu().numpy()  # (K, H, W, T)
        t0 = time.perf_counter()
        people, scores = self.parser.parse(det, tag)
        self.decode_s.append(time.perf_counter() - t0)
        scale = img_sq.shape[0] / det.shape[-1]
        for person in people:
            person[:, :2] *= scale
        return list(people), scores


def main(argv: Optional[Sequence[str]] = None):
    args = parse_args(argv)
    cam = args.input.lower() in ("camera", "webcam") or args.input.isdigit()
    live = args.live or args.no_display or args.max_frames
    if cam or live or args.input.lower().endswith(VIDEO_SUFFIXES):
        raise NotImplementedError(NO_VIDEO)

    from ..data.jpeg import decode_jpeg
    from ..utils import vis

    engine = NativeBackend(args) if args.backend == "native" else build_engine(args)
    os.makedirs(args.output, exist_ok=True)
    skipped = []

    def frames():
        if os.path.isdir(args.input):
            for path in sorted(glob.glob(os.path.join(args.input, "*"))):
                try:
                    image = decode_jpeg(path)
                except (ValueError, OSError):
                    skipped.append(path)
                    continue
                yield os.path.basename(path), image
        else:
            yield os.path.basename(args.input), decode_jpeg(args.input)

    n, t0 = 0, time.time()
    for name, image in frames():
        sq = center_crop_square(image, args.input_size)
        people, scores = engine.process(sq)
        canvas = vis.draw_skeleton(sq, people, args.dataset)
        vis.write_png(os.path.join(args.output, os.path.splitext(name)[0] + ".png"), canvas)
        n += 1
        if n % 10 == 0:
            print(f"{n} frames ({n / (time.time() - t0):.2f} fps)")
    if skipped:
        print(f"skipped {len(skipped)} files the JPEG decoder refuses")
    if args.backend == "native" and engine.decode_s:
        print(f"host decode: {1e3 * float(np.mean(engine.decode_s)):.3f} ms per image")
    print(f"done: {n} frames -> {args.output} ({n / max(time.time() - t0, 1e-9):.2f} fps)")
    return n


if __name__ == "__main__":
    main()
