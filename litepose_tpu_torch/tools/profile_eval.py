"""The eval protocol's step split into its pieces, on the card
(counterpart of ``tools/profile_eval.py``).

    python -m litepose_tpu_torch.tools.profile_eval [--batch 32] [--arch auto-S]
        [--ckpt PATH] [--rounds 5] [--device cuda]

The step of ``bench.py``'s eval-protocol number (flip test, the projection
to the input size, exact top-M, Hungarian grouping, adjust, refine) on
``bench_scene_batch`` images already on the card, in pieces:

- the flip-concat forward: one forward of 2B normalized images;
- ``infer``: the forward, the flip merge and the projection; the glue is
  infer - forward;
- K1 (NMS + exact top-M at the decode resolution, ``top_k_peaks_batch``),
  K3 grouping (``match_by_tag_batch``), adjust and K4 refine
  (``refine_batch``), each on maps, peaks and people captured once from
  the step's own outputs;
- the whole step (``infer``, then ``parse_batch`` with adjust and refine),
  and the sum of the pieces beside it: total - sum is the slack.

The trained checkpoint is required (``--ckpt``, default
``assets/bench_ckpt.msgpack``): a seeded model's maps hold other peaks
and people, so the decode would do other work.  Timing and the kernel
families as in ``profile_model``: CUDA events on the card, the host clock
with the plain twins on ``--device cpu`` (for the tests only).
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional, Sequence

import torch

from ..arch import get_arch
from .export import check_device
from .profile_model import BENCH_CKPT, Sections, device_line, litepose, load_weights


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="auto-S")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--rounds", type=int, default=5, help="timed rounds a piece")
    ap.add_argument("--device", default="cuda")
    return ap


PIECES = ("infer (fwd + glue + project)", "exact NMS+top-M (K1)", "grouping (K3 hungarian)",
          "adjust (quarter-pixel)", "refine (K4 penalized argmax fill)")


def main(argv: Optional[Sequence[str]] = None, weights=None, log=print) -> dict:
    """Run the pieces; ``weights`` (params, state) already read stand in for
    the checkpoint.  Returns {"device", "arch", "batch", "sections": {label:
    result as ``profile_model``'s}, "total_ms", "sum_ms", "slack_ms"}."""
    from ..core.engine import EngineConfig, PoseEngine
    from ..core.inference import normalize_images
    from ..data.synthetic import bench_scene_batch
    from ..ops.group import GroupParams, adjust, match_by_tag_batch, parse_batch
    from ..ops.refine import refine_batch
    from ..ops.topk import top_k_peaks_batch
    from .profile_model import inference_flags

    args = build_parser().parse_args(argv)
    device = check_device(args.device)
    arch = get_arch(args.arch)
    B, img = args.batch, arch.img_size
    if weights is None:
        ckpt = args.ckpt or str(BENCH_CKPT)
        if not os.path.isfile(ckpt):
            sys.exit("trained checkpoint required (a seeded model's maps decode other work)")
        weights = load_weights(ckpt, log)
    images = torch.from_numpy(bench_scene_batch(B, img)).to(device)
    log(f"# device={device_line(device)} arch={args.arch} img={img} batch={B}")

    model = litepose(weights, arch, device)  # bf16 convs, fp32 maps: phase 9's
    engine = PoseEngine(model, inference_flags(flip_test=True, decode_bf16=False),
                        GroupParams(num_joints=14, detection_threshold=0.1, nms_kernel=5,
                                    nms_padding=2),
                        EngineConfig(input_size=img), device=device)
    infer = engine.infer_fn((img, img), (img, img))
    gcfg = engine.group_cfg  # hungarian, exact
    sec = Sections(device, B, args.rounds, log)
    out = {"device": device_line(device), "arch": args.arch, "batch": B,
           "sections": sec.results}

    def forward():
        xn = normalize_images(images)
        return model(torch.cat([xn, xn.flip(3)], 0))

    with torch.inference_mode():
        fwd = sec.run("flip-concat forward (2B)", forward)
        inf = sec.run(PIECES[0], lambda: infer(images))
        log(f"{'  -> glue (infer - forward)':44s} {inf['ms'] - fwd['ms']:8.2f} ms/b{B}")
        # the decode pieces on the step's own maps, peaks and people, captured once
        det0, tag0 = infer(images)
        m, kern = gcfg.max_people, gcfg.nms_kernel
        sec.run(PIECES[1], lambda: top_k_peaks_batch(det0, tag0, m, kern, tag_layout="thw"))
        tag_k0, loc_k0, val_k0 = top_k_peaks_batch(det0, tag0, m, kern, tag_layout="thw")
        sec.run(PIECES[2], lambda: match_by_tag_batch(tag_k0, loc_k0, val_k0, gcfg))
        people0, _ = match_by_tag_batch(tag_k0, loc_k0, val_k0, gcfg)
        sec.run(PIECES[3], lambda: adjust(people0, det0))
        sec.run(PIECES[4], lambda: refine_batch(people0, det0, tag0, tag_layout="thw"))
        total = sec.run("TOTAL protocol step", lambda: parse_batch(
            *infer(images), gcfg, True, True, tag_layout="thw"))
    pieces = sum(sec.results[p]["ms"] for p in PIECES)
    log(f"{'  sum of pieces':44s} {pieces:8.2f} ms/b{B}")
    log(f"{'  scheduling slack (total - sum)':44s} {total['ms'] - pieces:8.2f} ms/b{B} "
        f"({100 * (total['ms'] - pieces) / total['ms']:+.1f}% of the total)")
    out.update(total_ms=total["ms"], sum_ms=pieces, slack_ms=total["ms"] - pieces)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
