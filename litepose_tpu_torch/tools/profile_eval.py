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
- the whole step (``infer``, then ``parse_batch`` with adjust and refine);
- the step split: the same step, run back to back, with a mark after each
  piece (``parse_batch``'s calls in its order; the person scores fall in
  the refine piece), each piece's time the gap between its marks on the
  card's timeline, in rounds that alternate with rounds of the whole step.
  The sum of the split beside the whole step of the same rounds: total -
  sum is the slack.  A piece timed alone reads otherwise than in the step:
  where the card sets the pace, a small piece's own launches are hidden
  behind the forward's kernels in the step; where the host does (a small
  batch), it enqueues the step's calls more slowly than each piece's in a
  loop of its own.  The sum of the pieces alone is reported beside it.

The trained checkpoint is required (``--ckpt``, default
``assets/bench_ckpt.msgpack``): a seeded model's maps hold other peaks
and people, so the decode would do other work.  Timing and the kernel
families as in ``profile_model``: CUDA events on the card, the host clock
with the plain twins on ``--device cpu`` (for the tests only).
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import time
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from ..arch import get_arch
from .export import check_device
from .profile_model import BENCH_CKPT, ITERS, Sections, device_line, litepose, load_weights
from .timing import synchronize


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


def step_split(step: Callable, whole: Callable, device: torch.device, rounds: int,
               iters: int = ITERS, warmup: int = 2) -> Tuple[List[float], float]:
    """``step(mark)`` runs the step and calls ``mark()`` before its first
    piece and after each piece; ``whole()`` runs the step as it is.  Each
    round times ``iters`` back-to-back calls of ``whole``, then ``iters``
    back-to-back steps with marks, so that both meet the host as it is
    then (where the host sets the pace, its speed drifts over seconds).
    Returns (each piece's ms a step: the time between its marks, the
    whole step's ms a call), medians over ``rounds`` rounds: CUDA events
    on a card, the host clock on the CPU."""
    cuda = device.type == "cuda"

    def now():
        if not cuda:
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def ms(a, b) -> float:
        return a.elapsed_time(b) if cuda else (b - a) * 1e3

    for _ in range(warmup):
        whole()
        step(lambda: None)
    synchronize(device)
    per_round, wholes = [], []
    for _ in range(rounds):
        start = now()
        for _ in range(iters):
            whole()
        end = now()
        marks: list = []
        for _ in range(iters):
            step(lambda: marks.append(now()))
        synchronize(device)
        wholes.append(ms(start, end) / iters)
        n = len(marks) // iters
        gaps = [0.0] * (n - 1)
        for i in range(0, len(marks), n):
            for j in range(n - 1):
                gaps[j] += ms(marks[i + j], marks[i + j + 1])
        per_round.append([g / iters for g in gaps])
    pieces = [statistics.median(r[j] for r in per_round) for j in range(len(per_round[0]))]
    return pieces, statistics.median(wholes)


def main(argv: Optional[Sequence[str]] = None, weights=None, log=print) -> dict:
    """Run the pieces; ``weights`` (params, state) already read stand in for
    the checkpoint.  Returns {"device", "arch", "batch", "sections": {label:
    result as ``profile_model``'s}, "in_step": {piece: ms in the step},
    "total_ms" (the whole step in the split's rounds), "sum_ms" (of the
    split), "slack_ms", "alone_sum_ms" (of the pieces timed alone)}."""
    from ..core.engine import EngineConfig, PoseEngine
    from ..core.inference import normalize_images
    from ..data.synthetic import bench_scene_batch
    from ..ops.group import (GroupParams, adjust, match_by_tag_batch, parse_batch,
                             person_scores)
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

        def step(mark):
            mark()
            det, tag = infer(images)
            mark()
            tag_k, loc_k, val_k = top_k_peaks_batch(det, tag, m, kern, tag_layout="thw")
            mark()
            people, _ = match_by_tag_batch(tag_k, loc_k, val_k, gcfg)
            mark()
            people = adjust(people, det)
            mark()
            person_scores(people)
            refine_batch(people, det, tag, tag_layout="thw")
            mark()

        split, step_ms = step_split(step, lambda: parse_batch(
            *infer(images), gcfg, True, True, tag_layout="thw"), device, args.rounds)
        in_step = dict(zip(PIECES, split))
    log(f"{'  the step beside its split':44s} {step_ms:8.2f} ms/b{B} (the section above "
        f"{total['ms']:.2f})")
    for p in PIECES:
        log(f"{'  in the step: ' + p:44s} {in_step[p]:8.2f} ms/b{B} "
            f"(alone {sec.results[p]['ms']:.2f})")
    pieces = sum(in_step.values())
    alone = sum(sec.results[p]["ms"] for p in PIECES)
    log(f"{'  sum of pieces (in the step)':44s} {pieces:8.2f} ms/b{B} (alone {alone:.2f})")
    log(f"{'  scheduling slack (total - sum)':44s} {step_ms - pieces:8.2f} ms/b{B} "
        f"({100 * (step_ms - pieces) / step_ms:+.1f}% of the total)")
    out.update(in_step=in_step, total_ms=step_ms, sum_ms=pieces, slack_ms=step_ms - pieces,
               alone_sum_ms=alone)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
