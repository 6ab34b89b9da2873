"""Whether ``torch.profiler`` (CUPTI) keeps every kernel of a trace as the
process ages.

    python -m litepose_tpu_torch.tools.cupti_check [--seconds 240] [--every 20]

Every ``--every`` seconds for ``--seconds``, it traces 3 launches of K1
(``nms_topk`` on seeded (64, 14, 224, 224) bf16 planes: 6 kernel rows) 4
times back to back and 3 Auto-S forwards at b16 (a seeded model: 3 x 39
depthwise rows) twice, as ``tools/timing.py:trace_kernels`` traces them,
and prints the rows each trace kept; between checkpoints it keeps the card
busy with forwards and K1.  ``timing.breakdown`` traces again while a
trace is empty or short of a counted port kernel's rows.  It runs on a
card only.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional, Sequence

import torch

from ..arch import get_arch
from ..models.litepose import ModelSpec, init_litepose
from ..ops.topk import nms_topk
from .export import check_device
from .timing import family_of, trace_kernels

K1_ROWS = 6  # 3 launches, a band and a merge kernel each
DEPTHWISE_ROWS = 3 * 39  # 3 Auto-S forwards


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seconds", type=float, default=240.0)
    ap.add_argument("--every", type=float, default=20.0)
    ap.add_argument("--device", default="cuda")
    return ap


def rows(fn, family: str) -> int:
    found, _ = trace_kernels(fn, 3)
    return sum(n for name, (n, _) in found.items() if family_of(name) == family)


def main(argv: Optional[Sequence[str]] = None, log=print) -> list:
    """Returns one {"t_s", "k1": [rows of 4 traces], "depthwise": [rows of
    2 traces]} a checkpoint."""
    args = build_parser().parse_args(argv)
    device = check_device(args.device)
    if device.type != "cuda":
        raise SystemExit("cupti_check traces the card: --device cuda")
    gen = torch.Generator(device=device).manual_seed(0)
    planes = torch.rand((64, 14, 224, 224), generator=gen, device=device).to(torch.bfloat16)
    model = init_litepose(ModelSpec(num_joints=14), get_arch("auto-S"),
                          torch.Generator().manual_seed(0), compute_dtype=torch.bfloat16,
                          out_dtype=torch.bfloat16).eval().to(device)
    x = torch.randn((16, 3, 448, 448), generator=gen, device=device).to(torch.bfloat16)
    log(f"# {torch.cuda.get_device_name(device)}; K1 rows of {K1_ROWS} in 4 traces back to "
        f"back, depthwise rows of {DEPTHWISE_ROWS} in 2")
    out = []
    t0 = time.perf_counter()
    with torch.inference_mode():
        def k1():
            return nms_topk(planes, 30, 5)

        def forward():
            return model(x)

        while time.perf_counter() - t0 < args.seconds:
            point = {"t_s": time.perf_counter() - t0,
                     "k1": [rows(k1, "K1 nms_topk") for _ in range(4)],
                     "depthwise": [rows(forward, "depthwise conv") for _ in range(2)]}
            out.append(point)
            log(f"t={point['t_s']:5.0f} s  K1 {point['k1']}  depthwise {point['depthwise']}")
            t1 = time.perf_counter()
            while time.perf_counter() - t1 < args.every:
                for _ in range(10):
                    forward()
                    k1()
                torch.cuda.synchronize()
    log(json.dumps(out))
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
