"""Where K1' (``csrc/nms_topk_loop.cu``) spends its cycles, on the card.

    python -m litepose_tpu_torch.tools.topk_clock [--out FILE.json]

(from the root of a checkout; needs a CUDA device and nvcc).  Builds the
kernels again with ``-DLP_TOPK_CLOCK``, which turns on clock64 stamps in the
CTAs of the first 64 planes (the CTA's start, the end of pass 1 with the
cycles thread 0 spent waiting for a chunk's rows and at the chunks' end
barrier, the end of each round, the end of the chain, and the count of row
refills), and runs
K1' at ``chip_smoke.py``'s serving shape (64, 14, 224, 224) bf16 and eval
shape (32, 14, 448, 448) fp32 on its planted planes (seed 7: noise, a row of
tied peaks, tied peaks down a column, an empty plane, a negated one), with
the NMS window 5 and M = 30.  For each shape it prints the CTAs an SM holds
(the occupancy calculator), the slowest plane's pass-1 cycles (the plane
through the ring into the row caches) with their waits, its chain cycles
(the M rounds) and cycles per round, with the median over the 64 planes and
their refills.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
# csrc/nms_topk_loop.cu: kClockPlanes, kClockHead, kClockHead + kClockRounds
PLANES, HEAD, STAMPS = 64, 8, 8 + 64
M, NMS_KERNEL = 30, 5


def timeline(lib, det, m: int, kernel: int) -> dict:
    """Three launches of the clock build; the last one's stamps, after its
    result is held to the twin."""
    import numpy as np
    import torch

    from litepose_tpu_torch.ops.topk import nms_topk_ref

    B, K, H, W = det.shape
    val = torch.empty((B, K, m), dtype=torch.float32, device=det.device)
    pos = torch.empty((B, K, m), dtype=torch.int32, device=det.device)
    for _ in range(3):
        err = lib.lp_nms_topk_loop(det.data_ptr(), int(det.dtype == torch.bfloat16),
                                   val.data_ptr(), pos.data_ptr(), B * K, H, W, m, kernel // 2,
                                   torch.cuda.current_stream(det.device).cuda_stream)
        if err:
            raise RuntimeError(f"lp_nms_topk_loop: CUDA error {err}")
    torch.cuda.synchronize()
    want_v, want_p = nms_topk_ref(det, m, kernel)
    if not (torch.equal(pos, want_p) and torch.equal(val.view(torch.int32),
                                                     want_v.view(torch.int32))):
        raise AssertionError("K1' (clock build) != twin")
    stamps = np.zeros((PLANES, STAMPS), np.int64)
    if lib.lp_nms_topk_loop_clock(ctypes.c_void_p(stamps.ctypes.data)):
        raise RuntimeError("lp_nms_topk_loop_clock failed")
    n = min(B * K, PLANES)
    s = stamps[:n]
    pass1, chain = s[:, 1] - s[:, 0], s[:, 2] - s[:, 1]
    rounds = np.diff(np.concatenate([s[:, 1:2], s[:, HEAD:HEAD + min(m, STAMPS - HEAD)]],
                                    axis=1), axis=1)
    p = int((pass1 + chain).argmax())
    blocks = ctypes.c_int()
    if lib.lp_nms_topk_loop_occupancy(H, W, kernel // 2, int(det.dtype == torch.bfloat16),
                                      ctypes.byref(blocks)):
        raise RuntimeError("lp_nms_topk_loop_occupancy failed")
    return {"shape": [B, K, H, W], "dtype": str(det.dtype).replace("torch.", ""),
            "ctas_an_sm": blocks.value,
            "slowest_plane": p, "pass1_cycles": int(pass1[p]),
            "pass1_row_wait_cycles": int(s[p, 4]), "pass1_barrier_cycles": int(s[p, 5]),
            "chain_cycles": int(chain[p]),
            "cycles_per_round": float(chain[p] / m), "slowest_round_cycles": int(rounds[p].max()),
            "refills": int(s[p, 3]),
            "median_pass1_cycles": float(np.median(pass1)),
            "median_chain_cycles": float(np.median(chain)),
            "median_cycles_per_round": float(np.median(chain) / m),
            "refills_of_the_planes": int(s[:, 3].sum()), "planes": n}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", help="also write the record to this JSON file")
    args = parser.parse_args()

    import torch

    sys.path.insert(0, str(REPO))
    import chip_smoke
    from litepose_tpu_torch.kernels import build

    if not torch.cuda.is_available():
        raise SystemExit("topk_clock: needs a CUDA device")
    dev = torch.device("cuda:0")
    card = chip_smoke.card_line()
    path, _, _ = build.build(extra_flags=("-DLP_TOPK_CLOCK",))
    lib = ctypes.CDLL(str(path))
    lib.lp_nms_topk_loop.argtypes = build._SIGNATURES["lp_nms_topk_loop"]
    lib.lp_nms_topk_loop_clock.argtypes = (ctypes.c_void_p,)
    lib.lp_nms_topk_loop_occupancy.argtypes = (ctypes.c_int,) * 4 + (ctypes.POINTER(ctypes.c_int),)

    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
    record = {"card": card}
    for name, shape, dtype in (("serving", (chip_smoke.BATCH, 14, 224, 224), torch.bfloat16),
                               ("eval", (chip_smoke.EVAL_BATCH, 14, 448, 448), torch.float32)):
        det = chip_smoke.planted_planes(gen, shape, dev).to(dtype).contiguous()
        r = timeline(lib, det, M, NMS_KERNEL)
        record[name] = r
        print(f"K1' {name} {tuple(shape)} {r['dtype']} on {card}, {r['ctas_an_sm']} CTAs an SM: "
              f"slowest of the first {r['planes']} planes (plane {r['slowest_plane']}): pass 1 "
              f"{r['pass1_cycles']} cycles (thread 0 waiting for rows {r['pass1_row_wait_cycles']}, "
              f"at the chunks' end barrier {r['pass1_barrier_cycles']}), chain "
              f"{r['chain_cycles']} cycles ({r['cycles_per_round']:.1f} a round, "
              f"the slowest round {r['slowest_round_cycles']}; {r['refills']} refills); median "
              f"pass 1 {r['median_pass1_cycles']:.0f}, chain {r['median_chain_cycles']:.0f} "
              f"({r['median_cycles_per_round']:.1f} a round); {r['refills_of_the_planes']} "
              f"refills in the {r['planes']} planes")
        del det
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)


if __name__ == "__main__":
    main()
