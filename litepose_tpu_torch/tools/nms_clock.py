"""Where K5's ring instance (``csrc/heatmap_nms.cu``) spends its cycles, on the card.

    python -m litepose_tpu_torch.tools.nms_clock [--out FILE.json] [--parent DIR]

(from the root of a checkout; needs a CUDA device and nvcc).  Builds the
kernels again with ``-DLP_NMS_CLOCK``, which turns on clock64 counters in
thread 0 of the first 64 CTAs of a ring launch: its cycles from start to
end, waiting on the ring's mbarriers, at the barrier that ends a stage,
issuing the copies, computing (the ring loads, the window maxima, the kept
chunk) and storing (the 16-byte stores, with any wait for the value they
write), and the rows and stages it staged.  Runs K5 (window 5) at
``chip_smoke.py``'s serving shape (64, 14, 224, 224) bf16 and eval shape
(32, 14, 448, 448) fp32 on its planted planes (seed 7), holds each result
to the twin, and prints the plan (threads, CTAs an SM, grid, rows a CTA)
and how the 64 CTAs' cycles split, summed and for the median CTA.  A warp
shares its SM's issue slots with the others, so a share is thread 0's wall
time in that part, stalls and other warps' turns included.

Then the ceiling: the kernels built with ``-DLP_NMS_COPY`` (the same
launch, ring and stores, each cell stored as staged: the data movement
without the window max) timed against the ordinary build at the two
shapes, and PyTorch's copy of the same bytes (``out.copy_(det)``) beside
them.

``--parent DIR``: also build the kernels of another checkout (e.g. the
parent commit unpacked by ``git archive``) from its own sources, and time
its K5 against this checkout's on the same planes at the serving and eval
shapes and at ``parse_single``'s one-image shapes (14, 224, 224) bf16 and
(14, 448, 448) fp32.

Each comparison: CUDA events over 20 launches after 3, in turns A, B, B,
A, and each kernel's mean device time over 20 launches from CUPTI
(torch.profiler), which at the one-image shapes is the kernel's own time
where the events measure the host's launches; each result but the copy
build's held to the twin.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import importlib.util
import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
# csrc/heatmap_nms.cu: kClockCtas, kClockSlots
CTAS, SLOTS = 64, 10
NMS_KERNEL = 5
PARTS = ("wait", "barrier", "issue", "compute", "store")


def launch(lib, det, out):
    import torch

    err = lib.lp_heatmap_nms(det.data_ptr(), int(det.dtype == torch.bfloat16), out.data_ptr(),
                             det.shape[0], det.shape[1], det.shape[2], NMS_KERNEL // 2,
                             torch.cuda.current_stream(det.device).cuda_stream)
    if err:
        raise RuntimeError(f"lp_heatmap_nms: CUDA error {err}")


def held(out, det) -> None:
    """Raise unless ``out`` is the twin's suppressed map of ``det``, bit for bit."""
    import torch

    from litepose_tpu_torch.ops.nms import nms_suppress_ref

    torch.cuda.synchronize()
    bits = torch.int32 if det.dtype == torch.float32 else torch.int16
    if not torch.equal(out.view(bits), nms_suppress_ref(det, NMS_KERNEL).view(bits)):
        raise AssertionError(f"K5 {tuple(det.shape)} {det.dtype} != twin")


def split(lib, det) -> dict:
    """Three launches of the clock build; the last one's counters, after
    its result is held to the twin."""
    import numpy as np
    import torch

    from litepose_tpu_torch.ops.library import heatmap_nms_plan

    out = torch.empty_like(det)
    for _ in range(3):
        launch(lib, det, out)
    held(out, det)
    slots = np.zeros((CTAS, SLOTS), np.int64)
    if lib.lp_heatmap_nms_clock(ctypes.c_void_p(slots.ctypes.data)):
        raise RuntimeError("lp_heatmap_nms_clock failed")
    plan = heatmap_nms_plan(det, NMS_KERNEL, lib)
    s = slots[:min(CTAS, plan["grid"])]
    total = s[:, 0]
    parts = dict(zip(PARTS, s[:, 1:6].T))
    median = int(np.argsort(total)[len(total) // 2])
    return {"shape": list(det.shape), "dtype": str(det.dtype).replace("torch.", ""),
            "plan": plan, "ctas": len(s),
            "share_of_cycles": {k: float(v.sum() / total.sum()) for k, v in parts.items()},
            "other_share": float(1 - s[:, 1:6].sum() / total.sum()),
            "median_cta": {"cycles": int(total[median]), "rows": int(s[median, 6]),
                           "stages": int(s[median, 7]), "copies_issued": int(s[median, 8]),
                           **{k: int(v[median]) for k, v in parts.items()}},
            "cycles_per_row": float(total.sum() / s[:, 6].sum()),
            "sms": len(set(s[:, 9].tolist())),
            "slowest_cta_cycles": int(total.max()), "fastest_cta_cycles": int(total.min())}


def load_lib(path):
    from litepose_tpu_torch.kernels import build

    lib = ctypes.CDLL(str(path))
    for name in ("lp_heatmap_nms", "lp_heatmap_nms_plan"):
        if hasattr(lib, name):  # a parent checkout's library may have no plan
            getattr(lib, name).argtypes = build._SIGNATURES[name]
    return lib


def parent_library(parent: Path) -> Path:
    """The kernel library of the checkout at ``parent``, built from its own
    sources by its own ``kernels/build.py``."""
    spec = importlib.util.spec_from_file_location(
        "parent_kernels_build", parent / "litepose_tpu_torch" / "kernels" / "build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.build()[0]


def in_turns(libs: dict, shapes, card, unchecked=()) -> dict:
    """K5's ms by CUDA events and by CUPTI for the two libraries ``libs``
    (name -> library), in turns A, B, B, A at each (name, planes) of
    ``shapes``; each result held to the twin but those of ``unchecked``."""
    import torch

    from litepose_tpu_torch.tools.timing import cuda_ms, profiler_ms

    a, b = libs
    record = {}
    for name, det in shapes:
        ms = {who: [] for who in libs}
        cupti = {who: [] for who in libs}
        for who in (a, b, b, a):
            out = torch.empty_like(det)
            call = functools.partial(launch, libs[who], det, out)
            ms[who].append(cuda_ms(call))
            cupti[who].append(profiler_ms([call] * 20, ["heatmap_nms"])["heatmap_nms"])
            if who not in unchecked:
                held(out, det)
        record[name] = {"shape": list(det.shape), "dtype": str(det.dtype).replace("torch.", ""),
                        "events_ms": ms, "cupti_ms": cupti}

        def show(ts):
            return ", ".join("none" if t is None else f"{t:.4f}" for t in ts)

        print(f"K5 {name} {tuple(det.shape)} on {card}: "
              + "; ".join(f"{who} events {show(ms[who])} ms, CUPTI {show(cupti[who])} ms"
                          for who in libs))
    return record


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", help="also write the record to this JSON file")
    parser.add_argument("--parent", help="a checkout whose K5 to time against this one's")
    args = parser.parse_args()

    import torch

    sys.path.insert(0, str(REPO))
    import chip_smoke
    from litepose_tpu_torch.kernels import build
    from litepose_tpu_torch.tools.timing import cuda_ms

    if not torch.cuda.is_available():
        raise SystemExit("nms_clock: needs a CUDA device")
    dev = torch.device("cuda:0")
    card = chip_smoke.card_line()
    # the builds at once: each runs its nvcc processes in parallel
    flags = {"this": (), "clock": ("-DLP_NMS_CLOCK",), "copy": ("-DLP_NMS_COPY",)}
    with ThreadPoolExecutor(len(flags)) as pool:
        libs = dict(zip(flags, pool.map(lambda f: load_lib(build.build(extra_flags=f)[0]),
                                        flags.values())))
    clock = libs["clock"]
    clock.lp_heatmap_nms_clock.argtypes = (ctypes.c_void_p,)

    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
    record = {"card": card}
    timed = []
    for name, shape, dtype in (("serving", (chip_smoke.BATCH, 14, 224, 224), torch.bfloat16),
                               ("eval", (chip_smoke.EVAL_BATCH, 14, 448, 448), torch.float32)):
        det = chip_smoke.planted_planes(gen, shape, dev).to(dtype).reshape(-1, *shape[2:])
        r = split(clock, det)
        record[name] = r
        p, m, sh = r["plan"], r["median_cta"], r["share_of_cycles"]
        print(f"K5 clock {name} {tuple(shape)} {r['dtype']} on {card}: {p['threads']} threads, "
              f"{p['ctas_per_sm']} CTAs an SM, grid {p['grid']}, {p['rows_per_cta']} rows a CTA "
              f"in stages of {p['stage_rows']}; the first {r['ctas']} CTAs' cycles (on "
              f"{r['sms']} SMs): waiting on the ring {100 * sh['wait']:.1f}%, at the stage "
              f"barrier {100 * sh['barrier']:.1f}%, issuing copies {100 * sh['issue']:.1f}%, "
              f"computing {100 * sh['compute']:.1f}%, storing {100 * sh['store']:.1f}%, other "
              f"{100 * r['other_share']:.1f}%; {r['cycles_per_row']:.1f} cycles a staged row; "
              f"median CTA {m['cycles']} cycles for {m['rows']} rows in {m['stages']} stages "
              f"(wait {m['wait']}, barrier {m['barrier']}, {m['copies_issued']} copies "
              f"issued in {m['issue']}, compute {m['compute']}, store {m['store']}); slowest "
              f"{r['slowest_cta_cycles']}, fastest {r['fastest_cta_cycles']}")
        timed.append((name, det))
        timed.append((f"{name} one image", det[:14].clone()))
    print("the window max against the data movement alone (the LP_NMS_COPY build):")
    record["ceiling"] = in_turns({"this": libs["this"], "copy": libs["copy"]}, timed[::2], card,
                                 unchecked=("copy",))
    for name, det in timed[::2]:
        out = torch.empty_like(det)
        ms = [cuda_ms(lambda: out.copy_(det)) for _ in range(2)]
        record["ceiling"][name]["torch_copy_ms"] = ms
        print(f"  PyTorch's copy of the same bytes (out.copy_(det), {name}): "
              f"{', '.join(f'{t:.4f}' for t in ms)} ms")
    if args.parent:
        parent = load_lib(parent_library(Path(args.parent).resolve()))
        print("against the parent checkout's K5:")
        record["against_parent"] = in_turns({"parent": parent, "this": libs["this"]}, timed,
                                            card)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)


if __name__ == "__main__":
    main()
