"""Where the grouping kernels' cycles go, on the card.

    python -m litepose_tpu_torch.tools.group_clock [--out FILE.json]

(from the root of a checkout; needs a CUDA device and nvcc).  Builds the
kernels again with ``-DLP_GROUP_CLOCK``, which turns on clock64 stamps at
each joint step of the first 64 images (``csrc/group_common.cuh``), and runs
K2 and K3 on ``chip_smoke.py``'s planted timed inputs (seed 7; K2 at
(64, 14, 30, 1), K3 at (64, 14, 30, 2) with its edge images).  For each
kernel's slowest image it prints the cycles of the staging and, summed over
the joint steps, of the means, the cost rows, the assignment and the
join/spawn, with the assignment's cycles per step of its chain (greedy
rounds; JV sweeps plus augment steps, counted by the twin).  Then the
latency in cycles of the operations the chains are made of, each timed as a
dependent chain of 1000 in one warp.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

# each loop: a dependent chain of one operation (with the integer add or
# mask that keeps it dependent), 1000 times
LATENCY_SRC = r"""
#include <cstdio>
__global__ void lat(unsigned* out, long long* cyc, int n) {
  const int lane = threadIdx.x;
  unsigned x = lane * 7u + 3u;
  __shared__ unsigned sh[32];
  sh[lane] = lane;
  __syncwarp();
  long long t[10];
  t[0] = clock64();
  for (int i = 0; i < n; ++i) x = __reduce_min_sync(0xffffffffu, x + lane);
  t[1] = clock64();
  for (int i = 0; i < n; ++i) x = __shfl_sync(0xffffffffu, x, (x + lane) & 31);
  t[2] = clock64();
  for (int i = 0; i < n; ++i) x = __ffs(__ballot_sync(0xffffffffu, ((x + lane) & 3) == 0));
  t[3] = clock64();
  for (int i = 0; i < n; ++i) x = sh[(x + lane) & 31];
  t[4] = clock64();
  float f = __uint_as_float(x) * 1e-30f + 1.0f;
  for (int i = 0; i < n; ++i) f = __fadd_rn(f, 1.0f);
  t[5] = clock64();
  for (int i = 0; i < n; ++i) f = __fsqrt_rn(f);
  t[6] = clock64();
  for (int i = 0; i < n; ++i) f = __fdiv_rn(f, 3.0f + lane);
  t[7] = clock64();
  for (int i = 0; i < n; ++i) f = rintf(__fmul_rn(f, 3.7f));
  t[8] = clock64();
  out[lane] = x + __float_as_uint(f);
  if (lane == 0)
    for (int k = 0; k < 8; ++k) cyc[k] = t[k + 1] - t[k];
}
int main() {
  unsigned* out;
  long long* cyc;
  long long h[8];
  cudaMalloc(&out, 128);
  cudaMalloc(&cyc, 64);
  for (int rep = 0; rep < 2; ++rep) lat<<<1, 32>>>(out, cyc, 1000);
  cudaMemcpy(h, cyc, sizeof(h), cudaMemcpyDeviceToHost);
  for (int k = 0; k < 8; ++k) printf("%.1f\n", h[k] / 1000.0);
  return 0;
}
"""
LATENCY_NAMES = ("redux.min", "shfl.idx", "ballot+ffs", "lds", "fadd", "fsqrt_rn", "fdiv_rn",
                 "fmul+rint")


def latencies(work: Path) -> dict:
    from litepose_tpu_torch.kernels import build

    src, exe = work / "lat.cu", work / "lat"
    src.write_text(LATENCY_SRC)
    subprocess.run([build.find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "--fmad=false", "-o", str(exe), str(src)], check=True)
    out = subprocess.run([str(exe)], check=True, capture_output=True, text=True).stdout
    return dict(zip(LATENCY_NAMES, (float(v) for v in out.split())))


def breakdown(lib, entry: str, tag, val, cfg) -> dict:
    """One launch of ``entry`` from the clock build; the slowest image's
    cycles by phase, with its chain as the twin counts it."""
    import numpy as np
    import torch

    from litepose_tpu_torch.ops.group import match_by_tag

    dev = tag.device
    B, K, M, T = tag.shape
    order = torch.tensor(cfg.joint_order, dtype=torch.int32, device=dev)
    cid = torch.empty((B, K, M), dtype=torch.int32, device=dev)
    ncl = torch.empty((B,), dtype=torch.int32, device=dev)
    for _ in range(3):  # warm, then read the last launch's stamps
        err = getattr(lib, entry)(
            tag.data_ptr(), val.data_ptr(), order.data_ptr(), cid.data_ptr(), ncl.data_ptr(),
            B, K, M, T, len(cfg.joint_order), cfg.max_people, cfg.max_clusters,
            cfg.detection_threshold, cfg.tag_threshold, int(cfg.use_detection_val),
            int(cfg.ignore_too_much), torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"{entry}: CUDA error {err}")
    torch.cuda.synchronize()
    stamps = np.zeros((64, 16, 8), np.int64)
    if getattr(lib, entry + "_clock")(ctypes.c_void_p(stamps.ctypes.data)):
        raise RuntimeError(f"{entry}_clock failed")
    chain = torch.zeros(B, dtype=torch.int64, device=dev)
    want_c, _ = match_by_tag(tag, val, cfg, chain)
    if not torch.equal(cid, want_c):
        raise AssertionError(f"{entry} (clock build) != twin")
    n = min(B, 64)
    total = stamps[:n, 15, 2] - stamps[:n, 15, 0]
    b = int(total.argmax())
    s = stamps[b, :len(cfg.joint_order)]
    phases = {"means": s[:, 1] - s[:, 0], "cost rows": s[:, 2] - s[:, 1],
              "assignment": s[:, 3] - s[:, 2], "join/spawn": s[:, 4] - s[:, 3]}
    out = {"image": b, "cycles": int(total[b]),
           "staging": int(stamps[b, 15, 1] - stamps[b, 15, 0]),
           **{k: int(v.sum()) for k, v in phases.items()},
           "chain": int(chain[b]),
           "cycles_per_chain_step": float(phases["assignment"].sum() / max(int(chain[b]), 1))}
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", help="also write the record to this JSON file")
    args = parser.parse_args()

    import numpy as np
    import torch

    sys.path.insert(0, str(REPO))
    import chip_smoke
    from litepose_tpu_torch.kernels import build
    from litepose_tpu_torch.ops.group import GroupParams, StaticGroupCfg

    if not torch.cuda.is_available():
        raise SystemExit("group_clock: needs a CUDA device")
    dev = torch.device("cuda:0")
    card = chip_smoke.card_line()
    path, _, _ = build.build(extra_flags=("-DLP_GROUP_CLOCK",))
    lib = ctypes.CDLL(str(path))
    for entry in ("lp_group_greedy", "lp_group_hungarian"):
        getattr(lib, entry).argtypes = build._SIGNATURES[entry]
        getattr(lib, entry + "_clock").argtypes = (ctypes.c_void_p,)

    # chip_smoke.py's draws, in its order: K2's four, then K3's three
    rng = np.random.default_rng(chip_smoke.SEED)
    draws = [chip_smoke.planted_groups(rng, chip_smoke.BATCH, 14, 30, T) for T in (1, 1, 2, 2)]
    draws += [chip_smoke.planted_groups(rng, chip_smoke.BATCH, 14, 30, T, edges=True)
              for T in (1, 1, 2)]
    gcfg = StaticGroupCfg.from_params(GroupParams(num_joints=14, detection_threshold=0.1),
                                      assignment="greedy")
    record = {"card": card}
    for name, entry, (tag, val), cfg in (
            ("K2 planted (64,14,30,1)", "lp_group_greedy", draws[0], gcfg),
            ("K3 planted, edges (64,14,30,2)", "lp_group_hungarian", draws[6],
             gcfg._replace(assignment="hungarian"))):
        r = breakdown(lib, entry, torch.from_numpy(tag).to(dev), torch.from_numpy(val).to(dev),
                      cfg)
        record[name] = r
        print(f"{name} on {card}: slowest image {r['image']}, {r['cycles']} cycles: staging "
              f"{r['staging']}, means {r['means']}, cost rows {r['cost rows']}, assignment "
              f"{r['assignment']} ({r['chain']} chain steps, {r['cycles_per_chain_step']:.1f} "
              f"cycles a step), join/spawn {r['join/spawn']}")
    record["latency_cycles"] = latencies(path.parent)
    print("latency in cycles, a dependent chain of 1000 in one warp: " + ", ".join(
        f"{k} {v:.1f}" for k, v in record["latency_cycles"].items()))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)


if __name__ == "__main__":
    main()
