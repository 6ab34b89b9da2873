"""Run one cell of the benchmark of ``litepose_tpu_torch`` once.

    python3 bench_h100/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The cell's configuration, traffic mix and
driver are found by name from ``BENCHMARK.json`` (``harness/spec.py``).
The run loads, warms up the cell's shapes, measures for ``--seconds`` (or,
with ``--trace 1``, traces a short sub-window of calls), checks what the
timed calls produced against the plain reference, and prints one JSON line
last on standard output: the end-to-end metrics, or with ``--trace 1`` the
per-layer metrics read by ``metrics/<name>.py``.  The numbers compared,
each with its limit, are the last lines of standard error.

It exits non-zero and prints no result without as many CUDA cards as the
cell asks for, and when a module of JAX or of the JAX package
``litepose_tpu`` was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
CACHE = os.path.join(BENCH, "_cache")


def parse(argv):
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def cache_env() -> None:
    """Compile caches at fixed paths inside the checkout, so only a cell's
    first run in a checkout fills them."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(CACHE, sub)


def main(argv=None) -> int:
    args = parse(argv)
    cache_env()
    for p in (ROOT, BENCH):
        if p not in sys.path:
            sys.path.insert(0, p)
    from harness import core, spec, trace

    try:
        bench = spec.load(ROOT)
        cell = spec.Cell(bench, ROOT, args.workload)
    except (OSError, ValueError, KeyError) as e:
        print(f"bench_h100: {e}", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    import torch

    notes = [f"set-up: import torch {time.perf_counter() - t0:.3f} s"]
    t0 = time.perf_counter()
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench_h100: {args.workload} needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    notes.append(f"set-up: CUDA driver init and device count {time.perf_counter() - t0:.3f} s; "
                 f"{torch.get_num_threads()} intra-op threads")
    ctx = core.Context(cell=args.workload, config=cell.config, traffic=cell.traffic, chips=chips,
                       seed=args.seed, seconds=args.seconds, trace=bool(args.trace), root=ROOT,
                       t_start=T_START)
    outcome = cell.driver.run(ctx)

    breakdown = None
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    if args.trace:
        record = dict(outcome.record, config=cell.config, traffic=cell.traffic, chips=chips)
        values = {name: reader.read(record) for name, reader in cell.readers().items()}
        metrics = {k: (v, units[k]) for k, v in values.items() if v is not None}
        breakdown = trace.breakdown(outcome.record)
    else:
        missing = [m["name"] for m in cell.end_to_end if m["name"] not in outcome.metrics]
        if missing:
            print(f"bench_h100: the driver took no {missing}", file=sys.stderr)
            return 3
        metrics = {m["name"]: (outcome.metrics[m["name"]], m["unit"]) for m in cell.end_to_end}

    found = core.loaded_forbidden()
    if found:
        print(f"bench_h100: the run loaded {found}: the port may not load JAX or the JAX "
              f"package", file=sys.stderr)
        return 3
    for line in notes + outcome.notes + core.check_lines(outcome):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(core.result_line(outcome, metrics, breakdown), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
