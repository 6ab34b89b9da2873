"""Closed-loop serving: one client hands ``batch`` uint8 images at a time
to ``PoseEngine.process_batch_square`` and waits for the people.

Traffic parameters (``traffic/<name>.json``): ``batch``; ``pool_batches``,
the distinct batches made in set-up from the seed and cycled through;
``warmup_calls``; ``trace_calls``, the calls of the traced sub-window;
and ``scene``, the generator's ``people`` and ``person_size`` ranges.

The engine runs in its serving form: greedy grouping (K2), exact top-M (K1),
bf16 maps and decode, no flip, adjust, refine or projection.  Frames go in
as pageable numpy arrays, as a caller's frames arrive.

End-to-end metrics, on the host clock: ``img_per_s``, the images of every
call completed in the window over the window's seconds; ``p95_ms``, the
95th percentile of every call's latency, from handing over the batch to
its people on the host; ``setup_s``, from process start to the first timed
call.  The weights are the checkpoint the configuration names, read only if
its bytes match the configuration's ``weights_sha256``.  The last call of each pool batch is kept (its maps too, through
the engine's ``run_batch``) and checked after the window closes.
"""

from __future__ import annotations

import os
import time
import traceback

import numpy as np

from harness import msgpack, scenes, trace
from harness.core import Check, Context, Outcome


def _engine(cfg, dev):
    import torch

    from litepose_tpu_torch.arch import ArchConfig
    from litepose_tpu_torch.core.engine import EngineConfig, PoseEngine
    from litepose_tpu_torch.core.inference import InferenceFlags
    from litepose_tpu_torch.models.convert import litepose_from_jax
    from litepose_tpu_torch.models.litepose import ModelSpec
    from litepose_tpu_torch.ops.group import GroupParams

    J = cfg["num_joints"]
    spec = ModelSpec(num_joints=J, tag_per_joint=cfg["tag_per_joint"],
                     with_heatmaps_loss=tuple(cfg["with_heatmaps"]),
                     with_ae_loss=tuple(cfg["with_ae"]),
                     deconv_kernels=(cfg["deconv_kernel"],) * 3)
    params, state = msgpack.load_params(cfg["weights_path"], cfg["weights_sha256"])
    model = litepose_from_jax(params, state, spec, ArchConfig.from_dict(cfg["arch"]),
                              compute_dtype=getattr(torch, cfg["compute_dtype"]),
                              out_dtype=getattr(torch, cfg["maps_dtype"])).to(dev).eval()
    flags = InferenceFlags(num_joints=J, with_heatmaps_loss=tuple(cfg["with_heatmaps"]),
                           with_ae_loss=tuple(cfg["with_ae"]),
                           test_with_heatmaps=tuple(cfg["with_heatmaps"]),
                           test_with_ae=tuple(cfg["with_ae"]),
                           tag_per_joint=cfg["tag_per_joint"], flip_test=False)
    group = GroupParams(num_joints=J, max_num_people=cfg["max_people"],
                        detection_threshold=cfg["detection_threshold"],
                        tag_threshold=cfg["tag_threshold"],
                        use_detection_val=cfg["use_detection_val"],
                        nms_kernel=cfg["nms_kernel"], nms_padding=cfg["nms_kernel"] // 2,
                        joint_order=list(cfg["joint_order"]), max_clusters=cfg["max_clusters"])
    config = EngineConfig(input_size=cfg["input_size"], assignment="greedy",
                          topk_method="approx", with_adjust=False, with_refine=False,
                          project2image=False, decode_bf16=cfg["maps_dtype"] == "bfloat16")
    return PoseEngine(model, flags, group, config, device=dev), (params, state)


def run(ctx: Context) -> Outcome:
    import torch

    cfg, tr = dict(ctx.config), ctx.traffic
    cfg["weights_path"] = os.path.join(ctx.root, cfg["weights"])
    dev = torch.device(ctx.device)
    notes = [f"set-up: {time.perf_counter() - ctx.t_start:.3f} s to the driver"]
    if dev.type == "cuda":
        from litepose_tpu_torch.kernels import build

        _, build_s, _ = build.build()
        notes.append(f"set-up: kernel build {build_s:.3f} s (0 when the checkout's build was "
                     f"reused)")
    t0 = time.perf_counter()
    engine, weights = _engine(cfg, dev)

    b, n_pool = tr["batch"], tr["pool_batches"]
    scene = tr["scene"]
    pool, _ = scenes.scene_batch(b * n_pool, cfg["input_size"], ctx.seed, cfg["num_joints"],
                                 scene["people"], scene["person_size"])
    batches = [pool[i * b:(i + 1) * b] for i in range(n_pool)]
    notes.append(f"set-up: engine and {len(pool)} scenes {time.perf_counter() - t0:.3f} s")

    # the last call of each pool batch: its maps through run_batch, its
    # people as process_batch_square returns them
    kept = {}
    current = [0]
    run_batch = engine.run_batch

    def keep_maps(images_u8):
        out = run_batch(images_u8)
        kept[current[0]] = list(out[:2])
        return out

    engine.run_batch = keep_maps
    calls = [0]

    def call():
        k = calls[0] % n_pool
        current[0] = k
        calls[0] += 1
        out = engine.process_batch_square(batches[k])
        kept[k][2:] = out  # after keep_maps put this call's maps there

    t0 = time.perf_counter()
    for _ in range(tr["warmup_calls"]):
        call()
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    notes.append(f"set-up: {tr['warmup_calls']} warm-up calls {time.perf_counter() - t0:.3f} s")
    kept.clear()
    calls[0] = 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    metrics, record, failed, lat = {}, None, 0, []
    t_first = time.perf_counter()
    setup_s = t_first - ctx.t_start
    if ctx.trace:
        record = trace.trace_checked(call, tr["trace_calls"], sync)
        record.update(calls=tr["trace_calls"], images=tr["trace_calls"] * b)
        attempted = calls[0] * b
    else:
        end = t_first + ctx.seconds
        attempted = 0
        while time.perf_counter() < end:
            attempted += b
            t0 = time.perf_counter()
            try:
                call()
            except Exception:  # a failed call misses; the run goes on and is not correct
                failed += b
                notes.append("call failed:\n" + traceback.format_exc())
                continue
            lat.append(time.perf_counter() - t0)
        window = time.perf_counter() - t_first
        ms = np.asarray(lat) * 1e3
        metrics = {"img_per_s": len(lat) * b / window,
                   "p95_ms": float(np.percentile(ms, 95)) if lat else float("nan"),
                   "setup_s": setup_s}
        if lat:
            p50, p90, p99 = np.percentile(ms, [50, 90, 99])
            notes.append(f"window {window:.3f} s, {len(lat)} calls of {b} images; latency ms "
                         f"p50 {p50:.3f} p90 {p90:.3f} p99 {p99:.3f} max {ms.max():.3f}; "
                         f"{int((ms > 5 * p50).sum())} calls over 5 x p50; load average "
                         f"{os.getloadavg()}")
    cuda = dev.type == "cuda"
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(dev) if cuda else "cpu", "count": 1,
              "memory_peak_bytes": torch.cuda.max_memory_allocated(dev) if cuda else 0}
    if record is not None:
        device.update(busy_s=record["busy_s"], window_s=record["window_s"])

    engine = run_batch = None  # the program's state goes before the reference runs
    checks = _check(cfg, weights, batches, kept, dev, notes)
    return Outcome(metrics=metrics, attempted=attempted, failed=failed, checks=checks,
                   device=device, record=record, notes=notes)


def _check(cfg, weights, batches, kept, dev, notes):
    """After the window: the checked calls against the reference."""
    import torch

    from reference.check import numbers
    from reference.litepose import Reference

    done = sorted(k for k, v in kept.items() if len(v) == 5)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    images = np.concatenate([batches[k] for k in done])
    det = torch.cat([kept[k][0] for k in done])
    tag = torch.cat([kept[k][1] for k in done])
    people, scores, counts = (np.concatenate([kept[k][2 + i] for k in done]) for i in range(3))
    t0 = time.perf_counter()
    ref = Reference(*weights, cfg["arch"], cfg["num_joints"], dev)
    got = numbers(ref, cfg, images, det, tag, people, scores, counts)
    notes.append(f"checked {len(images)} images of {len(done)} calls in "
                 f"{time.perf_counter() - t0:.3f} s")
    return [Check(name, got[name], float(limit)) for name, limit in cfg["limits"].items()]
