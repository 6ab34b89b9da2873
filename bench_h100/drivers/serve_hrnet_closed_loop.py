"""Closed-loop serving of a HigherHRNet: one client hands ``batch`` uint8
images at a time to ``PoseEngine.process_batch_square`` and waits for the
people.  The loop, the kept maps and the checks are
``serve_closed_loop.py``'s; the model is built from the configuration's
widths (``cfg["hrnet"]``) and a seed, not read from a checkpoint.

Traffic parameters (``traffic/<name>.json``): ``batch``; ``pool_batches``,
the distinct batches made in set-up from ``--seed`` and cycled through;
``warmup_calls``; ``trace_calls``, the calls of the traced sub-window;
and ``scene``, the generator's ``people`` and ``person_size`` ranges.

The weights (``weights``): a state dict by the reference's parameter
names, every tensor drawn with numpy from the configuration's
``weights_seed`` at the shapes ``harness/hrnet_macs.py`` lists from its
widths (not through the port's modules): each conv in the JAX fan-in
uniform law, every BN's affine and statistics off the identity, and each
joint's heatmap bias in every final layer set to the configuration's
``heatmap_bias_shift``.  That shift leaves ``peak_share`` of each plane of
the fp32 reference's aggregated maps above the detection threshold, on
``peak_scenes`` scenes drawn from ``weights_seed``; it is computed once on
the card (``heatmap_bias_shift``, ``tools/calibrate_hrnet.py --shift``)
and committed, so no reference runs in set-up.  Every run serves the same
model; the port loads the state dict with ``strict=True``, so a layer of
another shape fails the run, and the reference gets the same tensors.

The engine runs in its serving form: greedy grouping (K2), approximate
top-M (K1), bf16 maps and decode, no flip, adjust, refine or projection;
the model folds its BNs at eval (``fold_bn_``), and a port whose
HigherHRNet does not fold fails the run at once.  Frames go in as
pageable numpy arrays.

End-to-end metrics, on the host clock: ``img_per_s``, ``p95_ms`` and
``setup_s`` as ``serve_closed_loop.py`` takes them.  With ``--trace 1``
the window is ``harness/trace_program.py``'s, which keeps the program's
``litepose.*`` spans in ``record["program"]``.
"""

from __future__ import annotations

import math
import os
import time
import traceback
from typing import Dict, List

import numpy as np

from harness import hrnet_macs, scenes, trace_program
from harness.core import Check, Context, Outcome

BN_DRAWS = (("weight", "uniform", 0.5, 1.5), ("bias", "normal", 0.0, 0.2),
            ("running_mean", "normal", 0.0, 0.2), ("running_var", "uniform", 0.5, 1.5))


def hrnet_spec(cfg: Dict):
    """The port's ``HRNetSpec`` of the configuration."""
    from litepose_tpu_torch.models.higher_hrnet import HRNetSpec, StageSpec

    hr, dc = cfg["hrnet"], cfg["hrnet"]["deconv"]
    stages = [StageSpec(s["num_modules"], s["num_branches"], s["block"], tuple(s["num_blocks"]),
                        tuple(s["num_channels"])) for s in hr["stages"]]
    return HRNetSpec(num_joints=cfg["num_joints"], tag_per_joint=cfg["tag_per_joint"],
                     with_ae_loss=tuple(cfg["with_ae"]), stem_inplanes=hr["stem_inplanes"],
                     final_conv_kernel=hr["final_conv_kernel"], stage2=stages[0],
                     stage3=stages[1], stage4=stages[2], num_deconvs=dc["num_deconvs"],
                     deconv_channels=tuple(dc["num_channels"]),
                     deconv_kernels=tuple(dc["kernel_size"]),
                     deconv_num_basic_blocks=dc["num_basic_blocks"],
                     cat_output=tuple(dc["cat_output"]))


def weights(cfg: Dict, shift=None) -> Dict:
    """The cell's fp32 state dict on the CPU, by the reference's parameter
    names, as the module docstring says: each conv of ``hrnet_macs``
    uniform in +-sqrt(3 / fan_in), fan_in ``k*k*cin`` (``k*k*cout`` for a
    transposed conv), each BN by ``BN_DRAWS``, the final layers' biases 0
    but the heatmaps', which take ``shift`` (the configuration's
    ``heatmap_bias_shift`` where None)."""
    import torch

    rng = np.random.default_rng(cfg["weights_seed"])
    J = cfg["num_joints"]
    shift = np.asarray(cfg["heatmap_bias_shift"] if shift is None else shift, np.float32)
    sd = {}
    for c in hrnet_macs.conv_layers(cfg):
        shape = (c.cin, c.cout, c.k, c.k) if c.transposed else (c.cout, c.cin, c.k, c.k)
        bound = math.sqrt(3.0 / (c.k * c.k * (c.cout if c.transposed else c.cin)))
        sd[c.name + ".weight"] = rng.uniform(-bound, bound, shape).astype(np.float32)
        bn = hrnet_macs.bn_of(c)
        if bn is None:
            bias = np.zeros(c.cout, np.float32)
            bias[:J] = shift
            sd[c.name + ".bias"] = bias
            continue
        for name, law, a, b in BN_DRAWS:
            sd[f"{bn}.{name}"] = getattr(rng, law)(a, b, c.cout).astype(np.float32)
    sd = {k: torch.from_numpy(v) for k, v in sd.items()}
    for bn in {k[:-len(".running_mean")] for k in sd if k.endswith(".running_mean")}:
        sd[bn + ".num_batches_tracked"] = torch.tensor(0)
    return sd


def heatmap_bias_shift(cfg: Dict, dev) -> List[float]:
    """Per joint, the heatmap bias that leaves ``peak_share`` of each plane
    of the fp32 reference's aggregated maps above the detection threshold,
    on ``peak_scenes`` scenes drawn from ``weights_seed``: the
    configuration's ``heatmap_bias_shift``, computed on the card."""
    import torch

    from reference.higher_hrnet import Reference, peak_shift

    J = cfg["num_joints"]
    ref = Reference(weights(cfg, shift=np.zeros(J)), cfg["hrnet"], J, dev)
    images, _ = scenes.scene_batch(cfg["peak_scenes"], cfg["input_size"], cfg["weights_seed"], J)
    det = torch.cat([ref.maps(torch.from_numpy(images[lo:lo + 16]))[0]
                     for lo in range(0, len(images), 16)])
    return peak_shift(det, cfg["peak_share"], cfg["detection_threshold"]).tolist()


def require_folding() -> None:
    """Raise at once where the port's HigherHRNet keeps its BNs unfolded at
    eval: the cell serves the folded model."""
    from litepose_tpu_torch.models.higher_hrnet import HigherHRNet
    from litepose_tpu_torch.models.layers import FoldsBN

    if not issubclass(HigherHRNet, FoldsBN):
        raise RuntimeError("this port's HigherHRNet does not fold its BNs at eval (no "
                           "fold_bn_): the cell serves the folded model")


def _engine(cfg, dev):
    import torch

    from litepose_tpu_torch.core.engine import EngineConfig, PoseEngine
    from litepose_tpu_torch.core.inference import InferenceFlags
    from litepose_tpu_torch.models.higher_hrnet import HigherHRNet
    from litepose_tpu_torch.ops.group import GroupParams

    sd = weights(cfg)
    model = HigherHRNet(hrnet_spec(cfg), compute_dtype=getattr(torch, cfg["compute_dtype"]),
                        out_dtype=getattr(torch, cfg["maps_dtype"]))
    model.load_state_dict(sd)
    model = model.to(dev).eval()  # eval folds the BNs on the card
    J = cfg["num_joints"]
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
    return PoseEngine(model, flags, group, config, device=dev), sd


def run(ctx: Context) -> Outcome:
    import torch

    require_folding()
    cfg, tr = ctx.config, ctx.traffic
    dev = torch.device(ctx.device)
    notes = [f"set-up: {time.perf_counter() - ctx.t_start:.3f} s to the driver"]
    if dev.type == "cuda":
        from litepose_tpu_torch.kernels import build

        _, build_s, _ = build.build()
        notes.append(f"set-up: kernel build {build_s:.3f} s (0 when the checkout's build was "
                     f"reused)")
    t0 = time.perf_counter()
    engine, sd = _engine(cfg, dev)
    notes.append(f"set-up: seeded weights and engine "
                 f"{time.perf_counter() - t0:.3f} s")

    t0 = time.perf_counter()
    b, n_pool = tr["batch"], tr["pool_batches"]
    scene = tr["scene"]
    pool, _ = scenes.scene_batch(b * n_pool, cfg["input_size"], ctx.seed, cfg["num_joints"],
                                 scene["people"], scene["person_size"])
    batches = [pool[i * b:(i + 1) * b] for i in range(n_pool)]
    notes.append(f"set-up: {len(pool)} scenes {time.perf_counter() - t0:.3f} s")

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
        record = trace_program.trace_checked(call, tr["trace_calls"], sync)
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
    checks = _check(cfg, sd, batches, kept, dev, notes)
    return Outcome(metrics=metrics, attempted=attempted, failed=failed, checks=checks,
                   device=device, record=record, notes=notes)


def _check(cfg, sd, batches, kept, dev, notes):
    """After the window: the checked calls against the reference."""
    import torch

    from reference.check import numbers
    from reference.higher_hrnet import Reference

    done = sorted(k for k, v in kept.items() if len(v) == 5)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    images = np.concatenate([batches[k] for k in done])
    det = torch.cat([kept[k][0] for k in done])
    tag = torch.cat([kept[k][1] for k in done])
    people, scores, counts = (np.concatenate([kept[k][2 + i] for k in done]) for i in range(3))
    t0 = time.perf_counter()
    ref = Reference(sd, cfg["hrnet"], cfg["num_joints"], dev)
    got = numbers(ref, cfg, images, det, tag, people, scores, counts)
    notes.append(f"checked {len(images)} images of {len(done)} calls in "
                 f"{time.perf_counter() - t0:.3f} s")
    return [Check(name, got[name], float(limit)) for name, limit in cfg["limits"].items()]
