"""Export a self-contained serving artifact (``torch.export``, a ``.pt2``)
(the counterpart of ``tools/export.py``).

The artifact holds the weights and the whole fused serving program (forward
and decode, the kernels as ``torch.ops.litepose.*``) for one batch and
input shape.  Serve it from any process with torch and the port's op
library, no model code:

    from litepose_tpu_torch.core.export import load_artifact
    serve = load_artifact("auto_s.pt2")         # on the card; device="cpu" for the twins
    people, scores, counts = serve(images_u8)   # (B, H, W, 3) uint8 on that device

Usage:
  python -m litepose_tpu_torch.tools.export --arch auto-S --weights ckpt.msgpack \\
      --batch 64 --out auto_s.pt2
  python -m litepose_tpu_torch.tools.export --arch auto-XS --exact --eval-decode \\
      --device cpu --out auto_xs_cpu.pt2

``--device cuda`` (the default) traces on the card and raises without one;
``--device cpu`` writes a CPU artifact, which ``load_artifact(path)`` moves
to the card (``load_artifact(path, device="cpu")`` runs its plain twins).
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

import torch


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--arch", default="auto-S", help="zoo name or arch JSON path")
    p.add_argument("--weights", default=None,
                   help=".msgpack or torch .pth/.tar weights (random init if absent)")
    p.add_argument("--out", required=True, help="artifact output path")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--input-size", type=int, default=None,
                   help="square input size (default: the arch's native size)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (the kernels; raises without a card) or cpu (their plain twins)")
    p.add_argument("--num-joints", type=int, default=14)
    p.add_argument("--dataset", default="CROWDPOSE", choices=["CROWDPOSE", "COCO"])
    p.add_argument("--flip-test", action="store_true",
                   help="bake the flip-test (eval protocol) into the program")
    p.add_argument("--project2image", action="store_true",
                   help="project heatmaps to input size before decode")
    p.add_argument("--exact", action="store_true",
                   help="exact top-M + Hungarian decode (eval parity) instead "
                        "of the greedy serving path")
    p.add_argument("--eval-decode", action="store_true",
                   help="run adjust+refine after grouping (eval semantics)")
    p.add_argument("--detection-threshold", type=float, default=0.1)
    return p.parse_args(argv)


def check_device(device: str) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run the plain twins on the host")
    return dev


def resolve_arch(name: str, input_size: Optional[int]):
    """A zoo name or an arch JSON path, at ``input_size`` when given."""
    from ..arch import ARCH_ZOO, load_arch

    arch = ARCH_ZOO[name] if name in ARCH_ZOO else load_arch(name)
    return arch.with_img_size(input_size) if input_size else arch


def load_litepose(arch, weights: Optional[str], num_joints: int, device,
                  out_dtype: torch.dtype = torch.float32, warn: Optional[str] = None):
    """LitePose of ``arch`` with bf16 convs (the JAX CLIs' default policy),
    the weights of a ``.msgpack`` (either package's) or a reference
    ``.pth`` / ``.tar``, else the seeded init (printing ``warn`` to stderr
    when given), in eval mode with its BNs folded, on ``device``."""
    from ..models.litepose import LitePose, ModelSpec, init_litepose

    spec = ModelSpec(num_joints=num_joints)
    kw = dict(compute_dtype=torch.bfloat16, out_dtype=out_dtype)
    if weights and weights.endswith((".pth", ".tar")):
        from ..models.torch_convert import litepose_from_torch, load_torch_checkpoint

        model = litepose_from_torch(load_torch_checkpoint(weights), spec, arch, **kw)
    elif weights:
        from ..models.convert import state_dict_from_jax
        from ..train.checkpoint import load_params

        model = LitePose(spec, arch, **kw)
        model.load_state_dict(state_dict_from_jax(*load_params(weights), spec, arch),
                              strict=True)
        model.eval()
    else:
        if warn:
            print(warn, file=sys.stderr)
        model = init_litepose(spec, arch, torch.Generator().manual_seed(0), **kw).eval()
    return model.to(device)


def build_engine(args: argparse.Namespace):
    """The engine the artifact is exported from: ``tools/export.py``'s
    flags, bf16 maps, decode in bf16 unless ``--eval-decode``."""
    from ..core.engine import EngineConfig, PoseEngine
    from ..core.inference import InferenceFlags
    from ..data.flip import flip_index_for
    from ..ops.group import GroupParams

    dev = check_device(args.device)
    arch = resolve_arch(args.arch, args.input_size)
    model = load_litepose(arch, args.weights, args.num_joints, dev, out_dtype=torch.bfloat16,
                          warn="WARNING: exporting randomly-initialized weights")
    flags = InferenceFlags(
        num_joints=args.num_joints,
        with_heatmaps_loss=(True, True), with_ae_loss=(True, False),
        test_with_heatmaps=(True, True), test_with_ae=(True, False),
        flip_test=args.flip_test, flip_index=tuple(flip_index_for(args.dataset.lower())),
        decode_bf16=not args.eval_decode,
    )
    group = GroupParams(num_joints=args.num_joints,
                        detection_threshold=args.detection_threshold,
                        nms_kernel=5, nms_padding=2)
    return PoseEngine(
        model, flags, group,
        EngineConfig(
            input_size=arch.img_size, scale_factors=(1.0,),
            with_adjust=args.eval_decode, with_refine=args.eval_decode,
            project2image=args.project2image,
            assignment="hungarian" if args.exact else "greedy",
            topk_method="exact" if args.exact else "approx",
        ),
        device=dev,
    )


def main(argv: Optional[Sequence[str]] = None):
    args = parse_args(argv)
    from ..core.export import export_engine, save_artifact

    engine = build_engine(args)
    ep = export_engine(engine, args.batch)
    info = save_artifact(ep, args.out)
    print(f"wrote {args.out}: device={info.device} batch={info.batch} "
          f"input={info.in_hw[0]}x{info.in_hw[1]}x3 uint8 "
          f"size={info.nbytes / 1e6:.1f} MB")
    outs = [n for n in ep.graph.nodes if n.op == "output"][0].args[0]
    print("outputs:", [tuple(o.meta["val"].shape) for o in outs])
    return info


if __name__ == "__main__":
    main()
