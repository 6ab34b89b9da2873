"""Fold BatchNorm into the convolutions of a fixed LitePose, with an output
check (the counterpart of ``tools/fuse_bn.py``).

  python -m litepose_tpu_torch.tools.fuse_bn --cfg configs/crowd_pose/mobilenet/mobile.yaml \\
      --superconfig search-S.json --ckpt weights.msgpack --out weights_fused.msgpack \\
      [--device cuda]

``--ckpt`` is a ``.msgpack`` of either package or a reference ``.pth``.
Folded and raw networks run one seeded standard-normal input in fp32 (TF32
off); every stage output must agree to a max abs difference below 1e-3.
``--device cuda`` (the default) raises without a card.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch


def main(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser()
    p.add_argument("--cfg", required=True)
    p.add_argument("--superconfig", required=True)
    p.add_argument("--ckpt", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--device", default="cuda", help="cuda (raises without a card) or cpu")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    args = p.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to fold on the host")
    from ..arch import load_arch
    from ..config import default_config, update_config
    from ..models.fold_bn import fold_litepose_bn
    from ..models.litepose import LitePose, ModelSpec
    from ..train.checkpoint import load_model_params, save_params
    from .weight_transfer import check_outputs, exact_cuda, seeded_input

    cfg = default_config()
    update_config(cfg, args.cfg, args.opts)
    arch = load_arch(args.superconfig)
    spec = ModelSpec.from_config(cfg)
    if args.ckpt.endswith((".pth", ".tar")):
        from ..models.torch_convert import litepose_from_torch, load_torch_checkpoint

        model = litepose_from_torch(load_torch_checkpoint(args.ckpt), spec, arch,
                                    compute_dtype=torch.float32)
    else:
        model = LitePose(spec, arch, compute_dtype=torch.float32)
        load_model_params(args.ckpt, model)
        model.eval()
    fused = fold_litepose_bn(model)

    exact_cuda()
    model, fused = model.to(device), fused.to(device)
    x = seeded_input(arch.img_size, device)
    with torch.no_grad():
        outs_a, outs_b = model(x), fused(x)
    for i, b in enumerate(outs_b):
        print(f"stage {i} abssum {float(b.abs().sum()):.1f}")
    diff = check_outputs(outs_b, outs_a, 1e-3, "fused-vs-raw", metric="max diff")
    save_params(args.out, fused)
    print(f"saved fused weights to {args.out}")
    return fused, diff


if __name__ == "__main__":
    main()
