"""Supernet -> subnet weight extraction with an output check (the
counterpart of ``tools/weight_transfer.py``, the reference
``weight_transfer.py``).

  python -m litepose_tpu_torch.tools.weight_transfer \\
      --cfg configs/crowd_pose/mobilenet/supermobile.yaml --superconfig search-S.json \\
      --ckpt output/.../checkpoint.msgpack --out pretrain/crowdpose-S.msgpack [--device cuda]

``--ckpt`` is a supernet ``.msgpack`` of either package's train CLI; a
torch ``.pth`` supernet is refused (no super-layout converter).  The
subnet is ``extract_subnet`` of the arch; before it is written the
supernet at the arch's mask descriptor and the subnet run one seeded
standard-normal input in fp32 (TF32 off), and every stage output must
agree to an MSE below 1e-6.  ``--device cuda`` (the default) raises
without a card.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional, Sequence

import numpy as np
import torch


def check_outputs(a: Sequence[torch.Tensor], b: Sequence[torch.Tensor], limit: float,
                  what: str, metric: str = "mse") -> List[float]:
    """Per stage output MSE (or max abs diff) of ``a`` against ``b``,
    printed; raises when one reaches ``limit``."""
    out = []
    for i, (x, y) in enumerate(zip(a, b)):
        d = x.double().cpu() - y.double().cpu()
        v = float((d ** 2).mean()) if metric == "mse" else float(d.abs().max())
        print(f"stage {i} output {metric} {what}: {v:.3e}")
        if not v < limit:
            raise AssertionError(f"{what}: stage {i} {metric} {v:.3e} >= {limit}")
        out.append(v)
    return out


def seeded_input(img_size: int, device) -> torch.Tensor:
    """The tools' check input: a seed-0 standard normal (1, S, S, 3) NHWC
    draw, as (1, 3, S, S)."""
    x = np.random.default_rng(0).standard_normal((1, img_size, img_size, 3)).astype(np.float32)
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().to(device)


def exact_cuda() -> None:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def main(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser()
    p.add_argument("--cfg", required=True)
    p.add_argument("--superconfig", required=True, help="target subnet arch JSON")
    p.add_argument("--ckpt", required=True, help="supernet checkpoint (.msgpack)")
    p.add_argument("--out", required=True, help="output subnet weights path")
    p.add_argument("--device", default="cuda", help="cuda (raises without a card) or cpu")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    args = p.parse_args(argv)

    from ..arch import load_arch
    from ..config import default_config, update_config
    from ..models.super_litepose import arch_to_mask_desc, extract_subnet
    from ..train.checkpoint import save_params
    from .search import build_supernet

    if args.ckpt.endswith((".pth", ".tar")):
        raise SystemExit("supernet torch checkpoints need a super-layout converter; "
                         "train the supernet with the train CLI and pass its .msgpack")
    cfg = default_config()
    update_config(cfg, args.cfg, args.opts)
    arch = load_arch(args.superconfig)
    supernet = build_supernet(cfg, args.ckpt, args.device, torch.float32)
    exact_cuda()
    subnet = extract_subnet(supernet, arch)

    x = seeded_input(arch.img_size, supernet.max_desc.device)
    with torch.no_grad():
        outs_super = supernet(x, arch_to_mask_desc(arch))
        outs_sub = subnet(x)
    mse = check_outputs(outs_super, outs_sub, 1e-6, "supernet-vs-subnet")

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    save_params(args.out, subnet)
    print(f"saved subnet weights to {args.out}")
    return subnet, mse


if __name__ == "__main__":
    main()
