"""Write a manual architecture JSON from the search space (the counterpart
of ``tools/gen_arch.py``, the reference ``gen_arch.py``: ``fixed_sample``
at a resolution and a width ratio).

  python -m litepose_tpu_torch.tools.gen_arch --reso 256 --ratio 0.5 --out manual-S.json
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser()
    p.add_argument("--reso", type=int, default=256)
    p.add_argument("--ratio", type=float, default=0.5)
    p.add_argument("--deconv", type=int, nargs=3, default=[64, 48, 32])
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)

    from ..arch import ArchManager, save_arch

    arch = ArchManager(deconv_setting=args.deconv).fixed_sample(reso=args.reso, ratio=args.ratio)
    save_arch(arch, args.out)
    print(f"wrote {args.out}: {arch.to_dict()}")
    return arch


if __name__ == "__main__":
    main()
