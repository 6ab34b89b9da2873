"""Model summary: parameter counts and MACs (the port's copy of
``litepose_tpu/utils/summary.py``).

Replaces the reference's ptflops-based ``get_model_summary``
(``lib/utils/utils.py:107-166``): parameters are counted from the module;
MACs come from the static analyzer for LitePose archs (``arch.macs``), no
hooks or forward pass.
"""

from __future__ import annotations

import torch


def count_params(model: torch.nn.Module) -> int:
    """The module's parameters (not its buffers: BN statistics and folded
    weights), which is the JAX count of the ``params`` pytree's leaves."""
    return int(sum(p.numel() for p in model.parameters()))


def model_summary(model: torch.nn.Module, arch=None, num_joints: int = 14) -> str:
    lines = []
    n = count_params(model)
    lines.append(f"parameters: {n:,} ({n / 1e6:.2f} M)")
    if arch is not None:
        from ..arch.macs import count_litepose_macs

        info = count_litepose_macs(arch, num_joints)
        lines.append(
            f"MACs @ {arch.img_size}x{arch.img_size}: {info['macs'] / 1e9:.2f} G"
        )
        for section, macs in info["breakdown"].items():
            lines.append(f"  {section}: {macs / 1e9:.3f} G")
    return "\n".join(lines)
