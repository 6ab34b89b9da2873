"""BatchNorm folding of a fixed LitePose for deployment (counterpart of
``litepose_tpu/models/fold_bn.py``, the reference ``fuse_bn.py``).

Every conv -> BN pair folds in the JAX arithmetic: ``a = scale *
rsqrt(var + eps)``, the conv weight times ``a`` per output channel, and the
BN left as a pure bias add (scale 1, bias ``bias - a * mean``, mean 0, var
``1 - eps``).  The deconv head's BN follows the *sum* of the refined and
the raw transposed convs, so ``a`` scales both branches' weights and the
bias stays at the one BN site.  Output channels are axis 0 of an OIHW
conv weight and axis 1 of an IOHW transposed-conv weight.
"""

from __future__ import annotations

import copy

import torch

from .layers import BN_EPS
from .litepose import LitePose


def _identity_(bn: torch.nn.BatchNorm2d, a: torch.Tensor) -> None:
    bn.bias.copy_(bn.bias - a * bn.running_mean)
    bn.weight.fill_(1.0)
    bn.running_mean.zero_()
    bn.running_var.copy_(torch.full_like(a, 1.0 - BN_EPS))


def _scale(bn: torch.nn.BatchNorm2d) -> torch.Tensor:
    return bn.weight * torch.rsqrt(bn.running_var + BN_EPS)


def fold_litepose_bn(model: LitePose) -> LitePose:
    """A copy of ``model`` with every BN folded, in eval mode: the same
    function in eval, BN reduced to a bias add."""
    out = copy.deepcopy(model).train()  # train() drops folded eval buffers
    with torch.no_grad():
        for conv, bn in out._conv_bn_pairs():
            a = _scale(bn)
            conv.weight.mul_(a[:, None, None, None])
            _identity_(bn, a)
        for i, bnrelu in enumerate(out.deconv_bnrelu):
            bn = bnrelu[0]
            a = _scale(bn)
            out.deconv_refined[i].weight.mul_(a[None, :, None, None])
            if out.with_skips:
                out.deconv_raw[i].weight.mul_(a[None, :, None, None])
            _identity_(bn, a)
    return out.eval()
