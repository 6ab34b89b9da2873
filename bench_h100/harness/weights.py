"""Seeded LitePose weights for the training cell, made by the benchmark and
handed to the program and to the reference alike.

The tree is the checkpoints' JAX layout (``harness/msgpack.py``): HWIO conv
kernels, spatially flipped HWIO transposed-conv kernels, BN ``scale`` /
``bias`` in the parameters and ``mean`` / ``var`` in the state.  Every
kernel is drawn uniformly in +-sqrt(3 / fan_in) from one ``torch.rand``
call on the device (fan_in: k*k*cin/groups for a conv, k*k*cout for a
transposed conv, as the JAX init); BNs start at scale 1, bias 0, mean 0,
var 1.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np

from .macs import STEM_CHANNELS, make_divisible


def _kernel(k: int, cin: int, cout: int, fan_in: int):
    return ("kernel", (k, k, cin, cout), fan_in)


def _bn(n: int) -> Tuple[Dict, Dict]:
    return ({"scale": ("fill", n, 1.0), "bias": ("fill", n, 0.0)},
            {"mean": ("fill", n, 0.0), "var": ("fill", n, 1.0)})


def _conv_bn(k: int, cin: int, cout: int, groups: int = 1) -> Tuple[Dict, Dict]:
    p, s = _bn(cout)
    return ({"conv": {"w": _kernel(k, cin // groups, cout, k * k * cin // groups)}, "bn": p},
            {"bn": s})


def skeleton(arch: Dict[str, Any], num_joints: int, with_ae) -> Tuple[Dict, Dict]:
    """(params, state) with a ("kernel", shape, fan_in) or ("fill", n,
    value) description at each leaf."""
    c = arch["input_channel"]
    p: Dict[str, Any] = {"first": {}, "stage": []}
    s: Dict[str, Any] = {"first": {}, "stage": []}
    p["first"]["cbr0"], s["first"]["cbr0"] = _conv_bn(3, 3, STEM_CHANNELS)
    p["first"]["cbr1"], s["first"]["cbr1"] = _conv_bn(3, STEM_CHANNELS, STEM_CHANNELS,
                                                      STEM_CHANNELS)
    p["first"]["conv2"] = {"w": _kernel(1, STEM_CHANNELS, c, STEM_CHANNELS)}
    p["first"]["bn2"], s["first"]["bn2"] = _bn(c)
    channels, cur = [c], c
    for st in arch["backbone_setting"]:
        ps, ss = [], []
        for t, k in st["block_setting"]:
            feat = make_divisible(round(cur * t), 8)
            bp, bs = {}, {}
            bp["inv"], bs["inv"] = _conv_bn(1, cur, feat)
            bp["depth"], bs["depth"] = _conv_bn(k, feat, feat, feat)
            bp["point"], bs["point"] = _conv_bn(1, feat, st["channel"])
            ps.append(bp)
            ss.append(bs)
            cur = st["channel"]
        p["stage"].append(ps)
        s["stage"].append(ss)
        channels.append(cur)
    filters = arch["deconv_setting"]
    for key in ("deconv_refined", "deconv_raw", "deconv_bn", "final_refined", "final_raw"):
        p[key] = []
    for key in ("deconv_bn", "final_refined", "final_raw"):
        s[key] = []
    inplanes = channels[-1]
    for i, f in enumerate(filters):
        p["deconv_refined"].append({"w": _kernel(4, inplanes, f, 16 * f)})
        p["deconv_raw"].append({"w": _kernel(4, channels[-i - 2], f, 16 * f)})
        bp, bs = _bn(f)
        p["deconv_bn"].append(bp)
        s["deconv_bn"].append(bs)
        inplanes = f
        if i > 0:
            oup = num_joints * (2 if with_ae[i - 1] else 1)
            for head, ch in (("final_refined", f), ("final_raw", channels[-i - 3])):
                dw, dws = _conv_bn(5, ch, ch, ch)
                p[head].append({"dw": dw, "pw": {"conv": {"w": _kernel(1, ch, oup, ch)}}})
                s[head].append({"dw": dws})
    return p, s


def leaves(tree, path=()) -> List[Tuple[tuple, Any]]:
    """(path, leaf) of every leaf of a nested dict / list tree, in order."""
    if isinstance(tree, dict):
        return [x for k in tree for x in leaves(tree[k], path + (k,))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in leaves(v, path + (i,))]
    return [(path, tree)]


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def seeded(arch: Dict[str, Any], num_joints: int, with_ae, seed: int, device
           ) -> Tuple[Dict, Dict]:
    """(params, state) of numpy float32 leaves, drawn from ``seed`` on
    ``device``."""
    import torch

    p, s = skeleton(arch, num_joints, with_ae)
    kernels = [leaf for _, leaf in leaves(p) if leaf[0] == "kernel"]
    sizes = [int(np.prod(shape)) for _, shape, _ in kernels]
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand(sum(sizes), generator=gen, device=device)
    bound = torch.repeat_interleave(
        torch.tensor([np.sqrt(3.0 / fan_in) for _, _, fan_in in kernels], device=device,
                     dtype=torch.float32),
        torch.tensor(sizes, device=device))
    flat = ((2.0 * u - 1.0) * bound).cpu().numpy()
    drawn = iter(np.split(flat, np.cumsum(sizes)[:-1]))

    def make(leaf):
        if leaf[0] == "kernel":
            return next(drawn).reshape(leaf[1])
        return np.full((leaf[1],), leaf[2], np.float32)

    return _map(p, make), _map(s, make)


_STEM = {"0": "cbr0", "1": "cbr1"}
_BLOCK = {"inv": "inv", "depth_conv": "depth", "point_conv": "point"}
_BN = {"weight": ("params", "scale"), "bias": ("params", "bias"),
       "running_mean": ("state", "mean"), "running_var": ("state", "var")}


def path_of(name: str):
    """A state-dict name of the published PyTorch LitePose (the layout of
    mit-han-lab/litepose, which the port keeps) -> ("params" | "state",
    path in the JAX tree); None for ``num_batches_tracked``."""
    parts = name.split(".")
    if parts[-1] == "num_batches_tracked":
        return None

    def conv_or_bn(prefix, child, leaf):
        if child == "0":
            return ("params",) + prefix + ("conv", "w")
        tree, key = _BN[leaf]
        return (tree,) + prefix + ("bn", key)

    head = parts[0]
    if head == "first":
        if parts[1] in _STEM:
            return conv_or_bn(("first", _STEM[parts[1]]), parts[2], parts[3])
        if parts[1] == "2":
            return ("params", "first", "conv2", "w")
        tree, key = _BN[parts[2]]
        return (tree, "first", "bn2", key)
    if head == "stage":
        prefix = ("stage", int(parts[1]), int(parts[2]), _BLOCK[parts[3]])
        return conv_or_bn(prefix, parts[4], parts[5])
    if head in ("deconv_refined", "deconv_raw"):
        return ("params", head, int(parts[1]), "w")
    if head == "deconv_bnrelu":
        tree, key = _BN[parts[3]]
        return (tree, "deconv_bn", int(parts[1]), key)
    if head in ("final_refined", "final_raw"):
        prefix = (head, int(parts[1]))
        if parts[3] == "3":
            return ("params",) + prefix + ("pw", "conv", "w")
        return conv_or_bn(prefix + ("dw",), parts[3], parts[4])
    raise KeyError(name)
