"""Weight bridge between the JAX pytrees and the port's ``LitePose`` and
``SuperLitePose``, both ways (counterpart of ``litepose_to_torch`` in
``litepose_tpu/models/torch_convert.py``).

Layouts: a conv kernel is HWIO in JAX and OIHW here; a transposed-conv
kernel is stored spatially flipped HWIO in JAX (the lhs-dilated-conv form)
and IOHW here (``nn.ConvTranspose2d``); BN ``scale/bias/mean/var`` become
``weight/bias/running_mean/running_var``.  One table of (state-dict name,
pytree path, kind) drives both directions; the pytrees are nested dicts and
lists of numpy arrays, the layout ``litepose_tpu`` and its checkpoints use.
The supernet's table is the fixed net's at the maximal arch plus each
block's ``lin5`` / ``lin3`` (``nn.Linear``, whose ``weight`` is the JAX
``w`` as it is: both compute ``W @ flat + b``).

The baseline families' tables (``hrnet_entries``, ``efficient_hrnet_entries``,
``litepose_resnet_entries``) are read off a built model; their rows of kind
``NONE`` stand for the None slots of the JAX lists (HRNet transitions that
pass a branch on, the diagonal of the fuse layers), which the pytrees keep.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch

from ..arch import ArchConfig
from .litepose import LitePose, ModelSpec

CONV, DECONV, VEC = "conv", "deconv", "vec"
NONE = "none"  # a None slot of a JAX list (an absent transition or fuse layer)
Path = Tuple[Any, ...]


def _to_torch(kind: str, w) -> np.ndarray:
    w = np.asarray(w, np.float32)
    if kind == CONV:  # HWIO -> OIHW
        return w.transpose(3, 2, 0, 1)
    if kind == DECONV:  # flipped HWIO -> IOHW
        return w[::-1, ::-1].transpose(2, 3, 0, 1)
    return w


def _to_jax(kind: str, w) -> np.ndarray:
    w = np.asarray(w, np.float32)
    if kind == CONV:  # OIHW -> HWIO
        return np.ascontiguousarray(w.transpose(2, 3, 1, 0))
    if kind == DECONV:  # IOHW -> flipped HWIO
        return np.ascontiguousarray(w.transpose(2, 3, 0, 1)[::-1, ::-1])
    return np.ascontiguousarray(w)


class _Rows(list):
    """A table under construction: (name, pytree, path, kind) rows."""

    def weight(self, name: str, path: Path, kind: str = CONV) -> None:
        self.append((name, "params", path, kind))

    def bn(self, prefix: str, path: Path) -> None:
        self.extend([(f"{prefix}.weight", "params", path + ("scale",), VEC),
                     (f"{prefix}.bias", "params", path + ("bias",), VEC),
                     (f"{prefix}.running_mean", "state", path + ("mean",), VEC),
                     (f"{prefix}.running_var", "state", path + ("var",), VEC),
                     (f"{prefix}.num_batches_tracked", "", path, VEC)])

    def conv_bn(self, conv: str, bn: str, path: Path) -> None:
        self.weight(f"{conv}.weight", path + ("conv", "w"))
        self.bn(bn, path + ("bn",))

    def seq(self, prefix: str, path: Path) -> None:
        """A ``Sequential(conv, BN, ...)``."""
        self.conv_bn(f"{prefix}.0", f"{prefix}.1", path)

    def none(self, path: Path) -> None:
        self.extend([(None, "params", path, NONE), (None, "state", path, NONE)])

    def biased(self, name: str, path: Path) -> None:
        """A conv with a bias: pytree ``w`` and ``b``."""
        self.weight(f"{name}.weight", path + ("w",))
        self.weight(f"{name}.bias", path + ("b",), VEC)


def entries(spec: ModelSpec, arch: ArchConfig, with_skips: bool = True,
            lin: bool = False) -> List[Tuple[str, str, Path, str]]:
    """Every state-dict entry in the order of the reference layout, as
    (name, pytree, path, kind): pytree is "params", "state" (BN
    statistics) or "" (``num_batches_tracked``, which JAX does not keep).
    ``lin`` adds each block's ``lin5`` / ``lin3`` (the supernet's table)."""
    table = _Rows()
    bn, weight, conv_bn = table.bn, table.weight, table.seq

    conv_bn("first.0", ("first", "cbr0"))
    conv_bn("first.1", ("first", "cbr1"))
    weight("first.2.weight", ("first", "conv2", "w"))
    bn("first.3", ("first", "bn2"))

    for si, st in enumerate(arch.backbone_setting):
        for bi in range(st.num_blocks):
            for ours, theirs in (("inv", "inv"), ("depth", "depth_conv"),
                                 ("point", "point_conv")):
                conv_bn(f"stage.{si}.{bi}.{theirs}", ("stage", si, bi, ours))
            if lin:
                for t in ("lin5", "lin3"):
                    weight(f"stage.{si}.{bi}.{t}.weight", ("stage", si, bi, t, "w"), VEC)
                    weight(f"stage.{si}.{bi}.{t}.bias", ("stage", si, bi, t, "b"), VEC)

    for i in range(spec.num_deconv_layers):
        weight(f"deconv_refined.{i}.weight", ("deconv_refined", i, "w"), DECONV)
        if with_skips:
            weight(f"deconv_raw.{i}.weight", ("deconv_raw", i, "w"), DECONV)
        bn(f"deconv_bnrelu.{i}.0", ("deconv_bn", i))

    heads = ("final_refined", "final_raw") if with_skips else ("final_refined",)
    for i in range(spec.num_deconv_layers - 1):
        for head in heads:
            weight(f"{head}.{i}.conv.0.weight", (head, i, "dw", "conv", "w"))
            bn(f"{head}.{i}.conv.1", (head, i, "dw", "bn"))
            weight(f"{head}.{i}.conv.3.weight", (head, i, "pw", "conv", "w"))
    return table


def _get(tree, path: Path):
    for key in path:
        tree = tree[key]
    return tree


def _put(tree: dict, path: Path, value) -> None:
    """Set ``tree[path] = value``, making dicts for str keys and lists for
    int keys on the way."""
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        fresh = [] if isinstance(nxt, int) else {}
        if isinstance(key, int):
            node.extend([None] * (key + 1 - len(node)))
            if node[key] is None:
                node[key] = fresh
            node = node[key]
        else:
            node = node.setdefault(key, fresh)
    if isinstance(path[-1], int):
        node.extend([None] * (path[-1] + 1 - len(node)))
    node[path[-1]] = value


def named_from_tree(tree, table, which: str = "params") -> Dict[str, np.ndarray]:
    """The ``which`` pytree's leaves -> {state-dict name: array in the
    port's layout}."""
    return {name: _to_torch(kind, _get(tree, path))
            for name, w, path, kind in table if w == which and kind != NONE}


def tree_from_named(named: Mapping[str, Any], table, which: str = "params") -> dict:
    """{state-dict name: array or tensor} -> the ``which`` pytree in the
    JAX layout (an optimizer moment takes its parameter's layout)."""
    tree: dict = {}
    for name, w, path, kind in table:
        if w == which and kind == NONE:
            _put(tree, path, None)
        elif w == which:
            v = named[name]
            if isinstance(v, torch.Tensor):
                v = v.detach().float().cpu().numpy()
            _put(tree, path, _to_jax(kind, v))
    return tree


def state_dict_from_jax(params, state, spec: ModelSpec, arch: ArchConfig,
                        with_skips: bool = True) -> Dict[str, torch.Tensor]:
    """JAX (params, state) pytrees with numpy leaves -> the port's state
    dict (fp32 tensors; ``num_batches_tracked`` zeros, which neither eval BN
    nor a BN with a fixed momentum reads)."""
    trees = {"params": params, "state": state}
    sd = {}
    for name, which, path, kind in entries(spec, arch, with_skips):
        v = _to_torch(kind, _get(trees[which], path)) if which else np.zeros((), np.int64)
        sd[name] = torch.from_numpy(np.array(v))
    return sd


def jax_from_state_dict(sd: Mapping[str, Any], spec: ModelSpec, arch: ArchConfig,
                        with_skips: bool = True) -> Tuple[dict, dict]:
    """The inverse of ``state_dict_from_jax``: the port's state dict ->
    (params, model_state) pytrees of fp32 numpy arrays in the JAX layout."""
    table = entries(spec, arch, with_skips)
    return tree_from_named(sd, table, "params"), tree_from_named(sd, table, "state")


def litepose_from_jax(params, state, spec: ModelSpec, arch: ArchConfig,
                      with_skips: bool = True, **model_kw) -> LitePose:
    """Build a ``LitePose`` in eval mode, load the JAX weights into it with
    ``strict=True`` and fold its BNs."""
    model = LitePose(spec, arch, with_skips=with_skips, **model_kw)
    model.load_state_dict(
        state_dict_from_jax(params, state, spec, arch, with_skips), strict=True)
    return model.eval()


def super_entries(spec: ModelSpec, dims) -> List[Tuple[str, str, Path, str]]:
    """The supernet's table (``dims``: its ``SuperDims``)."""
    return entries(spec, dims.max_arch(), lin=True)


def super_state_dict_from_jax(params, state, spec: ModelSpec, dims,
                              keep: Mapping[str, Any] = None) -> Dict[str, torch.Tensor]:
    """The JAX supernet (params, state) -> the port's state dict.  A JAX
    supernet whose backbone came from a LitePose pretrain has no ``lin5`` /
    ``lin3`` leaves (``load_pretrained_backbone`` replaces the blocks
    whole); their entries then come from ``keep`` (a state dict of the
    model they load into), and raise ``KeyError`` without it."""
    trees = {"params": params, "state": state}
    sd = {}
    for name, which, path, kind in super_entries(spec, dims):
        if not which:
            v = np.zeros((), np.int64)
        else:
            try:
                v = _to_torch(kind, _get(trees[which], path))
            except KeyError:
                if keep is None or path[-2] not in ("lin5", "lin3"):
                    raise
                v = keep[name].detach().cpu().numpy()
        sd[name] = torch.from_numpy(np.array(v))
    return sd


def supernet_from_jax(params, state, spec: ModelSpec, dims, **model_kw):
    """A ``SuperLitePose`` in eval mode holding JAX supernet weights."""
    from .super_litepose import SuperLitePose

    model = SuperLitePose(spec, dims, **model_kw)
    model.load_state_dict(super_state_dict_from_jax(params, state, spec, dims,
                                                    keep=model.state_dict()), strict=True)
    return model.eval()


def supernet_to_jax(model) -> Tuple[dict, dict]:
    """The inverse of ``supernet_from_jax``: (params, model_state) pytrees
    of fp32 numpy arrays in the JAX supernet layout."""
    table = super_entries(model.spec, model.dims)
    sd = model.state_dict()
    return tree_from_named(sd, table, "params"), tree_from_named(sd, table, "state")


# -- the baseline families ----------------------------------------------------


def _res_block(t: _Rows, prefix: str, block, path: Path) -> None:
    from .higher_hrnet import Bottleneck

    for c in range(1, 4 if isinstance(block, Bottleneck) else 3):
        t.conv_bn(f"{prefix}.conv{c}", f"{prefix}.bn{c}", path + (f"c{c}",))
    if block.downsample is not None:
        t.seq(f"{prefix}.downsample", path + ("down",))


def _hr_stage(t: _Rows, n: int, modules) -> None:
    from .higher_hrnet import ConvBN

    for m, module in enumerate(modules):
        prefix, path = f"stage{n}.{m}", (f"stage{n}", m)
        for b, branch in enumerate(module.branches):
            if isinstance(branch, ConvBN):
                t.seq(f"{prefix}.branches.{b}", path + ("branches", b, "cbr"))
            else:
                for k, block in enumerate(branch):
                    _res_block(t, f"{prefix}.branches.{b}.{k}", block,
                               path + ("branches", b, "blocks", k))
        if module.fuse_layers is None:  # one branch: JAX keeps [[None]]
            t.none(path + ("fuse", 0, 0))
            continue
        for i, row in enumerate(module.fuse_layers):
            for j, layer in enumerate(row):
                base, fpath = f"{prefix}.fuse_layers.{i}.{j}", path + ("fuse", i, j)
                if j == i:
                    t.none(fpath)
                elif j > i:
                    t.seq(base, fpath + ("up",))
                else:
                    for k in range(len(layer)):
                        t.seq(f"{base}.{k}", fpath + ("down", k))


def _higher_head(t: _Rows, model) -> None:
    for i in range(len(model.final_layers)):
        t.biased(f"final_layers.{i}", ("final", i))
    for i, stage in enumerate(model.deconv_layers):
        t.weight(f"deconv_layers.{i}.0.0.weight", ("deconv", i, "deconv", "w"), DECONV)
        t.bn(f"deconv_layers.{i}.0.1", ("deconv", i, "bn"))
        for k, block in enumerate(stage[1:]):
            _res_block(t, f"deconv_layers.{i}.{k + 1}.0", block[0], ("deconv", i, "blocks", k))


def hrnet_entries(model) -> List[Tuple[str, str, Path, str]]:
    """The table of a ``HigherHRNet``: reference keys against the JAX
    pytree of ``init_higher_hrnet`` (whose ``transition{n}`` feeds stage n,
    the reference's ``transition{n-1}``)."""
    from .higher_hrnet import ConvBN

    t = _Rows()
    t.conv_bn("conv1", "bn1", ("stem", "c1"))
    t.conv_bn("conv2", "bn2", ("stem", "c2"))
    for k, block in enumerate(model.layer1):
        _res_block(t, f"layer1.{k}", block, ("layer1", k))
    for n in (2, 3, 4):
        for i, layer in enumerate(getattr(model, f"transition{n - 1}")):
            path = (f"transition{n}", i)
            if layer is None:
                t.none(path)
            elif isinstance(layer, ConvBN):
                t.seq(f"transition{n - 1}.{i}", path + ("cbr",))
            else:
                for j in range(len(layer)):
                    t.seq(f"transition{n - 1}.{i}.{j}", path + ("down", j))
        _hr_stage(t, n, getattr(model, f"stage{n}"))
    _higher_head(t, model)
    return t


def efficient_hrnet_entries(model) -> List[Tuple[str, str, Path, str]]:
    """The table of an ``EfficientHRNet`` (pytree of ``init_efficient_hrnet``)."""
    from .efficient_hrnet import MBConv

    t = _Rows()
    for i, block in enumerate(model.features):
        path = ("features", i)
        if not isinstance(block, MBConv):  # the stem: Sequential(pad, conv, BN, Swish)
            t.conv_bn(f"features.{i}.1", f"features.{i}.2", path)
            continue
        off = len(block.conv) - 4  # 1 with the expand conv, else 0
        if off:
            t.conv_bn(f"features.{i}.conv.0.1", f"features.{i}.conv.0.2", path + ("expand",))
        t.conv_bn(f"features.{i}.conv.{off}.1", f"features.{i}.conv.{off}.2", path + ("dw",))
        for j, side in ((1, "r"), (3, "e")):
            t.biased(f"features.{i}.conv.{off + 1}.se.{j}", path + ("se", side))
        t.conv_bn(f"features.{i}.conv.{off + 2}", f"features.{i}.conv.{off + 3}",
                  path + ("project",))
    for n, branches in ((1, 2), (2, 3), (3, 4)):
        for m in range(branches):
            prefix, path = f"trans{n}_branch{m + 1}", (f"trans{n}", m)
            t.biased(f"{prefix}.0", path + ("conv",))
            t.bn(f"{prefix}.1", path + ("bn",))
    for n in (2, 3, 4):
        _hr_stage(t, n, getattr(model, f"stage{n}"))
    _higher_head(t, model)
    return t


def litepose_resnet_entries(model) -> List[Tuple[str, str, Path, str]]:
    """The table of a ``LitePoseResNet`` (pytree of ``init_litepose_resnet``)."""
    t = _Rows()
    t.seq("first.0", ("first", "cbr0"))
    t.seq("first.1", ("first", "cbr1"))
    for si, blocks in enumerate(model.stage):
        for bi in range(len(blocks)):
            t.seq(f"stage.{si}.{bi}.inv", ("stage", si, bi, "inv"))
            t.seq(f"stage.{si}.{bi}.point_conv", ("stage", si, bi, "point"))
    for i in range(len(model.deconv_refined)):
        t.weight(f"deconv_refined.{i}.conv.weight", ("deconv_refined", i, "conv", "w"))
        t.weight(f"deconv_raw.{i}.conv.weight", ("deconv_raw", i, "conv", "w"))
        t.bn(f"deconv_bnrelu.{i}.0", ("deconv_bn", i))
    for i in range(len(model.final_refined)):
        t.biased(f"final_refined.{i}", ("final_refined", i))
        t.biased(f"final_raw.{i}", ("final_raw", i))
    return t


def family_entries(model) -> List[Tuple[str, str, Path, str]]:
    """The table of a baseline-family model, by its class."""
    from .efficient_hrnet import EfficientHRNet
    from .higher_hrnet import HigherHRNet
    from .litepose_resnet import LitePoseResNet

    for cls, fn in ((HigherHRNet, hrnet_entries), (EfficientHRNet, efficient_hrnet_entries),
                    (LitePoseResNet, litepose_resnet_entries)):
        if isinstance(model, cls):
            return fn(model)
    raise TypeError(f"no family table for {type(model).__name__}")


def family_state_dict_from_jax(model, params, state) -> Dict[str, torch.Tensor]:
    """JAX (params, state) pytrees of a baseline family -> the state dict
    of ``model`` (a model of the same spec)."""
    trees = {"params": params, "state": state}
    sd = {}
    for name, which, path, kind in family_entries(model):
        if kind != NONE:
            v = _to_torch(kind, _get(trees[which], path)) if which else np.zeros((), np.int64)
            sd[name] = torch.from_numpy(np.array(v))
    return sd


def _loaded(model, params, state):
    model.load_state_dict(family_state_dict_from_jax(model, params, state), strict=True)
    return model.eval()


def to_jax(model) -> Tuple[dict, dict]:
    """A family model's (params, model_state) pytrees of fp32 numpy arrays
    in the JAX layout, None slots included: the inverse of
    ``family_state_dict_from_jax``."""
    table, sd = family_entries(model), model.state_dict()
    return tree_from_named(sd, table, "params"), tree_from_named(sd, table, "state")


def hrnet_from_jax(params, state, spec, **model_kw):
    """A ``HigherHRNet`` in eval mode holding JAX ``higher_hrnet`` weights."""
    from .higher_hrnet import HigherHRNet

    return _loaded(HigherHRNet(spec, **model_kw), params, state)


def efficient_hrnet_from_jax(params, state, spec, **model_kw):
    """An ``EfficientHRNet`` in eval mode holding JAX ``efficient_hrnet``
    weights."""
    from .efficient_hrnet import EfficientHRNet

    return _loaded(EfficientHRNet(spec, **model_kw), params, state)


def litepose_resnet_from_jax(params, state, spec: ModelSpec,
                             deconv_filters: Sequence[int] = (64, 48, 32), **model_kw):
    """A ``LitePoseResNet`` in eval mode holding JAX ``litepose_resnet``
    weights."""
    from .litepose_resnet import LitePoseResNet

    return _loaded(LitePoseResNet(spec, deconv_filters, **model_kw), params, state)


hrnet_to_jax = efficient_hrnet_to_jax = litepose_resnet_to_jax = to_jax
