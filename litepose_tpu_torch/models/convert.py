"""Weight bridge between the JAX pytrees and the port's ``LitePose``, both
ways (counterpart of ``litepose_to_torch`` in
``litepose_tpu/models/torch_convert.py``).

Layouts: a conv kernel is HWIO in JAX and OIHW here; a transposed-conv
kernel is stored spatially flipped HWIO in JAX (the lhs-dilated-conv form)
and IOHW here (``nn.ConvTranspose2d``); BN ``scale/bias/mean/var`` become
``weight/bias/running_mean/running_var``.  One table of (state-dict name,
pytree path, kind) drives both directions; the pytrees are nested dicts and
lists of numpy arrays, the layout ``litepose_tpu`` and its checkpoints use.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

from ..arch import ArchConfig
from .litepose import LitePose, ModelSpec

CONV, DECONV, VEC = "conv", "deconv", "vec"
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


def entries(spec: ModelSpec, arch: ArchConfig, with_skips: bool = True
            ) -> List[Tuple[str, str, Path, str]]:
    """Every state-dict entry in the order of the reference layout, as
    (name, pytree, path, kind): pytree is "params", "state" (BN
    statistics) or "" (``num_batches_tracked``, which JAX does not keep)."""
    table: List[Tuple[str, str, Path, str]] = []

    def bn(prefix, path):
        table.extend([(f"{prefix}.weight", "params", path + ("scale",), VEC),
                      (f"{prefix}.bias", "params", path + ("bias",), VEC),
                      (f"{prefix}.running_mean", "state", path + ("mean",), VEC),
                      (f"{prefix}.running_var", "state", path + ("var",), VEC),
                      (f"{prefix}.num_batches_tracked", "", path, VEC)])

    def weight(name, path, kind=CONV):
        table.append((name, "params", path, kind))

    def conv_bn(prefix, path):
        weight(f"{prefix}.0.weight", path + ("conv", "w"))
        bn(f"{prefix}.1", path + ("bn",))

    conv_bn("first.0", ("first", "cbr0"))
    conv_bn("first.1", ("first", "cbr1"))
    weight("first.2.weight", ("first", "conv2", "w"))
    bn("first.3", ("first", "bn2"))

    for si, st in enumerate(arch.backbone_setting):
        for bi in range(st.num_blocks):
            for ours, theirs in (("inv", "inv"), ("depth", "depth_conv"),
                                 ("point", "point_conv")):
                conv_bn(f"stage.{si}.{bi}.{theirs}", ("stage", si, bi, ours))

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
    node[path[-1]] = value


def named_from_tree(tree, table, which: str = "params") -> Dict[str, np.ndarray]:
    """The ``which`` pytree's leaves -> {state-dict name: array in the
    port's layout}."""
    return {name: _to_torch(kind, _get(tree, path))
            for name, w, path, kind in table if w == which}


def tree_from_named(named: Mapping[str, Any], table, which: str = "params") -> dict:
    """{state-dict name: array or tensor} -> the ``which`` pytree in the
    JAX layout (an optimizer moment takes its parameter's layout)."""
    tree: dict = {}
    for name, w, path, kind in table:
        if w == which:
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
