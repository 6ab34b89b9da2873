"""Serving artifacts: the engine's whole fused program as a ``torch.export``
program (counterpart of ``litepose_tpu/core/export.py``).

The artifact holds normalize -> forward -> stage aggregation -> [projection]
-> NMS + top-M (K1) -> grouping (K2 or K3) [-> adjust, refine (K4)] for one
batch and input shape, with the model's weights (BN folded, as the live
engine serves them) in it.  The kernels are the ops ``torch.ops.litepose.*``
(``ops/library.py``), one graph node each, so the program runs them on the
card and their plain twins on the CPU.  ``load_artifact`` needs torch and
``ops.library`` (which builds the kernels at first use) and no model,
arch, config or engine code: the counterpart of the JAX artifact needing
only JAX, and of the reference's TVM ``.so`` per model.

An artifact is saved with ``torch.export.save`` (a ``.pt2`` zip); its
device, batch and input shape are those of the program's images input.
``load_artifact`` runs it on the card unless the caller asks for the CPU,
moving a program exported on the CPU with
``torch.export.passes.move_to_device_pass``: the CPU host builds artifacts
for the card.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, Optional, Tuple

import torch

from ..ops import library  # noqa: F401  registers torch.ops.litepose.*

@dataclasses.dataclass(frozen=True)
class ArtifactInfo:
    device: str
    batch: int
    in_hw: Tuple[int, int]
    nbytes: int


class FusedBody(torch.nn.Module):
    """``PoseEngine.run_batch`` without its det/tag outputs: uint8 (B, H, W,
    3) images on the engine's device -> (people (B, P, K, 3+T) in heatmap
    coordinates, scores (B, P), counts (B,)).  It runs the engine's own
    ``infer_fn`` and ``parse_batch``; a model given as an ``nn.Module`` is a
    submodule, so its weights are the program's."""

    def __init__(self, engine, in_hw: Tuple[int, int]):
        super().__init__()
        if isinstance(engine.apply_fn, torch.nn.Module):
            self.model = engine.apply_fn
        cfg = engine.config
        self.infer = engine.infer_fn(in_hw, in_hw if cfg.project2image else None)
        self.group_cfg = engine.group_cfg
        self.with_adjust, self.with_refine = cfg.with_adjust, cfg.with_refine

    def forward(self, images_u8: torch.Tensor):
        from ..ops.group import parse_batch

        det, tag = self.infer(images_u8)
        return parse_batch(det, tag, self.group_cfg, self.with_adjust, self.with_refine,
                           tag_layout="thw")


class _WeightsAsArguments(torch.nn.Module):
    """``(weights, images) -> body(images)`` with ``weights`` standing in
    for the body's parameters and buffers (``engine_weights``).  The body is
    held outside the module tree, so its tensors are not the program's."""

    def __init__(self, body: FusedBody):
        super().__init__()
        self._body = (body,)

    def forward(self, weights: Dict[str, torch.Tensor], images_u8: torch.Tensor):
        return torch.func.functional_call(self._body[0], weights, (images_u8,))


def fused_body(engine, in_hw: Optional[Tuple[int, int]] = None) -> FusedBody:
    """The engine's fused serving program for (H, W) inputs (default the
    square ``input_size``), as an ``nn.Module``."""
    if in_hw is None:
        in_hw = (engine.config.input_size, engine.config.input_size)
    return FusedBody(engine, tuple(in_hw))


def engine_weights(engine, in_hw: Optional[Tuple[int, int]] = None) -> Dict[str, torch.Tensor]:
    """The arguments an artifact exported with ``bake_params=False`` takes
    first: the fused body's parameters and buffers by name (the folded BN
    weights included)."""
    body = fused_body(engine, in_hw)
    return {**dict(body.named_parameters()), **dict(body.named_buffers())}


def export_engine(engine, batch: int, in_hw: Optional[Tuple[int, int]] = None,
                  bake_params: bool = True) -> torch.export.ExportedProgram:
    """``engine``'s fused program for ``batch`` uint8 (H, W, 3) images as a
    ``torch.export.ExportedProgram`` on the engine's device.

    With ``bake_params`` (the default) the weights are in the program; with
    ``bake_params=False`` it takes ``(engine_weights(engine), images)``, the
    JAX package's weights-as-arguments mode.  A model with ``fold_bn_`` is
    traced in eval mode, so the program carries the folded BN weights the
    live engine serves.  Tracing runs under ``torch.no_grad`` (not
    ``inference_mode``, whose tensors the tracer cannot take)."""
    if in_hw is None:
        in_hw = (engine.config.input_size, engine.config.input_size)
    body = fused_body(engine, in_hw)
    if body.training:
        body.eval()
    images = torch.zeros((batch, in_hw[0], in_hw[1], 3), dtype=torch.uint8,
                         device=engine.device)
    with torch.no_grad():
        if bake_params:
            ep = torch.export.export(body, (images,), strict=False)
        else:
            weights = engine_weights(engine, in_hw)
            ep = torch.export.export(_WeightsAsArguments(body), (weights, images), strict=False)
    # the example batch (and in args mode the weights) would be saved with it
    ep.example_inputs = None
    return ep


def _images_spec(ep: torch.export.ExportedProgram) -> torch.Tensor:
    """The fake images tensor of the program's last user input."""
    user = [s for s in ep.graph_signature.input_specs
            if s.kind == torch.export.graph_signature.InputKind.USER_INPUT]
    return next(n for n in ep.graph.nodes if n.op == "placeholder"
                and n.name == user[-1].arg.name).meta["val"]


def save_artifact(ep: torch.export.ExportedProgram, path: str) -> ArtifactInfo:
    """Write ``ep`` to ``path`` (``torch.export.save``, a ``.pt2`` zip)."""
    torch.export.save(ep, path)
    images = _images_spec(ep)
    b, h, w, _ = images.shape
    return ArtifactInfo(device=images.device.type, batch=int(b), in_hw=(int(h), int(w)),
                        nbytes=os.path.getsize(path))


def load_artifact(path: str, device: str = "cuda") -> Callable:
    """Load a saved artifact; returns ``images_u8 -> (people, scores,
    counts)`` (``(weights, images_u8) -> ...`` for one exported with
    ``bake_params=False``), taking and giving tensors on ``device``.

    ``device`` "cuda" (the default) raises on a host without a card; "cpu"
    runs the kernels' plain twins.  A program exported on the other device
    is moved.  Needs torch and ``ops.library`` only."""
    target = torch.device(device)
    if target.type not in ("cpu", "cuda"):
        raise ValueError(f"artifacts run on cpu or cuda, not {target}")
    if target.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"load_artifact: no CUDA device for {path}; pass "
                           f"device=\"cpu\" to run its plain twins")
    ep = torch.export.load(path)
    if _images_spec(ep).device.type != target.type:
        from torch.export.passes import move_to_device_pass

        ep = move_to_device_pass(ep, str(target))
    module = ep.module()

    def serve(*args):
        with torch.no_grad():
            return module(*args)

    return serve
