"""The plain references against the port's plain path on the CPU, at small
sizes: the fp32 forward with stage aggregation, and the serving decode bit
for bit."""

import json
import os

import numpy as np
import pytest
import torch

from conftest import BENCH, ROOT
from harness import msgpack, scenes
from reference.check import numbers
from reference.decode import decode
from reference.litepose import Reference


def _config(name):
    with open(os.path.join(BENCH, "configs", name + ".json")) as f:
        return json.load(f)


def _port(cfg, weights, dtype):
    from litepose_tpu_torch.arch import ArchConfig
    from litepose_tpu_torch.core.inference import InferenceFlags, make_infer_fn
    from litepose_tpu_torch.models.convert import litepose_from_jax
    from litepose_tpu_torch.models.litepose import ModelSpec

    model = litepose_from_jax(*weights, ModelSpec(num_joints=cfg["num_joints"]),
                              ArchConfig.from_dict(cfg["arch"]), compute_dtype=dtype,
                              out_dtype=dtype)
    flags = InferenceFlags(num_joints=cfg["num_joints"], with_heatmaps_loss=(True, True),
                           with_ae_loss=(True, False), test_with_heatmaps=(True, True),
                           test_with_ae=(True, False), decode_bf16=dtype == torch.bfloat16)
    return make_infer_fn(model, flags)


@pytest.mark.parametrize("name, n", [("auto_xs256", 2), ("auto_s448", 1)])
def test_forward_matches_the_port_in_fp32(name, n):
    cfg = _config(name)
    weights = msgpack.load_params(os.path.join(ROOT, cfg["weights"]), cfg["weights_sha256"])
    images, _ = scenes.scene_batch(n, cfg["input_size"], seed=2**31 + 3)
    det_r, tag_r = Reference(*weights, cfg["arch"], cfg["num_joints"], "cpu").maps(
        torch.from_numpy(images))
    with torch.inference_mode():
        det_p, tag_p = _port(cfg, weights, torch.float32)(torch.from_numpy(images))
    assert det_p.shape == det_r.shape and tag_p.shape == tag_r.shape
    # fp32 on both sides; only the summation order and the BN fold differ
    assert (det_p - det_r).abs().max() <= 1e-4 * det_r.abs().max()
    assert (tag_p - tag_r).abs().max() <= 1e-4 * tag_r.abs().max()


def _serving_group(cfg):
    from litepose_tpu_torch.ops.group import GroupParams, StaticGroupCfg

    g = GroupParams(num_joints=cfg["num_joints"], max_num_people=cfg["max_people"],
                    detection_threshold=cfg["detection_threshold"],
                    tag_threshold=cfg["tag_threshold"], nms_kernel=cfg["nms_kernel"],
                    nms_padding=cfg["nms_kernel"] // 2, joint_order=cfg["joint_order"],
                    max_clusters=cfg["max_clusters"])
    return StaticGroupCfg.from_params(g, assignment="greedy", topk_method="approx")


@pytest.mark.parametrize("seed", [5, 2**31 + 7])
def test_decode_matches_the_port_bit_for_bit(seed):
    """On the port's own bf16 maps, and on planted maps with ties and
    crowded peaks."""
    from litepose_tpu_torch.ops.group import parse_batch

    cfg = _config("auto_xs256")
    weights = msgpack.load_params(os.path.join(ROOT, cfg["weights"]), cfg["weights_sha256"])
    images, _ = scenes.scene_batch(2, cfg["input_size"], seed=seed)
    with torch.inference_mode():
        det, tag = _port(cfg, weights, torch.bfloat16)(torch.from_numpy(images))
    gen = torch.Generator().manual_seed(seed)
    planted = (torch.rand((3, 14, 40, 40), generator=gen) * 4).round() / 4
    planted_tag = torch.randn((3, 14, 1, 40, 40), generator=gen) * 3
    for d, t in ((det, tag), (planted.to(torch.bfloat16), planted_tag.to(torch.bfloat16))):
        want = parse_batch(d, t, _serving_group(cfg), False, False, tag_layout="thw")
        got = decode(d.float(), t.float(), cfg)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_numbers_of_the_port_in_bf16():
    """The program's CPU path at its configured precision: its maps a few
    percent from fp32, its decode equal to the reference's on its maps."""
    from litepose_tpu_torch.ops.group import parse_batch

    cfg = _config("auto_xs256")
    weights = msgpack.load_params(os.path.join(ROOT, cfg["weights"]), cfg["weights_sha256"])
    images, _ = scenes.scene_batch(2, cfg["input_size"], seed=2**31 + 9)
    with torch.inference_mode():
        det, tag = _port(cfg, weights, torch.bfloat16)(torch.from_numpy(images))
        people, scores, counts = (x.numpy() for x in parse_batch(
            det, tag, _serving_group(cfg), False, False, tag_layout="thw"))
    got = numbers(Reference(*weights, cfg["arch"], cfg["num_joints"], "cpu"), cfg, images, det,
                  tag, people, scores, counts)
    assert got["decode_mismatch"] == 0
    assert 0 < got["det_rel_rms"] <= cfg["limits"]["det_rel_rms"]
    assert 0 < got["tag_rel_rms"] <= cfg["limits"]["tag_rel_rms"]
    moved = people.copy()
    moved[1, 0, 0, 0] += 1.0
    assert numbers(Reference(*weights, cfg["arch"], cfg["num_joints"], "cpu"), cfg, images, det,
                   tag, moved, scores, counts)["decode_mismatch"] == 1
    assert np.isfinite(scores).all()
