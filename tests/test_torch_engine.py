"""The serving slice end to end: the port's ``PoseEngine.process_batch_square``
against the JAX one, with the serving config (greedy grouping, "approx"
top-k, no adjust, refine or projection) at fp32, on the trained Auto-XS
checkpoint and synthetic bench scenes."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from litepose_tpu.arch.zoo import get_arch
from litepose_tpu.core.engine import EngineConfig as JEngineConfig
from litepose_tpu.core.engine import PoseEngine as JPoseEngine
from litepose_tpu.core.inference import InferenceFlags as JFlags
from litepose_tpu.data.synthetic import bench_scene_batch
from litepose_tpu.models.layers import Policy
from litepose_tpu.models.litepose import ModelSpec as JSpec
from litepose_tpu.models.litepose import apply_litepose
from litepose_tpu.ops.group import parse_batch as j_parse_batch
from litepose_tpu.ops.group_ref import GroupParams as JGroupParams

from litepose_tpu_torch.core.engine import EngineConfig, PoseEngine
from litepose_tpu_torch.core.inference import InferenceFlags
from litepose_tpu_torch.data.flip import flip_index_for
from litepose_tpu_torch.models.convert import litepose_from_jax
from litepose_tpu_torch.models.litepose import ModelSpec
from litepose_tpu_torch.ops.group import GroupParams, parse_batch
from litepose_tpu_torch.train.checkpoint import load_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT_XS = os.path.join(REPO, "assets", "bench_ckpt_xs.msgpack")
SIZE = 256
SERVING = dict(input_size=SIZE, assignment="greedy", topk_method="approx",
               with_adjust=False, with_refine=False, project2image=False,
               decode_bf16=False)
FLAGS = dict(num_joints=14, with_heatmaps_loss=(True, True),
             with_ae_loss=(True, False), test_with_heatmaps=(True, True),
             test_with_ae=(True, False), flip_test=False,
             flip_index=tuple(flip_index_for("crowd_pose")))


@pytest.fixture(scope="module")
def slice_pair():
    """Both engines on the trained Auto-XS weights, 2 bench scenes, and the
    scenes' fp32 decode maps.

    The JAX side gets the checkpoint through the port's reader, which
    tests/test_torch_convert.py pins bit for bit to flax's."""
    torch.backends.cudnn.allow_tf32 = False
    arch = get_arch("auto-XS")
    params, state = load_params(CKPT_XS)

    def apply_fn(p, s, x):
        return apply_litepose(p, s, x, JSpec(num_joints=14), arch,
                              policy=Policy.exact())[0]

    j_engine = JPoseEngine(apply_fn, params, state, JFlags(**FLAGS),
                           JGroupParams(num_joints=14, detection_threshold=0.1),
                           JEngineConfig(**SERVING))
    model = litepose_from_jax(params, state, ModelSpec(num_joints=14), arch,
                              compute_dtype=torch.float32)
    engine = PoseEngine(model, InferenceFlags(**FLAGS),
                        GroupParams(num_joints=14, detection_threshold=0.1),
                        EngineConfig(**SERVING))
    images = bench_scene_batch(2, SIZE)
    det, tag = engine.run_batch(images)[:2]
    return j_engine, engine, images, (det.numpy(), tag.numpy())


def test_process_batch_square_matches_jax(slice_pair):
    j_engine, engine, images, _ = slice_pair
    jp, js, jn = j_engine.process_batch_square(images)
    tp, ts, tn = engine.process_batch_square(images)
    assert tp.shape == jp.shape == (2, 40, 14, 4)
    np.testing.assert_array_equal(tn, jn)
    assert jn.min() > 0  # trained weights find people in every scene
    # fp32 forward differs by conv summation order (~1e-6): peak positions
    # are equal, joint coordinates within 1e-3 px, scores within 1e-4
    np.testing.assert_allclose(tp[..., :2], jp[..., :2], atol=1e-3, rtol=0)
    np.testing.assert_allclose(ts, js, atol=1e-4, rtol=0)
    np.testing.assert_allclose(tp[..., 2:], jp[..., 2:], atol=1e-4, rtol=0)


@pytest.mark.parametrize("dtype,topk_method",
                         [("float32", "approx"), ("bfloat16", "exact")])
def test_parse_batch_bit_equal_on_same_maps(slice_pair, dtype, topk_method):
    """The same trained-model maps through both decodes: people bit-equal.

    bf16 maps take the decode_bf16 path (NMS and top-M of bf16 planes).
    They are held against the JAX "exact" config, the fused Pallas
    NMS + top-M in interpret mode: on the CPU ``lax.approx_max_k`` breaks
    bf16 value ties in no fixed order, while ``lax.top_k`` and the port
    take the lowest flat index.  On fp32 planes the two JAX configs agree."""
    j_engine, engine, _, (det, tag) = slice_pair
    j_cfg = j_engine.group_cfg._replace(topk_method=topk_method)
    jd, jt = jnp.asarray(det).astype(dtype), jnp.asarray(tag).astype(dtype)
    jp, js, jn = j_parse_batch(jd, jt, j_cfg, False, False, tag_layout="thw")
    td = torch.from_numpy(det).to(getattr(torch, dtype))
    tt = torch.from_numpy(tag).to(getattr(torch, dtype))
    tp, ts, tn = parse_batch(td, tt, engine.group_cfg, False, False)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    # scores: a mean over 14 joints, summed in another order than XLA's
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6, rtol=0)


_NO_JAX = """
import sys
import numpy as np
import torch
from litepose_tpu.arch.manager import ArchManager
from litepose_tpu_torch.core.engine import EngineConfig, PoseEngine
from litepose_tpu_torch.core.inference import InferenceFlags
from litepose_tpu_torch.models.litepose import LitePose, ModelSpec
from litepose_tpu_torch.ops.group import GroupParams

torch.manual_seed(0)
arch = ArchManager().fixed_sample(reso=128, ratio=0.25)
model = LitePose(ModelSpec(), arch).eval()
flags = InferenceFlags(14, (True, True), (True, False), (True, True), (True, False))
cfg = EngineConfig(input_size=128, assignment="greedy", topk_method="approx",
                   with_adjust=False, with_refine=False, project2image=False,
                   decode_bf16=True)
engine = PoseEngine(model, flags, GroupParams(num_joints=14), cfg)
images = np.random.default_rng(0).integers(0, 255, (2, 128, 128, 3), dtype=np.uint8)
people, scores, n = engine.process_batch_square(images)
assert people.shape == (2, 40, 14, 4) and np.isfinite(people).all(), people.shape
assert "jax" not in sys.modules and "cv2" not in sys.modules, "jax or cv2 imported"
print("ok", n.tolist())
"""


def test_port_runs_without_jax():
    """The port imports neither jax nor cv2: a fresh interpreter runs the
    CPU engine and then checks ``sys.modules``."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    out = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("ok")


def test_scene_renderer_matches_cv2_scenes():
    """The cv2-free bench scenes: the same people as the JAX package's, and
    all but a few rasterization edge pixels equal."""
    from litepose_tpu_torch.data.synthetic import bench_scene_batch as port_scenes

    want, want_gt = bench_scene_batch(6, 256, return_gt=True)
    got, got_gt = port_scenes(6, 256, return_gt=True)
    assert [len(p) for p in got_gt] == [len(p) for p in want_gt]
    for a, b in zip(got_gt, want_gt):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert (got != want).any(-1).mean() < 1e-3
