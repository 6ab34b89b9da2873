"""The engine end to end against the JAX one, at fp32 on the trained
Auto-XS checkpoint and synthetic bench scenes: the serving path
(``process_batch_square``: greedy grouping, "approx" top-k, no adjust,
refine or projection) and the eval protocol (``process`` /
``process_many`` with the eval defaults: flip test, projection, exact top-M,
Hungarian grouping, adjust, refine), single- and multi-scale, and with a
centre joint."""

import dataclasses

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
from litepose_tpu_torch.data.synthetic import bench_scene_batch as port_scenes
from litepose_tpu_torch.ops.group import GroupParams, StaticGroupCfg, joint_order_for, parse_batch
from litepose_tpu_torch.train.checkpoint import load_params
from test_torch_arch import port_arch

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
    model = litepose_from_jax(params, state, ModelSpec(num_joints=14), port_arch(arch),
                              compute_dtype=torch.float32)
    engine = PoseEngine(model, InferenceFlags(**FLAGS),
                        GroupParams(num_joints=14, detection_threshold=0.1),
                        EngineConfig(**SERVING), device="cpu")
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
    tp, ts, tn = parse_batch(td, tt, engine.group_cfg, False, False, tag_layout="thw")
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    # scores: a mean over 14 joints, summed in another order than XLA's
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6, rtol=0)


_NO_JAX = """
import sys
import numpy as np
import torch
from litepose_tpu_torch.arch import get_arch
from litepose_tpu_torch.core.engine import EngineConfig, PoseEngine
from litepose_tpu_torch.core.inference import InferenceFlags
from litepose_tpu_torch.data.flip import flip_index_for
from litepose_tpu_torch.models.litepose import LitePose, ModelSpec
from litepose_tpu_torch.ops.group import GroupParams

torch.manual_seed(0)
arch = get_arch("auto-XS").with_img_size(128)
model = LitePose(ModelSpec(), arch).eval()
flags = InferenceFlags(14, (True, True), (True, False), (True, True), (True, False))
cfg = EngineConfig(input_size=128, assignment="greedy", topk_method="approx",
                   with_adjust=False, with_refine=False, project2image=False,
                   decode_bf16=True)
engine = PoseEngine(model, flags, GroupParams(num_joints=14), cfg, device="cpu")
images = np.random.default_rng(0).integers(0, 255, (2, 128, 128, 3), dtype=np.uint8)
people, scores, n = engine.process_batch_square(images)
assert people.shape == (2, 40, 14, 4) and np.isfinite(people).all(), people.shape
# deployment: the serving program exported, saved, loaded and run, a
# skeleton drawn and written as PNG, the summary, the export and demo CLIs
import tempfile
import litepose_tpu_torch.ops.library
import litepose_tpu_torch.tools.demo
import litepose_tpu_torch.tools.export
# the profilers, the serving batch sweep and the CUPTI check
import litepose_tpu_torch.tools.cupti_check
import litepose_tpu_torch.tools.profile_eval
import litepose_tpu_torch.tools.profile_model
import litepose_tpu_torch.tools.sweep_serve
from litepose_tpu_torch.core.export import export_engine, load_artifact, save_artifact
from litepose_tpu_torch.utils.summary import model_summary
from litepose_tpu_torch.utils.vis import draw_skeleton, read_png, write_png
with tempfile.TemporaryDirectory() as tmp:
    save_artifact(export_engine(engine, 2), tmp + "/serving.pt2")
    got = load_artifact(tmp + "/serving.pt2", device="cpu")(torch.from_numpy(images))
    assert all(np.array_equal(g.numpy(), w) for g, w in zip(got, (people, scores, n)))
    canvas = draw_skeleton(images[0], [people[0, 0]])
    write_png(tmp + "/canvas.png", canvas)
    assert np.array_equal(read_png(tmp + "/canvas.png"), canvas)
assert model_summary(model, arch).startswith("parameters: ")
# the eval protocol (defaults: hungarian, refine, projection) with flip test
# on a non-square image
evaluator = PoseEngine(model, flags._replace(flip_test=True,
                                             flip_index=tuple(flip_index_for("crowd_pose"))),
                       GroupParams(num_joints=14), EngineConfig(input_size=128), device="cpu")
found, scores = evaluator.process(images[0][:90])
assert len(found) == len(scores), (len(found), len(scores))
assert all(p.shape == (14, 5) and np.isfinite(p).all() for p in found)
# the dataset eval path: a config read without yaml, a JPEG decoded and a
# polygon filled without cv2, and the CLI's modules
import litepose_tpu_torch.arch.manager
import litepose_tpu_torch.data.eval_oks
import litepose_tpu_torch.models.torch_convert
import litepose_tpu_torch.tools.valid
from litepose_tpu_torch.config import default_config, update_config
from litepose_tpu_torch.data.coco_io import polygons_to_mask
from litepose_tpu_torch.data.jpeg import decode_jpeg
cfg = update_config(default_config(), "configs/crowd_pose/mobilenet/mobile.yaml")
assert cfg.DATASET.NUM_JOINTS == 14 and cfg.TRAIN.LR == 4e-3
assert decode_jpeg("litepose_tpu_torch/assets/eval_fixture/000004.jpg").shape == (427, 640, 3)
assert polygons_to_mask([[1, 1, 8, 1, 8, 6]], 10, 10).sum() > 0
# the NAS pipeline: the supernet at a sampled arch, its modules and CLIs
import litepose_tpu_torch.models.fold_bn
import litepose_tpu_torch.nas.calibrate
import litepose_tpu_torch.tools.calibrate_test
import litepose_tpu_torch.tools.fuse_bn
import litepose_tpu_torch.tools.gen_arch
import litepose_tpu_torch.tools.search
import litepose_tpu_torch.tools.train
import litepose_tpu_torch.tools.weight_transfer
from litepose_tpu_torch.arch import ArchManager, gmacs
from litepose_tpu_torch.data.resize import resize_linear
from litepose_tpu_torch.models.super_litepose import (SuperDims, arch_to_mask_desc,
                                                      extract_subnet, init_super_litepose)
from litepose_tpu_torch.nas import EvolutionFinder
manager = ArchManager(deconv_setting=(16, 16, 8),
                      stage_setting=((8, 1, 2), (8, 2, 2), (16, 2, 2), (16, 1, 1)))
supernet = init_super_litepose(ModelSpec(), SuperDims.from_manager(manager),
                               torch.Generator().manual_seed(0)).eval()
sub_arch = manager.random_sample(np.random.default_rng(0)).with_img_size(64)
with torch.no_grad():
    outs = supernet(torch.zeros(1, 3, 64, 64), arch_to_mask_desc(sub_arch))
assert [tuple(o.shape) for o in outs] == [(1, 28, 16, 16), (1, 14, 32, 32)]
assert extract_subnet(supernet, sub_arch).arch == sub_arch and gmacs(sub_arch) > 0
assert resize_linear(images[0], (64, 48)).shape == (48, 64, 3)
# the baseline families from their configs, their bridges and reference
# loaders, and K1' on the host (its twin)
import litepose_tpu_torch.models.convert as convert
import litepose_tpu_torch.models.torch_convert as torch_convert
from litepose_tpu_torch.models import FAMILIES, get_model
from litepose_tpu_torch.ops.topk import nms_topk
for fam, path in zip(FAMILIES + ("pose_superresnet",),
                     ("crowd_pose/higher_hrnet/w32_512_adam_lr1e-3.yaml",
                      "crowd_pose/efficient_hrnet/H-3.yaml", "crowd_pose/resnet/resnet.yaml",
                      "crowd_pose/resnet/superresnet.yaml")):
    net = get_model(fam, update_config(default_config(), "configs/" + path), device="cpu")
    with torch.no_grad():
        outs = net(torch.zeros(1, 3, 64, 64))
    assert [tuple(o.shape) for o in outs] == [(1, 28, 16, 16), (1, 14, 32, 32)], fam
    assert convert.family_entries(net) and convert.to_jax(net)[0]
assert nms_topk(torch.rand(1, 2, 16, 16), 4, _gather="sum")[1].shape == (1, 2, 4)
# data parallelism: the mesh engine on two host replicas, a process group
# of one rank, the synced BN statistics
import tempfile
import litepose_tpu_torch.parallel
from litepose_tpu_torch.parallel import (destroy_distributed, init_distributed, make_mesh,
                                         sync_batch_stats)
mesh_engine = PoseEngine(model, flags, GroupParams(num_joints=14), engine.config,
                         mesh=make_mesh(2, "cpu"))
got = mesh_engine.process_batch_square(images)
mesh_engine.close()
chunks = [engine.process_batch_square(images[i:i + 1]) for i in range(2)]
assert all(np.array_equal(g, np.concatenate([c[j] for c in chunks])) for j, g in enumerate(got))
with tempfile.TemporaryDirectory() as tmp:
    init_distributed("cpu", "file://" + tmp + "/rendezvous", 1, 0)
    assert sync_batch_stats(torch.ones(2, 3, 4, 4), (0, 2, 3))[2] == 32
    destroy_distributed()
# the host decoder of the demo's --backend native, and a zipped JPEG
import zipfile
from litepose_tpu_torch.native import NativeHeatmapParser
from litepose_tpu_torch.utils import zipreader
people, _ = NativeHeatmapParser(GroupParams(num_joints=14)).parse(
    np.zeros((14, 16, 16), np.float32), np.zeros((14, 16, 16, 1), np.float32))
assert people.shape == (0, 14, 4)
with tempfile.TemporaryDirectory() as tmp:
    with zipfile.ZipFile(tmp + "/f.zip", "w") as z:
        z.write("litepose_tpu_torch/assets/eval_fixture/000000.jpg", "a.jpg")
    assert zipreader.imread(tmp + "/f.zip@a.jpg").shape == (427, 640, 3)
    zipreader.close_all()
for name in ("jax", "cv2", "yaml", "PIL"):
    assert name not in sys.modules, name + " imported"
jax_package = [m for m in sys.modules if m == "litepose_tpu" or m.startswith("litepose_tpu.")]
assert not jax_package, jax_package
print("ok", n.tolist())
"""


def test_port_runs_without_jax():
    """The port imports neither jax, cv2, yaml, PIL nor any module of the
    JAX package ``litepose_tpu``: a fresh interpreter builds an arch from the
    port's own zoo, runs the CPU engine's serving path and eval ``process``
    on a non-square image, reads a config, decodes a JPEG, fills a polygon,
    imports the eval CLI's modules and the NAS pipeline's (the train,
    search, weight-transfer, BN-fusion, arch and calibration CLIs), runs the
    supernet at a sampled arch and extracts it, builds and runs the three
    baseline families and the super-ResNet from their configs and K1' (its
    twin), exports the serving program and runs the loaded artifact, draws
    and writes a skeleton as PNG, imports the op library, the summary, the
    export and demo CLIs and the profilers (``profile_model``,
    ``profile_eval``, ``sweep_serve``, ``cupti_check``), serves on a mesh of two host
    replicas, joins a
    process group of one rank, decodes maps with the host decoder, reads a
    zipped JPEG, then checks ``sys.modules``."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    out = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("ok")


def test_engine_defaults_to_the_card():
    """Without a ``device`` argument the engine targets CUDA; with no card
    it raises at construction instead of running on the host."""
    args = (lambda x: [], InferenceFlags(**FLAGS), GroupParams(), EngineConfig())
    if torch.cuda.is_available():
        assert PoseEngine(*args).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PoseEngine(*args)
    assert PoseEngine(*args, device="cpu").device == torch.device("cpu")


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


# -- the eval protocol --------------------------------------------------------

EVAL_SIZE = 128
EVAL_FLAGS = dict(FLAGS, flip_test=True)
GROUP = dict(num_joints=14, detection_threshold=0.1)


def _eval_scenes():
    """Non-square scenes on two rungs of the resize ladder: 192x256 and
    150x192 warp to 128x192, 192x140 to 192x128."""
    sc = port_scenes(4, 192, seed=11)
    return [np.pad(sc[0], ((0, 0), (0, 64), (0, 0))), sc[1][:150], sc[3][:, 20:160]]


def _engines(scale_factors=(1.0,)):
    """JAX and port engines with the eval defaults plus flip test."""
    arch = get_arch("auto-XS")
    params, state = load_params(CKPT_XS)

    def apply_fn(p, s, x):
        return apply_litepose(p, s, x, JSpec(num_joints=14), arch,
                              policy=Policy.exact())[0]

    j_engine = JPoseEngine(apply_fn, params, state, JFlags(**EVAL_FLAGS),
                           JGroupParams(**GROUP),
                           JEngineConfig(input_size=EVAL_SIZE, scale_factors=scale_factors))
    model = litepose_from_jax(params, state, ModelSpec(num_joints=14), port_arch(arch),
                              compute_dtype=torch.float32)
    engine = PoseEngine(model, InferenceFlags(**EVAL_FLAGS), GroupParams(**GROUP),
                        EngineConfig(input_size=EVAL_SIZE, scale_factors=scale_factors),
                        device="cpu")
    return j_engine, engine


@pytest.fixture(scope="module")
def eval_pair():
    torch.backends.cudnn.allow_tf32 = False
    return _engines()


def _assert_same_people(want, got):
    """Equal person counts; joints within 1e-3 px, scores, joint scores and
    tags within 1e-4.  The fp32 forwards differ by conv summation order
    (about 1e-6 on these maps); the decode of equal maps is bit-equal
    (tests/test_torch_group.py).  The pinned scenes keep every rounded tag
    distance away from x.5, where such a difference could regroup people."""
    (wp, ws), (gp, gs) = want, got
    assert len(gp) == len(wp) == len(gs) == len(ws)
    np.testing.assert_allclose(gs, ws, atol=1e-4, rtol=0)
    for a, b in zip(gp, wp):
        assert a.shape == b.shape
        np.testing.assert_allclose(a[:, :2], b[:, :2], atol=1e-3, rtol=0)
        np.testing.assert_allclose(a[:, 2:], b[:, 2:], atol=1e-4, rtol=0)


def test_process_matches_jax(eval_pair):
    j_engine, engine = eval_pair
    for image in _eval_scenes()[:2]:
        want = j_engine.process(image)
        _assert_same_people(want, engine.process(image))
        assert len(want[0]) > 0
        assert want[0][0].shape == (14, 5)  # x, y, score and the two flip-test tags


def test_process_many_matches_jax_and_process(eval_pair):
    """Two shape buckets, the second a zero-padded chunk; each image as
    the JAX engine's ``process_many`` and as the port's own ``process``."""
    j_engine, engine = eval_pair
    images = _eval_scenes()
    progress = []
    got = engine.process_many(images, batch_size=2, progress_cb=progress.append)
    assert progress == [2, 3]
    for want, g in zip(j_engine.process_many(images, batch_size=2), got):
        _assert_same_people(want, g)
    for image, g in zip(images, got):
        _assert_same_people(engine.process(image), g)


def test_multi_scale_process_matches_jax():
    """Scales (1.0, 0.5): heatmaps of both scales projected to the base size
    and averaged, tags from scale 1."""
    j_engine, engine = _engines(scale_factors=(1.0, 0.5))
    image = _eval_scenes()[1]
    want = j_engine.process(image)
    _assert_same_people(want, engine.process(image))
    _assert_same_people(want, engine.process_many([image])[0])


@pytest.mark.parametrize("scale", [0.5, 2.0])
def test_single_non_unit_scale_matches_jax(scale):
    """One scale other than 1.0: the tags come from that scale, as in the
    JAX engine; process_many sends the image through process.  A 256x256
    scene: at these scales the narrow eval scenes fill all 40 clusters with
    noise peaks whose grouping hangs on the fp32 forwards' 1e-6 difference."""
    j_engine, engine = _engines(scale_factors=(scale,))
    image = port_scenes(2, 256, seed=11)[1]
    want = j_engine.process(image)
    _assert_same_people(want, engine.process(image))
    _assert_same_people(want, engine.process_many([image])[0])


def test_with_center_process_matches_jax():
    """A 15-joint model (14 + centre, seeded random weights) whose centre
    channel the decode drops, flip test on."""
    import jax
    from litepose_tpu.arch.manager import ArchManager
    from litepose_tpu.models.litepose import init_litepose

    arch = ArchManager().fixed_sample(reso=128, ratio=0.25)
    spec = JSpec(num_joints=15)
    params, state = init_litepose(jax.random.PRNGKey(0), spec, arch)
    flags = dict(EVAL_FLAGS, num_joints=15, ignore_center=True,
                 flip_index=tuple(flip_index_for("crowd_pose", with_center=True)))

    def apply_fn(p, s, x):
        return apply_litepose(p, s, x, spec, arch, policy=Policy.exact())[0]

    j_engine = JPoseEngine(apply_fn, params, state, JFlags(**flags), JGroupParams(**GROUP),
                           JEngineConfig(input_size=EVAL_SIZE))
    model = litepose_from_jax(params, state, ModelSpec(num_joints=15), port_arch(arch),
                              compute_dtype=torch.float32)
    engine = PoseEngine(model, InferenceFlags(**flags), GroupParams(**GROUP),
                        EngineConfig(input_size=EVAL_SIZE), device="cpu")
    image = np.random.default_rng(1).integers(0, 255, (100, 120, 3)).astype(np.uint8)
    want = j_engine.process(image)
    _assert_same_people(want, engine.process(image))
    assert all(p.shape == (14, 5) for p in want[0])  # centre removed


def test_defaults_match_jax():
    """The same call means the same thing in both packages: eval defaults
    of EngineConfig, GroupParams and StaticGroupCfg.from_params, and the
    joint orders with and without a kept centre."""
    assert dataclasses.asdict(EngineConfig()) == dataclasses.asdict(JEngineConfig())
    assert dataclasses.asdict(GroupParams()) == dataclasses.asdict(JGroupParams())
    from litepose_tpu.ops.group import StaticGroupCfg as JCfg
    from litepose_tpu.ops.group_ref import joint_order_for as j_joint_order_for

    want = JCfg.from_params(JGroupParams())._asdict()
    want.pop("interpret")
    assert StaticGroupCfg.from_params(GroupParams())._asdict() == want
    for n in (14, 15, 17, 18):
        for kept in (False, True):
            assert joint_order_for(n, kept) == j_joint_order_for(n, kept)
