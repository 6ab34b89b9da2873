"""The port's HigherHRNet against the JAX package's ``higher_hrnet``.

fp32 with ``Policy.exact()`` on the JAX side and TF32 off on the port's:
the forwards differ only in convolution summation order, so the bound is
the one of tests/test_torch_model.py (atol 2e-4, rtol 1e-3).  Widths and
depths are narrowed (one module a stage, 1-2 blocks a branch) and images
are 64 px; weights reach both packages through ``models.convert`` (the
port's seeded init with BN affines and statistics moved, as pytrees), and
the port's state dict through JAX's own reference reader
``hrnet_from_torch``.  The engine cases run both ``PoseEngine``s on the
same images: serving (greedy) and the eval protocol (flip, projection,
Hungarian, adjust, refine)."""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from litepose_tpu.models import higher_hrnet as jhr
from litepose_tpu.models.layers import Policy

from litepose_tpu_torch.models import convert
from litepose_tpu_torch.models.higher_hrnet import (HigherHRNet, HRNetSpec, StageSpec,
                                                    init_higher_hrnet)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(2)

SPECS = {
    # one module a stage, 1-2 BASIC blocks a branch
    "basic": HRNetSpec(
        stem_inplanes=8,
        stage2=StageSpec(1, 2, "BASIC", (1, 2), (8, 16)),
        stage3=StageSpec(1, 3, "BASIC", (1, 1, 2), (8, 16, 24)),
        stage4=StageSpec(1, 4, "BASIC", (1, 1, 1, 1), (8, 16, 24, 32)),
        deconv_channels=(8,), deconv_num_basic_blocks=1),
    # the gradual-shrinking variant of the w16 configs: 0-block branches
    "zero_blocks": HRNetSpec(
        stem_inplanes=8,
        stage2=StageSpec(1, 2, "BASIC", (0, 1), (8, 16)),
        stage3=StageSpec(2, 3, "BASIC", (0, 0, 1), (8, 16, 24)),
        stage4=StageSpec(1, 4, "BASIC", (0, 0, 0, 2), (8, 16, 24, 32)),
        deconv_channels=(8,), deconv_num_basic_blocks=2),
    # BOTTLENECK branches (later stages keep their widths: like the
    # reference, a transition that changes a width reads the last branch),
    # a 3x3 final conv, two deconv stages (one concatenating the
    # prediction, one not) and one tag a pixel
    "bottleneck_two_deconvs": HRNetSpec(
        num_joints=5, tag_per_joint=False, with_ae_loss=(True, True, False),
        stem_inplanes=8, final_conv_kernel=3,
        stage2=StageSpec(1, 2, "BOTTLENECK", (1, 1), (4, 8)),
        stage3=StageSpec(1, 3, "BASIC", (1, 1, 1), (16, 32, 24)),
        stage4=StageSpec(1, 4, "BASIC", (1, 1, 1, 1), (16, 32, 24, 32)),
        num_deconvs=2, deconv_channels=(8, 8), deconv_kernels=(4, 2),
        deconv_num_basic_blocks=1, cat_output=(True, False)),
}
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*", "higher_hrnet", "*.yaml")))


def jax_spec(spec, module=jhr, cls=None):
    """The JAX spec (``module``'s ``cls``, default ``HRNetSpec``) of a port spec."""
    cls = cls or module.HRNetSpec
    return cls(**{k: module.StageSpec(*v) if isinstance(v, StageSpec) else v
                  for k, v in spec._asdict().items()})


def moved(model, seed=1):
    """``model`` with every BN's affine and statistics drawn off the
    identity (numpy, seeded), in eval mode."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                m.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)))
                m.bias.copy_(torch.from_numpy(rng.normal(0, 0.2, c).astype(np.float32)))
                m.running_mean.copy_(torch.from_numpy(rng.normal(0, 0.2, c).astype(np.float32)))
                m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)))
            elif isinstance(m, torch.nn.Conv2d) and m.bias is not None:
                m.bias.copy_(torch.from_numpy(rng.normal(0, 0.2, m.out_channels)
                                              .astype(np.float32)))
    return model.eval()


def images(n=2, size=64, seed=2):
    return np.random.default_rng(seed).standard_normal((n, size, size, 3)).astype(np.float32)


def jax_forward(apply_fn, params, state, x, spec):
    """``apply_fn``'s fp32 outputs (``Policy.exact()``) under one jit: one
    compile instead of one a primitive."""
    fn = jax.jit(lambda p, s, x: apply_fn(p, s, x, spec, policy=Policy.exact())[0])
    return fn(params, state, jnp.asarray(x))


def port_forward(model, x):
    with torch.no_grad():
        return [o.numpy() for o in model(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))]


def assert_forward_equal(got, want):
    """Port NCHW outputs against JAX NHWC ones: atol 2e-4, rtol 1e-3."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w).transpose(0, 3, 1, 2)
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=2e-4, rtol=1e-3)


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cudnn.allow_tf32 = False


def seeded_model(spec, seed=0):
    return moved(init_higher_hrnet(spec, torch.Generator().manual_seed(seed),
                                   compute_dtype=torch.float32))


@pytest.mark.parametrize("name", list(SPECS))
def test_forward_matches_jax_fp32(name):
    spec = SPECS[name]
    model = seeded_model(spec)
    params, state = convert.hrnet_to_jax(model)
    x = images()
    want = jax_forward(jhr.apply_higher_hrnet, params, state, x, jax_spec(spec))
    assert_forward_equal(port_forward(model, x), want)


@pytest.mark.parametrize("name", ["basic", "zero_blocks"])
def test_state_dict_through_jax_reference_reader(name):
    """The port's state dict is a reference state dict: JAX's
    ``hrnet_from_torch`` reads it (with a DDP ``module.`` prefix) into the
    pytrees ``hrnet_to_jax`` gives, and its forward is the port's."""
    from litepose_tpu.models.torch_convert import hrnet_from_torch

    spec = SPECS[name]
    model = seeded_model(spec, seed=3)
    sd = {"module." + k: v for k, v in model.state_dict().items()}
    params, state = hrnet_from_torch(sd, jax_spec(spec))
    want_p, want_s = convert.hrnet_to_jax(model)
    for a, b in ((params, want_p), (state, want_s)):
        assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
        for u, v in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
            np.testing.assert_array_equal(np.asarray(u), v)
    x = images(1)
    want = jax_forward(jhr.apply_higher_hrnet, params, state, x, jax_spec(spec))
    assert_forward_equal(port_forward(model, x), want)


def test_jax_init_round_trips_through_the_port():
    """The JAX init's pytrees (None slots included) -> the port's model ->
    the same pytrees, leaf for leaf."""
    spec = SPECS["zero_blocks"]
    params, state = jhr.init_higher_hrnet(jax.random.PRNGKey(0), jax_spec(spec))
    model = convert.hrnet_from_jax(jax.device_get(params), jax.device_get(state), spec,
                                   compute_dtype=torch.float32)
    got_p, got_s = convert.hrnet_to_jax(model)
    for a, b in ((got_p, params), (got_s, state)):
        assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
        for u, v in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
            np.testing.assert_array_equal(u, np.asarray(v))


def test_reference_checkpoint_loads_strict(tmp_path):
    """A ``.pth.tar`` holding a reference-keyed state dict (with the DDP
    prefix, under ``state_dict``) loads with ``strict=True``; a missing key
    raises."""
    from litepose_tpu_torch.models.torch_convert import (hrnet_from_torch,
                                                         load_torch_checkpoint)

    spec = SPECS["basic"]
    model = seeded_model(spec, seed=4)
    path = tmp_path / "hrnet.pth.tar"
    torch.save({"state_dict": {"module." + k: v for k, v in model.state_dict().items()}}, path)
    loaded = hrnet_from_torch(load_torch_checkpoint(str(path)), spec,
                              compute_dtype=torch.float32)
    x = images(1)
    for a, b in zip(port_forward(loaded, x), port_forward(model, x)):
        np.testing.assert_array_equal(a, b)
    sd = model.state_dict()
    sd.pop("stage3.0.fuse_layers.2.0.1.1.weight")
    with pytest.raises(RuntimeError, match="Missing key"):
        hrnet_from_torch(sd, spec)


def test_msgpack_crosses_packages(tmp_path):
    """Weights written by the JAX ``save_params`` load into the port
    (``load_model_params``), and the port's ``save_params`` into JAX's
    ``load_params``, None slots included."""
    from litepose_tpu.train import checkpoint as jckpt

    from litepose_tpu_torch.train.checkpoint import load_model_params, save_params

    spec = SPECS["zero_blocks"]
    src = seeded_model(spec, seed=5)
    params, state = convert.hrnet_to_jax(src)
    jckpt.save_params(str(tmp_path / "j.msgpack"), params, state)
    dst = HigherHRNet(spec, compute_dtype=torch.float32).eval()
    load_model_params(str(tmp_path / "j.msgpack"), dst)
    x = images(1)
    for a, b in zip(port_forward(dst, x), port_forward(src, x)):
        np.testing.assert_array_equal(a, b)
    save_params(str(tmp_path / "p.msgpack"), src)
    got_p, got_s = jckpt.load_params(str(tmp_path / "p.msgpack"), params, state)
    for u, v in zip(jax.tree_util.tree_leaves((got_p, got_s)),
                    jax.tree_util.tree_leaves((params, state))):
        np.testing.assert_array_equal(np.asarray(u), v)


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: os.path.relpath(p, REPO))
def test_config_spec_equals_jax(path):
    """Each shipped HigherHRNet config reads to the JAX tree and spec, and
    the model it builds has the reference's key set (every key JAX's
    ``hrnet_from_torch`` reads, and no other)."""
    from litepose_tpu.config import default_config as j_default
    from litepose_tpu.config import update_config as j_update

    from litepose_tpu_torch.config import default_config, update_config

    cfg, jcfg = update_config(default_config(), path), j_update(j_default(), path)
    assert cfg.to_dict() == jcfg.to_dict()
    spec = HRNetSpec.from_config(cfg)
    assert jax_spec(spec) == jhr.HRNetSpec.from_config(jcfg)
    model = HigherHRNet(spec)
    table = convert.hrnet_entries(model)
    names = {n for n, _, _, kind in table if kind != convert.NONE}
    assert names == set(model.state_dict())


# -- the engines ---------------------------------------------------------------

ENGINE_SIZE = 128
GROUP = dict(num_joints=14, detection_threshold=0.1)
SERVING = dict(input_size=ENGINE_SIZE, assignment="greedy", topk_method="approx",
               with_adjust=False, with_refine=False, project2image=False, decode_bf16=False)


def engine_pair(model, apply_fn, params, state, mode, num_joints=14, dataset="crowd_pose"):
    """(JAX engine, port CPU engine) on one model's weights, serving or the
    eval protocol with flip test."""
    from litepose_tpu.core.engine import EngineConfig as JEngineConfig
    from litepose_tpu.core.engine import PoseEngine as JPoseEngine
    from litepose_tpu.core.inference import InferenceFlags as JFlags
    from litepose_tpu.ops.group_ref import GroupParams as JGroupParams

    from litepose_tpu_torch.core.engine import EngineConfig, PoseEngine
    from litepose_tpu_torch.core.inference import InferenceFlags
    from litepose_tpu_torch.data.flip import flip_index_for
    from litepose_tpu_torch.ops.group import GroupParams

    flags = dict(num_joints=num_joints, with_heatmaps_loss=(True, True),
                 with_ae_loss=(True, False), test_with_heatmaps=(True, True),
                 test_with_ae=(True, False), flip_test=mode == "eval",
                 flip_index=tuple(flip_index_for(dataset)))
    group = dict(GROUP, num_joints=num_joints)
    cfg = SERVING if mode == "serving" else dict(input_size=ENGINE_SIZE)
    j_engine = JPoseEngine(apply_fn, params, state, JFlags(**flags), JGroupParams(**group),
                           JEngineConfig(**cfg))
    engine = PoseEngine(model, InferenceFlags(**flags), GroupParams(**group),
                        EngineConfig(**cfg), device="cpu")
    return j_engine, engine


def scenes():
    from litepose_tpu_torch.data.synthetic import bench_scene_batch

    return bench_scene_batch(2, ENGINE_SIZE, seed=3)


def peaky(model, imgs, num_joints, share=0.02):
    """Shift each heatmap channel's final bias so that ``share`` of its
    pixels on ``imgs`` lie above the 0.1 detection threshold, as a trained
    model's few peaks do; a seeded init puts most of a plane above it, and
    the decode then runs at its 40-person cap on noise.  The share that
    leaves a few people after the flip average depends on the model.  A
    folded model in eval mode stores its eval constants again."""
    from litepose_tpu_torch.core.inference import normalize_images

    with torch.no_grad():
        outs = model(normalize_images(torch.from_numpy(imgs)))
        for conv, out in zip(model.final_layers, outs):
            q = torch.quantile(out[:, :num_joints].transpose(0, 1).flatten(1), 1.0 - share, dim=1)
            conv.bias[:num_joints] -= q - 0.1
    if not model.training and hasattr(model, "fold_bn_"):
        model.fold_bn_()
    return model


def assert_people_equal(j_engine, engine, mode, imgs):
    """Serving: counts equal, joints within 1e-3 px, scores within 1e-4;
    the eval protocol: per image the same people, coordinates within 1e-3
    px, scores within 1e-4 (the fp32 forwards differ by ~1e-6)."""
    if mode == "serving":
        jp, js, jn = j_engine.process_batch_square(imgs)
        tp, ts, tn = engine.process_batch_square(imgs)
        np.testing.assert_array_equal(tn, jn)
        assert jn.min() > 0
        np.testing.assert_allclose(tp, jp, atol=1e-3, rtol=0)
        np.testing.assert_allclose(ts, js, atol=1e-4, rtol=0)
        return
    # one rung of the resize ladder (one JAX compile): 96x128 crops
    found = 0
    for src in (imgs[0][:96], imgs[1][16:112]):
        (jp, js), (tp, ts) = j_engine.process(src), engine.process(src)
        assert len(tp) == len(jp)
        found += len(tp)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a, b, atol=1e-3, rtol=0)
        np.testing.assert_allclose(ts, js, atol=1e-4, rtol=0)
    assert found > 0


@pytest.mark.parametrize("mode", ["serving", "eval"])
def test_engine_matches_jax(mode):
    """The ``basic`` narrow HigherHRNet, seeded, its heatmaps made
    ``peaky``, through both engines on two synthetic scenes."""
    spec = SPECS["basic"]
    imgs = scenes()
    model = peaky(seeded_model(spec, seed=6), imgs, spec.num_joints)
    params, state = convert.hrnet_to_jax(model)
    jspec = jax_spec(spec)

    def apply_fn(p, s, x):
        return jhr.apply_higher_hrnet(p, s, x, jspec, policy=Policy.exact())[0]

    j_engine, engine = engine_pair(model, apply_fn, params, state, mode)
    assert_people_equal(j_engine, engine, mode, imgs)
