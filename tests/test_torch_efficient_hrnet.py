"""The port's EfficientHRNet against the JAX package's ``efficient_hrnet``.

As tests/test_torch_hrnet.py: fp32, ``Policy.exact()`` against TF32 off,
atol 2e-4 / rtol 1e-3, at narrowed HRNet stages and 64 px images (the
EfficientNet backbone keeps its B0 table at each DEPTH_MULT / WIDTH_MULT
of the shipped configs); weights through ``models.convert`` and through
JAX's reference reader ``efficient_hrnet_from_torch``; the SAME padding,
the width/depth rounding and the feature taps against the JAX copies; and
both ``PoseEngine``s on the same images."""

import glob
import os

import jax
import numpy as np
import pytest
import torch

from litepose_tpu.models import efficient_hrnet as jeff
from litepose_tpu.models.layers import Policy

from litepose_tpu_torch.models import convert
from litepose_tpu_torch.models import efficient_hrnet as eff
from litepose_tpu_torch.models.efficient_hrnet import (EffHRNetSpec, EfficientHRNet,
                                                       init_efficient_hrnet)
from litepose_tpu_torch.models.higher_hrnet import StageSpec
from test_torch_hrnet import (assert_forward_equal, assert_people_equal, engine_pair, images,
                              jax_forward, jax_spec, moved, peaky, port_forward, scenes)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(2)
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*", "efficient_hrnet", "*.yaml")))

NARROW = dict(stage2=StageSpec(1, 2, "BASIC", (1, 1), (32, 64)),
              stage3=StageSpec(1, 3, "BASIC", (1, 1, 1), (32, 64, 128)),
              stage4=StageSpec(1, 4, "BASIC", (1, 2, 1, 1), (32, 64, 128, 256)),
              deconv_num_basic_blocks=1)
# (DEPTH_MULT, WIDTH_MULT) of the configs H-1 to H-4, with SCALE_FACTOR -5:
# stage widths 11..85
VARIANTS = {"H-3": (0.578, 0.751, -5), "H-1": (0.833, 0.909, -5), "H-4": (0.483, 0.684, -5),
            "H-2": (0.694, 0.826, -5)}


def spec_of(name, **kw):
    dm, wm, sf = VARIANTS[name]
    return EffHRNetSpec(depth_mult=dm, width_mult=wm, scale_factor=sf, **dict(NARROW, **kw))


def jspec(spec):
    return jax_spec(spec, jeff, jeff.EffHRNetSpec)


def seeded_model(spec, seed=0):
    return moved(init_efficient_hrnet(spec, torch.Generator().manual_seed(seed),
                                      compute_dtype=torch.float32))


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.parametrize("name", ["H-3", "H-1", "H-4"])
def test_forward_matches_jax_fp32(name):
    spec = spec_of(name)
    model = seeded_model(spec)
    params, state = convert.efficient_hrnet_to_jax(model)
    x = images()
    want = jax_forward(jeff.apply_efficient_hrnet, params, state, x, jspec(spec))
    assert_forward_equal(port_forward(model, x), want)


def test_non_square_input_matches_jax():
    """A 96x64 input (the SAME pads of a stride-2 conv are uneven at any
    size: one row and column after, none before)."""
    spec = spec_of("H-3")
    model = seeded_model(spec, seed=2)
    params, state = convert.efficient_hrnet_to_jax(model)
    x = np.random.default_rng(4).standard_normal((1, 96, 64, 3)).astype(np.float32)
    want = jax_forward(jeff.apply_efficient_hrnet, params, state, x, jspec(spec))
    assert_forward_equal(port_forward(model, x), want)


def test_state_dict_through_jax_reference_reader():
    from litepose_tpu.models.torch_convert import efficient_hrnet_from_torch

    spec = spec_of("H-1")
    model = seeded_model(spec, seed=3)
    sd = {"module." + k: v for k, v in model.state_dict().items()}
    params, state = efficient_hrnet_from_torch(sd, jspec(spec))
    want_p, want_s = convert.efficient_hrnet_to_jax(model)
    for a, b in ((params, want_p), (state, want_s)):
        assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
        for u, v in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
            np.testing.assert_array_equal(np.asarray(u), v)
    x = images(1)
    want = jax_forward(jeff.apply_efficient_hrnet, params, state, x, jspec(spec))
    assert_forward_equal(port_forward(model, x), want)


def test_jax_init_round_trips_and_loads_strict(tmp_path):
    """The JAX init -> the port -> the same pytrees; the port's state dict
    as a ``.pth.tar`` loads back with ``strict=True``."""
    from litepose_tpu_torch.models.torch_convert import (efficient_hrnet_from_torch,
                                                         load_torch_checkpoint)

    spec = spec_of("H-4")
    params, state = jeff.init_efficient_hrnet(jax.random.PRNGKey(0), jspec(spec))
    model = convert.efficient_hrnet_from_jax(jax.device_get(params), jax.device_get(state),
                                             spec, compute_dtype=torch.float32)
    got_p, got_s = convert.efficient_hrnet_to_jax(model)
    for a, b in ((got_p, params), (got_s, state)):
        assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
        for u, v in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
            np.testing.assert_array_equal(u, np.asarray(v))
    torch.save({"state_dict": model.state_dict()}, tmp_path / "e.pth.tar")
    loaded = efficient_hrnet_from_torch(load_torch_checkpoint(str(tmp_path / "e.pth.tar")),
                                        spec, compute_dtype=torch.float32)
    x = images(1)
    for a, b in zip(port_forward(loaded, x), port_forward(model, x)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kernel,stride", [(1, 1), (3, 1), (3, 2), (5, 1), (5, 2), (2, 2)])
def test_same_pad_matches_jax(kernel, stride):
    assert eff._same_pad(kernel, stride) == jeff._same_pad(kernel, stride)


def test_copies_match_jax():
    """The EfficientNet table, the taps, the rounding and the stage scale."""
    assert eff.EFFNET_SETTINGS == jeff.EFFNET_SETTINGS
    assert eff.DEPTH_TAPS == jeff.DEPTH_TAPS
    for v in (8, 12.5, 16, 24, 32, 40, 80, 112, 192, 320, 1280):
        for wm in (0.684, 0.751, 0.826, 0.909, 1.0, 1.1, 1.4):
            assert eff._round_filters(v, wm) == jeff._round_filters(v, wm)
        assert eff._make_divisible(v) == jeff._make_divisible(v)
    for n in range(1, 6):
        for dm in eff.DEPTH_TAPS:
            assert eff._round_repeats(n, dm) == jeff._round_repeats(n, dm)
    for c in (32, 64, 128, 256):
        for sf in range(-5, 3):
            assert eff._scale(c, sf) == jeff._scale(c, sf)
    for dm, wm in ((0.483, 0.684), (0.578, 0.751), (0.694, 0.826), (0.833, 0.909), (1.0, 1.0),
                   (1.4, 1.1), (1.8, 1.4)):
        spec = EffHRNetSpec(depth_mult=dm, width_mult=wm)
        want = jeff.EffHRNetSpec(depth_mult=dm, width_mult=wm)
        assert spec.backbone_plan() == want.backbone_plan()
        assert spec.taps() == want.taps()


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: os.path.relpath(p, REPO))
def test_config_spec_equals_jax(path):
    """Every shipped EfficientHRNet config reads to the JAX tree and spec;
    the model's key set is the reference reader's."""
    from litepose_tpu.config import default_config as j_default
    from litepose_tpu.config import update_config as j_update

    from litepose_tpu_torch.config import default_config, update_config

    cfg, jcfg = update_config(default_config(), path), j_update(j_default(), path)
    assert cfg.to_dict() == jcfg.to_dict()
    spec = EffHRNetSpec.from_config(cfg)
    assert jspec(spec) == jeff.EffHRNetSpec.from_config(jcfg)
    model = EfficientHRNet(spec)
    names = {n for n, _, _, kind in convert.efficient_hrnet_entries(model)
             if kind != convert.NONE}
    assert names == set(model.state_dict())


@pytest.mark.parametrize("mode", ["serving", "eval"])
def test_engine_matches_jax(mode):
    """The narrow H-3 variant, seeded and ``peaky`` (10% of each plane above
    the threshold: a few people after the flip average), through both
    engines."""
    spec = spec_of("H-3")
    imgs = scenes()
    model = peaky(seeded_model(spec, seed=6), imgs, spec.num_joints, share=0.1)
    params, state = convert.efficient_hrnet_to_jax(model)
    js = jspec(spec)

    def apply_fn(p, s, x):
        return jeff.apply_efficient_hrnet(p, s, x, js, policy=Policy.exact())[0]

    j_engine, engine = engine_pair(model, apply_fn, params, state, mode)
    assert_people_equal(j_engine, engine, mode, imgs)


@pytest.mark.parametrize("name", ["H-1", "H-2", "H-4"])
def test_mismatched_joint_counts_raise_as_in_jax(name, tmp_path):
    """H-1, H-2 and H-4 give DATASET.NUM_JOINTS and MODEL.NUM_JOINTS
    different values (17 and 14).  The JAX engine built from such a config
    as ``tools/valid.py`` builds it fails in the forward's stage
    aggregation; the port's CLI refuses the config before it builds."""
    from litepose_tpu.config import default_config as j_default
    from litepose_tpu.config import update_config as j_update
    from litepose_tpu.core.engine import EngineConfig as JEngineConfig
    from litepose_tpu.core.engine import PoseEngine as JPoseEngine
    from litepose_tpu.core.inference import InferenceFlags as JFlags
    from litepose_tpu.data.flip import flip_index_for as j_flip_index
    from litepose_tpu.ops.group_ref import GroupParams as JGroupParams

    from litepose_tpu_torch.tools import valid

    path = os.path.join(REPO, "configs", "crowd_pose", "efficient_hrnet", f"{name}.yaml")
    jcfg = j_update(j_default(), path)
    assert jcfg.DATASET.NUM_JOINTS != jcfg.MODEL.NUM_JOINTS
    spec = spec_of(name, num_joints=jcfg.MODEL.NUM_JOINTS)
    params, state = convert.efficient_hrnet_to_jax(seeded_model(spec))
    js = jspec(spec)
    flip = j_flip_index(jcfg.DATASET.DATASET, jcfg.DATASET.WITH_CENTER)
    engine = JPoseEngine(
        lambda p, s, x: jeff.apply_efficient_hrnet(p, s, x, js, policy=Policy.exact())[0],
        params, state, JFlags.from_config(jcfg, flip), JGroupParams.from_config(jcfg),
        JEngineConfig(input_size=64))
    with pytest.raises(TypeError, match="incompatible shapes"):
        engine.process(np.zeros((64, 64, 3), np.uint8))
    with pytest.raises(ValueError, match="MODEL.NUM_JOINTS 14 != DATASET.NUM_JOINTS 17|"
                                         "MODEL.NUM_JOINTS 17 != DATASET.NUM_JOINTS 14"):
        valid.main(["--cfg", path, "--device", "cpu", "OUTPUT_DIR", str(tmp_path / "o"),
                    "LOG_DIR", str(tmp_path / "l")])
