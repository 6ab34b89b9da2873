"""The port's experiment config against the JAX package's: its YAML reader
against ``yaml.safe_load`` on every config of ``configs/``, ``update_config``
and ``dump`` against the JAX ``ConfigNode``, the ``from_config``
constructors of the eval CLI against the JAX ones, ``ArchManager`` and the
``MODEL.NAME`` registry."""

import dataclasses
import glob
import math
import os

import numpy as np
import pytest
import yaml

from litepose_tpu_torch.config import default_config, update_config, yaml_subset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "**", "*.yaml"), recursive=True))
LITEPOSE_CONFIGS = [p for p in CONFIGS if os.sep + "mobilenet" + os.sep in p
                    or os.sep + "simplenet" + os.sep in p]
OPTS = ["DATASET.INPUT_SIZE", "448", "TEST.SCALE_FACTOR", "[0.5]", "TEST.FLIP_TEST", "False"]


def _rel(path):
    return os.path.relpath(path, REPO)


def _same(a, b) -> bool:
    """Equal trees, types included (nan equal to nan)."""
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


def test_every_config_is_read():
    assert len(CONFIGS) == 20
    assert len(LITEPOSE_CONFIGS) >= 4


@pytest.mark.parametrize("path", CONFIGS, ids=_rel)
def test_reader_equals_safe_load(path):
    with open(path) as f:
        want = yaml.safe_load(f)
    assert _same(yaml_subset.load_file(path), want)


@pytest.mark.parametrize("path", CONFIGS, ids=_rel)
@pytest.mark.parametrize("opts", [[], OPTS], ids=["file", "file+opts"])
def test_update_config_equals_jax(path, opts):
    from litepose_tpu.config import default_config as j_default
    from litepose_tpu.config import update_config as j_update

    got = update_config(default_config(), path, opts)
    want = j_update(j_default(), path, opts)
    assert _same(got.to_dict(), want.to_dict())
    assert got.dump() == want.dump()


SUBSET_DOC = """
a: 1_000
b: 0x1f
c: 017
d: 1:30
e: -.inf
f: .5
g: '4e-3'
h: "x\\ty \\u00e9"
i: [1, [2, 'three'], yes, ~, Off, 1.0e+3, 1.0e3, ]
j:
k: 'it''s'   # a comment
l: a#b
m: [ ]
n:
  o:
    p: NULL
q: +12
r: 3.
s: 4e-3
"""


def test_reader_equals_safe_load_on_the_subset():
    """Every scalar form of the subset, resolved as YAML 1.1 does."""
    assert _same(yaml_subset.loads(SUBSET_DOC), yaml.safe_load(SUBSET_DOC))
    assert yaml_subset.loads("# only a comment\n") is None


@pytest.mark.parametrize("doc,line", [
    ("a: 1\nb:\n  - 1\n", 3),  # block sequence
    ("a: {b: 1}\n", 1),  # flow mapping
    ("a: &x 1\n", 1),  # anchor
    ("a: 1\nb: *x\n", 2),  # alias
    ("a: !!str 1\n", 1),  # tag
    ("a: |\n  text\n", 1),  # block scalar
    ("a: [1,\n  2]\n", 1),  # multi-line flow sequence
    ("---\na: 1\n", 1),  # document marker
    ("a: 2001-12-14\n", 1),  # timestamp
    ("a:\n\tb: 1\n", 2),  # tab indentation
    ("a: b: c\n", 1),  # a mapping on one line
    ("a: 1\n    b: 2\n", 2),  # indentation after a scalar
    ("a: 'open\n", 1),  # unclosed quote
])
def test_reader_refuses_outside_the_subset(doc, line):
    with pytest.raises(ValueError, match=f"<string>:{line}: "):
        yaml_subset.loads(doc)


def test_dump_equals_safe_dump():
    tree = {"a": ["*", "", "true", "1.5", "x y", "-", "a: b", 1e-4, 4e-3, 1e17,
                  float("inf"), None, True, 3],
            "b": {}, "c": [], "d": {"e": "/dataset/x", "f": (0,)}}
    assert yaml_subset.dumps(tree) == yaml.safe_dump(tree, sort_keys=True)


@pytest.mark.parametrize("path", LITEPOSE_CONFIGS, ids=_rel)
def test_from_config_equals_jax(path):
    """InferenceFlags, GroupParams, ModelSpec and the EngineConfig of the
    eval CLI, built from one config in each package, field for field."""
    from litepose_tpu.config import default_config as j_default
    from litepose_tpu.config import update_config as j_update
    from litepose_tpu.core.inference import InferenceFlags as JFlags
    from litepose_tpu.data.flip import flip_index_for as j_flip_index
    from litepose_tpu.models.litepose import ModelSpec as JSpec
    from litepose_tpu.ops.group_ref import GroupParams as JGroupParams

    from litepose_tpu_torch.core.engine import EngineConfig
    from litepose_tpu_torch.core.inference import InferenceFlags
    from litepose_tpu_torch.data.flip import flip_index_for
    from litepose_tpu_torch.models.litepose import ModelSpec
    from litepose_tpu_torch.ops.group import GroupParams

    for opts in ([], ["DATASET.WITH_CENTER", "True", "TEST.IGNORE_CENTER", "False"]):
        cfg = update_config(default_config(), path, opts)
        jcfg = j_update(j_default(), path, opts)
        flip = flip_index_for(cfg.DATASET.DATASET, cfg.DATASET.WITH_CENTER)
        assert flip == j_flip_index(jcfg.DATASET.DATASET, jcfg.DATASET.WITH_CENTER)
        want = JFlags.from_config(jcfg, flip)._asdict()
        project2image = want.pop("project2image")
        assert InferenceFlags.from_config(cfg, flip)._asdict() == want
        assert dataclasses.asdict(GroupParams.from_config(cfg)) == dataclasses.asdict(
            JGroupParams.from_config(jcfg))
        assert ModelSpec.from_config(cfg)._asdict() == JSpec.from_config(jcfg)._asdict()
        engine = EngineConfig.from_config(cfg)
        assert engine.project2image == project2image
        # tools/valid.py:62-68
        assert (engine.input_size, engine.scale_factors, engine.with_adjust,
                engine.with_refine) == (jcfg.DATASET.INPUT_SIZE, tuple(jcfg.TEST.SCALE_FACTOR),
                                        jcfg.TEST.ADJUST, jcfg.TEST.REFINE)
        # the rest stays at the eval defaults, as in the JAX CLI
        assert (engine.assignment, engine.topk_method, engine.decode_bf16) == (
            "hungarian", "exact", False)


def _arch_sizes():
    """Every (reso, deconv setting) the configs and the zoo use."""
    from litepose_tpu_torch.arch import ARCH_ZOO

    resos = {a.img_size for a in ARCH_ZOO.values()}
    deconvs = set()
    for path in LITEPOSE_CONFIGS:
        cfg = update_config(default_config(), path)
        resos.add(cfg.DATASET.INPUT_SIZE)
        deconvs.add(tuple(cfg.MODEL.EXTRA.NUM_DECONV_FILTERS))
    return sorted(resos), sorted(deconvs)


@pytest.mark.parametrize("ratio", [1.0, 0.75, 0.5, 0.25])
def test_arch_manager_fixed_sample_equals_jax(ratio):
    from litepose_tpu.arch.manager import ArchManager as JManager

    from litepose_tpu_torch.arch import ArchManager

    resos, deconvs = _arch_sizes()
    for deconv in deconvs:
        for reso in resos:
            got = ArchManager(deconv_setting=deconv).fixed_sample(reso=reso, ratio=ratio)
            want = JManager(deconv_setting=deconv).fixed_sample(reso=reso, ratio=ratio)
            assert got.to_dict() == want.to_dict()


def test_arch_manager_random_sample_equals_jax():
    from litepose_tpu.arch.manager import ArchManager as JManager

    from litepose_tpu_torch.arch import ArchManager

    got, want = ArchManager(seed=3), JManager(seed=3)
    for _ in range(20):
        assert got.random_sample().to_dict() == want.random_sample().to_dict()
    rng_a, rng_b = np.random.default_rng(5), np.random.default_rng(5)
    assert got.random_sample(rng_a).to_dict() == want.random_sample(rng_b).to_dict()
    assert got.max_arch(448).to_dict() == want.max_arch(448).to_dict()
    assert got.channel_choices(96) == want.channel_choices(96)


def test_registry_builds_litepose_and_names_what_waits():
    """LitePose, its supernet, the ResNet-space supernet and the three
    baseline families of the shipped configs build (the families and the
    super-ResNet at the JAX registry's stage output shapes, from
    ``jax.eval_shape``); an unknown name raises."""
    import jax
    import litepose_tpu.models as jmodels
    import torch
    from litepose_tpu.config import default_config as j_default
    from litepose_tpu.config import update_config as j_update

    from litepose_tpu_torch.arch import get_arch
    from litepose_tpu_torch.models import FAMILIES, get_model

    cfg = update_config(default_config(), os.path.join(
        REPO, "configs", "crowd_pose", "mobilenet", "mobile.yaml"))
    arch = get_arch("auto-XS").with_img_size(64)
    model = get_model("pose_mobilenet", cfg, arch, device="cpu")
    assert model.with_skips and not model.training
    assert not get_model("pose_simplenet", cfg, arch, device="cpu").with_skips
    with torch.no_grad():
        outs = model(torch.zeros(1, 3, 64, 64))
    assert [tuple(o.shape) for o in outs] == [(1, 28, 16, 16), (1, 14, 32, 32)]
    supernet = get_model("pose_supermobilenet", cfg, arch, device="cpu")
    assert not supernet.training and supernet.dims.deconv == (64, 48, 32)
    assert supernet.max_desc.tolist() == [24, 32, 64, 96, 160, 64, 48, 32]
    for name, path in zip(FAMILIES + ("pose_superresnet",),
                          ("crowd_pose/higher_hrnet/w32_512_adam_lr1e-3.yaml",
                           "crowd_pose/efficient_hrnet/H-3.yaml",
                           "crowd_pose/resnet/resnet.yaml",
                           "crowd_pose/resnet/superresnet.yaml")):
        path = os.path.join(REPO, "configs", path)
        family = get_model(name, update_config(default_config(), path), device="cpu")
        assert not family.training and family.compute_dtype == torch.bfloat16
        with torch.no_grad():
            outs = family(torch.zeros(1, 3, 64, 64))
        init_fn, apply_fn = jmodels.get_model(name, j_update(j_default(), path), None)
        params, state = jax.eval_shape(init_fn, jax.random.PRNGKey(0))
        want = jax.eval_shape(lambda p, s, x: apply_fn(p, s, x)[0], params, state,
                              jax.ShapeDtypeStruct((1, 64, 64, 3), "float32"))
        assert [tuple(o.shape) for o in outs] == [(w.shape[0], w.shape[3], w.shape[1],
                                                    w.shape[2]) for w in want], name
        assert all(o.dtype == torch.float32 for o in outs)
    from litepose_tpu_torch.models import available
    from litepose_tpu_torch.models.litepose_resnet import SuperLitePoseResNet

    superresnet = get_model("pose_superresnet", update_config(default_config(), path), arch,
                            device="cpu")
    assert isinstance(superresnet, SuperLitePoseResNet) and superresnet.deconv_filters == (
        64, 48, 32)
    assert superresnet.max_desc.tolist() == [24, 32, 64, 96, 160, 64, 48, 32]
    assert available() == tuple(sorted(jmodels.available()))
    with pytest.raises(KeyError):
        get_model("pose_unknown", cfg, arch, device="cpu")
