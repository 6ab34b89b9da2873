"""The port's eval CLI (``python -m litepose_tpu_torch.tools.valid``) against
the JAX package's ``tools/valid.py`` on the committed eval fixture, both on
the CPU: Auto-XS@256 with the trained ``assets/bench_ckpt_xs.msgpack``,
CrowdPose config, flip test and projection on (tag dim 2 through K3's and
K4's twins), batches of 4 over the first 6 images.  Both sides compute the
forward in fp32 (the JAX CLI through ``Policy.exact()``, the port's through
``TPU.COMPUTE_DTYPE float32``): detection counts equal, joints within
``test_torch_engine.py``'s tolerances, every AP/AR stat within 1e-6.

Also: a port ``TrainPipeline`` over the port's ``PoseDataset`` against the
JAX pair on the same files, the reference ``.pth.tar`` loader against the
JAX forward, the CLI's refusals, and a narrow HigherHRNet (the w32 CrowdPose
config cut to one module a stage and 8-32 channels, at 128 px) through both
CLIs from one reference ``.pth.tar``."""

import glob
import importlib.util
import json
import os
import sys
from collections import defaultdict

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "litepose_tpu_torch", "assets", "eval_fixture")
CFG = os.path.join(REPO, "configs", "crowd_pose", "mobilenet", "mobile.yaml")
CKPT_XS = os.path.join(REPO, "assets", "bench_ckpt_xs.msgpack")
MAX_IMAGES = 6


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _args(arch_json, out, *extra):
    return ["--cfg", CFG, "--superconfig", arch_json,
            "--ann-file", os.path.join(FIXTURE, "annotations.json"), "--image-dir", FIXTURE,
            "--batch-size", "4", "--max-images", str(MAX_IMAGES), *extra,
            "TEST.MODEL_FILE", CKPT_XS, "OUTPUT_DIR", os.path.join(out, "output"),
            "LOG_DIR", os.path.join(out, "log")]


def _results(out):
    """{image_id: [(keypoints (14, 3), score)]} from a run's keypoint_results.json."""
    (path,) = glob.glob(os.path.join(out, "output", "**", "keypoint_results.json"),
                        recursive=True)
    with open(path) as f:
        records = json.load(f)
    by_image = defaultdict(list)
    for r in records:
        by_image[r["image_id"]].append((np.asarray(r["keypoints"]).reshape(-1, 3), r["score"]))
    return by_image


@pytest.fixture(scope="module")
def arch_json(tmp_path_factory):
    from litepose_tpu_torch.arch import get_arch

    path = str(tmp_path_factory.mktemp("arch") / "auto-XS.json")
    with open(path, "w") as f:
        json.dump(get_arch("auto-XS").to_dict(), f)
    return path


@pytest.fixture(scope="module")
def jax_run(arch_json, tmp_path_factory):
    """tools/valid.py's main, loaded by path and run in this process, with
    the LitePose entry of the JAX registry computing at Policy.exact()."""
    import litepose_tpu.models as jmodels
    from litepose_tpu.models.layers import Policy
    from litepose_tpu.models.litepose import ModelSpec, apply_litepose, init_litepose

    def exact(cfg, arch):
        spec = ModelSpec.from_config(cfg)

        def init_fn(key):
            return init_litepose(key, spec, arch, with_skips=True)

        def apply_fn(params, state, x, train=False, policy=None):
            return apply_litepose(params, state, x, spec, arch, train=train, with_skips=True,
                                  policy=Policy.exact())

        return init_fn, apply_fn

    out = str(tmp_path_factory.mktemp("jax_valid"))
    spec = importlib.util.spec_from_file_location("jax_valid_cli",
                                                  os.path.join(REPO, "tools", "valid.py"))
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    import jax

    mp = pytest.MonkeyPatch()
    # the CLI points JAX's compile cache at LITEPOSE_XLA_CACHE: keep the suite's
    mp.setenv("LITEPOSE_XLA_CACHE", jax.config.jax_compilation_cache_dir or "")
    mp.setitem(jmodels._REGISTRY, "pose_mobilenet", exact)
    mp.setattr(sys, "argv", ["valid.py"] + _args(arch_json, out))
    try:
        stats = cli.main()
    finally:
        mp.undo()
    return stats, _results(out)


@pytest.fixture(scope="module")
def port_run(arch_json, tmp_path_factory):
    from litepose_tpu_torch.tools.valid import main

    out = str(tmp_path_factory.mktemp("port_valid"))
    run = main(_args(arch_json, out, "--device", "cpu", "TPU.COMPUTE_DTYPE", "float32"))
    return run, _results(out)


def test_port_cli_equals_jax_cli(jax_run, port_run):
    want_stats, want = jax_run
    run, got = port_run
    assert list(run.stats) == list(want_stats)
    for key, value in want_stats.items():
        assert run.stats[key] == pytest.approx(value, abs=1e-6), key
    assert run.stats["AP"] > 0.05  # the trained weights find the drawn people
    assert sorted(got) == sorted(want) and len(run.preds) == MAX_IMAGES
    for image_id, people in want.items():
        assert len(got[image_id]) == len(people), image_id
        for (gk, gs), (wk, ws) in zip(got[image_id], people):
            np.testing.assert_allclose(gk[:, :2], wk[:, :2], atol=1e-3, rtol=0)
            np.testing.assert_allclose(gk[:, 2], wk[:, 2], atol=1e-4, rtol=0)
            assert gs == pytest.approx(ws, abs=1e-4)
    # the people the CLI returns are the ones it wrote
    assert [len(p) for p in run.preds] == [len(got[i + 1]) for i in range(MAX_IMAGES)]
    assert all(p.shape == (14, 5) for people in run.preds for p in people)  # T = 2
    assert 0 < run.decode_s < run.seconds


def test_reference_checkpoint_in_the_cli(arch_json, port_run, tmp_path):
    """The same weights as a reference ``.pth.tar`` (``module.`` prefixes,
    as DDP saves them) give the msgpack run's people."""
    from litepose_tpu_torch.arch import get_arch
    from litepose_tpu_torch.models.convert import state_dict_from_jax
    from litepose_tpu_torch.models.litepose import ModelSpec
    from litepose_tpu_torch.tools.valid import main
    from litepose_tpu_torch.train.checkpoint import load_params

    sd = state_dict_from_jax(*load_params(CKPT_XS), ModelSpec(), get_arch("auto-XS"))
    path = str(tmp_path / "model_best.pth.tar")
    torch.save({"epoch": 3, "state_dict": {"module." + k: v for k, v in sd.items()}}, path)
    args = _args(arch_json, str(tmp_path), "--device", "cpu", "TPU.COMPUTE_DTYPE", "float32")
    args[args.index("--max-images") + 1] = "2"
    args[args.index(CKPT_XS)] = path
    run = main(args)
    want, _ = port_run
    for got_people, want_people in zip(run.preds, want.preds[:2]):
        assert len(got_people) == len(want_people)
        for g, w in zip(got_people, want_people):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("with_skips", [True, False])
def test_reference_state_dict_loader_equals_jax_forward(with_skips, tmp_path):
    """JAX params -> ``litepose_to_torch`` (the reference layout) -> a
    ``.pth.tar`` -> ``load_torch_checkpoint`` + ``litepose_from_torch``: the
    fp32 forward equals the JAX one at Policy.exact() within
    tests/test_torch_model.py's bound (atol 2e-4, rtol 1e-3)."""
    import jax
    import jax.numpy as jnp
    from litepose_tpu.arch.manager import ArchManager
    from litepose_tpu.models.layers import Policy
    from litepose_tpu.models.litepose import ModelSpec as JSpec
    from litepose_tpu.models.litepose import apply_litepose, init_litepose
    from litepose_tpu.models.torch_convert import litepose_to_torch

    from litepose_tpu_torch.models.litepose import ModelSpec
    from litepose_tpu_torch.models.torch_convert import (litepose_from_torch,
                                                         load_torch_checkpoint)
    from test_torch_arch import port_arch
    from test_torch_convert import _random_bn

    arch = ArchManager().fixed_sample(reso=128, ratio=0.25)
    params, state = init_litepose(jax.random.PRNGKey(5), JSpec(), arch, with_skips=with_skips)
    rng = np.random.default_rng(1)
    params, state = _random_bn(params, rng), _random_bn(state, rng)
    sd = litepose_to_torch(params, state, JSpec(), arch, with_skips=with_skips)
    path = str(tmp_path / "ref.pth.tar")
    # the reference fp16 wrapper's leading "1." and DDP's "module."
    torch.save({"state_dict": {"module.1." + k: torch.from_numpy(np.array(v))
                               for k, v in sd.items()}}, path)
    model = litepose_from_torch(load_torch_checkpoint(path), ModelSpec(), port_arch(arch),
                                with_skips=with_skips, compute_dtype=torch.float32)
    x = np.random.default_rng(2).standard_normal((2, 128, 128, 3)).astype(np.float32)
    want, _ = apply_litepose(params, state, jnp.asarray(x), JSpec(), arch,
                             with_skips=with_skips, policy=Policy.exact())
    with torch.no_grad():
        got = model(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w).transpose(0, 3, 1, 2),
                                   atol=2e-4, rtol=1e-3)


class _Pickled:
    """An object only the full unpickler rebuilds."""


def test_checkpoint_loader_refuses_pickled_code(tmp_path):
    """A checkpoint that needs the full unpickler is refused, with the
    file's name; nothing falls back to loading its pickled code."""
    from litepose_tpu_torch.models.torch_convert import load_torch_checkpoint

    path = str(tmp_path / "pickled.pth.tar")
    torch.save({"state_dict": {"w": torch.zeros(2)}, "extra": _Pickled()}, path)
    with pytest.raises(RuntimeError, match="pickled.pth.tar: .*refused"):
        load_torch_checkpoint(path)


def test_train_pipeline_over_the_dataset_equals_jax():
    """A port TrainPipeline over the port PoseDataset (decoded without cv2,
    masks filled without cv2) against the JAX TrainPipeline over the JAX
    PoseDataset: 4 items of epoch 0, bit for bit."""
    from litepose_tpu.config import default_config as j_default
    from litepose_tpu.config import update_config as j_update
    from litepose_tpu.data.dataset import PoseDataset as JDataset
    from litepose_tpu.data.dataset import TrainPipeline as JPipeline

    from litepose_tpu_torch.config import default_config, update_config
    from litepose_tpu_torch.data.dataset import PipelineConfig, PoseDataset, TrainPipeline

    opts = ["DATASET.INPUT_SIZE", "256", "DATASET.OUTPUT_SIZE", "[64, 128]"]
    ann = os.path.join(FIXTURE, "annotations.json")
    ds = PoseDataset(ann, FIXTURE, 14, style="crowdpose")
    jds = JDataset(ann, FIXTURE, 14, style="crowdpose")
    assert ds.ids == jds.ids and len(ds) == 12
    got = TrainPipeline(ds, PipelineConfig.from_config(update_config(default_config(), CFG, opts)))
    want = JPipeline(jds, j_update(j_default(), CFG, opts))
    masked = 0
    for idx in (1, 2, 4, 5):  # a crowd region, a keypoint-less person, the EXIF-rotated file
        g, w = got.get(idx, 0), want.get(idx, 0)
        np.testing.assert_array_equal(g[0], w[0])
        for part in (1, 2, 3):
            for a, b in zip(g[part], w[part]):
                np.testing.assert_array_equal(a, b)
        masked += int((w[2][0] == 0).any())
        np.testing.assert_array_equal(ds.ignore_mask(ds.ids[idx]),
                                      jds.coco.ignore_mask(jds.ids[idx]))
    assert masked >= 2


def test_cli_refusals(arch_json, tmp_path):
    from litepose_tpu_torch.tools.valid import main

    with pytest.raises(NotImplementedError, match="M11"):
        main(_args(arch_json, str(tmp_path), "--device", "cpu", "--devices", "2"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            main(_args(arch_json, str(tmp_path)))
    # a reference .pth of pose_resnet: the JAX CLI's loader cannot read it
    bad = _args(arch_json, str(tmp_path), "--device", "cpu", "MODEL.NAME", "pose_resnet")
    bad[bad.index(CKPT_XS)] = str(tmp_path / "resnet.pth.tar")
    with pytest.raises(NotImplementedError, match="Queue 3"):
        main(bad)


HRNET_CFG = os.path.join(REPO, "configs", "crowd_pose", "higher_hrnet", "w32_512_adam_lr1e-3.yaml")
HRNET_OPTS = ["DATASET.INPUT_SIZE", "128", "DATASET.OUTPUT_SIZE", "[32, 64]",
              "MODEL.EXTRA.STEM_INPLANES", "8",
              "MODEL.EXTRA.STAGE2.NUM_BLOCKS", "[1, 1]",
              "MODEL.EXTRA.STAGE2.NUM_CHANNELS", "[8, 16]",
              "MODEL.EXTRA.STAGE3.NUM_MODULES", "1",
              "MODEL.EXTRA.STAGE3.NUM_BLOCKS", "[1, 1, 1]",
              "MODEL.EXTRA.STAGE3.NUM_CHANNELS", "[8, 16, 24]",
              "MODEL.EXTRA.STAGE4.NUM_MODULES", "1",
              "MODEL.EXTRA.STAGE4.NUM_BLOCKS", "[1, 1, 1, 1]",
              "MODEL.EXTRA.STAGE4.NUM_CHANNELS", "[8, 16, 24, 32]",
              "MODEL.EXTRA.DECONV.NUM_CHANNELS", "[8]",
              "MODEL.EXTRA.DECONV.NUM_BASIC_BLOCKS", "1"]
HRNET_IMAGES = 3


def test_hrnet_port_cli_equals_jax_cli(tmp_path):
    """One seeded narrow HigherHRNet (BNs moved, heatmaps ``peaky`` on the
    three images resized to 128x128: 10% of each plane above the threshold)
    saved as a reference ``.pth.tar`` with DDP prefixes, read by each CLI's
    reference loader (JAX's ``hrnet_from_torch``, the port's strict
    ``load_state_dict``) and run on the fixture's first images, fp32 on
    both sides: counts, joints and every AP/AR stat equal within the
    tolerances of ``test_port_cli_equals_jax_cli``."""
    import jax
    import litepose_tpu.models as jmodels
    from litepose_tpu.models.higher_hrnet import HRNetSpec as JSpec
    from litepose_tpu.models.higher_hrnet import apply_higher_hrnet, init_higher_hrnet
    from litepose_tpu.models.layers import Policy

    from litepose_tpu_torch.config import default_config, update_config
    from litepose_tpu_torch.data.jpeg import decode_jpeg
    from litepose_tpu_torch.data.resize import resize_linear
    from litepose_tpu_torch.models.higher_hrnet import HRNetSpec, init_higher_hrnet as init
    from litepose_tpu_torch.tools.valid import main
    from test_torch_hrnet import moved, peaky

    cfg = update_config(default_config(), HRNET_CFG, HRNET_OPTS)
    spec = HRNetSpec.from_config(cfg)
    imgs = np.stack([resize_linear(decode_jpeg(os.path.join(FIXTURE, f"{i:06d}.jpg")), (128, 128))
                     for i in range(HRNET_IMAGES)])
    model = peaky(moved(init(spec, torch.Generator().manual_seed(0),
                             compute_dtype=torch.float32)), imgs, spec.num_joints, share=0.1)
    ckpt = str(tmp_path / "hrnet.pth.tar")
    torch.save({"state_dict": {"module." + k: v for k, v in model.state_dict().items()}}, ckpt)

    def args(out, *extra):
        return ["--cfg", HRNET_CFG, "--ann-file", os.path.join(FIXTURE, "annotations.json"),
                "--image-dir", FIXTURE, "--batch-size", "4", "--max-images", str(HRNET_IMAGES),
                *extra, *HRNET_OPTS, "TEST.MODEL_FILE", ckpt,
                "OUTPUT_DIR", os.path.join(out, "output"), "LOG_DIR", os.path.join(out, "log")]

    def exact(cfg, arch):
        jspec = JSpec.from_config(cfg)

        def apply_fn(params, state, x, train=False, policy=None):
            return apply_higher_hrnet(params, state, x, jspec, train=train,
                                      policy=Policy.exact())

        return (lambda key: init_higher_hrnet(key, jspec)), apply_fn

    jout, pout = str(tmp_path / "jax"), str(tmp_path / "port")
    spec_mod = importlib.util.spec_from_file_location("jax_valid_cli_hrnet",
                                                      os.path.join(REPO, "tools", "valid.py"))
    cli = importlib.util.module_from_spec(spec_mod)
    spec_mod.loader.exec_module(cli)
    mp = pytest.MonkeyPatch()
    mp.setenv("LITEPOSE_XLA_CACHE", jax.config.jax_compilation_cache_dir or "")
    mp.setitem(jmodels._REGISTRY, "pose_higher_hrnet", exact)
    mp.setattr(sys, "argv", ["valid.py"] + args(jout))
    try:
        want_stats = cli.main()
    finally:
        mp.undo()
    run = main(args(pout, "--device", "cpu") + ["TPU.COMPUTE_DTYPE", "float32"])
    want, got = _results(jout), _results(pout)
    assert list(run.stats) == list(want_stats)
    for key, value in want_stats.items():
        assert run.stats[key] == pytest.approx(value, abs=1e-6), key
    assert sorted(got) == sorted(want) and sum(len(p) for p in want.values()) > 0
    for image_id, people in want.items():
        assert len(got[image_id]) == len(people), image_id
        for (gk, gs), (wk, ws) in zip(got[image_id], people):
            np.testing.assert_allclose(gk[:, :2], wk[:, :2], atol=1e-3, rtol=0)
            np.testing.assert_allclose(gk[:, 2], wk[:, 2], atol=1e-4, rtol=0)
            assert gs == pytest.approx(ws, abs=1e-4)
