"""The HRNet families through the port's train CLI on the CPU: HigherHRNet
(configs/crowd_pose/higher_hrnet/w32_512_adam_lr1e-3.yaml) and
EfficientHRNet (configs/crowd_pose/efficient_hrnet/H-3.yaml) on the
committed fixture at 64 px, b4, two epochs and a resume, their HRNet
stages narrowed by ``KEY VALUE`` opts (the EfficientNet backbone keeps its
table), and what becomes of the weights each writes.

* Each config trains at its own size with no elastic size or arch drawn,
  writes its checkpoint and final weights, and resumes;
* each ``final_state.msgpack`` loads in JAX's ``load_params`` over the JAX
  init's template, leaf for leaf (None slots included);
* each evaluates through the port's eval CLI (the CPU twins of K1, K3 and
  K4) with the trained weights;
* EfficientHRNet H-1, H-2 and H-4 give ``MODEL.NUM_JOINTS`` and
  ``DATASET.NUM_JOINTS`` different values (14 and 17): JAX's step fails in
  its heatmap loss (the model's planes against the dataset's targets), and
  the port's CLI refuses the config before it writes a run directory."""

import os

import numpy as np
import pytest
import torch

from litepose_tpu_torch.models.efficient_hrnet import EfficientHRNet
from litepose_tpu_torch.models.higher_hrnet import HigherHRNet
from litepose_tpu_torch.train.trainer import StepFns

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "litepose_tpu_torch", "assets", "eval_fixture")
CONFIGS = {"higher": os.path.join(REPO, "configs", "crowd_pose", "higher_hrnet",
                                  "w32_512_adam_lr1e-3.yaml"),
           "efficient": os.path.join(REPO, "configs", "crowd_pose", "efficient_hrnet",
                                     "H-3.yaml")}
SIZE_OPTS = ["DATASET.INPUT_SIZE", "64", "DATASET.OUTPUT_SIZE", "[16, 32]"]
# one module a stage and one block a branch; HigherHRNet's widths cut too
STAGE_OPTS = ["MODEL.EXTRA.STAGE2.NUM_BLOCKS", "[1, 1]",
              "MODEL.EXTRA.STAGE3.NUM_MODULES", "1",
              "MODEL.EXTRA.STAGE3.NUM_BLOCKS", "[1, 1, 1]",
              "MODEL.EXTRA.STAGE4.NUM_MODULES", "1",
              "MODEL.EXTRA.STAGE4.NUM_BLOCKS", "[1, 1, 1, 1]",
              "MODEL.EXTRA.DECONV.NUM_BASIC_BLOCKS", "1"]
NARROW = {"higher": STAGE_OPTS + ["MODEL.EXTRA.STEM_INPLANES", "8",
                                  "MODEL.EXTRA.STAGE2.NUM_CHANNELS", "[8, 16]",
                                  "MODEL.EXTRA.STAGE3.NUM_CHANNELS", "[8, 16, 24]",
                                  "MODEL.EXTRA.STAGE4.NUM_CHANNELS", "[8, 16, 24, 32]",
                                  "MODEL.EXTRA.DECONV.NUM_CHANNELS", "[8]"],
          "efficient": STAGE_OPTS + ["MODEL.SCALE_FACTOR", "-5"]}
CLASSES = {"higher": HigherHRNet, "efficient": EfficientHRNet}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _opts(which):
    return SIZE_OPTS + NARROW[which] + ["TPU.COMPUTE_DTYPE", "float32"]


def _argv(which, tmp, end_epoch):
    return ["--cfg", CONFIGS[which], "--ann-file", os.path.join(FIXTURE, "annotations.json"),
            "--image-dir", FIXTURE, "--device", "cpu", *_opts(which),
            "TRAIN.IMAGES_PER_GPU", "4", "TRAIN.END_EPOCH", str(end_epoch), "PRINT_FREQ", "1",
            "OUTPUT_DIR", str(tmp / "output"), "LOG_DIR", str(tmp / "log")]


_RUNS = {}


def run_of(which, tmp_path_factory):
    """Two runs of the train CLI: epoch 0, then epochs 1-2 resumed; and the
    (size, extra) of every step."""
    if which not in _RUNS:
        from litepose_tpu_torch.tools import train

        tmp = tmp_path_factory.mktemp(which)
        drawn = []
        get = StepFns.get

        def recording_get(self, img_size=None):
            step = get(self, img_size)

            def recorded(ts, batch, extra=None):
                drawn.append((img_size, extra))
                return step(ts, batch, extra)
            return recorded

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(StepFns, "get", recording_get)
            first = train.main(_argv(which, tmp, 1))
            second = train.main(_argv(which, tmp, 3))
        _RUNS[which] = first, second, drawn
    return _RUNS[which]


def _log(out_dir):
    return "".join(open(os.path.join(out_dir, f)).read()
                   for f in os.listdir(out_dir) if f.endswith(".log"))


@pytest.mark.parametrize("which", list(CONFIGS))
def test_train_cli_trains_then_resumes(which, tmp_path_factory):
    """An epoch of 3 steps (12 fixture images at b4) at the config's size
    with no size or arch drawn, its checkpoint and final weights, then two
    more epochs auto-resumed from the checkpoint, with Adam (both configs'
    optimizer)."""
    first, second, drawn = run_of(which, tmp_path_factory)
    model = first.ts.model
    assert isinstance(model, CLASSES[which]) and model.compute_dtype == torch.float32
    assert (first.ts.step, first.ts.epoch) == (3, 1)
    assert (second.ts.step, second.ts.epoch, len(second.epochs)) == (9, 3, 2)
    assert drawn == [(None, None)] * 9
    losses = [m["total"] for m in first.epochs + second.epochs]
    assert np.isfinite(losses).all() and min(losses) > 0
    assert {"checkpoint.msgpack", "final_state.msgpack"} <= set(os.listdir(first.out_dir))
    log = _log(first.out_dir)
    assert "auto-resumed from epoch 1" in log and "loading backbone pretrain" not in log
    assert isinstance(second.ts.optimizer, torch.optim.Adam)
    assert second.ts.scheduler.last_epoch == 9


@pytest.mark.parametrize("which", list(CONFIGS))
def test_final_state_loads_in_jax(which, tmp_path_factory):
    """The CLI's ``final_state.msgpack`` in JAX's ``load_params`` over the
    JAX init's template of the same config: leaf for leaf the trained
    model's trees, None slots where JAX has them."""
    import jax

    from litepose_tpu.config import default_config as j_default
    from litepose_tpu.config import update_config as j_update
    from litepose_tpu.models import get_model as j_get_model
    from litepose_tpu.train.checkpoint import load_params as jload

    from litepose_tpu_torch.models.convert import to_jax

    _, second, _ = run_of(which, tmp_path_factory)
    jcfg = j_update(j_default(), CONFIGS[which], _opts(which))
    init_fn, _ = j_get_model(jcfg.MODEL.NAME, jcfg, None)
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                            jax.eval_shape(lambda: init_fn(jax.random.PRNGKey(0))))
    got = jload(os.path.join(second.out_dir, "final_state.msgpack"), *template)
    want = to_jax(second.ts.model)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for (p, u), (_, v) in zip(jax.tree_util.tree_leaves_with_path(got),
                              jax.tree_util.tree_leaves_with_path(want)):
        np.testing.assert_array_equal(np.asarray(u), v, err_msg=jax.tree_util.keystr(p))


@pytest.mark.parametrize("which", list(CONFIGS))
def test_trained_family_evaluates_through_the_eval_cli(which, tmp_path_factory, tmp_path):
    """The ``final_state.msgpack`` through the port's eval CLI with the same
    opts: the model it builds holds the trained weights, and the AP table
    comes out."""
    import jax

    from litepose_tpu_torch.models.convert import to_jax
    from litepose_tpu_torch.tools import valid

    _, second, _ = run_of(which, tmp_path_factory)
    built = []
    build_engine = valid.build_engine

    def recording(cfg, model, device, mesh=None):
        built.append(model)
        return build_engine(cfg, model, device, mesh)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(valid, "build_engine", recording)
        run = valid.main(["--cfg", CONFIGS[which], "--ann-file",
                          os.path.join(FIXTURE, "annotations.json"), "--image-dir", FIXTURE,
                          "--max-images", "3", "--batch-size", "3", "--device", "cpu",
                          *_opts(which), "TEST.FLIP_TEST", "False",
                          "TEST.MODEL_FILE", os.path.join(second.out_dir, "final_state.msgpack"),
                          "OUTPUT_DIR", str(tmp_path / "output"), "LOG_DIR", str(tmp_path / "log")])
    (model,) = built
    assert isinstance(model, CLASSES[which]) and not model.training
    for u, v in zip(jax.tree_util.tree_leaves(to_jax(model)),
                    jax.tree_util.tree_leaves(to_jax(second.ts.model))):
        np.testing.assert_array_equal(u, v)
    assert len(run.preds) == 3 and "AP" in run.stats


def test_mismatched_joint_counts_fail_in_jax_training():
    """H-1's narrow model (MODEL.NUM_JOINTS 14) on a batch of its dataset's
    17-joint targets: JAX's ``StepFns`` step fails in the heatmap loss."""
    import jax
    import jax.numpy as jnp
    import optax

    from litepose_tpu.config import default_config as j_default
    from litepose_tpu.config import update_config as j_update
    from litepose_tpu.core.losses import LossConfig as JLoss
    from litepose_tpu.models import get_model as j_get_model
    from litepose_tpu.train.checkpoint import init_train_state as jinit_ts
    from litepose_tpu.train.trainer import StepFns as JStepFns

    path = os.path.join(REPO, "configs", "crowd_pose", "efficient_hrnet", "H-1.yaml")
    jcfg = j_update(j_default(), path, SIZE_OPTS + NARROW["efficient"])
    assert (jcfg.MODEL.NUM_JOINTS, jcfg.DATASET.NUM_JOINTS) == (14, 17)
    init_fn, apply_fn = j_get_model(jcfg.MODEL.NAME, jcfg, None)
    params, state = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                                 jax.eval_shape(lambda: init_fn(jax.random.PRNGKey(0))))
    tx = optax.adam(1e-3)
    step = JStepFns(lambda p, s, x: apply_fn(p, s, x, train=True), JLoss.from_config(jcfg), tx,
                    base_input_size=64, base_output_sizes=[16, 32]).get()
    k = jcfg.DATASET.NUM_JOINTS
    batch = {"images": np.zeros((2, 64, 64, 3), np.uint8),
             "heatmaps": [np.zeros((2, k, r, r), np.float32) for r in (16, 32)],
             "masks": [np.ones((2, r, r), np.float32) for r in (16, 32)],
             "joints": [np.zeros((2, 30, k, 2), np.int32) for _ in range(2)]}
    with pytest.raises(TypeError, match="incompatible shapes"):
        step(jinit_ts(params, state, tx.init(params)), jax.tree.map(jnp.asarray, batch))


@pytest.mark.parametrize("name", ["H-1", "H-2", "H-4"])
def test_train_cli_refuses_mismatched_joint_counts(name, tmp_path):
    from litepose_tpu_torch.tools import train

    out = tmp_path / "output"
    with pytest.raises(ValueError, match="MODEL.NUM_JOINTS 1[47] != DATASET.NUM_JOINTS 1[47]"):
        train.main(["--cfg", os.path.join(REPO, "configs", "crowd_pose", "efficient_hrnet",
                                          f"{name}.yaml"), "--device", "cpu",
                    "OUTPUT_DIR", str(out), "LOG_DIR", str(tmp_path / "log")])
    assert not out.exists()
