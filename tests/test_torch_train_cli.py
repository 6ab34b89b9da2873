"""The supernet's training and the NAS CLIs of the port against the JAX
package on the CPU.

* One SGD step of the narrow supernet (tests/test_torch_supernet.py) at a
  sampled desc against the JAX ``StepFns.get(None, True)``, fp32 (JAX under
  ``Policy.exact()``), within the tolerances of tests/test_torch_train.py:
  the loss rtol 1e-5, each gradient within 1e-4 relative of the port's
  float64 step and of JAX's beyond JAX's own distance from it, the BN
  statistics atol 2e-4, the parameters atol 1e-5.
* ``train_epoch``'s draws: 20 steps of (size, desc) equal to JAX's.
* The remat step keeps the masked BNs' statistics as the plain step.
* The CLIs on the committed fixture at a tiny size (the narrow space,
  32/64-px elastic sizes, ``--device cpu``): ``tools.train`` for 2 steps
  and an auto-resumed epoch; ``gen_arch``, ``weight_transfer`` and
  ``fuse_bn`` writing what the JAX tools write; ``search`` at population
  2, one iteration, in both scoring modes.
* Every new entry point defaults to the card and raises without one."""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from test_torch_supernet import (IMG, NARROW, assert_heads_aside,  # noqa: F401
                                 assert_trees_equal, head_widths, jax_side, jax_supernet,
                                 perturbed, port_dims, port_supernet, residual_free_arch)

from litepose_tpu_torch.arch import ArchManager
from litepose_tpu_torch.core.losses import LossConfig
from litepose_tpu_torch.models.convert import supernet_to_jax, tree_from_named, super_entries
from litepose_tpu_torch.models.litepose import ModelSpec
from litepose_tpu_torch.models.super_litepose import arch_to_mask_desc
from litepose_tpu_torch.train import optim
from litepose_tpu_torch.train.checkpoint import init_train_state, load_params
from litepose_tpu_torch.train.trainer import StepFns, train_epoch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "litepose_tpu_torch", "assets", "eval_fixture")
SUPER_CFG = os.path.join(REPO, "configs", "crowd_pose", "mobilenet", "supermobile.yaml")
MOBILE_CFG = os.path.join(REPO, "configs", "crowd_pose", "mobilenet", "mobile.yaml")
OUT = [IMG // 4, IMG // 2]
LR, WD = 0.1, 1e-4
SIZES = (32, 64)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _batch(img=IMG, batch=2):
    """The batch of tests/test_torch_train.py at batch 2."""
    rng = np.random.default_rng(0)
    data = {
        "images": rng.integers(0, 255, (batch, img, img, 3)).astype(np.uint8),
        "heatmaps": [rng.random((batch, 14, img // 4, img // 4)).astype(np.float32) * 0.5,
                     rng.random((batch, 14, img // 2, img // 2)).astype(np.float32) * 0.5],
        "masks": [np.ones((batch, img // 4, img // 4), np.float32),
                  np.ones((batch, img // 2, img // 2), np.float32)],
        "joints": [np.zeros((batch, 30, 14, 2), np.int32), np.zeros((batch, 30, 14, 2), np.int32)],
    }
    for b in range(batch):
        data["joints"][0][b, 0, 0] = (5 * (img // 4) + 5, 1)
        data["joints"][0][b, 0, 1] = ((img // 4) ** 2 + 3 * (img // 4) + 8, 1)
    return data


def _desc_arch():
    return port_manager_sample(5)


def port_manager_sample(seed):
    return ArchManager(**NARROW).random_sample(np.random.default_rng(seed)).with_img_size(IMG)


def _port_step(trees, dtype=torch.float32, remat=False):
    model = port_supernet(trees, dtype).train().to(dtype)
    opt, sched = optim.make_optimizer("sgd", model.parameters(),
                                      optim.multistep_lr(LR, [100], 0.1, 10), weight_decay=WD)
    sfns = StepFns(LossConfig(num_joints=14), IMG, OUT, torch.device("cpu"), remat=remat)
    batch = _batch()
    for key in ("heatmaps", "masks"):
        batch[key] = [torch.from_numpy(x).to(dtype) for x in batch[key]]
    ts, metrics = sfns.get()(init_train_state(model, opt, sched), batch,
                             arch_to_mask_desc(_desc_arch()))
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in model.named_parameters()}
    return ts, {k: float(v) for k, v in metrics.items()}, grads


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_supernet_step_matches_jax(jax_supernet):  # noqa: F811
    import jax
    import jax.numpy as jnp
    import optax

    from litepose_tpu.core.losses import LossConfig as JLoss
    from litepose_tpu.models.layers import Policy
    from litepose_tpu.models.super_litepose import apply_super_litepose
    from litepose_tpu.models.super_litepose import arch_to_mask_desc as jdesc
    from litepose_tpu.train import optim as jopt
    from litepose_tpu.train.checkpoint import init_train_state as jinit_ts
    from litepose_tpu.train.trainer import StepFns as JStepFns
    from litepose_tpu.arch.schema import ArchConfig as JArch

    jm, jd, jspec = jax_side()
    params, state = jax_supernet

    def apply_fn(p, s, x, desc):
        return apply_super_litepose(p, s, x, desc, jspec, jd, train=True, policy=Policy.exact())

    keep_grads = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p), lambda u, s, p=None: (u, u))
    tx = optax.chain(keep_grads, jopt.make_optimizer(
        "sgd", jopt.multistep_lr(LR, [100], 0.1, 10), weight_decay=WD))
    sfns = JStepFns(apply_fn, JLoss(num_joints=14), tx, base_input_size=IMG,
                    base_output_sizes=OUT)
    ts = jinit_ts(jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, state),
                  tx.init(params))
    desc = jdesc(JArch.from_dict(_desc_arch().to_dict()), jm)
    ts, metrics = sfns.get(None, True)(ts, _batch(), desc)
    want = jax.tree.map(np.asarray, {"metrics": metrics, "grads": ts.opt_state[0],
                                     "state": ts.model_state, "params": ts.params})

    pts, pmetrics, grads = _port_step(jax_supernet)
    exact = _port_step(jax_supernet, torch.float64)[2]
    assert pts.step == 1 and sorted(pmetrics) == sorted(want["metrics"])
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(pmetrics[k], v, rtol=1e-5, err_msg=k)
    table = super_entries(ModelSpec(), port_dims())
    g_tree = tree_from_named(grads, table)
    x_tree = tree_from_named({n: g.double().numpy() for n, g in exact.items()}, table)
    w_tree = jax.tree.map(np.copy, want["grads"])
    heads = head_widths(_desc_arch())
    leaves = jax.tree_util.tree_leaves_with_path
    for (path, g), (_, w), (_, x) in zip(leaves(g_tree), leaves(w_tree), leaves(x_tree)):
        name = jax.tree_util.keystr(path)
        n = next((n for h, n in heads.items() if name.startswith(h)), None)
        if n is not None and "['bn']" in name:  # JAX's unmasked heads: see assert_heads_aside
            g, w, x = g[:n], w[:n], x[:n]
        assert _rel(g, x) <= 1e-4, (name, _rel(g, x))
        assert _rel(g, w) <= 1e-4 + _rel(w, x), (name, _rel(g, w), _rel(w, x))
    p_tree, s_tree = supernet_to_jax(pts.model)
    assert_heads_aside(s_tree, want["state"], _desc_arch(), atol=2e-4)
    assert_heads_aside(p_tree, want["params"], _desc_arch(), atol=1e-5)


def test_train_epoch_draws_sizes_and_archs_like_jax():
    """20 steps: the (size, desc) sequence of the port's ``train_epoch``
    equals JAX's for the same seed and epoch."""
    from litepose_tpu.arch.manager import ArchManager as JManager
    from litepose_tpu.models.super_litepose import arch_to_mask_desc as jdesc
    from litepose_tpu.train.trainer import train_epoch as jtrain_epoch

    class Recorder:
        def __init__(self, out):
            self.out = out

        def get(self, size=None, with_extra=False):
            def step(ts, batch, extra=None):
                self.out.append((size, np.asarray(extra).tolist()))
                return ts, {"total": 0.0}
            return step

    jm, m = JManager(), ArchManager()
    want, got = [], []
    batches = [{"images": np.zeros((1, 1, 1, 3), np.uint8)}] * 20
    jtrain_epoch(Recorder(want), None, batches, epoch=3, elastic_sizes=list(jm.img_sizes),
                 arch_sampler=lambda rng: jdesc(jm.random_sample(rng), jm), seed=11)
    train_epoch(Recorder(got), None, batches, epoch=3, elastic_sizes=list(m.img_sizes),
                arch_sampler=lambda rng: arch_to_mask_desc(m.random_sample(rng)), seed=11)
    assert got == want and len(got) == 20
    assert len({tuple(d) for _, d in got}) > 10 and len({s for s, _ in got}) > 2


def test_remat_supernet_step_equals_plain(jax_supernet):  # noqa: F811
    """Recomputing the masked forward in the backward leaves the loss,
    gradients and BN statistics (masked ones included) as the plain step."""
    ts_a, m_a, g_a = _port_step(jax_supernet)
    ts_r, m_r, g_r = _port_step(jax_supernet, remat=True)
    assert m_a == m_r
    for n in g_a:
        torch.testing.assert_close(g_r[n], g_a[n], rtol=0, atol=1e-7)
    sd_a, sd_r = ts_a.model.state_dict(), ts_r.model.state_dict()
    for k in sd_a:
        torch.testing.assert_close(sd_r[k], sd_a[k], rtol=0, atol=1e-7, msg=k)


class _Narrow(ArchManager):
    """The narrow space with 32/64-px elastic sizes, whatever the config's
    deconv widths."""

    def __init__(self, deconv_setting=None, seed=None, **kw):
        super().__init__(**NARROW, img_sizes=SIZES, seed=seed)


@pytest.fixture
def narrow_port(monkeypatch):
    import litepose_tpu_torch.arch as parch

    monkeypatch.setattr(parch, "ArchManager", _Narrow)


@pytest.fixture
def narrow_jax(monkeypatch):
    import jax

    import litepose_tpu.arch as jarch
    from litepose_tpu.arch.manager import ArchManager as JManager

    class JNarrow(JManager):
        def __init__(self, deconv_setting=None, seed=None, **kw):
            super().__init__(**NARROW, img_sizes=SIZES, seed=seed)

    monkeypatch.setattr(jarch, "ArchManager", JNarrow)
    # the JAX tools point the compile cache at LITEPOSE_XLA_CACHE: keep the suite's
    monkeypatch.setenv("LITEPOSE_XLA_CACHE", jax.config.jax_compilation_cache_dir or "")


def _jax_tool(name, argv, monkeypatch):
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    monkeypatch.setattr(sys, "argv", [f"{name}.py"] + argv)
    return tool.main()


def test_train_cli_two_steps_then_resumes(narrow_port, tmp_path):
    """The supernet config on the fixture: 2 steps of 6 images at elastic
    sizes with sampled archs, checkpoint and final weights; a second run to
    epoch 2 auto-resumes from the first's checkpoint."""
    from litepose_tpu_torch.models.super_litepose import SuperLitePose
    from litepose_tpu_torch.tools import train

    def argv(end_epoch):
        return ["--cfg", SUPER_CFG, "--ann-file", os.path.join(FIXTURE, "annotations.json"),
                "--image-dir", FIXTURE, "--device", "cpu",
                "DATASET.INPUT_SIZE", "64", "DATASET.OUTPUT_SIZE", "[16, 32]",
                "TRAIN.IMAGES_PER_GPU", "6", "TRAIN.END_EPOCH", str(end_epoch), "PRINT_FREQ", "1",
                "TPU.COMPUTE_DTYPE", "float32", "MODEL.INIT_WEIGHTS", "False",
                "OUTPUT_DIR", str(tmp_path / "output"), "LOG_DIR", str(tmp_path / "log")]

    run = train.main(argv(1))
    assert isinstance(run.ts.model, SuperLitePose) and run.ts.step == 2 and run.ts.epoch == 1
    assert run.ts.model.dims.stage_blocks == (1, 2, 2, 1)
    assert np.isfinite(run.epochs[0]["total"]) and run.epochs[0]["total"] > 0
    files = sorted(os.listdir(run.out_dir))
    assert "checkpoint.msgpack" in files and "final_state.msgpack" in files
    params, _ = load_params(os.path.join(run.out_dir, "final_state.msgpack"))
    assert "lin5" in params["stage"][1][1]
    again = train.main(argv(2))
    assert again.ts.step == 4 and again.ts.epoch == 2 and len(again.epochs) == 1
    log = "".join(open(os.path.join(run.out_dir, f)).read()
                  for f in os.listdir(run.out_dir) if f.endswith(".log"))
    assert "auto-resumed from epoch 1" in log


def test_train_cli_fixed_litepose(tmp_path):
    """A fixed LitePose (``--superconfig``) trains one step and writes
    weights both packages' readers take."""
    from litepose_tpu_torch.models.litepose import LitePose
    from litepose_tpu_torch.tools import train

    arch_json = tmp_path / "arch.json"
    arch_json.write_text(json.dumps(ArchManager(**NARROW).fixed_sample(64, 0.5).to_dict()))
    run = train.main(["--cfg", MOBILE_CFG, "--superconfig", str(arch_json),
                      "--ann-file", os.path.join(FIXTURE, "annotations.json"),
                      "--image-dir", FIXTURE, "--device", "cpu",
                      "DATASET.INPUT_SIZE", "64", "DATASET.OUTPUT_SIZE", "[16, 32]",
                      "TRAIN.IMAGES_PER_GPU", "12", "TRAIN.END_EPOCH", "1",
                      "MODEL.INIT_WEIGHTS", "False", "AUTO_RESUME", "False",
                      "OUTPUT_DIR", str(tmp_path / "output"), "LOG_DIR", str(tmp_path / "log")])
    assert isinstance(run.ts.model, LitePose) and run.ts.step == 1
    assert run.ts.model.arch.img_size == 64 and np.isfinite(run.epochs[0]["total"])


def test_gen_arch_matches_jax(tmp_path, monkeypatch):
    from litepose_tpu_torch.tools import gen_arch

    argv = ["--reso", "320", "--ratio", "0.75", "--deconv", "32", "24", "16"]
    _jax_tool("gen_arch", argv + ["--out", str(tmp_path / "jax.json")], monkeypatch)
    gen_arch.main(argv + ["--out", str(tmp_path / "port.json")])
    assert (tmp_path / "port.json").read_text() == (tmp_path / "jax.json").read_text()


@pytest.fixture
def transfer_inputs(jax_supernet, tmp_path):  # noqa: F811
    """A JAX-written supernet checkpoint, a target arch JSON and a second
    checkpoint: the narrow supernet's init holding a LitePose of the arch
    with every BN off identity (``inject_subnet``, the warm start the NAS
    takes from a trained subnet), and the perturbed supernet of
    tests/test_torch_supernet.py with its final heads' depthwise BNs off
    identity in every channel."""
    import jax

    from litepose_tpu.arch.schema import ArchConfig as JArch
    from litepose_tpu.models.litepose import init_litepose
    from litepose_tpu.models.super_litepose import init_super_litepose, inject_subnet
    from litepose_tpu.train.checkpoint import save_params as jsave

    arch = residual_free_arch()
    _, jd, jspec = jax_side()
    jarch = JArch.from_dict(arch.to_dict())
    sub = perturbed(*init_litepose(jax.random.PRNGKey(7), jspec, jarch), seed=4)
    injected = inject_subnet(*init_super_litepose(jax.random.PRNGKey(0), jspec, jd), *sub,
                             jarch, jd, jspec)
    ckpt, arch_json, raw = (str(tmp_path / n) for n in ("super.msgpack", "arch.json",
                                                        "perturbed.msgpack"))
    jsave(ckpt, *jax.tree.map(np.asarray, injected))
    jsave(raw, *perturbed(*jax_supernet, seed=5, whole_heads=True))
    with open(arch_json, "w") as f:
        json.dump(arch.to_dict(), f)
    return ckpt, arch_json, raw


def test_weight_transfer_and_fuse_bn_match_jax(transfer_inputs, narrow_port, narrow_jax,
                                               tmp_path, monkeypatch):
    """weight_transfer then fuse_bn, each tool of each package on the same
    inputs: the extracted subnets bit for bit, the fused ones to the last
    bit of rsqrt; both tools' checks pass; a .pth supernet is refused."""
    from litepose_tpu_torch.tools import fuse_bn, weight_transfer

    ckpt, arch_json, _ = transfer_inputs
    common = ["--cfg", SUPER_CFG, "--superconfig", arch_json]
    _jax_tool("weight_transfer", common + ["--ckpt", ckpt, "--out", str(tmp_path / "jsub.msgpack")],
              monkeypatch)
    sub, mse = weight_transfer.main(common + ["--ckpt", ckpt, "--device", "cpu",
                                              "--out", str(tmp_path / "psub.msgpack")])
    assert len(mse) == 2 and max(mse) < 1e-6
    assert_trees_equal(load_params(str(tmp_path / "psub.msgpack")),
                       load_params(str(tmp_path / "jsub.msgpack")))
    with pytest.raises(SystemExit, match="super-layout"):
        weight_transfer.main(common + ["--ckpt", "super.pth", "--out", "x", "--device", "cpu"])

    common = ["--cfg", MOBILE_CFG, "--superconfig", arch_json, "--ckpt", str(tmp_path / "jsub.msgpack")]
    _jax_tool("fuse_bn", common + ["--out", str(tmp_path / "jfused.msgpack")], monkeypatch)
    fused, diff = fuse_bn.main(common + ["--out", str(tmp_path / "pfused.msgpack"),
                                         "--device", "cpu"])
    assert max(diff) < 1e-3 and not fused.training
    assert_trees_equal(load_params(str(tmp_path / "pfused.msgpack")),
                       load_params(str(tmp_path / "jfused.msgpack")), close=("['w']", "['bias']"))


def test_weight_transfer_passes_where_jax_heads_leak(transfer_inputs, narrow_port,
                                                     narrow_jax, tmp_path, monkeypatch):
    """A supernet whose final heads' depthwise BNs are off identity in every
    channel (as training at max width leaves them): the JAX supernet's
    unmasked heads put an inactive channel's relu(bias - mean * inv) into
    the pointwise conv, so the JAX tool's own check fails (ROADMAP Queue 3);
    the port's masked heads pass it, and both tools extract the same
    subnet."""
    from litepose_tpu_torch.tools import weight_transfer

    _, arch_json, raw = transfer_inputs
    common = ["--cfg", SUPER_CFG, "--superconfig", arch_json, "--ckpt", raw]
    with pytest.raises(AssertionError, match="weight transfer verification failed"):
        _jax_tool("weight_transfer", common + ["--out", str(tmp_path / "j.msgpack")],
                  monkeypatch)
    _, mse = weight_transfer.main(common + ["--out", str(tmp_path / "p.msgpack"),
                                            "--device", "cpu"])
    assert max(mse) < 1e-6


@pytest.mark.parametrize("scoring", ["extract", "masked"])
def test_search_cli(transfer_inputs, narrow_port, scoring, tmp_path):
    """Population 2, one iteration on the fixture: the reference result
    schema, the history sidecar, and a best arch under the budget."""
    from litepose_tpu_torch.arch import gmacs
    from litepose_tpu_torch.tools import search

    out = str(tmp_path / "result.json")
    run = search.main(["--cfg", SUPER_CFG, "--ckpt", transfer_inputs[0], "--constraint", "0.05",
                       "--ann-file", os.path.join(FIXTURE, "annotations.json"),
                       "--image-dir", FIXTURE, "--out", out, "--population", "2",
                       "--iterations", "1", "--max-eval-images", "2", "--scoring", scoring,
                       "--device", "cpu", "TEST.FLIP_TEST", "False", "TPU.COMPUTE_DTYPE",
                       "float32", "OUTPUT_DIR", str(tmp_path / "output")])
    with open(out) as f:
        result = json.load(f)
    (key, (constraint, (acc, arch, eff))), = result.items()
    assert key == "0" and constraint == 0.05 and arch == run.best_arch.to_dict()
    assert acc == run.best_acc and eff == pytest.approx(gmacs(run.best_arch)) and eff <= 0.05
    assert arch["img_size"] in SIZES
    with open(out + ".history.json") as f:
        assert json.load(f) == run.history and len(run.history) == 1
    assert len(run.predictor.timings) == len(run.predictor.cache) >= 2
    if scoring == "masked":
        assert set(run.predictor._masked_engines) <= set(SIZES)


def test_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """Without a card every new entry point raises, naming the CPU switch,
    instead of running on the host; ``--multi-host`` without a rendezvous
    raises too."""
    from litepose_tpu_torch.config import default_config, update_config
    from litepose_tpu_torch.nas import AccuracyPredictor
    from litepose_tpu_torch.tools import calibrate_test, fuse_bn, search, train, weight_transfer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ann, arch = os.path.join(FIXTURE, "annotations.json"), str(tmp_path / "a.json")
    with open(arch, "w") as f:
        json.dump(ArchManager(**NARROW).fixed_sample(IMG, 0.5).to_dict(), f)
    calls = [
        lambda: train.main(["--cfg", SUPER_CFG]),
        lambda: search.main(["--cfg", SUPER_CFG, "--ckpt", "x.msgpack", "--ann-file", ann,
                             "--image-dir", FIXTURE]),
        lambda: weight_transfer.main(["--cfg", SUPER_CFG, "--superconfig", arch,
                                      "--ckpt", "x.msgpack", "--out", "y"]),
        lambda: fuse_bn.main(["--cfg", MOBILE_CFG, "--superconfig", arch, "--ckpt", "x",
                              "--out", "y"]),
        lambda: calibrate_test.main(["--cfg", SUPER_CFG, "--ckpt", "x.msgpack", "--superconfig",
                                     arch, "--ann-file", ann, "--image-dir", FIXTURE]),
        lambda: AccuracyPredictor(port_supernet_stub(), None, None,
                                  update_config(default_config(), SUPER_CFG)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA device"):
            call()
    # --multi-host with no rendezvous raises instead of training alone
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="rendezvous"):
        train.main(["--cfg", SUPER_CFG, "--multi-host", "--device", "cpu"])


def port_supernet_stub():
    from litepose_tpu_torch.models.super_litepose import SuperLitePose

    return SuperLitePose(ModelSpec(), port_dims())
