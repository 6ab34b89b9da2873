"""The training cell on the CPU at a size a test run holds: the reference's
loss and step against the port's plain path, and the data-parallel driver
over gloo ranks, sound and with its timed path broken underneath (a step
that leaves the state unchanged; half of each batch left out, the mean
taken over the rest; the exchange between ranks left out)."""

import copy
import json
import os
import time

import numpy as np
import pytest
import torch

from conftest import BENCH, ROOT
from harness import core, spec, targets, weights, scenes
from reference.train import TrainReference, loss, train_numbers

SIZE = 128


def _config():
    with open(os.path.join(BENCH, "configs", "auto_xs256.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(BENCH, "configs", "auto_s448.json")) as f:
        cfg["train"] = copy.deepcopy(json.load(f)["train"])
    cfg["arch"]["img_size"] = cfg["input_size"] = SIZE
    cfg["train"]["output_sizes"] = [SIZE // 4, SIZE // 2]
    return cfg


def _batch(cfg, n, seed):
    images, people = scenes.scene_batch(n, SIZE, seed, people=(2, 4), person_size=(40, 80))
    return targets.batch(images, people, cfg["train"]["output_sizes"], cfg["num_joints"],
                         cfg["train"]["sigma"], cfg["max_people"])


def _port_model(cfg, tree, dtype):
    from litepose_tpu_torch.arch import ArchConfig
    from litepose_tpu_torch.models.convert import state_dict_from_jax
    from litepose_tpu_torch.models.litepose import LitePose, ModelSpec

    arch = ArchConfig.from_dict(cfg["arch"])
    model = LitePose(ModelSpec(num_joints=cfg["num_joints"]), arch, compute_dtype=dtype,
                     out_dtype=dtype)
    model.load_state_dict(state_dict_from_jax(*tree, ModelSpec(num_joints=cfg["num_joints"]),
                                              arch), strict=True)
    return model.train()


def test_loss_matches_the_port():
    from litepose_tpu_torch.core.losses import LossConfig, multi_loss

    cfg = _config()
    b = _batch(cfg, 3, 2**31 + 41)
    gen = torch.Generator().manual_seed(3)
    outs = [torch.randn((3, 28, SIZE // 4, SIZE // 4), generator=gen),
            torch.randn((3, 14, SIZE // 2, SIZE // 2), generator=gen)]
    on = {k: [torch.as_tensor(x) for x in b[k]] for k in ("heatmaps", "masks", "joints")}
    want, _ = multi_loss(outs, on["heatmaps"], on["masks"], on["joints"],
                         LossConfig(num_joints=14))
    assert float(loss(outs, on, cfg)) == pytest.approx(float(want), rel=1e-6)


def test_reference_step_matches_the_port_in_float64():
    """One step from the same seeded weights, the port in float64 in one
    process: the loss, every gradient, the updated parameters and the BN
    statistics equal to rounding."""
    from litepose_tpu_torch.core.losses import LossConfig
    from litepose_tpu_torch.train.checkpoint import init_train_state
    from litepose_tpu_torch.train.optim import make_optimizer, multistep_lr
    from litepose_tpu_torch.train.trainer import StepFns

    cfg = _config()
    tree = weights.seeded(cfg["arch"], 14, cfg["with_ae"], 2**31 + 43, "cpu")
    b = _batch(cfg, 4, 2**31 + 44)
    model = _port_model(cfg, tree, torch.float64).double()
    opt, sched = make_optimizer("adam", model.parameters(),
                                multistep_lr(cfg["train"]["lr"], [], 0.1, 1))
    step = StepFns(LossConfig(num_joints=14), SIZE, cfg["train"]["output_sizes"], "cpu").get()
    _, metrics = step(init_train_state(model, opt, sched), b)
    from litepose_tpu_torch.core.inference import normalize_images

    ref = TrainReference(*tree, cfg, "cpu", dtype=torch.float64)
    # the port normalizes in fp32 before its float64 forward: the same input
    ref.net.normalize = lambda u8: normalize_images(torch.as_tensor(u8)).double()
    value, grads = ref.step(b)
    assert value == pytest.approx(float(metrics["total"]), rel=1e-12)
    got = ref.tensors()
    med = float(np.median([float(g.norm()) for g in grads.values()]))

    def port_layout(path, t):  # OIHW for a conv, IOHW for a transposed conv
        if path[-1] != "w":
            return t
        return t.permute(2, 3, 0, 1).flip(2, 3) if "deconv" in path[1] else t.permute(3, 2, 0, 1)

    for name, p in model.named_parameters():
        path = weights.path_of(name)
        g = port_layout(path, grads[path[1:]])
        # float64 on both sides; only the summation orders differ
        assert float((p.grad - g).norm()) <= 1e-9 * max(float(g.norm()), med), name
        assert torch.allclose(p.detach(), port_layout(path, got[path]), rtol=0, atol=1e-9), name
    for name, t in model.state_dict().items():
        path = weights.path_of(name)
        if path is not None and path[0] == "state":
            assert torch.allclose(t, got[path], rtol=1e-9, atol=1e-12), name


def _run(world=2, seed=2**31 + 51, compute_dtype="bfloat16"):
    cfg = _config()
    cfg["compute_dtype"] = compute_dtype
    tr = {"driver": "train_ddp", "images_per_rank": 2, "pool_steps": 3, "checked_steps": 3,
          "timing_steps": 1, "trace_steps": 2, "scene": {"people": [2, 4],
                                                         "person_size": [40, 80]}}
    driver = spec._module(os.path.join(BENCH, "drivers", "train_ddp.py"), "train_ddp_test")
    ctx = core.Context(cell="train-test", config=cfg, traffic=tr, chips=world, seed=seed,
                       seconds=0.2, trace=False, root=ROOT, t_start=time.perf_counter(),
                       device="cpu")
    return driver.run(ctx)


# each fault as ``apply(put)``, ``put`` being ``setattr`` in a rank process
# and ``monkeypatch.setattr`` in this one
PATCHES = {
    "unchanged": (
        "def apply(put):\n"
        "    import torch\n"
        "    put(torch.optim.Adam, 'step', lambda self, closure=None: None)\n"),
    "half_batch": (
        "def apply(put):\n"
        "    import litepose_tpu_torch.train.trainer as t\n"
        "    build = t.StepFns._build\n"
        "    def half(self, img_size):\n"
        "        step = build(self, img_size)\n"
        "        def run(ts, batch, extra=None):\n"
        "            n = len(batch['images']) // 2\n"
        "            cut = {k: ([x[:n] for x in v] if isinstance(v, list) else v[:n])\n"
        "                   for k, v in batch.items()}\n"
        "            return step(ts, cut, extra)\n"
        "        return run\n"
        "    put(t.StepFns, '_build', half)\n"),
    "no_exchange": (
        "def apply(put):\n"
        "    import litepose_tpu_torch.models.layers as layers\n"
        "    import litepose_tpu_torch.train.trainer as trainer\n"
        "    from litepose_tpu_torch.parallel.mesh import World\n"
        "    for module in (layers, trainer):\n"
        "        put(module, 'world', lambda: World(0, 1, None))\n"),
}


@pytest.fixture()
def threads(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def test_sound_ddp_run_is_correct(threads):
    out = _run()
    assert out.correct, core.check_lines(out) + out.notes
    assert set(out.metrics) == {"train_img_per_s", "setup_s"}
    assert out.device["count"] == 2


@pytest.mark.parametrize("fault", sorted(PATCHES))
def test_a_broken_step_is_not_correct(fault, tmp_path, monkeypatch, threads):
    """The fault is planted in every rank: in this process, and through a
    ``sitecustomize`` in the rank processes it starts."""
    (tmp_path / "sitecustomize.py").write_text(PATCHES[fault] + "apply(setattr)\n")
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join([str(tmp_path), ROOT]))
    scope = {}
    exec(PATCHES[fault], scope)
    scope["apply"](monkeypatch.setattr)
    out = _run(seed=2**31 + 52)
    assert not out.correct, core.check_lines(out) + out.notes


def test_train_numbers_of_an_unchanged_state():
    ref = {"losses": [1.0, 0.9, 0.8], "grad": {("params", "a"): 1.0, ("params", "b"): 2.0},
           "change": {("params", "a"): 0.5, ("params", "b"): 0.4, ("state", "m"): 0.3}}
    same = train_numbers(ref, ref)
    assert same["loss_gap"] == same["grad_gap"] == same["change_gap"] == 0
    still = dict(ref, change={k: 0.0 for k in ref["change"]})
    assert train_numbers(still, ref)["change_gap"] == pytest.approx(1.0)
    assert np.isfinite(train_numbers(still, ref)["change_gap_median"])
