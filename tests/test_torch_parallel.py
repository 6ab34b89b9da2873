"""Multi-process training in the port (``litepose_tpu_torch.parallel``)
against the JAX package's mesh, on the CPU.

Two ranks are two processes (``python -c``), joined in a gloo group by a
``file://`` rendezvous under the test's temporary directory (no port to
clash under xdist), one torch thread each, each run bounded by a timeout.

* One SGD step of two ranks, each on its half of the batch of
  tests/test_torch_train.py (the two-block 64-px arch, batch 4), against
  JAX's ``StepFns`` step on ``make_mesh(2)`` with the batch sharded over
  the mesh, for LitePose, for the narrow supernet at a sampled arch
  (tests/test_torch_supernet.py) and for the super-ResNet at its published
  widths at a sampled desc (tests/test_torch_super_resnet.py; its
  comparison with one rank in float64, see
  ``test_two_rank_step_matches_one_rank``), fp32 (JAX under ``Policy.exact()``), at
  tests/test_torch_train.py's tolerances: rtol 1e-5 on the loss and the
  metrics, atol 2e-4 on the BN statistics, atol 1e-5 on the parameters;
  and against the port's one-process step on the whole batch at the same
  tolerances; the two ranks end bit-equal.
* ``sync_batch_stats``: without a group and in a group of one, the local
  statistics bit for bit; over two ranks, the whole batch's statistics and
  their gradient.
* Every rank draws the same (size, arch) sequence in ``train_epoch``.
* The port's ``make_batch_iterator`` shards as JAX's for 2 and 4 processes.
* The train CLI with ``--multi-host`` on two ranks on the eval fixture:
  equal parameters and metrics on both ranks, checkpoints written by rank 0
  alone, a ``--profile-dir`` trace of the second epoch from rank 0, and a
  resumed run."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from test_torch_supernet import assert_heads_aside, jax_side, jax_supernet  # noqa: F401
from test_torch_supernet import port_supernet
from test_torch_train import _batch, _port_arch, _port_model, jax_weights  # noqa: F401
from test_torch_train_cli import port_manager_sample
from test_torch_super_resnet import jspec as res_jspec, port_model, trees  # noqa: F401

from litepose_tpu_torch.arch import ArchManager
from litepose_tpu_torch.core.losses import LossConfig
from litepose_tpu_torch.models.convert import (jax_from_state_dict, super_resnet_to_jax,
                                               supernet_to_jax)
from litepose_tpu_torch.models.litepose import ModelSpec
from litepose_tpu_torch.models.super_litepose import arch_to_mask_desc
from litepose_tpu_torch.parallel import init_distributed, destroy_distributed, sync_batch_stats
from litepose_tpu_torch.train import optim
from litepose_tpu_torch.train.checkpoint import init_train_state
from litepose_tpu_torch.train.trainer import StepFns

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")
FIXTURE = os.path.join(REPO, "litepose_tpu_torch", "assets", "eval_fixture")
MOBILE_CFG = os.path.join(REPO, "configs", "crowd_pose", "mobilenet", "mobile.yaml")
IMG, B = 64, 4
OUT = [IMG // 4, IMG // 2]
LR, WD = 0.1, 1e-4
RANKS = 2
TIMEOUT = 110  # seconds a multi-process run may take

# A rank that has saved its result leaves without the interpreter's
# teardown: on a loaded host (the tier-1 run's six workers) that teardown
# has aborted a rank whose job had ended and whose result was saved
# ("terminate called without an active exception" from gloo's C++ side).
_WORKER = """
import os, sys
sys.path.insert(0, sys.argv[4])
import test_torch_parallel
test_torch_parallel.rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
sys.stdout.flush()
sys.stderr.flush()
os._exit(0)
"""


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run_ranks(tmp, job: dict, size: int = RANKS):
    """``job`` run by ``size`` rank processes (``rank_main``); returns what
    each rank saved.  Raises with the rank's log when one fails or the run
    outlasts ``TIMEOUT``."""
    tmp = str(tmp)
    torch.save(job, os.path.join(tmp, "job.pt"))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    logs = [open(os.path.join(tmp, f"rank{r}.log"), "w") for r in range(size)]
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(r), str(size), tmp, TESTS],
                              cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT)
             for r, log in enumerate(logs)]
    deadline = time.monotonic() + TIMEOUT
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(tmp, f"rank{r}.log")) as f:
                raise AssertionError(f"rank {r} exited {p.returncode}:\n{f.read()[-4000:]}")
    return [torch.load(os.path.join(tmp, f"out{r}.pt"), weights_only=False)
            for r in range(size)]


def rank_main(rank: int, size: int, tmp: str) -> None:
    """A rank process: run the job in ``tmp/job.pt``, save its result."""
    torch.set_num_threads(1)
    job = torch.load(os.path.join(tmp, "job.pt"), weights_only=False)
    if job["kind"] == "cli":
        out = _cli_rank(job, rank, size, tmp)
    else:
        init_distributed("cpu", f"file://{tmp}/rendezvous", size, rank)
        try:
            out = {"step": _step_rank, "unit": _unit_rank}[job["kind"]](job, rank, size)
        finally:
            destroy_distributed()
    torch.save(out, os.path.join(tmp, f"out{rank}.pt"))


def port_step(model, batch, desc=None):
    """One SGD step of ``model`` (modified in place) on ``batch``; returns
    the metrics as floats."""
    opt, sched = optim.make_optimizer("sgd", model.parameters(),
                                      optim.multistep_lr(LR, [100], 0.1, 10), weight_decay=WD)
    batch = dict(batch)
    for key in ("heatmaps", "masks"):
        batch[key] = [torch.from_numpy(np.asarray(x)) for x in batch[key]]
    sfns = StepFns(LossConfig(num_joints=14), IMG, OUT, torch.device("cpu"))
    ts, metrics = sfns.get()(init_train_state(model, opt, sched), batch, desc)
    assert ts.step == 1
    return {k: float(v) for k, v in metrics.items()}


def _shard(batch, rank, size):
    per = len(batch["images"]) // size

    def cut(x):
        return x[rank * per:(rank + 1) * per]

    return {k: [cut(x) for x in v] if isinstance(v, list) else cut(v) for k, v in batch.items()}


def _step_rank(job, rank, size):
    model = job["model"]
    metrics = port_step(model, _shard(job["batch"], rank, size), job["desc"])
    return {"metrics": metrics, "state": model.state_dict()}


def _unit_rank(job, rank, size):
    """sync_batch_stats of this rank's shard with its gradient, and the
    (size, arch) draws of train_epoch."""
    from litepose_tpu_torch.train.trainer import train_epoch

    x = torch.from_numpy(job["x"][rank * 3:(rank + 1) * 3]).requires_grad_(True)
    mean, var, n = sync_batch_stats(x, (0, 2, 3))
    (mean * torch.arange(1.0, 5.0)).sum().add((var * torch.arange(2.0, 6.0)).sum()).backward()

    draws = []

    class Recorder:
        def get(self, size=None):
            def step(ts, batch, extra=None):
                draws.append((size, extra.tolist()))
                return ts, {"total": torch.zeros(())}
            return step

    manager = ArchManager()
    train_epoch(Recorder(), None, [{"images": np.zeros((1, 1, 1, 3), np.uint8)}] * 20, epoch=2,
                elastic_sizes=list(manager.img_sizes), seed=5,
                arch_sampler=lambda rng: arch_to_mask_desc(manager.random_sample(rng)))
    return {"mean": mean.detach(), "var": var.detach(), "n": n, "grad": x.grad, "draws": draws}


def _cli_rank(job, rank, size, tmp):
    from litepose_tpu_torch.tools import train
    from litepose_tpu_torch.train import checkpoint

    saves = []
    save = checkpoint.save_checkpoint

    def counted(*args, **kw):
        saves.append(args[0])
        return save(*args, **kw)

    checkpoint.save_checkpoint = counted
    run = train.main(["--multi-host", "--coordinator", f"file://{tmp}/rendezvous",
                      "--num-processes", str(size), "--process-id", str(rank)] + job["argv"])
    return {"state": run.ts.model.state_dict(), "step": run.ts.step, "epoch": run.ts.epoch,
            "epochs": run.epochs, "saves": saves, "out_dir": run.out_dir}


# -- the step on two ranks -------------------------------------------------------


def _supernet_desc():
    return arch_to_mask_desc(port_manager_sample(5))


def _super_resnet_desc():
    """A desc of the ResNet space drawn from a seeded rng."""
    from litepose_tpu_torch.models.litepose_resnet import resnet_arch_manager

    return arch_to_mask_desc(resnet_arch_manager().random_sample(np.random.default_rng(6)))


@pytest.fixture(scope="module")
def models(jax_weights, jax_supernet, trees):  # noqa: F811
    """{"litepose" | "supernet" | "superresnet": (a factory of the fresh
    training model, desc)}; the super-ResNet at its published widths
    (tests/test_torch_super_resnet.py)."""
    (params, state), _ = jax_weights
    return {"litepose": (lambda: _port_model(params, state), None),
            "supernet": (lambda: port_supernet(jax_supernet).train(), _supernet_desc()),
            "superresnet": (lambda: port_model(trees).train(), _super_resnet_desc()),
            "superresnet_f64": (lambda: port_model(trees, torch.float64).train(),
                                _super_resnet_desc())}


def _batch_f64():
    """``_batch()`` with float64 targets and masks (the step then runs in
    float64 throughout)."""
    batch = _batch()
    return {k: [np.asarray(x, np.float64) for x in v] if k in ("heatmaps", "masks") else v
            for k, v in batch.items()}


def _batch_of(name):
    return _batch_f64() if name.endswith("_f64") else _batch()


@pytest.fixture(scope="module")
def two_rank_steps(models, tmp_path_factory):
    """{name: [rank 0's result, rank 1's]} of one 2-rank SGD step."""
    out = {}
    for name, (make, desc) in models.items():
        tmp = tmp_path_factory.mktemp(f"step_{name}")
        out[name] = run_ranks(tmp, {"kind": "step", "model": make(), "batch": _batch_of(name),
                                    "desc": desc})
    return out


@pytest.fixture(scope="module")
def jax_mesh_steps(jax_weights, jax_supernet, trees):  # noqa: F811
    """{name: JAX's step on make_mesh(2): (metrics, new state, new params)}."""
    import jax
    import jax.numpy as jnp

    from litepose_tpu.arch.schema import ArchConfig as JArch
    from litepose_tpu.core.losses import LossConfig as JLoss
    from litepose_tpu.models.layers import Policy
    from litepose_tpu.models.litepose import ModelSpec as JSpec
    from litepose_tpu.models.litepose import apply_litepose
    from litepose_tpu.models.super_litepose import apply_super_litepose
    from litepose_tpu.models.super_litepose import arch_to_mask_desc as jdesc
    from litepose_tpu.parallel.mesh import (global_batch, make_mesh, replicate_spec,
                                            shard_batch_spec, shard_pytree)
    from litepose_tpu.train import optim as jopt
    from litepose_tpu.train.checkpoint import init_train_state as jinit_ts
    from litepose_tpu.train.trainer import StepFns as JStepFns
    from test_torch_train import _arch

    mesh = make_mesh(RANKS)
    assert mesh.devices.size == RANKS
    rspec, bspec = replicate_spec(mesh), shard_batch_spec(mesh)
    tx = jopt.make_optimizer("sgd", jopt.multistep_lr(LR, [100], 0.1, 10), weight_decay=WD)
    jm, jd, jspec = jax_side()
    arch, spec = _arch(), JSpec()

    def lite(p, s, x):
        return apply_litepose(p, s, x, spec, arch, train=True, policy=Policy.exact())

    def sup(p, s, x, desc):
        return apply_super_litepose(p, s, x, desc, jspec, jd, train=True,
                                    policy=Policy.exact())

    def sup_res(p, s, x, desc):
        from litepose_tpu.models.litepose_resnet import apply_super_litepose_resnet

        return apply_super_litepose_resnet(p, s, x, desc, res_jspec(), train=True,
                                           policy=Policy.exact())

    desc = jdesc(JArch.from_dict(port_manager_sample(5).to_dict()), jm)
    res_desc = jnp.asarray(_super_resnet_desc().numpy(), jnp.int32)
    out = {}
    for name, apply_fn, (params, state), extra in (
            ("litepose", lite, jax_weights[0], ()), ("supernet", sup, jax_supernet, (desc,)),
            ("superresnet", sup_res, trees, (res_desc,))):
        sfns = JStepFns(apply_fn, JLoss(num_joints=14), tx, base_input_size=IMG,
                        base_output_sizes=OUT)
        ts = jinit_ts(shard_pytree(jax.tree.map(jnp.asarray, params), rspec),
                      shard_pytree(jax.tree.map(jnp.asarray, state), rspec),
                      shard_pytree(tx.init(params), rspec))
        ts, metrics = sfns.get(None, bool(extra))(ts, global_batch(_batch(), bspec), *extra)
        out[name] = jax.tree.map(np.asarray, (metrics, ts.model_state, ts.params))
    return out


def _assert_metrics(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("name", ["litepose", "supernet", "superresnet"])
def test_two_rank_step_matches_jax_mesh(name, models, two_rank_steps, jax_mesh_steps):
    """Two gloo ranks, each on half the batch, take JAX's mesh step."""
    make, _ = models[name]
    want_metrics, want_state, want_params = jax_mesh_steps[name]
    result = two_rank_steps[name][0]
    _assert_metrics(result["metrics"], want_metrics)
    model = make()
    model.load_state_dict(result["state"])
    if name != "supernet":
        params, state = jax_from_state_dict(model.state_dict(), ModelSpec(), _port_arch()) \
            if name == "litepose" else super_resnet_to_jax(model)
        for got, want, atol in ((state, want_state, 2e-4), (params, want_params, 1e-5)):
            import jax

            for (path, g), (_, w) in zip(jax.tree_util.tree_leaves_with_path(got),
                                         jax.tree_util.tree_leaves_with_path(want)):
                np.testing.assert_allclose(g, w, atol=atol, rtol=0,
                                           err_msg=jax.tree_util.keystr(path))
    else:
        params, state = supernet_to_jax(model)
        arch = port_manager_sample(5)
        assert_heads_aside(state, want_state, arch, atol=2e-4)
        assert_heads_aside(params, want_params, arch, atol=1e-5)


@pytest.mark.parametrize("name", ["litepose", "supernet", "superresnet_f64"])
def test_two_rank_step_matches_one_rank(name, models, two_rank_steps):
    """The same step in one process on the whole batch; the two ranks end
    bit-equal.  The super-ResNet's steps run in float64: at its published
    depth, on this batch, its fp32 step is ill-conditioned at the stem
    (the masked BN after ``first.1``), where one fp32 process lies up to
    9e-4 from the float64 step on ``first.1.weight`` (at the max desc; 2e-4
    at this one) and two ranks 1e-7, by chance of the summation order; in
    float64 the two equal the one to the same atol."""
    make, desc = models[name]
    ranks = two_rank_steps[name]
    for k, v in ranks[0]["state"].items():
        assert torch.equal(v, ranks[1]["state"][k]), k
    assert ranks[0]["metrics"] == ranks[1]["metrics"]
    model = make()
    metrics = port_step(model, _batch_of(name), desc)
    _assert_metrics(ranks[0]["metrics"], metrics)
    for k, w in model.state_dict().items():
        g = ranks[0]["state"][k]
        if "num_batches_tracked" in k:
            assert torch.equal(g, w), k
        else:
            atol = 2e-4 if "running" in k else 1e-5
            torch.testing.assert_close(g, w, atol=atol, rtol=0, msg=k)


# -- sync_batch_stats and the draws ------------------------------------------------


@pytest.mark.parametrize("group", ["none", "of one"])
def test_sync_batch_stats_at_world_size_one_is_local(group, tmp_path):
    """No group, or a group of one rank: the local mean and biased var,
    bit for bit, and the local count."""
    x = torch.from_numpy(np.random.default_rng(0).normal(1.0, 2.0, (3, 5, 7, 6))
                         .astype(np.float32))
    if group == "of one":
        init_distributed("cpu", f"file://{tmp_path}/rendezvous", 1, 0)
    try:
        mean, var, n = sync_batch_stats(x, (0, 2, 3))
    finally:
        destroy_distributed()
    assert n == 3 * 7 * 6
    assert torch.equal(mean, x.mean(dim=(0, 2, 3)))
    assert torch.equal(var, x.var(dim=(0, 2, 3), unbiased=False))


@pytest.fixture(scope="module")
def unit_ranks(tmp_path_factory):
    x = np.random.default_rng(1).normal(0.5, 3.0, (6, 4, 5, 3)).astype(np.float32)
    return x, run_ranks(tmp_path_factory.mktemp("unit"), {"kind": "unit", "x": x})


def test_sync_batch_stats_over_two_ranks(unit_ranks):
    """Each rank holds 3 of 6 images: both get the whole batch's statistics
    (float64 reference, within fp32 rounding) and count, and each image's
    gradient is that of the whole batch's statistics.  Each rank's loss is
    the same function of them, so the ranks' losses sum to ``RANKS`` times
    it, and so do the gradients."""
    x, ranks = unit_ranks
    full = torch.from_numpy(x).double().requires_grad_(True)
    mean = full.mean(dim=(0, 2, 3))
    var = ((full - mean[:, None, None]) ** 2).mean(dim=(0, 2, 3))
    (mean * torch.arange(1.0, 5.0)).sum().add((var * torch.arange(2.0, 6.0)).sum()).backward()
    for r in ranks:
        assert r["n"] == 6 * 5 * 3
        torch.testing.assert_close(r["mean"].double(), mean.detach(), rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(r["var"].double(), var.detach(), rtol=1e-6, atol=1e-6)
    grad = torch.cat([r["grad"] for r in ranks]).double()
    torch.testing.assert_close(grad, RANKS * full.grad, rtol=1e-5, atol=1e-6)


def test_ranks_draw_the_same_sizes_and_archs(unit_ranks):
    """``train_epoch``'s (size, arch) sequence from ``default_rng((seed,
    epoch))`` is the same on every rank, and varies."""
    _, ranks = unit_ranks
    assert ranks[0]["draws"] == ranks[1]["draws"] and len(ranks[0]["draws"]) == 20
    assert len({tuple(d) for _, d in ranks[0]["draws"]}) > 10
    assert len({s for s, _ in ranks[0]["draws"]}) > 2


# -- the sharded batch iterator ------------------------------------------------------


class _Items:
    """A pipeline whose item i carries its index in every array."""

    seed = 1234

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def get(self, i, epoch):
        return (np.full((4, 4, 3), i % 256, np.uint8), [np.full((2, 2, 2), i, np.float32)],
                [np.full((2, 2), i, np.float32)], [np.full((3, 2, 2), i, np.int32)])


@pytest.mark.parametrize("process_count", [2, 4])
def test_batch_iterator_shards_as_jax(process_count):
    """The counterpart of tests/test_multihost_data.py: 109 items at batch
    4, every process's batches equal to JAX's iterator's."""
    from litepose_tpu.data.dataset import make_batch_iterator as jax_iterator
    from litepose_tpu_torch.data.dataset import make_batch_iterator

    pipe = _Items(109)
    seen = []
    for pi in range(process_count):
        kw = dict(shuffle=True, process_index=pi, process_count=process_count,
                  num_workers=2, prefetch=1)
        got = list(make_batch_iterator(pipe, 4, 3, **kw))
        want = list(jax_iterator(pipe, 4, 3, **kw))
        assert len(got) == len(want) == 109 // process_count // 4
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["images"], w["images"])
            for key in ("heatmaps", "masks", "joints"):
                for a, b in zip(g[key], w[key]):
                    np.testing.assert_array_equal(a, b)
        seen += [int(v) for b in got for v in b["heatmaps"][0][:, 0, 0, 0]]
    assert len(seen) == len(set(seen)), "shards overlap"


# -- the train CLI on two ranks --------------------------------------------------------


def _cli_argv(tmp, arch_json, end_epoch, *extra):
    return ["--cfg", MOBILE_CFG, "--superconfig", arch_json,
            "--ann-file", os.path.join(FIXTURE, "annotations.json"), "--image-dir", FIXTURE,
            "--device", "cpu", *extra,
            "DATASET.INPUT_SIZE", "64", "DATASET.OUTPUT_SIZE", "[16, 32]",
            "TRAIN.IMAGES_PER_GPU", "3", "TRAIN.END_EPOCH", str(end_epoch), "PRINT_FREQ", "1",
            "TPU.COMPUTE_DTYPE", "float32", "MODEL.INIT_WEIGHTS", "False",
            "OUTPUT_DIR", os.path.join(tmp, "output"), "LOG_DIR", os.path.join(tmp, "log")]


def test_train_cli_two_ranks_then_resumes(tmp_path):
    """``--multi-host`` on two gloo ranks, 3 images a rank a step on the
    12 fixture images (2 steps an epoch), 2 epochs with ``--profile-dir``,
    then a run to epoch 3 that resumes from the first's checkpoint."""
    arch_json = str(tmp_path / "arch.json")
    with open(arch_json, "w") as f:
        json.dump(ArchManager(deconv_setting=(16, 16, 8),
                              stage_setting=((8, 1, 2), (8, 2, 2), (16, 2, 2), (16, 1, 1)))
                  .fixed_sample(64, 0.5).to_dict(), f)
    prof = str(tmp_path / "profile")
    runs = []
    for name, argv in (("run1", _cli_argv(str(tmp_path), arch_json, 2, "--profile-dir", prof)),
                       ("run2", _cli_argv(str(tmp_path), arch_json, 3))):
        (tmp_path / name).mkdir()
        runs.append(run_ranks(tmp_path / name, {"kind": "cli", "argv": argv}))
    first, second = runs
    for run, steps, epochs, saves in ((first, 4, 2, 2), (second, 6, 3, 1)):
        r0, r1 = run
        assert r0["step"] == r1["step"] == steps and r0["epoch"] == r1["epoch"] == epochs
        for k, v in r0["state"].items():
            assert torch.equal(v, r1["state"][k]), k
        assert r0["epochs"] == r1["epochs"] and np.isfinite(r0["epochs"][-1]["total"])
        assert len(r0["saves"]) == saves and r1["saves"] == []
    out_dir = first[0]["out_dir"]
    assert {"checkpoint.msgpack", "final_state.msgpack"} <= set(os.listdir(out_dir))
    assert os.listdir(prof) == ["train_epoch1_rank0.json"]
    with open(os.path.join(prof, "train_epoch1_rank0.json")) as f:
        assert json.load(f)["traceEvents"]
    logs = {f: open(os.path.join(out_dir, f)).read() for f in os.listdir(out_dir)
            if f.endswith(".log")}
    assert any("rank0" in f for f in logs) and any("rank1" in f for f in logs)
    for f, text in logs.items():
        assert "rank 0 of 2 (gloo)" in text or "rank 1 of 2 (gloo)" in text, f
    assert sum("auto-resumed from epoch 2" in t for t in logs.values()) >= 2
