"""The port's msgpack checkpoints against ``litepose_tpu.train.checkpoint``
(flax).

The writer's bytes equal flax's ``msgpack_serialize`` for the same tree and
its reader restores flax's bytes; a ``save_checkpoint`` of either package
resumes in the other with bit-equal parameters, BN statistics, optimizer
state (optax layout) and counters; and a run resumed from either package's
checkpoint takes the step the uninterrupted run takes: bit for bit within
the port, and within the one-step tolerance of tests/test_torch_train.py
(atol 1e-5 on the parameters after an SGD step) across packages.  One JAX
train step is compiled, once per module."""

import os

import numpy as np
import pytest
import torch

from litepose_tpu_torch.core.losses import LossConfig
from litepose_tpu_torch.models.convert import (entries, jax_from_state_dict, named_from_tree,
                                               state_dict_from_jax)
from litepose_tpu_torch.models.litepose import ModelSpec
from litepose_tpu_torch.train import checkpoint as tck
from litepose_tpu_torch.train import optim
from litepose_tpu_torch.train.trainer import StepFns

from test_torch_train import IMG, OUT, WD, _arch, _batch, _port_arch, _port_model

SGD_LR = 0.02  # one cross-package step then moves parameters by ~1e-3, differs by ~1e-6


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The tier-1 run shares the host's cores among six workers; torch's
    default of one thread per core would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _trees():
    rng = np.random.default_rng(0)
    return [
        {"params": {"w": rng.normal(0, 1, (3, 3, 4, 8)).astype(np.float32),
                    "layers": [{"b": np.zeros(5, np.float32)}, {"b": np.ones(5, np.float32)}]},
         "step": 7, "best_perf": -1.0},
        {"dtypes": {"f64": rng.normal(0, 1, (2, 3)), "i32": np.arange(6, dtype=np.int32),
                    "i64": np.arange(-3, 3, dtype=np.int64), "u8": np.arange(256, dtype=np.uint8),
                    "bool": np.array([True, False]), "scalar": np.asarray(3, np.int32),
                    "empty": np.zeros((0, 4), np.float32)},
         "ints": [0, 127, 128, -1, -32, -33, 255, 256, -129, 65536, -70000, 2**33, -2**40],
         "floats": [0.5, -1e300], "flags": [True, False], "name": "x" * 40},
        {"big": rng.normal(0, 1, (70000,)).astype(np.float32),  # 32-bit ext length
         "mid": rng.normal(0, 1, (20, 20)).astype(np.float32),  # 16-bit ext length
         "many": {f"k{i:02d}": np.full((1,), i, np.int32) for i in range(20)}},  # map16
    ]


def _assert_trees_equal(a, b, where="root"):
    if isinstance(b, dict):
        assert isinstance(a, dict) and sorted(a) == sorted(b), where
        for k in b:
            _assert_trees_equal(a[k], b[k], f"{where}/{k}")
    elif isinstance(b, (list, tuple)):
        assert isinstance(a, (list, tuple)) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_trees_equal(x, y, f"{where}/{i}")
    elif isinstance(b, (np.ndarray, np.generic)) or hasattr(b, "dtype"):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (where, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


@pytest.mark.parametrize("i", range(3))
def test_writer_bytes_equal_flax(i):
    from flax import serialization

    tree = _trees()[i]
    want = serialization.msgpack_serialize(serialization.to_state_dict(tree))
    assert tck.msgpack_serialize(tree) == want
    _assert_trees_equal(serialization.msgpack_restore(tck.msgpack_serialize(tree)),
                        serialization.msgpack_restore(want))


@pytest.mark.parametrize("i", range(3))
def test_reader_restores_flax_bytes(i):
    from flax import serialization

    tree = serialization.to_state_dict(_trees()[i])
    data = serialization.msgpack_serialize(tree)
    _assert_trees_equal(tck.msgpack_restore(data), serialization.msgpack_restore(data))


def test_writer_refuses_what_flax_does_not_write():
    with pytest.raises(TypeError):
        tck.msgpack_serialize({1: np.zeros(2)})
    with pytest.raises(TypeError):
        tck.msgpack_serialize({"x": np.array([object()])})
    with pytest.raises(TypeError):
        tck.msgpack_serialize({"x": np.float32(1.0)})


@pytest.fixture(scope="module")
def jax_setup():
    """(params, state) numpy trees of the tiny arch with BN affines off
    identity, the JAX SGD transform, and its jitted train step."""
    import jax

    from litepose_tpu.core.losses import LossConfig as JLoss
    from litepose_tpu.models.layers import Policy
    from litepose_tpu.models.litepose import ModelSpec as JSpec
    from litepose_tpu.models.litepose import apply_litepose, init_litepose
    from litepose_tpu.train import optim as jopt
    from litepose_tpu.train.trainer import StepFns as JStepFns

    arch, spec = _arch(), JSpec()
    params, state = jax.tree.map(np.asarray, init_litepose(jax.random.PRNGKey(3), spec, arch))
    rng = np.random.default_rng(4)
    params = jax.tree.map(lambda x: x + rng.normal(0, 0.3, x.shape).astype(np.float32)
                          if x.ndim == 1 else x, params)

    def apply_fn(p, s, x):
        return apply_litepose(p, s, x, spec, arch, train=True, policy=Policy.exact())

    tx = jopt.make_optimizer("sgd", jopt.multistep_lr(SGD_LR, [100], 0.1, 10), weight_decay=WD)
    step = JStepFns(apply_fn, JLoss(num_joints=14), tx, base_input_size=IMG,
                    base_output_sizes=OUT).get()
    return params, state, tx, step


def _port_ts(params, state, name):
    model = _port_model(params, state)
    opt, sched = optim.make_optimizer(name, model.parameters(),
                                      optim.multistep_lr(SGD_LR if name == "sgd" else 1e-3, [100],
                                                         0.1, 10), weight_decay=WD)
    return tck.init_train_state(model, opt, sched)


def _port_steps(ts, n, seed=0):
    step = StepFns(LossConfig(num_joints=14), IMG, OUT, torch.device("cpu")).get()
    for i in range(n):
        ts, _ = step(ts, _batch_for(seed + i))
    return ts


def _batch_for(i):
    """A different batch per step: the seeded batch, images rolled by i."""
    b = _batch()
    b["images"] = np.roll(b["images"], 7 * i, axis=2)
    return b


def _jax_ts(params, state, tx, opt_state=None, step=0):
    from litepose_tpu.train.checkpoint import init_train_state

    opt_state = tx.init(jax_tree(params)) if opt_state is None else opt_state
    return init_train_state(jax_tree(params), jax_tree(state), opt_state, step=step)


def jax_tree(tree):
    import jax
    import jax.numpy as jnp

    return jax.tree.map(jnp.asarray, tree)


def _port_view(ts):
    """The port's training state as flax state dicts of numpy leaves."""
    params, state = jax_from_state_dict(ts.model.state_dict(), ModelSpec(), _port_arch())
    return params, state, tck.opt_state_tree(ts)


@pytest.mark.parametrize("name", ["adam", "sgd"])
def test_port_checkpoint_resumes_in_jax(jax_setup, tmp_path, name):
    import jax
    from flax import serialization

    from litepose_tpu.train import checkpoint as jck
    from litepose_tpu.train import optim as jopt

    params, state, _, _ = jax_setup
    ts = _port_steps(_port_ts(params, state, name), 2)._replace(epoch=3, best_perf=0.25)
    tck.save_checkpoint(str(tmp_path), ts, is_best=True)
    assert os.path.isfile(tmp_path / "model_best.msgpack")

    tx = jopt.make_optimizer(name, jopt.multistep_lr(1e-3, [100], 0.1, 10), weight_decay=WD)
    template = _jax_ts(params, state, tx)
    restored = jck.auto_resume(str(tmp_path), template)
    assert (int(restored.step), int(restored.epoch), float(restored.best_perf)) == (2, 3, 0.25)
    p, s, o = _port_view(ts)
    _assert_trees_equal(jax.tree.map(np.asarray, restored.params), p)
    _assert_trees_equal(jax.tree.map(np.asarray, restored.model_state), s)
    _assert_trees_equal(serialization.to_state_dict(jax.tree.map(np.asarray, restored.opt_state)),
                        serialization.to_state_dict(o))
    # the restored optax state has the structure optax steps with
    grads = jax.tree.map(np.zeros_like, restored.params)
    tx.update(grads, restored.opt_state, restored.params)


@pytest.mark.parametrize("name", ["adam", "sgd"])
def test_jax_checkpoint_resumes_in_port(jax_setup, tmp_path, name):
    import jax

    from litepose_tpu.train import checkpoint as jck
    from litepose_tpu.train import optim as jopt

    params, state, _, _ = jax_setup
    tx = jopt.make_optimizer(name, jopt.multistep_lr(1e-3, [100], 0.1, 10), weight_decay=WD)
    rng = np.random.default_rng(5)
    jp, opt_state = jax_tree(params), tx.init(jax_tree(params))
    for _ in range(3):  # three eager optax updates: non-trivial moments and counts
        g = jax.tree.map(lambda x: rng.normal(0, 1, x.shape).astype(np.float32), params)
        upd, opt_state = tx.update(jax_tree(g), opt_state, jp)
        jp = jax.tree.map(lambda a, b: a + b, jp, upd)
    jts = _jax_ts(jax.tree.map(np.asarray, jp), state, tx, opt_state, step=3)
    jck.save_checkpoint(str(tmp_path), jts._replace(epoch=jts.epoch + 1))

    ts = tck.auto_resume(str(tmp_path), _port_ts(params, state, name))
    assert (ts.step, ts.epoch, ts.best_perf) == (3, 1, -1.0)
    assert ts.scheduler.last_epoch == 3
    want_sd = state_dict_from_jax(jax.tree.map(np.asarray, jp), state, ModelSpec(), _port_arch())
    for k, v in ts.model.state_dict().items():
        if k.endswith("num_batches_tracked"):  # JAX keeps none; the port counts the steps
            assert int(v) == 3, k
        else:
            assert torch.equal(v, want_sd[k]), k
    _, _, o = _port_view(ts)
    from flax import serialization

    _assert_trees_equal(serialization.to_state_dict(o),
                        serialization.to_state_dict(jax.tree.map(np.asarray, opt_state)))
    if name == "adam":
        mu = named_from_tree(jax.tree.map(np.asarray, opt_state[0].mu), entries(ModelSpec(),
                                                                                _port_arch()))
        st = ts.optimizer.state[ts.model.first[0][0].weight]
        assert float(st["step"]) == 3
        assert torch.equal(st["exp_avg"], torch.from_numpy(mu["first.0.0.weight"].copy()))


def test_auto_resume_without_a_checkpoint_keeps_the_template(jax_setup, tmp_path):
    params, state, _, _ = jax_setup
    ts = _port_ts(params, state, "adam")
    assert tck.auto_resume(str(tmp_path), ts) is ts


@pytest.mark.parametrize("name", ["adam", "sgd"])
def test_port_resume_equals_uninterrupted(jax_setup, tmp_path, name):
    params, state, _, _ = jax_setup
    straight = _port_steps(_port_ts(params, state, name), 2)
    first = _port_steps(_port_ts(params, state, name), 1)
    tck.save_checkpoint(str(tmp_path), first)
    other = _port_ts(params, state, name)  # a fresh model and optimizer
    resumed = _port_steps(tck.load_checkpoint(str(tmp_path / "checkpoint.msgpack"), other), 1,
                          seed=1)
    assert resumed.step == straight.step == 2
    sa, sb = straight.model.state_dict(), resumed.model.state_dict()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    assert straight.optimizer.param_groups[0]["lr"] == resumed.optimizer.param_groups[0]["lr"]


def test_resume_across_packages_equals_uninterrupted(jax_setup, tmp_path):
    """SGD: a port checkpoint stepped once by JAX, and a JAX checkpoint
    stepped once by the port, each equal the other package's uninterrupted
    second step within atol 1e-5."""
    import jax

    from litepose_tpu.train import checkpoint as jck

    params, state, tx, jstep = jax_setup
    # port step 1, save; JAX resumes; the port goes on uninterrupted
    port1 = _port_steps(_port_ts(params, state, "sgd"), 1)
    tck.save_checkpoint(str(tmp_path / "port"), port1)
    port2 = _port_steps(port1, 1, seed=1)
    jts = jck.load_checkpoint(str(tmp_path / "port" / "checkpoint.msgpack"),
                              _jax_ts(params, state, tx))
    jts, _ = jstep(jts, _batch_for(1))
    p_port, s_port, _ = _port_view(port2)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray,
                                                                              jts.params)),
                            jax.tree_util.tree_leaves(p_port)):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0, err_msg=jax.tree_util.keystr(path))
    # JAX step 1, save; the port resumes; JAX goes on uninterrupted
    j1, _ = jstep(_jax_ts(params, state, tx), _batch_for(0))
    jck.save_checkpoint(str(tmp_path / "jax"), j1)
    j2, _ = jstep(j1, _batch_for(1))
    resumed = tck.load_checkpoint(str(tmp_path / "jax" / "checkpoint.msgpack"),
                                  _port_ts(params, state, "sgd"))
    resumed = _port_steps(resumed, 1, seed=1)
    assert resumed.step == int(j2.step) == 2
    p_port, _, _ = _port_view(resumed)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray,
                                                                              j2.params)),
                            jax.tree_util.tree_leaves(p_port)):
        np.testing.assert_allclose(b, a, atol=1e-5, rtol=0, err_msg=jax.tree_util.keystr(path))


def test_save_params_loads_in_both_packages(jax_setup, tmp_path):
    import jax

    from litepose_tpu.models.litepose import ModelSpec as JSpec
    from litepose_tpu.models.litepose import init_litepose
    from litepose_tpu.train import checkpoint as jck

    params, state, _, _ = jax_setup
    ts = _port_steps(_port_ts(params, state, "adam"), 1)
    path = str(tmp_path / "final.msgpack")
    tck.save_params(path, ts.model)
    p, s = _port_view(ts)[:2]
    _assert_trees_equal(tck.load_params(path)[0], p)
    _assert_trees_equal(tck.load_params(path)[1], s)
    tp, tstate = init_litepose(jax.random.PRNGKey(0), JSpec(), _arch())
    jp, js = jck.load_params(path, tp, tstate)
    _assert_trees_equal(jax.tree.map(np.asarray, jp), p)
    _assert_trees_equal(jax.tree.map(np.asarray, js), s)


@pytest.mark.parametrize("looks_like", ["supernet", "litepose", "nothing"])
def test_layout_follows_the_model_class(tmp_path, looks_like):
    """The JAX layout is chosen by the model's class: a module of another
    class raises ``TypeError`` in every entry point, even one that carries
    a supernet's ``dims`` / ``spec`` or a LitePose's ``arch``, instead of
    taking another model's table."""
    from litepose_tpu_torch.models.super_litepose import SuperDims

    class Other(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.conv = torch.nn.Conv2d(3, 4, 3)
            self.spec = ModelSpec()
            if looks_like == "supernet":
                self.dims = SuperDims(24, (32, 64, 96, 160), (1, 1, 1, 1), (2, 2, 2, 1),
                                      (64, 48, 32))
            elif looks_like == "litepose":
                self.arch, self.with_skips = _port_arch(), True

    model = Other()
    opt, sched = optim.make_optimizer("sgd", model.parameters(),
                                      optim.multistep_lr(0.1, [100], 0.1, 10))
    ts = tck.init_train_state(model, opt, sched)
    calls = [lambda: tck.save_params(str(tmp_path / "w.msgpack"), model),
             lambda: tck.save_checkpoint(str(tmp_path), ts),
             lambda: tck.opt_state_tree(ts),
             lambda: tck.load_model_params(str(tmp_path / "missing.msgpack"), model)]
    tck._write(str(tmp_path / "missing.msgpack"), {"params": {}, "model_state": {}})
    for call in calls:
        with pytest.raises(TypeError, match="Other"):
            call()
