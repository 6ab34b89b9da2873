"""The port's LR schedule and optimizers against ``litepose_tpu.train.optim``
(optax).

The LambdaLR's LR at every step equals the optax schedule's float32 value;
Adam and SGD (weight decay, momentum, nesterov) walk the same trajectory
over 5 steps on the same seeded gradients within atol 1e-6 (Adam's update
rounds in another order: torch divides by the bias corrections in float64
scalars, optax in float32)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from litepose_tpu.train import optim as jopt

from litepose_tpu_torch.train import optim as topt

SCHEDULES = [
    # (base_lr, milestones, gamma, steps_per_epoch, warmup_steps)
    (1e-3, [3, 5], 0.1, 2, 0),
    (1e-3, [10], 0.1, 1, 3),  # milestone 10 decays at step 13 under warmup
    (3e-4, [2, 4, 7], 0.5, 3, 4),
    (1e-2, [], 0.1, 5, 0),
]


@pytest.mark.parametrize("args", SCHEDULES, ids=[f"s{i}" for i in range(len(SCHEDULES))])
def test_lambda_lr_matches_optax_schedule_every_step(args):
    want = jopt.multistep_lr(*args)
    sched = topt.multistep_lr(*args)
    p = torch.nn.Parameter(torch.zeros(2))
    opt, lr_sched = topt.make_optimizer("sgd", [p], sched)
    for step in range(30):
        w = np.float32(want(jnp.asarray(step, jnp.int32)))
        assert np.float32(sched(step)) == w, step
        assert np.float32(opt.param_groups[0]["lr"]) == w, step
        opt.step()
        lr_sched.step()
    if args[4]:
        assert sched(0) == 0.0
    if args == SCHEDULES[1]:
        assert sched(12) == pytest.approx(1e-3) and sched(13) == pytest.approx(1e-4)


def test_set_schedule_step_resumes_the_lr():
    sched = topt.multistep_lr(1e-3, [4], 0.1, 1, warmup_steps=2)
    p = torch.nn.Parameter(torch.zeros(2))
    opt, lr_sched = topt.make_optimizer("adam", [p], sched)
    topt.set_schedule_step(lr_sched, 7)
    assert opt.param_groups[0]["lr"] == pytest.approx(sched(7), rel=1e-12)
    assert lr_sched.last_epoch == 7
    opt.step()
    lr_sched.step()
    assert opt.param_groups[0]["lr"] == pytest.approx(sched(8), rel=1e-12)


@pytest.mark.parametrize("name,nesterov", [("adam", False), ("sgd", False), ("sgd", True)])
@pytest.mark.parametrize("warmup", [0, 2])
def test_trajectory_matches_optax(name, nesterov, warmup):
    rng = np.random.default_rng(0)
    w0 = {"a": rng.normal(0, 1, (4, 3)).astype(np.float32),
          "b": rng.normal(0, 1, (5,)).astype(np.float32)}
    grads = [{k: rng.normal(0, 1, v.shape).astype(np.float32) for k, v in w0.items()}
             for _ in range(5)]
    args = (1e-2, [1], 0.5, 3, warmup)

    tx = jopt.make_optimizer(name, jopt.multistep_lr(*args), weight_decay=1e-2,
                             nesterov=nesterov)
    jp = {k: jnp.asarray(v) for k, v in w0.items()}
    st = tx.init(jp)
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in w0.items()}
    opt, lr_sched = topt.make_optimizer(name, params.values(), topt.multistep_lr(*args),
                                        weight_decay=1e-2, nesterov=nesterov)
    for g in grads:
        upd, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        lr_sched.step()
        for k, p in params.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=0, atol=1e-6)
    moved = max(np.abs(np.asarray(jp[k]) - w0[k]).max() for k in w0)
    assert moved > 1e-3


def test_unknown_optimizer_is_refused():
    with pytest.raises(ValueError, match="unknown optimizer"):
        topt.make_optimizer("rmsprop", [torch.nn.Parameter(torch.zeros(1))],
                            topt.multistep_lr(1e-3, [], 0.1, 1))
