"""A port train step held to the JAX package's, shared by the step tests of
tests/test_torch_{super_resnet,resnet,hrnet_train}.py: the tolerances of
tests/test_torch_train.py for a model whose JAX layout is a
``models.convert`` table."""

import numpy as np


def leaves(tree):
    import jax

    return jax.tree_util.tree_leaves_with_path(tree)


def rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def jax_sgd_step(apply_fn, params, state, batch, img, out, lr, wd, extra=None):
    """One step of JAX's ``StepFns`` with ``optim.make_optimizer("sgd")``
    behind a transform that keeps the gradients in the optimizer state:
    {"metrics", "grads", "state", "params"} as numpy.  ``apply_fn(p, s, x)``
    (or ``(p, s, x, extra)``) is the model's train-mode apply."""
    import jax
    import jax.numpy as jnp
    import optax

    from litepose_tpu.core.losses import LossConfig as JLoss
    from litepose_tpu.train import optim as jopt
    from litepose_tpu.train.checkpoint import init_train_state as jinit_ts
    from litepose_tpu.train.trainer import StepFns as JStepFns

    keep_grads = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p), lambda u, s, p=None: (u, u))
    tx = optax.chain(keep_grads, jopt.make_optimizer(
        "sgd", jopt.multistep_lr(lr, [100], 0.1, 10), weight_decay=wd))
    fns = JStepFns(apply_fn, JLoss(num_joints=14), tx, base_input_size=img,
                   base_output_sizes=out)
    ts = jinit_ts(jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, state),
                  tx.init(params))
    if extra is None:
        ts, metrics = fns.get()(ts, batch)
    else:
        ts, metrics = fns.get(None, True)(ts, batch, extra)
    return jax.tree.map(np.asarray, {"metrics": metrics, "grads": ts.opt_state[0],
                                     "state": ts.model_state, "params": ts.params})


def check_step_against_jax(want, ts, metrics, grads, exact, table, to_jax, update=None,
                           exact_metrics=None):
    """tests/test_torch_train.py's ``_check_against_jax`` for a model whose
    table is ``table`` and whose (params, state) trees ``to_jax`` gives:
    the loss and its metrics rtol 1e-5; each gradient within 1e-4 relative
    of the port's float64 step (``exact``) and of JAX's beyond JAX's own
    distance from it; the BN statistics atol 2e-4; the parameters atol
    1e-5.  A gradient that float64 gives as zero (norm within 1e-12 of the
    whole gradient's: a conv or BN bias that a train-mode BN follows,
    directly or through a 1x1 conv) has no relative precision in fp32;
    its fp32 norm is held within 1e-6 of the whole gradient's (EfficientHRNet
    H-3: both packages' residues 1e-8 to 4e-6 against 169).

    ``update``: (the step's optax optimizer, the parameters before the
    step); the parameters are then held at atol 1e-5 to optax's update of
    the port's own gradients, which the gradient checks hold to JAX's.
    Adam's first update is ``lr * g / (|g| + eps)``: where |g| is near
    1e-7 a 1e-5 relative difference in the gradient moves the parameter by
    more than 1e-5 (at lr 2e-3 two of the super-ResNet's 20 M parameters
    do).  SGD at lr 0.1 moves a parameter by a tenth of the gradient's
    difference: the HRNet stems' gradients reach 5, where both packages'
    fp32 gradients lie 1e-5 relative (5e-5) from the float64 step's.

    ``exact_metrics``: the port's float64 step's metrics; each metric is
    then held within rtol 1e-5 of JAX's beyond JAX's own distance from the
    float64 value, the gradients' rule.  An AE pull near 1e-4 is the square
    of a tag difference near 0.02, a difference of fp32 outputs: JAX's own
    pull lies up to 1.2e-4 relative from the float64 value."""
    import jax

    from litepose_tpu_torch.models.convert import tree_from_named

    assert sorted(metrics) == sorted(want["metrics"])
    for k, v in want["metrics"].items():
        slack = 0.0 if exact_metrics is None else abs(float(v) - exact_metrics[k])
        assert abs(metrics[k] - float(v)) <= 1e-5 * abs(float(v)) + slack, \
            (k, metrics[k], float(v), exact_metrics and exact_metrics[k])
    g_tree = tree_from_named(grads, table)
    x_tree = tree_from_named({n: g.double().numpy() for n, g in exact.items()}, table)
    whole = np.sqrt(sum(float(np.sum(x ** 2)) for _, x in leaves(x_tree)))
    for (path, g), (_, w), (_, x) in zip(leaves(g_tree), leaves(want["grads"]), leaves(x_tree)):
        name = jax.tree_util.keystr(path)
        if np.linalg.norm(x) <= 1e-12 * whole:
            # zero in exact arithmetic (a bias whose shift the next
            # train-mode BN removes): fp32 rounding residue, no more
            assert np.linalg.norm(g) <= 1e-6 * whole, (name, np.linalg.norm(g), whole)
            continue
        assert rel(g, x) <= 1e-4, (name, rel(g, x))
        assert rel(g, w) <= 1e-4 + rel(w, x), (name, rel(g, w), rel(w, x))
    p_tree, s_tree = to_jax(ts.model)
    assert len(leaves(s_tree)) == len(leaves(want["state"]))
    for (path, s), (_, w) in zip(leaves(s_tree), leaves(want["state"])):
        np.testing.assert_allclose(s, w, atol=2e-4, rtol=0, err_msg=jax.tree_util.keystr(path))
    want_params = want["params"]
    if update is not None:
        import optax

        tx, before = update
        upd, _ = jax.jit(tx.update)(g_tree, tx.init(before), before)
        want_params = jax.tree.map(np.asarray, optax.apply_updates(before, upd))
    assert len(leaves(p_tree)) == len(leaves(want_params))
    for (path, p), (_, w) in zip(leaves(p_tree), leaves(want_params)):
        np.testing.assert_allclose(p, w, atol=1e-5, rtol=0, err_msg=jax.tree_util.keystr(path))
    return g_tree
