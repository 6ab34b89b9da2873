"""The port's NAS stack (``litepose_tpu_torch.nas``, ``arch.macs``,
``models.fold_bn``, ``data.resize``) against the JAX package on the CPU.

* ``gmacs`` / ``count_litepose_macs``: the zoo and 50 sampled archs,
  exactly;
* ``calibrate_bn`` in both modes, through a fixed LitePose and through the
  masked supernet (the narrow space of tests/test_torch_supernet.py, fp32,
  JAX under ``Policy.exact()``): rtol 1e-5;
* ``EvolutionFinder`` with a seeded toy accuracy: the same candidates,
  history and best arch;
* ``fold_litepose_bn``: the folded weights within 1e-6 relative (XLA's and
  PyTorch's CPU ``rsqrt`` are each off the correctly rounded root on some
  inputs, and not on the same ones), the folded forward as the unfolded;
* ``resize_linear`` against ``cv2.resize`` bit for bit (skips without cv2);
* ``AccuracyPredictor`` on the committed fixture's first 6 images, the
  default supernet holding ``assets/bench_ckpt_xs.msgpack`` at Auto-XS
  (``inject_subnet``), calibrated on one batch of 4, in both scoring modes:
  the port (``device="cpu"``, fp32) gives the JAX predictor's AP (fp32
  through ``Policy.exact()``)."""

import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

from test_torch_supernet import (IMG, assert_heads_aside, assert_trees_equal,  # noqa: F401
                                 jax_side, jax_supernet, nchw, port_supernet)

from litepose_tpu_torch.arch import ARCH_ZOO, ArchConfig, ArchManager, count_litepose_macs, gmacs
from litepose_tpu_torch.core.inference import normalize_images
from litepose_tpu_torch.models.convert import jax_from_state_dict, litepose_from_jax
from litepose_tpu_torch.models.litepose import ModelSpec
from litepose_tpu_torch.models.super_litepose import arch_to_mask_desc
from litepose_tpu_torch.nas import EvolutionFinder
from litepose_tpu_torch.nas.calibrate import (bn_state, calibrate_bn, load_bn_state,
                                              module_train_fn)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "litepose_tpu_torch", "assets", "eval_fixture")
CFG = os.path.join(REPO, "configs", "crowd_pose", "mobilenet", "supermobile.yaml")
CKPT_XS = os.path.join(REPO, "assets", "bench_ckpt_xs.msgpack")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_gmacs_matches_jax():
    from litepose_tpu.arch.macs import count_litepose_macs as jcount
    from litepose_tpu.arch.manager import ArchManager as JManager
    from litepose_tpu.arch.zoo import ARCH_ZOO as J_ZOO

    from litepose_tpu_torch.nas import EfficiencyPredictor

    archs = [(ARCH_ZOO[n], J_ZOO[n]) for n in sorted(J_ZOO)]
    jm = JManager(seed=3)
    for _ in range(50):
        a = jm.random_sample()
        archs.append((ArchConfig.from_dict(a.to_dict()), a))
    for ours, theirs in archs:
        assert count_litepose_macs(ours) == jcount(theirs)
        assert count_litepose_macs(ours, 17, with_ae=(True, True)) == \
            jcount(theirs, 17, with_ae=(True, True))
        assert EfficiencyPredictor()(ours) == gmacs(ours) == jcount(theirs)["macs"] / 1e9


def _calib_batches():
    rng = np.random.default_rng(3)
    return [rng.integers(0, 255, (2, IMG, IMG, 3)).astype(np.uint8) for _ in range(2)]


@pytest.mark.parametrize("mode", ["average", "momentum"])
@pytest.mark.parametrize("path", ["subnet", "masked"])
def test_calibrate_bn_matches_jax(jax_supernet, path, mode):  # noqa: F811
    import jax

    from litepose_tpu.core.inference import normalize_images as jnorm
    from litepose_tpu.models.layers import Policy
    from litepose_tpu.models.litepose import apply_litepose
    from litepose_tpu.models.super_litepose import apply_super_litepose, extract_subnet
    from litepose_tpu.models.super_litepose import arch_to_mask_desc as jdesc
    from litepose_tpu.nas.calibrate import calibrate_bn as jcalibrate

    jm, jd, jspec = jax_side()
    jarch = jm.fixed_sample(IMG, 0.5)
    arch = ArchConfig.from_dict(jarch.to_dict())
    batches = _calib_batches()
    exact = Policy.exact()
    if path == "subnet":
        p, s = extract_subnet(*jax_supernet, jarch, jd, jspec)
        fn = jax.jit(lambda p_, s_, u8: apply_litepose(p_, s_, jnorm(u8), jspec, jarch,
                                                       train=True, policy=exact))
        want = jcalibrate(fn, p, s, batches, mode=mode)
        model = litepose_from_jax(p, s, ModelSpec(), arch, compute_dtype=torch.float32)
        fwd = module_train_fn(model, lambda u8: model(normalize_images(u8)))
    else:
        desc = jdesc(jarch, jm)
        fn = jax.jit(lambda p_, s_, u8: apply_super_litepose(p_, s_, jnorm(u8), desc, jspec, jd,
                                                             train=True, policy=exact))
        want = jcalibrate(fn, jax_supernet[0], jax_supernet[1], batches, mode=mode)
        model = port_supernet(jax_supernet)
        d = arch_to_mask_desc(arch)
        fwd = module_train_fn(model, lambda u8: model(normalize_images(u8), d))
    state = calibrate_bn(fwd, bn_state(model), [torch.from_numpy(b) for b in batches], mode=mode)
    load_bn_state(model, state)
    if path == "subnet":
        got = jax_from_state_dict(model.state_dict(), ModelSpec(), arch)[1]
    else:
        from litepose_tpu_torch.models.convert import supernet_to_jax

        got = supernet_to_jax(model)[1]
    assert_heads_aside(got, want, arch, atol=1e-6, rtol=1e-5)
    assert calibrate_bn(fwd, state, [], mode=mode) is state


def test_evolution_matches_jax():
    """Both finders, seed 0, a 12-candidate population over 4 iterations and
    a toy accuracy that hashes the arch: the same scored candidates in the
    same order, history and best arch."""
    import zlib

    from litepose_tpu.arch.manager import ArchManager as JManager
    from litepose_tpu.nas.evolution import EvolutionFinder as JFinder
    from litepose_tpu.nas.predictors import EfficiencyPredictor as JEff

    from litepose_tpu_torch.nas import EfficiencyPredictor

    def toy(seen):
        def acc(arch):
            d = arch.to_dict()
            seen.append(d)
            return (zlib.crc32(repr(sorted(d.items())).encode()) % 1000) / 1000 + gmacs(
                ArchConfig.from_dict(d)) / 100
        return acc

    seen_j, seen_p = [], []
    want = JFinder(JEff(), toy(seen_j), JManager(seed=0), population_size=12,
                   max_time_budget=4, seed=0).run_evolution_search(constraint=4.0)
    got = EvolutionFinder(EfficiencyPredictor(), toy(seen_p), ArchManager(seed=0),
                          population_size=12, max_time_budget=4,
                          seed=0).run_evolution_search(constraint=4.0)
    assert seen_p == seen_j and len(seen_p) > 12
    assert got[0] == want[0] and got[2] == want[2]
    assert got[1].to_dict() == want[1].to_dict() and gmacs(got[1]) <= 4.0


def test_fold_litepose_bn_matches_jax(jax_supernet):  # noqa: F811
    """The JAX fold and the port's on the same LitePose: equal trees to the
    last bit of ``rsqrt`` (the identity BN's var is 1 - eps in both); the
    folded forward equals the unfolded."""
    import jax

    from litepose_tpu.models.fold_bn import fold_litepose_bn as jfold
    from litepose_tpu.models.super_litepose import extract_subnet

    from litepose_tpu_torch.models.fold_bn import fold_litepose_bn

    jm, jd, jspec = jax_side()
    jarch = jm.fixed_sample(IMG, 1.0)
    arch = ArchConfig.from_dict(jarch.to_dict())
    p, s = jax.tree.map(np.asarray, extract_subnet(*jax_supernet, jarch, jd, jspec))
    want = jax.tree.map(np.asarray, jfold(p, s))
    model = litepose_from_jax(p, s, ModelSpec(), arch, compute_dtype=torch.float32)
    fused = fold_litepose_bn(model)
    assert not fused.training and fused is not model
    got = jax_from_state_dict(fused.state_dict(), ModelSpec(), arch)
    assert_trees_equal(got, want, close=("['w']", "['bias']"))
    assert (want[1]["first"]["bn2"]["var"] == np.float32(1 - 1e-5)).all()
    x = nchw(np.random.default_rng(4).standard_normal((2, IMG, IMG, 3)).astype(np.float32))
    with torch.no_grad():
        for a, b in zip(fused(x), model(x)):
            torch.testing.assert_close(a, b, atol=5e-4, rtol=1e-3)


def test_resize_matches_cv2():
    """``resize_linear`` equals OpenCV's INTER_LINEAR on every fixture image
    at every search resolution, and on random sizes up and down, exact 2x
    included."""
    cv2 = pytest.importorskip("cv2")
    from litepose_tpu_torch.data.jpeg import decode_jpeg
    from litepose_tpu_torch.data.resize import resize_linear

    for name in sorted(os.listdir(FIXTURE)):
        if name.endswith(".jpg"):
            img = decode_jpeg(os.path.join(FIXTURE, name))
            for s in (256, 320, 384, 448, 512):
                np.testing.assert_array_equal(resize_linear(img, (s, s)),
                                              cv2.resize(img, (s, s)), err_msg=f"{name} {s}")
    rng = np.random.default_rng(0)
    cases = [(512, 512, 256, 256), (7, 9, 300, 200), (1, 1, 5, 3), (480, 640, 240, 320)]
    cases += [tuple(int(v) for v in rng.integers(1, 400, 4)) for _ in range(60)]
    for h, w, oh, ow in cases:
        for shape in ((h, w, 3), (h, w)):
            img = rng.integers(0, 256, shape).astype(np.uint8)
            np.testing.assert_array_equal(resize_linear(img, (ow, oh)), cv2.resize(img, (ow, oh)),
                                          err_msg=f"{shape} -> {(oh, ow)}")


@pytest.fixture(scope="module")
def xs_supernet():
    """The default JAX supernet with the trained Auto-XS weights injected,
    as numpy trees."""
    import jax

    from litepose_tpu.arch.manager import ArchManager as JManager
    from litepose_tpu.arch.zoo import get_arch as jget
    from litepose_tpu.models.litepose import ModelSpec as JSpec
    from litepose_tpu.models.litepose import init_litepose
    from litepose_tpu.models.super_litepose import SuperDims as JDims
    from litepose_tpu.models.super_litepose import init_super_litepose, inject_subnet
    from litepose_tpu.train.checkpoint import load_params

    dims, spec, arch = JDims.from_manager(JManager()), JSpec(), jget("auto-XS")
    sp, ss = init_super_litepose(jax.random.PRNGKey(0), spec, dims)
    p, s = load_params(CKPT_XS, *init_litepose(jax.random.PRNGKey(0), spec, arch))
    return jax.tree.map(np.asarray, inject_subnet(sp, ss, p, s, arch, dims, spec))


def xs_supernet_state_of_xs(trees):
    """The Auto-XS slice of the supernet's BN statistics (before any
    calibration), in the JAX layout."""
    from litepose_tpu.arch.manager import ArchManager as JManager
    from litepose_tpu.arch.zoo import get_arch as jget
    from litepose_tpu.models.litepose import ModelSpec as JSpec
    from litepose_tpu.models.super_litepose import SuperDims as JDims
    from litepose_tpu.models.super_litepose import extract_subnet as jextract

    return jextract(*trees, jget("auto-XS"), JDims.from_manager(JManager()), JSpec())[1]


def _capture(monkeypatch, ds):
    """Keep what ``ds.evaluate`` is given: [(preds, scores)]."""
    seen = []
    evaluate = ds.evaluate

    def keep(preds, scores, *a, **kw):
        seen.append(([[np.asarray(p) for p in im] for im in preds], [list(s) for s in scores]))
        return evaluate(preds, scores, *a, **kw)

    monkeypatch.setattr(ds, "evaluate", keep)
    return seen


def _capture_calibration(monkeypatch, module):
    """Keep the states ``module.calibrate_bn`` returns."""
    seen = []
    calibrate = module.calibrate_bn

    def keep(*a, **kw):
        seen.append(calibrate(*a, **kw))
        return seen[-1]

    monkeypatch.setattr(module, "calibrate_bn", keep)
    return seen


@pytest.mark.parametrize("scoring", ["extract", "masked"])
def test_accuracy_predictor_matches_jax(xs_supernet, scoring, monkeypatch):
    """Flip test off (the eval CLI's test holds it).  ``extract`` calibrates
    on one batch of 4 (through ``cv2.resize`` in JAX, ``resize_linear`` in
    the port): the calibrated statistics agree within rtol 1e-4, atol 1e-5 (the delta
    recovery multiplies the forwards' differences by 10), the AP and the
    people per image are equal.  That calibration moves the trained
    statistics far (AP 0.12 before, 0 after, in both packages), and the
    maps' noise peaks then regroup on the fp32 forwards' 1e-6 differences,
    so ``masked`` scores without calibration batches: the maps carry the
    trained model's peaks, the AP is 0.12 in both, and 98% of the joints
    agree within 1e-3 px (the rest are noise peaks that the max-width fp32
    forwards' 1e-6 differences regroup)."""
    import jax

    import litepose_tpu.models.super_litepose as jsuper
    import litepose_tpu.nas.predictors as jpred
    from litepose_tpu.arch.manager import ArchManager as JManager
    from litepose_tpu.arch.zoo import get_arch as jget
    from litepose_tpu.config import default_config as jdefault
    from litepose_tpu.config import update_config as jupdate
    from litepose_tpu.data.dataset import PoseDataset as JDataset
    from litepose_tpu.models.layers import Policy
    from litepose_tpu.models.litepose import ModelSpec as JSpec
    from litepose_tpu.models.super_litepose import SuperDims as JDims

    import litepose_tpu_torch.nas.predictors as pred
    from litepose_tpu_torch.config import default_config, update_config
    from litepose_tpu_torch.models.convert import supernet_from_jax
    from litepose_tpu_torch.models.super_litepose import SuperDims
    from litepose_tpu_torch.nas import AccuracyPredictor
    from litepose_tpu_torch.tools.search import datasets

    exact = Policy.exact()
    monkeypatch.setattr(jpred, "apply_litepose",
                        functools.partial(jpred.apply_litepose, policy=exact))
    monkeypatch.setattr(jsuper, "apply_super_litepose",
                        functools.partial(jsuper.apply_super_litepose, policy=exact))
    ann = os.path.join(FIXTURE, "annotations.json")
    kw = dict(n_calib_batches=1 if scoring == "extract" else 0, calib_batch_size=4,
              max_eval_images=6, scoring=scoring)
    opts = ["TEST.FLIP_TEST", "False"]

    jcfg = jupdate(jdefault(), CFG, opts)
    jsearch = JDataset(ann, FIXTURE, 14, style="crowdpose", filter_for_train=False)
    want_people = _capture(monkeypatch, jsearch)
    want_state = _capture_calibration(monkeypatch, jpred)
    jacc = jpred.AccuracyPredictor(*xs_supernet, JDims.from_manager(JManager()), JSpec(),
                                   JDataset(ann, FIXTURE, 14, style="crowdpose"), jsearch,
                                   jcfg, **kw)
    want = jacc(jget("auto-XS"))

    cfg = update_config(default_config(), CFG, opts)
    supernet = supernet_from_jax(*xs_supernet, ModelSpec(), SuperDims.from_manager(ArchManager()),
                                 compute_dtype=torch.float32)
    before = {k: v.clone() for k, v in supernet.state_dict().items()}
    calib, search = datasets(cfg, ann, FIXTURE)
    got_people = _capture(monkeypatch, search)
    got_state = _capture_calibration(monkeypatch, pred)
    acc = AccuracyPredictor(supernet, calib, search, cfg, device="cpu", **kw)
    got = acc(ARCH_ZOO["auto-XS"])
    assert got == pytest.approx(want, abs=1e-6)
    (g_preds, g_scores), = got_people
    (w_preds, w_scores), = want_people
    assert [len(p) for p in g_preds] == [len(p) for p in w_preds] and sum(map(len, g_preds)) > 6
    if scoring == "extract":
        (state,), (jstate,) = got_state, want_state
        sub_sd = {k: v for k, v in pred.extract_subnet(supernet, ARCH_ZOO["auto-XS"]).state_dict()
                  .items()}
        sub_sd.update(state)
        got_tree = jax_from_state_dict(sub_sd, ModelSpec(), ARCH_ZOO["auto-XS"])[1]
        for (key, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(got_tree),
                                    jax.tree_util.tree_leaves_with_path(jstate)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-5, err_msg=str(key))
        assert any(not np.array_equal(a, b) for a, b in zip(
            jax.tree.leaves(got_tree), jax.tree.leaves(xs_supernet_state_of_xs(xs_supernet))))
        return
    assert got > 0.05
    joints = np.concatenate([np.stack(p) for p in g_preds if p])
    want_joints = np.concatenate([np.stack(p) for p in w_preds if p])
    close = np.abs(joints[..., :2] - want_joints[..., :2]).max(-1) <= 1e-3
    print(f"joints within 1e-3 px: {close.mean():.4f} of {close.size}")
    assert close.mean() >= 0.98
    np.testing.assert_allclose(joints[close][:, 2], want_joints[close][:, 2], atol=1e-4)
    np.testing.assert_allclose(np.concatenate(g_scores), np.concatenate(w_scores), atol=2e-2)
    assert acc(ARCH_ZOO["auto-XS"]) == got and len(acc.timings) == 1  # cached
    assert all(torch.equal(v, before[k]) for k, v in supernet.state_dict().items())
    if scoring == "masked":
        with pytest.raises(ValueError, match="full-kernel"):
            acc(dataclasses.replace(ARCH_ZOO["auto-XS"], img_size=320, backbone_setting=tuple(
                dataclasses.replace(st, block_setting=((6, 5),) * st.num_blocks)
                for st in ARCH_ZOO["auto-XS"].backbone_setting)))
