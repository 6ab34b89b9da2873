"""The port's host decoder (``litepose_tpu_torch.native``, its own build of
``csrc/fast_group.cpp``) against the JAX package's ``native``, and the
demo's ``--backend native``.

* On seeded scenes (tag dims 1 and 2, empty maps, more than 30 peaks in a
  joint, ``ignore_too_much`` and ``use_detection_val`` on and off) the
  port's parser gives JAX's ``NativeHeatmapParser``'s people and scores bit
  for bit.  The JAX build is ``g++ -O3 -march=native``, the port's ``c++
  -O2`` with no ``-march``: on a CPU with FMA the first may contract the
  tag distance's ``d2 += dt * dt``, which moves a distance by an ulp and
  could move a rounded cost across .5; no scene here shows a difference.
* On the same scenes the parser agrees with the port's CPU twins of the
  card's decode (``ops.group.parse_batch``: Hungarian grouping, no adjust
  or refine) at tests/test_native.py's tolerances against ``parse_np``
  (people atol 1e-4, scores 1e-5): the check ``chip_smoke.py`` phase 18(d)
  repeats on the card's host, where JAX is absent.
* ``tools.demo --backend native --device cpu`` draws the people of JAX's
  ``tools/demo.py --backend native`` on fixture JPEGs (both forwards fp32),
  within the engine tolerance of tests/test_torch_demo.py."""

import importlib.util
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from litepose_tpu_torch.native import NativeHeatmapParser
from litepose_tpu_torch.ops.group import GroupParams, StaticGroupCfg, parse_batch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "litepose_tpu_torch", "assets", "eval_fixture")
CKPT_XS = os.path.join(REPO, "assets", "bench_ckpt_xs.msgpack")


def scene(seed, n_people=3, T=1, K=14, H=48, W=48, noise=0.02, crowd=0):
    """Multi-person heatmaps (K, H, W) and tag maps (K, H, W, T): Gaussian
    peaks with a distinct tag a person, a quarter of the joints missing;
    ``crowd`` more isolated peaks in joint 0, each with its own tag."""
    rng = np.random.default_rng(seed)
    det = rng.uniform(0, noise, (K, H, W)).astype(np.float32)
    tag = rng.uniform(-0.05, 0.05, (K, H, W, T)).astype(np.float32)
    yy, xx = np.mgrid[0:H, 0:W]

    def blob(k, cx, cy, ptag, amp, sigma=2.0):
        g = amp * np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * sigma ** 2))
        det[k] = np.maximum(det[k], g.astype(np.float32))
        near = np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * 3.0 ** 2)) > 0.3
        tag[k][near] = ptag + rng.normal(0, 0.02, T)

    for pid in range(n_people):
        ptag = (pid + 1) * 2.0 + rng.normal(0, 0.05, T)
        for k in range(K):
            if rng.uniform() < 0.25:
                continue
            blob(k, rng.uniform(4, W - 4), rng.uniform(4, H - 4), ptag, rng.uniform(0.4, 1.0))
    cells = rng.permutation(np.stack(np.mgrid[0:H // 4, 0:W // 4], -1).reshape(-1, 2))[:crowd]
    for i, (cy, cx) in enumerate(cells):
        blob(0, cx * 4 + 2, cy * 4 + 2, rng.normal(0, 5, T), rng.uniform(0.2, 1.0), sigma=0.7)
    return det, tag


# (seed, scene kwargs, GroupParams kwargs)
CASES = {
    "t1": (0, {}, {}),
    "t1_five_people": (1, {"n_people": 5}, {}),
    "t2": (2, {"T": 2}, {}),
    "t2_two_people": (3, {"T": 2, "n_people": 2}, {}),
    "empty": (4, {"n_people": 0, "noise": 0.05}, {}),
    "crowded_joint": (5, {"crowd": 60, "n_people": 2}, {}),
    "ignore_too_much": (6, {"crowd": 40, "n_people": 4}, {"ignore_too_much": True,
                                                          "max_num_people": 8}),
    "no_detection_val": (7, {"n_people": 4}, {"use_detection_val": False}),
    "no_detection_val_t2": (8, {"n_people": 3, "T": 2}, {"use_detection_val": False}),
    "window_3": (9, {"n_people": 4}, {"nms_kernel": 3, "nms_padding": 1}),
}


def params_of(name, cls=GroupParams):
    return cls(**dict({"num_joints": 14, "detection_threshold": 0.1}, **CASES[name][2]))


def scene_of(name):
    seed, kw, _ = CASES[name]
    return scene(seed, **kw)


@pytest.mark.parametrize("name", list(CASES))
def test_parser_equals_jax_native(name):
    from litepose_tpu.native import NativeHeatmapParser as JParser
    from litepose_tpu.ops.group_ref import GroupParams as JGroupParams

    det, tag = scene_of(name)
    people, scores = NativeHeatmapParser(params_of(name)).parse(det, tag)
    want_people, want_scores = JParser(params_of(name, JGroupParams)).parse(det, tag)
    assert people.dtype == np.float32 and people.shape == want_people.shape
    np.testing.assert_array_equal(people, want_people)
    assert scores == want_scores
    if name == "empty":
        assert people.shape[0] == 0 and scores == []
    else:
        assert people.shape[0] > 0
    if name == "crowded_joint":
        assert (det[0] > 0.1).sum() > 30 and (people[:, 0, 2] > 0).sum() == 30


@pytest.mark.parametrize("name", list(CASES))
def test_parser_agrees_with_the_twins(name):
    """The CPU twins of the card's eval decode, Hungarian grouping without
    adjust or refine, on the same maps: the same people in the same order,
    coordinates, scores and tags within atol 1e-4, scores within 1e-5."""
    det, tag = scene_of(name)
    p = params_of(name)
    people, scores = NativeHeatmapParser(p).parse(det, tag)
    cfg = StaticGroupCfg.from_params(p, assignment="hungarian")
    got, got_scores, n = parse_batch(torch.from_numpy(det[None]),
                                     torch.from_numpy(tag.transpose(0, 3, 1, 2)[None].copy()),
                                     cfg, with_adjust=False, with_refine=False, tag_layout="thw")
    n = int(n[0])
    assert n == people.shape[0]
    np.testing.assert_allclose(got[0, :n].numpy(), people, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got_scores[0, :n].numpy(), scores, atol=1e-5, rtol=0)


@pytest.mark.parametrize("det_shape, tag_shape, order", [
    ((14, 8, 8), (14, 8, 9, 1), None), ((14, 8, 8), (14, 8, 8), None),
    ((14, 8, 8), (14, 8, 8, 1), list(range(13))), ((14, 8, 8), (14, 8, 8, 1), [0] * 14)])
def test_parser_refuses_what_the_c_code_would_read_out_of_bounds(det_shape, tag_shape, order):
    p = GroupParams(num_joints=14, joint_order=order)
    with pytest.raises(ValueError, match="does not match det|not an order"):
        NativeHeatmapParser(p).parse(np.zeros(det_shape, np.float32),
                                     np.zeros(tag_shape, np.float32))


def test_parser_takes_the_ports_params():
    from litepose_tpu.ops.group_ref import GroupParams as JGroupParams

    with pytest.raises(TypeError, match="GroupParams"):
        NativeHeatmapParser(JGroupParams())


# -- the demo -------------------------------------------------------------------------

NAMES = ("000000", "000001", "000002")
SIZE = 128


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("native_in")
    for name in NAMES:
        shutil.copy(os.path.join(FIXTURE, name + ".jpg"), d)
    return str(d)


def _args(input_dir, out):
    return ["--weights", CKPT_XS, "--arch", "auto-XS", "--input-size", str(SIZE),
            "--input", input_dir, "--output", out, "--backend", "native"]


def test_demo_native_matches_jax(inputs, tmp_path, capsys):
    """Both demos with ``--backend native`` on 3 fixture JPEGs at 128 px,
    fp32 forwards (the JAX policy patched to ``Policy.exact()``, the
    port's convs to float32): per image the same people, coordinates
    within 1e-3 px, scores and tags within 1e-4; the port prints its host
    ms a decode."""
    import jax

    import litepose_tpu.models.litepose as jlitepose
    import litepose_tpu.utils.vis as jvis
    from litepose_tpu.models.layers import Policy

    from litepose_tpu_torch.tools import demo
    from litepose_tpu_torch.tools import export as export_cli
    from litepose_tpu_torch.utils import vis

    def recorder(draw, out):
        def record(image, people, dataset="CROWDPOSE", **kw):
            out.append([np.array(p) for p in people])
            return draw(image, people, dataset, **kw)
        return record

    spec = importlib.util.spec_from_file_location("jax_demo_cli_native",
                                                  os.path.join(REPO, "tools", "demo.py"))
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    apply_litepose = jlitepose.apply_litepose
    want = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LITEPOSE_XLA_CACHE", jax.config.jax_compilation_cache_dir or "")
        mp.setattr(jlitepose, "apply_litepose",
                   lambda *a, **kw: apply_litepose(*a, **dict(kw, policy=Policy.exact())))
        mp.setattr(jvis, "draw_skeleton", recorder(jvis.draw_skeleton, want))
        mp.setattr(sys, "argv", ["demo.py"] + _args(inputs, str(tmp_path / "jax")))
        cli.main()

    load = export_cli.load_litepose

    def fp32(*args, **kw):
        model = load(*args, **kw)
        model.compute_dtype = torch.float32
        return model.fold_bn_()

    got = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(export_cli, "load_litepose", fp32)
        mp.setattr(vis, "draw_skeleton", recorder(vis.draw_skeleton, got))
        capsys.readouterr()
        n = demo.main(_args(inputs, str(tmp_path / "port")) + ["--device", "cpu"])
    assert "host decode:" in capsys.readouterr().out
    assert n == len(NAMES) == len(got) == len(want)
    assert sum(len(p) for p in want) > 0
    for want_img, got_img in zip(want, got):
        assert len(got_img) == len(want_img)
        for a, b in zip(got_img, want_img):
            assert a.shape == b.shape
            np.testing.assert_allclose(a[:, :2], b[:, :2], atol=1e-3, rtol=0)
            np.testing.assert_allclose(a[:, 2:], b[:, 2:], atol=1e-4, rtol=0)
    assert sorted(os.listdir(tmp_path / "port")) == [name + ".png" for name in NAMES]
