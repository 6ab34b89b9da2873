"""The demo CLI (``tools/demo.py``) against the JAX package's
``tools/demo.py`` (loaded by path): on 3 fixture JPEGs at 128 px with the
trained Auto-XS weights (at 64 px they find no person in these images), both in fp32 (the JAX policy patched to
``Policy.exact()``, the port's convs to float32), the people each draws
(``draw_skeleton`` patched in each package to record them) agree within
the engine tolerance of ``tests/test_torch_engine.py``; the PNGs are the
port's drawing of those people.  Video files, cameras and ``--live``
raise before any work."""

import importlib.util
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from litepose_tpu_torch.tools import demo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "litepose_tpu_torch", "assets", "eval_fixture")
CKPT_XS = os.path.join(REPO, "assets", "bench_ckpt_xs.msgpack")
NAMES = ("000000", "000001", "000002")
SIZE = 128


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("demo_in")
    for name in NAMES:
        shutil.copy(os.path.join(FIXTURE, name + ".jpg"), d)
    (d / "notes.txt").write_text("not an image")
    return str(d)


def _args(input_dir, out):
    return ["--weights", CKPT_XS, "--arch", "auto-XS", "--input-size", str(SIZE),
            "--input", input_dir, "--output", out]


@pytest.fixture(scope="module")
def jax_people(inputs, tmp_path_factory):
    import jax

    import litepose_tpu.models.litepose as jlitepose
    import litepose_tpu.utils.vis as jvis
    from litepose_tpu.models.layers import Policy

    spec = importlib.util.spec_from_file_location("jax_demo_cli",
                                                  os.path.join(REPO, "tools", "demo.py"))
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    drawn = []
    apply_litepose, draw = jlitepose.apply_litepose, jvis.draw_skeleton

    def exact(*args, **kw):
        return apply_litepose(*args, **dict(kw, policy=Policy.exact()))

    def record(image, people, dataset="CROWDPOSE", **kw):
        drawn.append([np.array(p) for p in people])
        return draw(image, people, dataset, **kw)

    mp = pytest.MonkeyPatch()
    mp.setenv("LITEPOSE_XLA_CACHE", jax.config.jax_compilation_cache_dir or "")
    mp.setattr(jlitepose, "apply_litepose", exact)
    mp.setattr(jvis, "draw_skeleton", record)
    out = str(tmp_path_factory.mktemp("jax_demo"))
    mp.setattr(sys, "argv", ["demo.py"] + _args(inputs, out) + ["--backend", "tpu"])
    try:
        cli.main()
    finally:
        mp.undo()
    return drawn


@pytest.fixture(scope="module")
def port_run(inputs, tmp_path_factory):
    from litepose_tpu_torch.tools import export as export_cli
    from litepose_tpu_torch.utils import vis

    drawn = []
    load, draw = export_cli.load_litepose, vis.draw_skeleton

    def fp32(*args, **kw):
        model = load(*args, **kw)
        model.compute_dtype = torch.float32
        return model.fold_bn_()

    def record(image, people, dataset="CROWDPOSE", **kw):
        drawn.append([np.array(p) for p in people])
        return draw(image, people, dataset, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(export_cli, "load_litepose", fp32)
    mp.setattr(vis, "draw_skeleton", record)
    out = str(tmp_path_factory.mktemp("port_demo"))
    try:
        n = demo.main(_args(inputs, out) + ["--device", "cpu"])
    finally:
        mp.undo()
    return n, drawn, out


def test_demo_matches_jax(jax_people, port_run):
    n, got, _ = port_run
    assert n == len(NAMES) == len(got) == len(jax_people)
    assert sum(len(p) for p in jax_people) > 0
    for want_img, got_img in zip(jax_people, got):
        assert len(got_img) == len(want_img)
        for a, b in zip(got_img, want_img):
            assert a.shape == b.shape
            np.testing.assert_allclose(a[:, :2], b[:, :2], atol=1e-3, rtol=0)
            np.testing.assert_allclose(a[:, 2:], b[:, 2:], atol=1e-4, rtol=0)


def test_demo_writes_pngs(inputs, port_run, capsys):
    from litepose_tpu_torch.data.jpeg import decode_jpeg
    from litepose_tpu_torch.utils import vis

    _, drawn, out = port_run
    assert sorted(os.listdir(out)) == [name + ".png" for name in NAMES]
    for name, people in zip(NAMES, drawn):
        square = demo.center_crop_square(decode_jpeg(os.path.join(inputs, name + ".jpg")), SIZE)
        np.testing.assert_array_equal(vis.read_png(os.path.join(out, name + ".png")),
                                      vis.draw_skeleton(square, people))


def test_center_crop_square_is_cv2s():
    cv2 = pytest.importorskip("cv2")
    image = np.random.default_rng(0).integers(0, 255, (90, 131, 3), dtype=np.uint8)
    np.testing.assert_array_equal(demo.center_crop_square(image, 64),
                                  cv2.resize(image[:, 20:110], (64, 64)))


@pytest.mark.parametrize("extra", [["--input", "clip.mp4"], ["--input", "0"],
                                   ["--input", "camera"], ["--input", "x.jpg", "--live"],
                                   ["--input", "x.jpg", "--no-display"],
                                   ["--input", "x.jpg", "--max-frames", "5"]])
def test_video_camera_and_live_raise(extra, tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP M11"):
        demo.main(["--output", str(tmp_path / "o"), "--device", "cpu", *extra])
    assert not (tmp_path / "o").exists()


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_default_device_raises_without_a_card(inputs, tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        demo.main(["--input", inputs, "--output", str(tmp_path / "o")])
