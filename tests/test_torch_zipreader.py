"""``litepose_tpu_torch.utils.zipreader`` against the JAX package's
``utils/zipreader.py`` on the committed fixture's JPEGs zipped in a
temporary directory: ``imread`` gives JAX's ``cv2.imdecode(...,
IMREAD_COLOR)`` bit for bit (BGR, the EXIF-rotated file turned as cv2
turns it), the path helpers give JAX's answers, a non-JPEG member raises
``ValueError`` naming the path, and the handles are cached until
``close_all``."""

import glob
import os
import zipfile

import numpy as np
import pytest

from litepose_tpu_torch.utils import zipreader

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "litepose_tpu_torch", "assets", "eval_fixture")
JPEGS = sorted(glob.glob(os.path.join(FIXTURE, "*.jpg")))


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    """The fixture's 12 JPEGs under ``images/``, and a PNG."""
    from litepose_tpu_torch.utils import vis

    d = tmp_path_factory.mktemp("zip")
    png = str(d / "mark.png")
    vis.write_png(png, np.zeros((4, 6, 3), np.uint8))
    path = str(d / "fixture.zip")
    with zipfile.ZipFile(path, "w") as z:
        for f in JPEGS:
            z.write(f, "images/" + os.path.basename(f))
        z.write(png, "images/mark.png")
    yield path
    zipreader.close_all()


@pytest.mark.parametrize("jpeg", JPEGS, ids=os.path.basename)
def test_imread_equals_jax(archive, jpeg):
    from litepose_tpu.utils import zipreader as jzip

    from litepose_tpu_torch.data.jpeg import decode_jpeg

    path = f"{archive}@images/{os.path.basename(jpeg)}"
    got, want = zipreader.imread(path), jzip.imread(path)
    assert got.dtype == np.uint8 and got.flags.c_contiguous
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[..., ::-1], decode_jpeg(jpeg))
    jzip.close_all()


def test_helpers_equal_jax(archive):
    from litepose_tpu.utils import zipreader as jzip

    for p in (f"{archive}@images/000000.jpg", "plain/000000.jpg", "a.zip", "x@y.jpg",
              "dir.zip/x@y", "a.zip@b@c.jpg"):
        assert zipreader.is_zip_path(p) == jzip.is_zip_path(p), p
    for p in (f"{archive}@images/000000.jpg", "a.zip@b@c.jpg"):
        assert zipreader.split_zip_path(p) == jzip.split_zip_path(p)
    with pytest.raises(AssertionError, match="not a zip archive"):
        zipreader.split_zip_path("a.tar@b.jpg")
    path = f"{archive}@images/000003.jpg"
    assert zipreader.read_bytes(path) == jzip.read_bytes(path) == open(
        os.path.join(FIXTURE, "000003.jpg"), "rb").read()
    jzip.close_all()


def test_handles_cached_until_close_all(archive):
    zipreader.close_all()
    zipreader.read_bytes(f"{archive}@images/000001.jpg")
    handle = zipreader._handles[archive]
    zipreader.imread(f"{archive}@images/000002.jpg")
    assert zipreader._handles[archive] is handle
    zipreader.close_all()
    assert zipreader._handles == {} and handle.fp is None
    with pytest.raises(KeyError):
        zipreader.read_bytes(f"{archive}@images/missing.jpg")


def test_png_member_raises_naming_the_path(archive):
    path = f"{archive}@images/mark.png"
    with pytest.raises(ValueError, match=f"{path}: not a JPEG file"):
        zipreader.imread(path)
