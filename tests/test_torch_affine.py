"""The port's cv2-free affine module against ``litepose_tpu.data.affine``:
the resize ladder, the transforms and the inverse projection equal, and
``warp_image`` (numpy) equals ``cv2.warpAffine`` pixel for pixel on the
ladder's matrices."""

import numpy as np
import pytest

from litepose_tpu_torch.data import affine

# source sizes: landscape, portrait, square, tiny, very wide
SHAPES = [(100, 140), (140, 100), (90, 90), (33, 47), (64, 400), (480, 640)]


@pytest.fixture(scope="module")
def jaffine():
    pytest.importorskip("cv2")  # the JAX package's data module imports cv2
    from litepose_tpu.data import affine as jaffine

    return jaffine


@pytest.mark.parametrize("input_size", [128, 448, 512])
@pytest.mark.parametrize("scale_factor,min_scale", [(1.0, 1.0), (0.5, 0.5), (1.0, 0.5), (2.0, 1.0)])
def test_ladder_and_transforms_match(jaffine, input_size, scale_factor, min_scale):
    rng = np.random.default_rng(input_size)
    for hw in SHAPES:
        want = jaffine.get_multi_scale_size(hw, input_size, scale_factor, min_scale)
        got = affine.get_multi_scale_size(hw, input_size, scale_factor, min_scale)
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
        size, center, scale = got
        for inv in (False, True):
            np.testing.assert_array_equal(
                affine.get_affine_transform(center, scale, 0, size, inv=inv),
                jaffine.get_affine_transform(center, scale, 0, size, inv=inv))
        people = rng.uniform(0, 100, (3, 14, 5)).astype(np.float32)
        hm = (size[0] // 2, size[1] // 2)
        for a, b in zip(affine.get_final_preds(people, center, scale, hm),
                        jaffine.get_final_preds(people, center, scale, hm)):
            np.testing.assert_array_equal(a, b)
        pts = rng.uniform(-50, 500, (7, 2))
        mat = affine.get_affine_transform(center, scale, 0, size)
        np.testing.assert_array_equal(affine.affine_transform_points(pts, mat),
                                      jaffine.affine_transform_points(pts, mat))


def test_rotated_transform_matches(jaffine):
    for rot in (-30.0, 15.0, 90.0):
        np.testing.assert_array_equal(
            affine.get_affine_transform(np.array([50.0, 40.0]), np.array([0.6, 0.8]), rot,
                                        (96, 128), shift=(0.1, -0.05)),
            jaffine.get_affine_transform(np.array([50.0, 40.0]), np.array([0.6, 0.8]), rot,
                                         (96, 128), shift=(0.1, -0.05)))


@pytest.mark.parametrize("input_size", [128, 448])
@pytest.mark.parametrize("scale_factor,min_scale", [(1.0, 1.0), (0.5, 0.5), (2.0, 1.0)])
def test_warp_image_matches_cv2(input_size, scale_factor, min_scale):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(input_size + int(10 * scale_factor))
    for hw in SHAPES:
        img = rng.integers(0, 256, hw + (3,), dtype=np.uint8)
        size, center, scale = affine.get_multi_scale_size(hw, input_size, scale_factor,
                                                          min_scale)
        mat = affine.get_affine_transform(center, scale, 0, size)
        want = cv2.warpAffine(img, mat.astype(np.float64), (int(size[0]), int(size[1])))
        got = affine.warp_image(img, mat, size)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want, err_msg=f"source {hw} -> {size}")


def test_warp_image_rotated_and_gray_match_cv2():
    """Away from the ladder: rotations, shifts and a single-channel image."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(5)
    for rot in (-35.0, 12.5, 90.0):
        img = rng.integers(0, 256, (70, 90), dtype=np.uint8)
        mat = affine.get_affine_transform(np.array([45.0, 35.0]), np.array([0.4, 0.3]), rot,
                                          (61, 53), shift=(0.05, 0.1))
        np.testing.assert_array_equal(affine.warp_image(img, mat, (61, 53)),
                                      cv2.warpAffine(img, mat, (61, 53)))


def test_fma32_rounds_once():
    """a * b + c with one rounding.  With c = 1 + 2^-23 and a * b = 2^-24 -
    2^-70, the float64 sum rounds onto the float32 midpoint 1 + 3 * 2^-24,
    whose tie would go up to the even 1 + 2^-22; the exact value lies below
    the midpoint, so one rounding gives c."""
    a = np.float32(1.0 + 2.0 ** -23)
    b = np.float32(2.0 ** -24 - 2.0 ** -47)
    c = np.float32(1.0 + 2.0 ** -23)
    naive = (np.float64(a) * np.float64(b) + np.float64(c)).astype(np.float32)
    assert naive == np.float32(1.0 + 2.0 ** -22)
    assert affine._fma32(a, b, c) == c
    assert affine._fma32(np.float32(1.0), np.float32(2.0 ** -24), np.float32(1.0)) == 1.0
