"""``utils/vis.py`` without cv2 against the JAX package's ``utils/vis.py``
(which calls cv2 on this host): the ``VIS_CONFIG`` copy, ``draw_skeleton``
pixel for pixel on seeded people (points off the canvas, lines clipped at
its edges), ``cv2.line`` / ``cv2.circle`` themselves on random segments and
discs, the heatmap and tag-map grids, and PNG round trips."""

import numpy as np
import pytest

from litepose_tpu_torch.utils import vis

cv2 = pytest.importorskip("cv2")


def test_vis_config_copy_equals_original():
    from litepose_tpu.data import VIS_CONFIG as J_VIS_CONFIG
    from litepose_tpu.utils.vis import _colors as j_colors
    from litepose_tpu_torch.data import VIS_CONFIG

    assert VIS_CONFIG == J_VIS_CONFIG
    for n in (1, 7, 40):
        assert vis._colors(n) == j_colors(n)


def _people(rng, n, K, h, w):
    """Joints scattered beyond the canvas on every side, scores in [0, 1)."""
    xy = rng.uniform(-0.3, 1.3, (n, K, 2)) * np.array([w, h])
    return [np.concatenate([xy[i], rng.uniform(0, 1, (K, 1)), rng.normal(0, 1, (K, 2))], 1)
            .astype(np.float32) for i in range(n)]


@pytest.mark.parametrize("dataset,K", [("CROWDPOSE", 14), ("COCO", 17)])
@pytest.mark.parametrize("hw", [(448, 448), (97, 130), (300, 211)])
def test_draw_skeleton_matches_jax(dataset, K, hw):
    from litepose_tpu.utils.vis import draw_skeleton as j_draw

    rng = np.random.default_rng(hw[0] * 7 + K)
    image = rng.integers(0, 255, (*hw, 3), dtype=np.uint8)
    people = _people(rng, 10, K, *hw)
    got = vis.draw_skeleton(image, people, dataset)
    np.testing.assert_array_equal(got, j_draw(image, people, dataset))
    assert (got != image).any()
    np.testing.assert_array_equal(vis.draw_skeleton(image, [], dataset), image)


@pytest.mark.parametrize("thickness", [2, 3, 4, 7])
def test_line_equals_cv2(thickness):
    rng = np.random.default_rng(thickness)
    for _ in range(150):
        h, w = (int(v) for v in rng.integers(3, 60, 2))
        a = tuple(int(v) for v in rng.integers(-30, 90, 2))
        b = tuple(int(v) for v in rng.integers(-30, 90, 2))
        color = tuple(int(c) for c in rng.integers(0, 256, 3))
        want = np.zeros((h, w, 3), np.uint8)
        got = want.copy()
        cv2.line(want, a, b, color, thickness)
        vis.line(got, a, b, color, thickness)
        np.testing.assert_array_equal(got, want, err_msg=f"{(h, w)} {a} {b}")


def test_circle_equals_cv2():
    rng = np.random.default_rng(0)
    for _ in range(300):
        h, w = (int(v) for v in rng.integers(1, 40, 2))
        center = tuple(int(v) for v in rng.integers(-10, 50, 2))
        radius = int(rng.integers(0, 9))
        want = np.zeros((h, w, 3), np.uint8)
        got = want.copy()
        cv2.circle(want, center, radius, (3, 2, 1), -1)
        vis.circle(got, center, radius, (3, 2, 1))
        np.testing.assert_array_equal(got, want, err_msg=f"{(h, w)} {center} {radius}")


def test_grids_match_jax():
    from litepose_tpu.utils import vis as jvis

    rng = np.random.default_rng(1)
    image = rng.integers(0, 255, (100, 120, 3), dtype=np.uint8)
    heat = rng.uniform(-0.2, 1.2, (4, 50, 60)).astype(np.float32)
    np.testing.assert_array_equal(vis.make_heatmaps_grid(image, heat),
                                  jvis.make_heatmaps_grid(image, heat))
    tags = rng.normal(0, 2, (4, 37, 41, 2)).astype(np.float32)
    np.testing.assert_array_equal(vis.make_tagmaps_grid(image, tags),
                                  jvis.make_tagmaps_grid(image, tags))


def test_png_round_trip(tmp_path):
    rng = np.random.default_rng(2)
    image = rng.integers(0, 255, (37, 53, 3), dtype=np.uint8)
    path = str(tmp_path / "a.png")
    vis.write_png(path, image)
    np.testing.assert_array_equal(vis.read_png(path), image)
    np.testing.assert_array_equal(cv2.imread(path)[..., ::-1], image)
    vis.write_png(str(tmp_path / "g.png"), image[..., 0])
    np.testing.assert_array_equal(vis.read_png(str(tmp_path / "g.png")), image[..., 0])
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "g.png"), cv2.IMREAD_UNCHANGED),
                                  image[..., 0])


def test_saved_images(tmp_path):
    rng = np.random.default_rng(3)
    image = rng.integers(0, 255, (64, 48, 3), dtype=np.uint8)
    people = _people(rng, 3, 14, 64, 48)
    canvas = vis.save_valid_image(image, people, str(tmp_path / "v.png"))
    np.testing.assert_array_equal(vis.read_png(str(tmp_path / "v.png")), canvas)
    heat = rng.uniform(0, 1, (2, 16, 12)).astype(np.float32)
    vis.save_debug_images(image, str(tmp_path / "d"), heat, heat, heat[..., None])
    for name in ("hm_gt", "hm_pred", "tag_pred"):
        assert vis.read_png(str(tmp_path / f"d_{name}.png")).shape == (16, 12 * 3, 3)
