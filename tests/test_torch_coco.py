"""The port's COCO annotation IO and OKS evaluation against the JAX
package's: the polygon fill against ``cv2.fillPoly`` pixel for pixel (the
JAX ``polygons_to_mask`` calls it), the RLE decoder, the annotation index
and its ignore masks on ``make_fixture`` data, and every
``KeypointEvaluator`` stat on seeded scenes in both the COCO and the
CrowdPose style."""

import numpy as np
import pytest

from litepose_tpu_torch.data import coco_io
from litepose_tpu_torch.data.eval_oks import (COCO_SIGMAS, CROWDPOSE_SIGMAS,
                                              KeypointEvaluator)


def _polygons(rng, kind, h, w):
    """Seeded int32 contours of one kind on an (h, w) image."""
    if kind == "convex":  # a regular polygon, jittered radius kept convex
        n = int(rng.integers(3, 9))
        c = rng.uniform(0, [w, h])
        r = rng.uniform(2, max(h, w) / 2)
        ang = np.sort(rng.uniform(0, 2 * np.pi, n))
        return [np.stack([c[0] + r * np.cos(ang), c[1] + r * np.sin(ang)], 1).round()
                .astype(np.int32)]
    if kind == "concave":  # a star: radii alternate
        n = 2 * int(rng.integers(3, 7))
        c = rng.uniform(0, [w, h])
        r = np.where(np.arange(n) % 2, rng.uniform(2, 6), rng.uniform(8, max(h, w, 16) / 2))
        ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
        return [np.stack([c[0] + r * np.cos(ang), c[1] + r * np.sin(ang)], 1).round()
                .astype(np.int32)]
    if kind == "self_touching":  # a bow tie, and two squares sharing a corner
        x, y = rng.integers(0, [w, h])
        s = int(rng.integers(3, 15))
        return [np.array([[x, y], [x + s, y + s], [x + s, y], [x, y + s]], np.int32),
                np.array([[x, y], [x + s, y], [x + s, y + s], [x + 2 * s, y + s],
                          [x + 2 * s, y + 2 * s], [x + s, y + 2 * s], [x + s, y + s],
                          [x, y + s]], np.int32)]
    if kind == "off_image":  # vertices up to 30 px outside, several contours
        return [rng.integers(-30, [w + 30, h + 30], (int(rng.integers(3, 12)), 2))
                .astype(np.int32) for _ in range(int(rng.integers(1, 4)))]
    if kind == "one_point":
        return [rng.integers(-5, [w + 5, h + 5], (1, 2)).astype(np.int32)]
    assert kind == "two_points"
    return [rng.integers(-20, [w + 20, h + 20], (2, 2)).astype(np.int32)]


KINDS = ["convex", "concave", "self_touching", "off_image", "one_point", "two_points"]


@pytest.mark.parametrize("kind", KINDS)
def test_fill_poly_equals_cv2(kind):
    import cv2

    rng = np.random.default_rng(KINDS.index(kind))
    for _ in range(300):
        h, w = int(rng.integers(1, 80)), int(rng.integers(1, 80))
        contours = _polygons(rng, kind, h, w)
        want = np.zeros((h, w), np.uint8)
        cv2.fillPoly(want, contours, 1)
        got = coco_io.fill_poly(np.zeros((h, w), np.uint8), contours, 1)
        assert np.array_equal(got, want), (kind, h, w, [c.tolist() for c in contours])


def test_polygons_to_mask_equals_jax():
    """Float COCO polygons, rounded as the JAX function rounds them; fewer
    than 3 points are dropped before the fill."""
    from litepose_tpu.data.coco_io import polygons_to_mask as j_polygons_to_mask

    rng = np.random.default_rng(7)
    for _ in range(100):
        h, w = int(rng.integers(20, 120)), int(rng.integers(20, 120))
        polys = [list(rng.uniform(-10, max(h, w) + 10, 2 * int(rng.integers(1, 9))))
                 for _ in range(int(rng.integers(1, 4)))]
        np.testing.assert_array_equal(coco_io.polygons_to_mask(polys, h, w),
                                      j_polygons_to_mask(polys, h, w))


def _compressed_rle(mask: np.ndarray) -> str:
    """COCO's compressed RLE string of a mask (pycocotools' rleToString)."""
    flat = np.asarray(mask, np.uint8).T.reshape(-1)
    counts, val, run = [], 0, 0
    for v in flat:
        if v == val:
            run += 1
        else:
            counts.append(run)
            val, run = int(v), 1
    counts.append(run)
    out = []
    for i, x in enumerate(counts):
        if i > 2:
            x -= counts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            out.append(chr(c + 48))
    return "".join(out)


def test_rle_decoding_equals_jax():
    from litepose_tpu.data.coco_io import rle_decode_counts as j_rle_decode_counts
    from litepose_tpu.data.coco_io import rle_to_mask as j_rle_to_mask

    rng = np.random.default_rng(3)
    for _ in range(30):
        h, w = int(rng.integers(1, 40)), int(rng.integers(1, 40))
        mask = (rng.random((h, w)) < rng.uniform(0.1, 0.9)).astype(np.uint8)
        s = _compressed_rle(mask)
        rle = {"size": [h, w], "counts": s}
        got = coco_io.rle_to_mask(rle)
        np.testing.assert_array_equal(got, mask)
        np.testing.assert_array_equal(got, j_rle_to_mask(rle))
        assert coco_io.rle_decode_counts(s) == j_rle_decode_counts(s)


@pytest.fixture(scope="module")
def fixture_ann(tmp_path_factory):
    from litepose_tpu.data.synthetic import make_fixture

    ann, _ = make_fixture(str(tmp_path_factory.mktemp("coco")), num_joints=14, n_images=4,
                          h=120, w=150, seed=2)
    return ann


def test_annotation_index_equals_jax(fixture_ann):
    """The index and the ignore masks (a crowd RLE region and a
    keypoint-less polygon among them) of a make_fixture set."""
    from litepose_tpu.data.coco_io import CocoAnnotations as JCoco

    got, want = coco_io.CocoAnnotations(fixture_ann), JCoco(fixture_ann)
    assert got.image_ids == want.image_ids
    assert got.imgs == want.imgs and got.anns == want.anns and got.cats == want.cats
    for i in want.image_ids:
        assert got.annotations_for(i) == want.annotations_for(i)
        assert got.image_info(i) == want.image_info(i)
        np.testing.assert_array_equal(got.ignore_mask(i), want.ignore_mask(i))
    assert any(not want.ignore_mask(i).all() for i in want.image_ids)


# -- OKS evaluation: the scene generator of tests/test_eval_oracle.py ---------


class FakeGT:
    def __init__(self, gts_by_img, infos=None):
        self._g = gts_by_img
        self._i = infos or {}

    @property
    def image_ids(self):
        return sorted(self._g.keys())

    def annotations_for(self, iid):
        return self._g[iid]

    def image_info(self, iid):
        return self._i.get(iid, {})


def _rand_scene(rng, k, n_imgs):
    gts_by_img, dts_by_img, results = {}, {}, []
    for iid in range(1, n_imgs + 1):
        n_gt = int(rng.integers(0, 6))
        gts = []
        for _ in range(n_gt):
            cx, cy = rng.uniform(20, 180, 2)
            spread = rng.uniform(5, 40)
            xs = cx + rng.normal(0, spread, k)
            ys = cy + rng.normal(0, spread, k)
            vs = rng.choice([0, 1, 2], k, p=[0.25, 0.35, 0.4])
            if rng.random() < 0.1:
                vs[:] = 0  # fully invisible person
            kp = np.stack([xs, ys, vs], 1).reshape(-1).astype(np.float64)
            w, h = rng.uniform(10, 150, 2)
            # cover all three area buckets, incl. boundary-ish values
            area = float(rng.choice([w * h, 20.0**2, 50.0**2, 120.0**2]))
            gts.append({
                "keypoints": kp.tolist(),
                "area": area,
                "bbox": [cx - w / 2, cy - h / 2, w, h],
                "iscrowd": int(rng.random() < 0.12),
                "num_keypoints": int(np.count_nonzero(vs > 0)),
            })
        n_dt = int(rng.integers(0, 9))
        dts = []
        for _ in range(n_dt):
            if gts and rng.random() < 0.6:
                # perturbation of a random gt -> plausible match
                g = np.asarray(gts[int(rng.integers(len(gts)))]["keypoints"])
                g = g.reshape(-1, 3).copy()
                g[:, :2] += rng.normal(0, rng.uniform(0.5, 15), (k, 2))
                g[:, 2] = rng.uniform(0.1, 1.0, k)
                kp = g.reshape(-1)
            else:
                kp = np.stack([
                    rng.uniform(0, 200, k), rng.uniform(0, 200, k),
                    rng.uniform(0.1, 1.0, k),
                ], 1).reshape(-1)
            # quantize scores to force ties
            score = round(float(rng.uniform(0.05, 1.0)), 1)
            dts.append({"keypoints": kp.tolist(), "score": score})
            results.append({"image_id": iid, "keypoints": kp.tolist(), "score": score})
        gts_by_img[iid] = gts
        dts_by_img[iid] = dts
    return gts_by_img, dts_by_img, results


@pytest.mark.parametrize("style", ["coco", "crowdpose"])
@pytest.mark.parametrize("seed", range(4))
def test_keypoint_evaluator_equals_jax(style, seed):
    """Every stat as a float, equal: the area buckets (COCO) and the
    crowdIndex buckets with their 0.1 / 0.8 edges (CrowdPose)."""
    from litepose_tpu.data.eval_oks import KeypointEvaluator as JEvaluator

    rng = np.random.default_rng(500 + seed)
    k = len(COCO_SIGMAS if style == "coco" else CROWDPOSE_SIGMAS)
    for _ in range(4):
        gts_by_img, _, results = _rand_scene(rng, k, int(rng.integers(1, 8)))
        infos = {i: {"crowdIndex": float(rng.choice([0.0, 0.05, 0.1, 0.3, 0.8, 0.9]))}
                 for i in gts_by_img}
        gt = FakeGT(gts_by_img, infos)
        got = KeypointEvaluator(gt, style=style).evaluate(results)
        want = JEvaluator(gt, style=style).evaluate(results)
        assert list(got) == list(want)
        for key in want:
            assert got[key] == want[key], (style, seed, key)
