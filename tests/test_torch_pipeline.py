"""The port's training input pipeline against ``litepose_tpu.data.dataset``.

Both pipelines read the decoded images, annotations and ignore masks of one
JAX ``make_fixture`` set (a crowd RLE region and a keypoint-less polygon
included); ``TrainPipeline.get`` must agree bit for bit (image, masks,
heatmaps, joint indices) over several epochs and items, so over random
scales, rotations, translations and flips, under four configurations; and
``make_batch_iterator`` must give the same order and stacks, host sharding
included.  The in-memory ``SyntheticSource`` must draw ``make_fixture``'s
people."""

import json

import numpy as np
import pytest

from litepose_tpu_torch.data import dataset as tds
from litepose_tpu_torch.data.synthetic import SyntheticSource

VARIANTS = {
    "default": {},
    "scale_aware": {"SCALE_AWARE_SIGMA": True, "INT_SIGMA": True},
    "center_long": {"WITH_CENTER": True, "NUM_JOINTS": 15, "SCALE_TYPE": "long"},
    "no_flip_no_tags": {"FLIP": 0.0, "MAX_TRANSLATE": 0, "TAG_PER_JOINT": False},
}


@pytest.fixture(scope="module")
def fixture_set(tmp_path_factory):
    """(annotation file, image directory) of a 6-image set."""
    from litepose_tpu.data.synthetic import make_fixture

    return make_fixture(str(tmp_path_factory.mktemp("fixture")), num_joints=14, n_images=6,
                        h=160, w=200, seed=0)


class _Decoded:
    """The JAX dataset's decoded items as an in-memory port source."""

    def __init__(self, ds):
        self.items = [ds.load_raw(i) for i in range(len(ds))]
        self.masks = {image_id: ds.coco.ignore_mask(image_id) for _, _, image_id in self.items}

    def __len__(self):
        return len(self.items)

    def load_raw(self, idx):
        img, anno, image_id = self.items[idx]
        return img.copy(), list(anno), image_id

    def ignore_mask(self, image_id):
        return self.masks[image_id]


def _config(variant):
    from litepose_tpu.config import default_config

    cfg = default_config()
    cfg.DATASET.DATASET = "crowd_pose_kpt"
    cfg.DATASET.NUM_JOINTS = 14
    cfg.DATASET.INPUT_SIZE = 128
    cfg.DATASET.OUTPUT_SIZE = [32, 64]
    for k, v in VARIANTS[variant].items():
        if k == "TAG_PER_JOINT":
            cfg.MODEL.TAG_PER_JOINT = v
        else:
            setattr(cfg.DATASET, k, v)
    return cfg


def _pipelines(fixture_set, variant, seed=3):
    from litepose_tpu.data.dataset import PoseDataset, TrainPipeline

    cfg = _config(variant)
    ds = PoseDataset(*fixture_set, cfg.DATASET.NUM_JOINTS, style="crowdpose",
                     with_center=cfg.DATASET.WITH_CENTER)
    return (TrainPipeline(ds, cfg, seed=seed),
            tds.TrainPipeline(_Decoded(ds), tds.PipelineConfig.from_config(cfg), seed=seed))


def _assert_items_equal(got, want, where):
    names = ("image", "heatmaps", "masks", "joints")
    for name, g, w in zip(names, got, want):
        for s, (a, b) in enumerate(zip(g, w) if isinstance(w, list) else [(g, w)]):
            assert a.dtype == b.dtype and a.shape == b.shape, (where, name, s)
            assert np.array_equal(a, b), (where, name, s)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_train_pipeline_get_is_bit_equal(fixture_set, variant):
    jpipe, tpipe = _pipelines(fixture_set, variant)
    masked = 0
    for epoch in range(3):
        for idx in range(len(jpipe)):
            want = jpipe.get(idx, epoch)
            _assert_items_equal(tpipe.get(idx, epoch), want, (variant, epoch, idx))
            masked += int((want[2][0] == 0).any())
    assert masked > 0  # the crowd and keypoint-less regions reach the masks


def test_batch_iterator_order_and_stacks(fixture_set):
    from litepose_tpu.data.dataset import make_batch_iterator as jiter

    jpipe, tpipe = _pipelines(fixture_set, "default")
    for process_index in range(2):
        kw = dict(batch_size=2, epoch=1, process_index=process_index, process_count=2,
                  num_workers=2)
        want, got = list(jiter(jpipe, **kw)), list(tds.make_batch_iterator(tpipe, **kw))
        assert len(got) == len(want) == 1
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            np.testing.assert_array_equal(g["images"], w["images"])
            for key in ("heatmaps", "masks", "joints"):
                for a, b in zip(g[key], w[key]):
                    assert a.dtype == b.dtype
                    np.testing.assert_array_equal(a, b)


def test_batch_iterator_raises_an_item_failure():
    class Broken(SyntheticSource):
        def load_raw(self, idx):
            if idx == 3:
                raise RuntimeError("unreadable item 3")
            return super().load_raw(idx)

    cfg = tds.PipelineConfig(input_size=64, output_sizes=(16, 32), num_joints=14,
                             dataset="crowd_pose_kpt")
    pipe = tds.TrainPipeline(Broken(n_images=6), cfg)
    with pytest.raises(RuntimeError, match="unreadable item 3"):
        list(tds.make_batch_iterator(pipe, 2, epoch=0, shuffle=False, num_workers=2))


def test_synthetic_source_draws_make_fixture_people(tmp_path):
    from litepose_tpu.data.synthetic import make_fixture

    kw = dict(num_joints=14, n_images=5, h=256, w=256, seed=11,
              n_people_range=(2, 6), size_range=(30, 100))
    ann_file, _ = make_fixture(str(tmp_path), with_edge_cases=False, **kw)
    with open(ann_file) as f:
        want = json.load(f)["annotations"]
    src = SyntheticSource(**kw)
    got = [a for i in range(len(src)) for a in src.load_raw(i)[1]]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for key in ("id", "image_id", "num_keypoints", "iscrowd"):
            assert a[key] == b[key], key
        np.testing.assert_allclose(a["keypoints"], b["keypoints"], rtol=0, atol=1e-9)
        np.testing.assert_allclose(a["bbox"], b["bbox"], rtol=0, atol=1e-9)
        np.testing.assert_allclose(a["segmentation"], b["segmentation"], rtol=0, atol=1e-9)
    assert src.ignore_mask(0).all() and src.load_raw(0)[0].shape == (256, 256, 3)
