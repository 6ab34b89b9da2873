"""Stage aggregation, flip test and projection: the port's ``make_infer_fn``
against the JAX ``make_infer_fn(decode_layout=True)`` at fp32.

A one-block-per-stage arch keeps the JAX compile short; what is under test
is the glue around the forward (normalization, upsampling, averaging, flip
and channel permutation, tag stacking, projection).  Bound: the model
test's fp32 bound (atol 2e-4, rtol 1e-3), since the forward differs by
convolution summation order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from litepose_tpu.arch.schema import ArchConfig, StageConfig
from litepose_tpu.core.inference import InferenceFlags as JFlags
from litepose_tpu.core.inference import make_infer_fn as j_make_infer_fn
from litepose_tpu.core.inference import normalize_images as j_normalize_images
from litepose_tpu.models.layers import Policy
from litepose_tpu.models.litepose import ModelSpec as JSpec
from litepose_tpu.models.litepose import apply_litepose, init_litepose

from litepose_tpu_torch.core.inference import InferenceFlags, make_infer_fn, normalize_images
from litepose_tpu_torch.data.flip import flip_index_for
from litepose_tpu_torch.models.convert import litepose_from_jax
from litepose_tpu_torch.models.litepose import ModelSpec
from test_torch_arch import port_arch

ARCH = ArchConfig(
    img_size=64, input_channel=8, deconv_setting=(8, 8, 8),
    backbone_setting=tuple(
        StageConfig(num_blocks=1, stride=s, channel=c, block_setting=((6, 7),))
        for s, c in zip((2, 2, 2, 1), (8, 16, 16, 24))))
HW = (64, 96)

# (flip_test, flip_mode, project, ignore_center, tag_per_joint)
CASES = {
    "plain": (False, "concat", False, False, True),
    "project": (False, "concat", True, False, True),
    "flip_concat": (True, "concat", False, False, True),
    "flip_twopass_project": (True, "twopass", True, False, True),
    "flip_ignore_center_project": (True, "concat", True, True, True),
    "flip_one_tag_channel": (True, "concat", False, False, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_infer_matches_jax(case):
    torch.backends.cudnn.allow_tf32 = False
    flip, mode, project, center, per_joint = CASES[case]
    nj = 15 if center else 14
    jspec = JSpec(num_joints=nj, tag_per_joint=per_joint)
    params, state = init_litepose(jax.random.PRNGKey(list(CASES).index(case)),
                                  jspec, ARCH)
    rng = np.random.default_rng(0)
    state = jax.tree_util.tree_map(
        lambda v: rng.uniform(0.5, 1.5, v.shape).astype(np.float32), state)
    flag_args = dict(
        num_joints=nj, with_heatmaps_loss=(True, True), with_ae_loss=(True, False),
        test_with_heatmaps=(True, True), test_with_ae=(True, False),
        tag_per_joint=per_joint, flip_test=flip, ignore_center=center,
        flip_index=tuple(flip_index_for("crowd_pose", with_center=center)),
        flip_mode=mode)
    project_hw = HW if project else None
    images = rng.integers(0, 256, (2, *HW, 3), dtype=np.uint8)

    def apply_fn(p, s, x):
        return apply_litepose(p, s, x, jspec, ARCH, policy=Policy.exact())[0]

    j_infer = jax.jit(j_make_infer_fn(apply_fn, JFlags(**flag_args),
                                      project_hw=project_hw, decode_layout=True))
    want_det, want_tag = j_infer(params, state, images)

    model = litepose_from_jax(params, state,
                              ModelSpec(num_joints=nj, tag_per_joint=per_joint),
                              port_arch(ARCH), compute_dtype=torch.float32)
    infer = make_infer_fn(model, InferenceFlags(**flag_args), project_hw=project_hw)
    with torch.no_grad():
        det, tag = infer(torch.from_numpy(images))

    out_hw = HW if project else (HW[0] // 2, HW[1] // 2)
    n_tag = 2 if flip else 1
    assert tuple(det.shape) == (2, nj - center, *out_hw)
    assert tuple(tag.shape) == (2, (nj - center) if per_joint else 1, n_tag, *out_hw)
    np.testing.assert_allclose(det.numpy(), np.asarray(want_det), atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(tag.numpy(), np.asarray(want_tag), atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_normalize_images_matches_jax(dtype):
    """Same constants and rounding; bf16 rounds the product and the sum
    separately in torch, once in XLA's fused fp32 chain: one bf16 step."""
    images = np.random.default_rng(0).integers(0, 256, (2, 8, 8, 3), dtype=np.uint8)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = np.asarray(j_normalize_images(jnp.asarray(images), jdt).astype(jnp.float32))
    got = normalize_images(torch.from_numpy(images), dtype).float().numpy()
    want = want.transpose(0, 3, 1, 2)
    if dtype == torch.float32:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=2 ** -7)


@pytest.mark.parametrize("in_hw,out_hw", [((64, 96), (32, 40)), ((30, 40), (30, 17)),
                                          ((20, 24), (48, 64)), ((64, 64), (200, 20))])
def test_resize_bilinear_matches_jax_resize(in_hw, out_hw):
    """``jax.image.resize(..., "bilinear")`` antialiases a downsampled axis
    (a triangle kernel widened by the ratio) and interpolates an upsampled
    one; the port's resize does the same.  fp32 on N(0, 1) inputs, summed
    in another order (``F.interpolate`` when upsampling, two weight-matrix
    products when downsampling): within 1e-5 (4.5e-6 seen)."""
    from litepose_tpu_torch.core.inference import resize_bilinear

    x = np.random.default_rng(sum(in_hw + out_hw)).standard_normal((2, 3) + in_hw)
    x = x.astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 3) + out_hw, "bilinear"))
    got = resize_bilinear(torch.from_numpy(x), out_hw).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_flip_tables_match_jax():
    pytest.importorskip("cv2")  # the JAX package's data module imports cv2
    from litepose_tpu.data.flip import flip_index_for as j_flip_index_for

    for dataset in ("coco_kpt", "crowd_pose_kpt", "crowdpose"):
        for with_center in (False, True):
            assert flip_index_for(dataset, with_center) == j_flip_index_for(dataset, with_center)
    with pytest.raises(ValueError):
        flip_index_for("mpii")
