"""The per-image decode that runs K5: ``top_k_peaks``, ``parse_single``, the
"hwt" tag layout of ``parse_batch`` and ``hungarian``, against the JAX
package.

On the CPU ``top_k_peaks`` must equal JAX's ``top_k_peaks(...,
interpret=False)`` under ``force_tpu_interpret_mode`` (its K5 path) bit for
bit, and on non-negative maps also JAX's default CPU path (XLA NMS);
``parse_single`` must equal JAX's ``parse_single`` (people and counts bit
for bit, scores to 1e-6: a mean over K joints summed in another order);
``parse_batch(tag_layout="hwt")`` must equal the "thw" result and
``hungarian`` JAX's ``hungarian``.  One order difference of JAX's K5 path is
pinned: ``lax.top_k`` ranks +0.0 above -0.0, while K1 and the port rank a
kept -0.0 as +0.0, by flat index.  On the card (marked ``cuda``)
``parse_single`` launches K5, not K1, and equals ``parse_batch`` image by
image.

The machine with the card has no jax: only the fixtures import the JAX
package, so ``pytest --noconftest -m cuda`` runs this file there."""

import numpy as np
import pytest
import torch

from litepose_tpu_torch.ops.group import GroupParams, StaticGroupCfg, parse_batch, parse_single
from litepose_tpu_torch.ops.hungarian import hungarian
from litepose_tpu_torch.ops.nms import nms_suppress, top_k_peaks
from litepose_tpu_torch.ops.topk import nms_topk, nms_topk_ref

K, M = 5, 10  # joints, peaks a joint (= max_people, as the Hungarian decode needs)


@pytest.fixture(scope="module")
def jpeaks():
    """JAX's top_k_peaks on its K5 path (TPU interpret mode) and on its
    default CPU path."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu
    from litepose_tpu.ops.nms import top_k_peaks as j_top_k_peaks

    def k5_path(det, tag, m, kernel):
        with pltpu.force_tpu_interpret_mode():
            out = j_top_k_peaks(jnp.asarray(det), jnp.asarray(tag), m, kernel, kernel // 2,
                                method="exact", interpret=False)
            return [np.asarray(a) for a in out]

    def cpu_path(det, tag, m, kernel):
        out = j_top_k_peaks(jnp.asarray(det), jnp.asarray(tag), m, kernel, kernel // 2,
                            method="exact")
        return [np.asarray(a) for a in out]

    return k5_path, cpu_path


def _group_params(**kw):
    return GroupParams(**{**dict(num_joints=K, max_num_people=M, detection_threshold=0.1,
                                 tag_threshold=1.0), **kw})


def _cfg(assignment):
    return StaticGroupCfg.from_params(_group_params(), assignment=assignment)


def _jcfg(assignment):
    from litepose_tpu.ops.group import StaticGroupCfg as JCfg
    from litepose_tpu.ops.group_ref import GroupParams as JGroupParams

    p = _group_params()
    return JCfg.from_params(JGroupParams(**{f: getattr(p, f) for f in (
        "num_joints", "max_num_people", "detection_threshold", "tag_threshold")}),
        assignment=assignment)


PEAK_CASES = ["random", "ties", "non_square", "few_peaks"]


def _peak_maps(case: str, T: int):
    """det (K, H, W) fp32 and tag (K, H, W, T) for one named case."""
    rng = np.random.default_rng(PEAK_CASES.index(case) + 10 * T)
    H, W = (7, 40) if case == "non_square" else (24, 20)
    tag = rng.standard_normal((K, H, W, T)).astype(np.float32)
    if case == "random":  # negatives: kept negative maxima, suppressed cells +0
        det = rng.standard_normal((K, H, W)).astype(np.float32)
    elif case == "ties":  # tied maxima apart and within one window, a flat plane
        det = (0.5 * rng.random((K, H, W))).astype(np.float32)
        det[0, 3::6, 2::5] = 0.9
        det[1, 10, 10] = det[1, 10, 12] = 0.8
        det[2] = 0.25
    elif case == "non_square":
        det = rng.uniform(0, 1, (K, H, W)).astype(np.float32)
    else:  # fewer than M peaks: the zeros in flat order
        det = np.zeros((K, H, W), np.float32)
        det[:, 4, 4] = 0.9
        det[1:, 15, 12] = 0.5
    return det, tag


def _assert_bits_equal(got, want):
    for g, w in zip(got, want):
        g = g.numpy()
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g.view(np.int32) if g.dtype == np.float32 else g,
                                      w.view(np.int32) if w.dtype == np.float32 else w)


@pytest.mark.parametrize("T", [1, 2])
@pytest.mark.parametrize("kernel", [3, 5])
@pytest.mark.parametrize("case", PEAK_CASES)
def test_top_k_peaks_matches_jax_k5_path(jpeaks, case, kernel, T):
    det, tag = _peak_maps(case, T)
    want = jpeaks[0](det, tag, M, kernel)
    got = top_k_peaks(torch.from_numpy(det), torch.from_numpy(tag), M, kernel, kernel // 2)
    _assert_bits_equal(got, want)
    # "approx" runs the same exact top-M
    approx = top_k_peaks(torch.from_numpy(det), torch.from_numpy(tag), M, kernel, kernel // 2,
                         method="approx")
    assert all(torch.equal(a, b) for a, b in zip(approx, got))


def test_top_k_peaks_matches_jax_k5_path_bf16(jpeaks):
    """bf16 maps: the values come back in bf16, as JAX's do."""
    import jax.numpy as jnp

    det, tag = _peak_maps("random", 2)
    det16 = jnp.asarray(det).astype(jnp.bfloat16)
    want = jpeaks[0](det16, tag, M, 5)
    got = top_k_peaks(torch.from_numpy(np.array(det16.astype(jnp.float32))).bfloat16(),
                      torch.from_numpy(tag), M, 5, 2)
    assert got[2].dtype == torch.bfloat16
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.float().numpy(), np.asarray(w, np.float32))


@pytest.mark.parametrize("kernel", [3, 5, 7])
@pytest.mark.parametrize("case", ["ties", "non_square", "few_peaks"])
def test_top_k_peaks_matches_jax_cpu_path_on_nonnegative_maps(jpeaks, case, kernel):
    """On maps without negatives the XLA NMS of JAX's CPU path writes the
    same +0.0 as K5, so that path gives the same peaks too."""
    det, tag = _peak_maps(case, 2)
    assert (det >= 0).all()
    want = jpeaks[1](det, tag, M, kernel)
    got = top_k_peaks(torch.from_numpy(det), torch.from_numpy(tag), M, kernel, kernel // 2)
    _assert_bits_equal(got, want)


def test_kept_negative_zero_ranks_as_k1_does(jpeaks):
    """A kept -0.0 maximum among +0.0 cells: ``lax.top_k`` after JAX's K5
    ranks every +0.0 above it; the port's top-M ranks it by flat index,
    as K1 (and JAX's fused K1) do."""
    det = np.full((1, 12, 12), -1.0, np.float32)
    det[0, 2, 2] = -0.0  # kept: -0.0 == the window max +-0.0; its neighbours +0.0
    det[0, 9, 9] = 0.0
    tag = np.zeros((1, 12, 12, 1), np.float32)
    m = 18  # the 18 zeros: two kept maxima and 16 suppressed neighbours
    got = top_k_peaks(torch.from_numpy(det), torch.from_numpy(tag), m, 3, 1)
    k1_v, k1_p = nms_topk_ref(torch.from_numpy(det)[None], m, 3)
    assert torch.equal(got[2].view(torch.int32), k1_v[0].view(torch.int32))
    x, y = got[1][0, :, 0].long(), got[1][0, :, 1].long()
    assert torch.equal(y * 12 + x, k1_p[0, 0].long())
    assert torch.equal(k1_p[0, 0], k1_p[0, 0].sort().values)  # flat order
    _, loc_j, val_j = jpeaks[0](det, tag, m, 3)
    assert np.signbit(val_j[0, -1]) and not np.signbit(val_j[0, :-1]).any()
    assert (loc_j[0, -1] == (2, 2)).all()
    assert np.signbit(got[2][0].numpy()).sum() == 1 and not np.signbit(got[2][0, -1].item())


def test_top_k_peaks_rejects_bad_arguments():
    det, tag = (torch.from_numpy(a) for a in _peak_maps("random", 1))
    with pytest.raises(ValueError, match="nms_padding"):
        top_k_peaks(det, tag, M, 5, 1)
    with pytest.raises(ValueError, match="method"):
        top_k_peaks(det, tag, M, 5, 2, method="chunked")
    with pytest.raises(ValueError, match="tag"):
        top_k_peaks(det, tag.permute(0, 3, 1, 2), M, 5, 2)
    with pytest.raises(ValueError, match="max_people"):
        top_k_peaks(det, tag, 24 * 20 + 1, 5, 2)


def _decode_maps(seed, B, H, W, T, negative=False):
    """det (B, K, H, W) with a few people's peaks and tag (B, K, H, W, T);
    ``negative`` shifts the background below zero."""
    rng = np.random.default_rng(seed)
    det = rng.uniform(0, 0.08, (B, K, H, W)).astype(np.float32)
    if negative:
        det -= np.float32(0.05)
    tag = rng.normal(0, 3.0, (B, K, H, W, T)).astype(np.float32)
    for b in range(B):
        for _ in range(int(rng.integers(1, 5))):
            center = rng.normal(0, 2.0, T)
            for k in range(K):
                if rng.random() < 0.75:
                    y, x = int(rng.integers(0, H)), int(rng.integers(0, W))
                    det[b, k, y, x] = rng.uniform(0.2, 1.0)
                    tag[b, k, max(y - 2, 0):y + 3, max(x - 2, 0):x + 3] = (
                        center + rng.normal(0, 0.1, T))
    return det, tag


@pytest.mark.parametrize("T", [1, 2])
@pytest.mark.parametrize("assignment", ["greedy", "hungarian"])
def test_parse_single_matches_jax(assignment, T):
    """JAX's ``parse_single`` (its CPU path: XLA NMS, the grouping scan,
    the per-person refine) on a map with a positive and one with a negative
    background (the XLA path's -0.0 zeros fall below the threshold)."""
    import jax
    import jax.numpy as jnp
    from litepose_tpu.ops.group import parse_single as j_parse_single

    jcfg = _jcfg(assignment)
    j_fn = jax.jit(j_parse_single, static_argnums=(2, 3, 4))
    cfg = _cfg(assignment)
    found = 0
    for i, negative in enumerate((False, True)):
        det, tag = _decode_maps(20 + T + 4 * i, 1, 16, 20, T, negative)
        for adjust_refine in (True, False):
            jp, js, jn = j_fn(jnp.asarray(det[0]), jnp.asarray(tag[0]), jcfg, adjust_refine,
                              adjust_refine)
            tp, ts, tn = parse_single(torch.from_numpy(det[0]), torch.from_numpy(tag[0]), cfg,
                                      adjust_refine, adjust_refine)
            assert tn.dtype == torch.int32 and tn.shape == ()
            np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
            np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
            np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6, rtol=0)
            found += int(tn)
    assert found > 0


@pytest.mark.parametrize("assignment", ["greedy", "hungarian"])
def test_parse_single_equals_parse_batch_per_image(assignment):
    """K5 + top-M against K1, end to end: each image of a batch decoded
    alone equals the batched decode's row for it, bit for bit."""
    det, tag = (torch.from_numpy(a) for a in _decode_maps(3, 3, 16, 20, 2, negative=True))
    cfg = _cfg(assignment)
    bp, bs, bn = parse_batch(det, tag, cfg)
    for b in range(3):
        p, s, n = parse_single(det[b], tag[b], cfg)
        assert torch.equal(p, bp[b]) and torch.equal(s, bs[b]) and torch.equal(n, bn[b])
    assert bn.min() > 0


@pytest.mark.parametrize("assignment", ["greedy", "hungarian"])
def test_parse_batch_hwt_equals_thw(assignment):
    det, tag = (torch.from_numpy(a) for a in _decode_maps(4, 2, 16, 20, 2))
    cfg = _cfg(assignment)
    hwt = parse_batch(det, tag, cfg)  # JAX's default layout
    thw = parse_batch(det, tag.permute(0, 1, 4, 2, 3).contiguous(), cfg, tag_layout="thw")
    assert all(torch.equal(a, b) for a, b in zip(hwt, thw))
    with pytest.raises(ValueError, match="hwt"):
        parse_batch(det, tag.permute(0, 1, 4, 2, 3).contiguous(), cfg)
    with pytest.raises(ValueError, match="thw"):
        parse_batch(det, tag, cfg, tag_layout="thw")
    with pytest.raises(ValueError, match="tag_layout"):
        parse_batch(det, tag, cfg, tag_layout="twh")


def test_to_decode_layout_matches_jax():
    import jax.numpy as jnp
    from litepose_tpu.core.inference import to_decode_layout as j_to_decode_layout

    from litepose_tpu_torch.core.inference import to_decode_layout

    rng = np.random.default_rng(0)
    heat = rng.standard_normal((2, 6, 7, K)).astype(np.float32)
    tag = rng.standard_normal((2, 6, 7, K, 2)).astype(np.float32)
    got = to_decode_layout(torch.from_numpy(heat), torch.from_numpy(tag))
    for g, w in zip(got, j_to_decode_layout(jnp.asarray(heat), jnp.asarray(tag))):
        assert g.is_contiguous()
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("n", [1, 2, 5, 8, 17])
def test_hungarian_matches_jax(n):
    """Random costs and integer costs full of ties (the solver's op order
    decides among equal optima): the same column for every row."""
    import jax.numpy as jnp
    from litepose_tpu.ops.hungarian import hungarian as j_hungarian

    rng = np.random.default_rng(n)
    for cost in (rng.standard_normal((n, n)) * 10, rng.integers(0, 4, (n, n)),
                 np.zeros((n, n))):
        cost = cost.astype(np.float32)
        got = hungarian(torch.from_numpy(cost))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(j_hungarian(jnp.asarray(cost))))
        assert sorted(got.tolist()) == list(range(n))


def test_ops_api_is_jaxs_without_the_unported():
    """The ops package exports the counterparts of JAX's ops API, less
    ``chunked_top_k`` and ``parse_np`` (not ported)."""
    import litepose_tpu.ops as j_ops

    import litepose_tpu_torch.ops as ops

    assert set(ops.__all__) == set(j_ops.__all__) - {"chunked_top_k", "parse_np"}
    assert all(hasattr(ops, name) for name in ops.__all__)


# -- on the card ----------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K5 and the grouping kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("assignment", ["greedy", "hungarian"])
def test_parse_single_on_card(cuda, assignment, dtype):
    """On the card ``parse_single`` launches K5 once an image and K1 never,
    and equals ``parse_batch`` (K1) image by image and the CPU twins."""
    det, tag = (torch.from_numpy(a).to(dtype) for a in _decode_maps(5, 3, 48, 40, 2, True))
    cfg = _cfg(assignment)
    bp, bs, bn = parse_batch(det.to(cuda), tag.to(cuda), cfg)
    for b in range(3):
        k5, k1 = nms_suppress.launches, nms_topk.launches
        p, s, n = parse_single(det[b].to(cuda), tag[b].to(cuda), cfg)
        torch.cuda.synchronize()
        assert (nms_suppress.launches, nms_topk.launches) == (k5 + 1, k1)
        assert torch.equal(p, bp[b]) and torch.equal(s, bs[b]) and torch.equal(n, bn[b])
        cp, cs, cn = parse_single(det[b], tag[b], cfg)
        assert torch.equal(p.cpu(), cp) and torch.equal(s.cpu(), cs) and torch.equal(n.cpu(), cn)


@pytest.mark.cuda
@pytest.mark.parametrize("case", PEAK_CASES)
def test_top_k_peaks_on_card(cuda, case):
    det, tag = (torch.from_numpy(a) for a in _peak_maps(case, 2))
    for dtype in (torch.float32, torch.bfloat16):
        want = top_k_peaks(det.to(dtype), tag, M, 5, 2)
        got = top_k_peaks(det.to(dtype).to(cuda), tag.to(cuda), M, 5, 2)
        assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
