"""The ops API (``litepose_tpu_torch.ops``) under JAX's contracts: every
exported name takes JAX's parameter names and, on JAX's shapes, gives what
JAX's function gives on the CPU.

``match_by_tag``, ``greedy_assign``, ``hungarian_prefix``, ``adjust`` and
``refine`` take one image or one cost here as in JAX, and ``heatmap_nms``
returns the map in ``det``'s dtype.  JAX's functions run as the JAX
package's own tests run them on the CPU: the XLA forms as they are
(jitted where a test calls them often), the Pallas kernels
(``pallas_refine.refine_batch``, ``pallas_topk.top_k_peaks_batch``) with
``interpret=True``.  Tolerance: none.  Integer outputs are compared
exactly, and so are float outputs, as the existing parity tests of the
batched functions compare them (``tests/test_torch_group.py``,
``test_torch_refine.py``, ``test_torch_topk.py``); ``heatmap_nms`` compares
values, where a suppressed negative cell is -0.0 in JAX's XLA path and
+0.0 here (``tests/test_torch_nms.py``).

The batched ``refine`` and ``refine_batch`` refuse a tag that is not in the
layout they are told: a T = 1 "hwt" tag (B, K, H, W, 1) read as "thw" once
gave wrong people silently.  ``refine_batch`` and ``top_k_peaks_batch``
take JAX's ``tag_layout`` with its default "hwt".

On the card (marked ``cuda``) the API launches K2, K3, K4 and K5 and equals
its CPU twins.  The machine with the card has no jax: only fixtures and
tests that skip there import it, so ``pytest --noconftest -m cuda`` runs
this file there."""

import inspect

import numpy as np
import pytest
import torch

import litepose_tpu_torch.ops as ops
from litepose_tpu_torch.ops import api
from litepose_tpu_torch.ops.group import GroupParams, StaticGroupCfg
from litepose_tpu_torch.ops.group import refine as refine_batched
from litepose_tpu_torch.ops.refine import refine_batch
from litepose_tpu_torch.ops.topk import top_k_peaks_batch

K, M = 5, 10  # joints, peaks a joint (= max_people, as the Hungarian decode needs)
SEEDS = (0, 1, 2)


def _group_args(**kw):
    return {**dict(num_joints=K, max_num_people=M, detection_threshold=0.2,
                   tag_threshold=1.0), **kw}


def _cfg(assignment):
    return StaticGroupCfg.from_params(GroupParams(**_group_args()), assignment=assignment)


@pytest.fixture(scope="module")
def jops():
    """JAX's ops package, its configs, its per-image grouping jitted once
    per config and its solvers jitted once (``n_rows`` traced)."""
    import jax
    import litepose_tpu.ops as j_ops
    from litepose_tpu.ops.group_ref import GroupParams as JGroupParams

    match = jax.jit(j_ops.match_by_tag, static_argnames="cfg")
    solvers = {name: jax.jit(getattr(j_ops, name))
               for name in ("greedy_assign", "hungarian_prefix")}

    def jcfg(assignment):
        return j_ops.StaticGroupCfg.from_params(JGroupParams(**_group_args()),
                                                assignment=assignment)

    return j_ops, jcfg, match, solvers


def _j(fn, *arrays, **kw):
    import jax.numpy as jnp

    out = fn(*(jnp.asarray(a) for a in arrays), **kw)
    return tuple(np.asarray(o) for o in out) if isinstance(out, tuple) else np.asarray(out)


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


# -- the names -------------------------------------------------------------------


def test_parameter_names_are_jaxs():
    """Every exported name takes JAX's parameters in JAX's order, less
    ``interpret``: the Pallas lowering switch of JAX's ``top_k_peaks`` and
    ``StaticGroupCfg``, which has no meaning on the card."""
    import litepose_tpu.ops as j_ops

    dropped = {}
    for name in ops.__all__:
        want = list(inspect.signature(getattr(j_ops, name)).parameters)
        got = list(inspect.signature(getattr(ops, name)).parameters)
        assert got == [p for p in want if p != "interpret"], name
        if "interpret" in want:
            dropped[name] = want.index("interpret") == len(want) - 1
    assert dropped == {"top_k_peaks": True, "StaticGroupCfg": True}


# -- grouping and assignment -----------------------------------------------------


def _peaks(seed, T, kind):
    """One image's (tag_k (K,M,T), loc_k (K,M,2), val_k (K,M) sorted
    descending).  "people": a few tight tag clusters among noise, fewer
    valid rows than M in every joint (n_rows < n); "ties": a duplicated
    peak (equal tag and score) and equal tag distances to two clusters;
    "full": every peak valid, far-apart tags, up to the cluster cap."""
    rng = np.random.default_rng(seed)
    loc = rng.integers(0, 64, (K, M, 2)).astype(np.float32)
    if kind == "full":
        tag = rng.uniform(-50, 50, (K, M, T)).astype(np.float32)
        val = rng.uniform(0.5, 1.0, (K, M)).astype(np.float32)
    else:
        centers = rng.normal(0, 2.0, (4, T))
        tag = rng.normal(0, 4.0, (K, M, T)).astype(np.float32)
        val = rng.uniform(0, 0.15, (K, M)).astype(np.float32)
        for k in range(K):
            for i in range(int(rng.integers(1, 7))):
                tag[k, i] = centers[rng.integers(0, 4)] + rng.normal(0, 0.3, T)
                val[k, i] = rng.uniform(0.25, 1.0)
    val = np.sort(val, axis=-1)[..., ::-1].copy()
    if kind == "ties":
        tag[1, 1], val[1, 1] = tag[1, 0], val[1, 0]  # a duplicated peak
        tag[0, :2] = 0.0
        tag[0, 1, 0] = 2.0  # the first joint spawns clusters at 0 and 2 ...
        val[0, :2] = (0.9, 0.8)
        tag[2, 0] = 0.0
        tag[2, 0, 0] = 1.0  # ... a later peak lies at distance 1 from both
    return tag, loc, val


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", ["people", "ties", "full"])
@pytest.mark.parametrize("T", [1, 2])
@pytest.mark.parametrize("assignment", ["greedy", "hungarian"])
def test_match_by_tag_matches_jax(jops, assignment, T, kind, seed):
    _, jcfg, j_match, _ = jops
    tag, loc, val = _peaks(seed * 10 + T, T, kind)
    want_cl, want_n = _j(j_match, tag, loc, val, cfg=jcfg(assignment))
    got_cl, got_n = api.match_by_tag(*_t(tag, loc, val), _cfg(assignment))
    assert got_cl.dtype == torch.float32 and got_n.dtype == torch.int32
    assert got_cl.shape == (40, K, 3 + T) == want_cl.shape  # max_clusters and got_n.shape == ()
    np.testing.assert_array_equal(got_n.numpy(), want_n)
    np.testing.assert_array_equal(got_cl.numpy(), want_cl)
    assert int(got_n) > 1


def _costs(seed, n):
    """Square costs: normal draws, the grouping's rounded distances with
    pad columns (many ties), and 0/1 costs (massively tied)."""
    rng = np.random.default_rng(seed)
    grouping = rng.integers(0, 3, (n, n)) * 100.0 - rng.uniform(0, 1, (n, 1))
    grouping[:, n - n // 3:] = 1e4
    return [c.astype(np.float32) for c in
            (rng.normal(size=(n, n)), grouping, rng.integers(0, 2, (n, n)))]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", ["greedy_assign", "hungarian_prefix"])
def test_assignment_matches_jax(jops, name, seed):
    """Each cost at every prefix n_rows from 0 to n, as an int and as a
    0-d tensor: int32 columns, n where unassigned, equal to JAX's."""
    solver = jops[3][name]
    n = 9
    for cost in _costs(seed, n):
        for n_rows in range(n + 1):
            want = _j(solver, cost, n_rows=n_rows)
            for rows in (n_rows, torch.tensor(n_rows)):
                got = getattr(ops, name)(torch.from_numpy(cost), rows)
                assert got.dtype == torch.int32 and got.shape == (n,)
                np.testing.assert_array_equal(got.numpy(), want, err_msg=f"n_rows={n_rows}")


def test_greedy_assign_leaves_out_unmatched_costs(jops):
    """Costs of 3e38 and above never match, in JAX and here."""
    j_ops = jops[0]
    cost = np.array([[1, 3e38, 2], [np.inf, np.inf, np.inf], [0.5, 1, 3e38]], np.float32)
    want = _j(j_ops.greedy_assign, cost, n_rows=3)
    np.testing.assert_array_equal(ops.greedy_assign(torch.from_numpy(cost), 3).numpy(), want)
    assert want.tolist() == [2, 3, 0]


def test_assignment_refuses_what_jax_cannot_take():
    cost = torch.zeros(4, 4)
    for fn in (ops.greedy_assign, ops.hungarian_prefix):
        with pytest.raises(ValueError, match="square"):
            fn(torch.zeros(1, 4, 4), 2)
    with pytest.raises(ValueError, match="n_rows"):
        ops.hungarian_prefix(cost, 5)


# -- adjust, refine --------------------------------------------------------------


def _image(seed, P, T, H=12, W=16):
    """One image's people (P, K, 3+T) with live and empty slots and
    joints on the border, det (K, H, W), tag (K, H, W, T)."""
    rng = np.random.default_rng(seed)
    det = rng.standard_normal((K, H, W)).astype(np.float32)
    tag = (rng.standard_normal((K, H, W, T)) * 2).astype(np.float32)
    people = np.zeros((P, K, 3 + T), np.float32)
    for p in range(P - 1):  # the last slot stays empty
        joints = rng.random(K) < 0.6
        people[p, joints, 0] = rng.integers(0, W, joints.sum())
        people[p, joints, 1] = rng.integers(0, H, joints.sum())
        people[p, joints, 2] = rng.random(joints.sum()) + 0.1
        people[p, joints, 3:] = rng.standard_normal((joints.sum(), T))
    people[0, :4, :3] = [[0, 0, 0.5], [W - 1, H - 1, 0.5], [0, H - 1, 0.5], [W - 1, 0, 0.5]]
    return people, det, tag


@pytest.mark.parametrize("seed", SEEDS)
def test_adjust_matches_jax(jops, seed):
    people, det, _ = _image(seed, P=6, T=2)
    want = _j(jops[0].adjust, people, det)
    got = ops.adjust(*_t(people, det))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("T", [1, 2])
def test_refine_matches_jax(jops, T, seed):
    """JAX's per-image ``refine`` (its XLA form) on an image's "hwt" tag,
    against the port's through K4's twin."""
    people, det, tag = _image(10 + seed, P=6, T=T)
    want = _j(jops[0].refine, people, det, tag)
    got = ops.refine(*_t(people, det, tag))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got[-1].any()  # the empty slot stays empty


def _probe():
    """The case that gave wrong people silently: B = 1, K = 14, a 16 x 16
    plane, one person of five joints, a T = 1 tag in the "hwt" layout."""
    rng = np.random.default_rng(0)
    det = rng.uniform(0, 1, (1, 14, 16, 16)).astype(np.float32)
    tag = rng.normal(0, 3, (1, 14, 16, 16, 1)).astype(np.float32)
    people = np.zeros((1, 30, 14, 4), np.float32)
    people[0, 0, :5, 0] = (1, 3, 5, 7, 9)
    people[0, 0, :5, 1] = (2, 4, 6, 8, 10)
    people[0, 0, :5, 2] = 0.9
    people[0, 0, :5, 3] = tag[0, np.arange(5), people[0, 0, :5, 1].astype(int),
                              people[0, 0, :5, 0].astype(int), 0]
    return _t(people, det, tag)


def test_hwt_tag_read_as_thw_raises():
    people, det, tag = _probe()
    with pytest.raises(ValueError, match="thw"):
        refine_batched(people, det, tag)
    with pytest.raises(ValueError, match="thw"):
        refine_batch(people, det, tag, tag_layout="thw")
    with pytest.raises(ValueError, match="hwt"):  # a "thw" tag under the default
        refine_batch(people, det, tag.permute(0, 1, 4, 2, 3))
    with pytest.raises(ValueError, match="tag_layout"):
        refine_batch(people, det, tag, tag_layout="htw")
    with pytest.raises(ValueError, match="3\\+T"):  # the people's T is not the tag's
        refine_batch(people[..., :3].contiguous(), det, tag)
    want = refine_batched(people, det, tag.permute(0, 1, 4, 2, 3))
    assert torch.equal(refine_batch(people, det, tag), want)
    assert torch.equal(ops.refine(people[0], det[0], tag[0]), want[0])
    assert want[0, 0, 5:, 2].gt(0).any()  # the probe's person gains joints


@pytest.mark.parametrize("T", [1, 2])
def test_refine_batch_layouts_match_jax(T):
    """``refine_batch`` with its default "hwt" equals its "thw" call and
    JAX's ``pallas_refine.refine_batch`` (interpret mode) on "hwt" tags."""
    import jax.numpy as jnp
    from litepose_tpu.ops.pallas_refine import refine_batch as j_refine_batch

    images = [_image(20 + T * 3 + b, P=6, T=T) for b in range(2)]
    people, det, tag = (np.stack(a) for a in zip(*images))
    want = np.asarray(j_refine_batch(jnp.asarray(people), jnp.asarray(det), jnp.asarray(tag),
                                     interpret=True))
    p, d, t = _t(people, det, tag)
    got = refine_batch(p, d, t)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(refine_batch(p, d, t.permute(0, 1, 4, 2, 3), tag_layout="thw"), got)


@pytest.mark.parametrize("T", [1, 2])
def test_top_k_peaks_batch_layouts_match_jax(T):
    """``top_k_peaks_batch`` with its default "hwt" equals its "thw" call
    and JAX's ``pallas_topk.top_k_peaks_batch`` (interpret mode) on "hwt"
    tags: tags, x/y and values."""
    import jax.numpy as jnp
    from litepose_tpu.ops.pallas_topk import top_k_peaks_batch as j_peaks

    rng = np.random.default_rng(T)
    det = rng.uniform(0, 1, (2, K, 12, 20)).astype(np.float32)
    det[0, 1, 3, ::4] = 2.0  # tied peaks
    tag = rng.normal(0, 2, (2, K, 12, 20, T)).astype(np.float32)
    want = j_peaks(jnp.asarray(det), jnp.asarray(tag), M, 5, interpret=True)
    d, t = _t(det, tag)
    got = top_k_peaks_batch(d, t, M, 5)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    thw = top_k_peaks_batch(d, t.permute(0, 1, 4, 2, 3), M, 5, tag_layout="thw")
    assert all(torch.equal(a, b) for a, b in zip(thw, got))
    with pytest.raises(ValueError, match="hwt"):
        top_k_peaks_batch(d, t.permute(0, 1, 4, 2, 3), M, 5)


# -- heatmap_nms -----------------------------------------------------------------


def _maps(seed):
    """(2, 3, 11, 14) maps of both signs with tied plateaus."""
    rng = np.random.default_rng(seed)
    det = rng.normal(0, 1, (2, 3, 11, 14)).astype(np.float32)
    det[0, 0, 2:5, 3:6] = 1.5  # a plateau
    det[1, 2] = np.round(det[1, 2])  # many ties
    return det


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kernel", [3, 5, 7])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_heatmap_nms_matches_jax(jops, dtype, kernel, seed):
    """JAX's ``heatmap_nms`` (XLA), values equal and the map in ``det``'s
    dtype."""
    import jax.numpy as jnp

    det = _maps(seed)
    jdt = getattr(jnp, dtype)
    tdt = getattr(torch, dtype)
    want = jops[0].heatmap_nms(jnp.asarray(det).astype(jdt), kernel, kernel // 2)
    got = ops.heatmap_nms(torch.from_numpy(det).to(tdt), kernel, kernel // 2)
    assert want.dtype == jdt and got.dtype == tdt and got.shape == det.shape
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    if kernel == 5:
        assert torch.equal(ops.heatmap_nms(torch.from_numpy(det).to(tdt)), got)


@pytest.mark.parametrize("kernel,padding", [(5, 1), (5, 3), (3, 0), (1, 1)])
def test_heatmap_nms_padding_must_be_half_the_window(jops, kernel, padding):
    """JAX's ``heatmap_nms`` fails there (its window max no longer has
    ``det``'s shape); the port refuses it."""
    import jax.numpy as jnp

    det = _maps(0)
    with pytest.raises(TypeError, match="incompatible shapes"):
        jops[0].heatmap_nms(jnp.asarray(det), kernel, padding)
    with pytest.raises(ValueError, match="kernel // 2"):
        ops.heatmap_nms(torch.from_numpy(det), kernel, padding)


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K2-K5 have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 2])
@pytest.mark.parametrize("assignment", ["greedy", "hungarian"])
def test_match_by_tag_on_card(cuda, assignment, T):
    from litepose_tpu_torch.ops.group import group_greedy, group_hungarian

    kernel = group_greedy if assignment == "greedy" else group_hungarian
    for kind in ("people", "ties", "full"):
        args = _t(*_peaks(T, T, kind))
        want = api.match_by_tag(*args, _cfg(assignment))
        n = kernel.launches
        got = api.match_by_tag(*(a.to(cuda) for a in args), _cfg(assignment))
        torch.cuda.synchronize()
        assert kernel.launches == n + 1
        assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 2])
def test_refine_and_adjust_on_card(cuda, T):
    from litepose_tpu_torch.ops.refine import refine_argmax

    people, det, tag = _t(*_image(T, P=6, T=T))
    n = refine_argmax.launches
    got = ops.refine(people.to(cuda), det.to(cuda), tag.to(cuda))
    torch.cuda.synchronize()
    assert refine_argmax.launches == n + 1
    assert torch.equal(got.cpu(), ops.refine(people, det, tag))
    assert torch.equal(ops.adjust(people.to(cuda), det.to(cuda)).cpu(), ops.adjust(people, det))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_heatmap_nms_on_card(cuda, dtype):
    from litepose_tpu_torch.ops.nms import nms_suppress

    det = torch.from_numpy(_maps(1)).to(dtype)
    n = nms_suppress.launches
    got = ops.heatmap_nms(det.to(cuda), 5, 2)
    torch.cuda.synchronize()
    assert nms_suppress.launches == n + 1 and got.dtype == dtype
    assert torch.equal(got.cpu(), ops.heatmap_nms(det, 5, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["greedy_assign", "hungarian_prefix"])
def test_assignment_on_card(cuda, name):
    for cost in _costs(3, 9):
        for n_rows in (0, 4, 9):
            want = getattr(ops, name)(torch.from_numpy(cost), n_rows)
            got = getattr(ops, name)(torch.from_numpy(cost).to(cuda), n_rows)
            assert torch.equal(got.cpu(), want)
