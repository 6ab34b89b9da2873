"""The decode kernels as registered torch ops (``ops/library.py``): each of
``torch.ops.litepose.{nms_topk, nms_topk_loop, group_greedy,
group_hungarian, refine_argmax, heatmap_nms}`` is registered, passes
``torch.library.opcheck`` (schema, fake implementation, autograd
registration, tracing), and on the CPU equals its plain twin bit for bit;
``library.call``, through which every wrapper runs its op, goes through
the op off the card and straight to the CUDA implementation on it.  The
same ``opcheck`` on the card is marked ``cuda``, and so is a launch on
``cuda:1`` tensors from a thread whose current device is ``cuda:0`` (two
cards; it skips below).

Nothing here imports jax, so ``pytest --noconftest -m cuda`` runs this file
on the card's host."""

import numpy as np
import pytest
import torch

from litepose_tpu_torch.ops import library
from litepose_tpu_torch.ops.group import GroupParams, StaticGroupCfg, match_by_tag
from litepose_tpu_torch.ops.nms import nms_suppress_ref
from litepose_tpu_torch.ops.refine import refine_argmax_ref
from litepose_tpu_torch.ops.topk import nms_topk_ref

K, M = 5, 10


def _planes(seed, dtype=torch.float32):
    """(2, K, 24, 20) planes with planted ties: a plateau and repeats."""
    g = torch.Generator().manual_seed(seed)
    det = torch.rand((2, K, 24, 20), generator=g)
    det[0, 1, 4:8, 4:8] = 0.75
    det[1, 2, ::5, ::3] = 0.5
    return det.to(dtype)


def _group_inputs(seed, T):
    """(tag (3, K, M, T), val (3, K, M) sorted descending): clustered tags."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 2.0, (4, T))
    tag = rng.normal(0, 4.0, (3, K, M, T))
    val = rng.uniform(0, 0.25, (3, K, M))
    for b in range(3):
        for k in range(K):
            for i in range(rng.integers(0, 7)):
                tag[b, k, i] = centers[rng.integers(0, 4)] + rng.normal(0, 0.3, T)
                val[b, k, i] = rng.uniform(0.2, 1.0)
    val = np.sort(val, axis=-1)[..., ::-1].copy()
    return (torch.from_numpy(tag.astype(np.float32)),
            torch.from_numpy(val.astype(np.float32)))


def _group_cfg(assignment):
    return StaticGroupCfg.from_params(
        GroupParams(num_joints=K, max_num_people=M, detection_threshold=0.2,
                    tag_threshold=1.0), assignment=assignment, topk_method="approx")


def _group_args(cfg):
    return ([int(k) for k in cfg.joint_order], cfg.max_people, cfg.max_clusters,
            cfg.detection_threshold, cfg.tag_threshold, cfg.use_detection_val,
            cfg.ignore_too_much)


def _refine_inputs(seed, T):
    """need (2, K, 6) int32, prev (2, 6, T), det (2, K, 16, 12), tag."""
    g = torch.Generator().manual_seed(seed)
    need = (torch.rand((2, K, 6), generator=g) < 0.5).to(torch.int32)
    prev = torch.randn((2, 6, T), generator=g) * 2
    det = torch.rand((2, K, 16, 12), generator=g)
    tag = torch.randn((2, K, T, 16, 12), generator=g) * 2
    return need, prev, det, tag


def _cases(device):
    """(op name, args, twin) on ``device``."""
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        det = _planes(0, dtype).to(device)
        for name in ("nms_topk", "nms_topk_loop"):
            cases.append((name, (det, 8, 5), lambda d, m, k: nms_topk_ref(d, m, k)))
    for assignment in ("greedy", "hungarian"):
        cfg = _group_cfg(assignment)
        for T in (1, 2):
            tag, val = (t.to(device) for t in _group_inputs(T, T))
            cases.append((f"group_{assignment}", (tag, val, *_group_args(cfg)),
                          lambda t, v, *_, cfg=cfg: match_by_tag(t, v, cfg)))
    for T in (1, 2, 3):
        cases.append(("refine_argmax", tuple(t.to(device) for t in _refine_inputs(T, T)),
                      refine_argmax_ref))
    for dtype in (torch.float32, torch.bfloat16):
        for kernel in (3, 5):
            cases.append(("heatmap_nms", (_planes(2, dtype)[0].to(device), kernel),
                          nms_suppress_ref))
    return cases


CASE_IDS = [f"{i}-{c[0]}" for i, c in enumerate(_cases("cpu"))]


def test_ops_registered():
    assert library.OPS == ("nms_topk", "nms_topk_loop", "group_greedy",
                           "group_hungarian", "refine_argmax", "heatmap_nms",
                           "depthwise_conv", "conv_epilogue", "conv3x3_bn_act",
                           "squeeze_excite")
    for name in library.OPS:
        op = getattr(torch.ops.litepose, name).default
        assert op._schema.name == f"litepose::{name}"
    schema = str(torch.ops.litepose.group_greedy.default._schema)
    assert "int[] joint_order" in schema and "float tag_threshold" in schema


@pytest.mark.parametrize("index", range(len(CASE_IDS)), ids=CASE_IDS)
def test_opcheck_cpu(index):
    name, args, _ = _cases("cpu")[index]
    torch.library.opcheck(getattr(torch.ops.litepose, name).default, args)


@pytest.mark.parametrize("index", range(len(CASE_IDS)), ids=CASE_IDS)
def test_cpu_op_is_the_twin(index):
    name, args, twin = _cases("cpu")[index]
    got = getattr(torch.ops.litepose, name)(*args)
    want = twin(*args)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g.view(torch.int32) if g.dtype == torch.float32 else g,
                           w.view(torch.int32) if w.dtype == torch.float32 else w)


def _equal(got, want):
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        if not (g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w)):
            return False
    return True


@pytest.mark.parametrize("index", range(len(CASE_IDS)), ids=CASE_IDS)
def test_call_goes_through_the_op_off_the_card(index, monkeypatch):
    """On a CPU tensor ``library.call`` takes the registered op, once, and
    never the CUDA implementation."""
    name, args, twin = _cases("cpu")[index]
    ran = []
    op = library._OP[name]
    monkeypatch.setitem(library._OP, name, lambda *a: ran.append(name) or op(*a))
    monkeypatch.setitem(library._EAGER, name, None)
    assert not library.eager(args[0])
    assert _equal(library.call(name, *args), twin(*args)) and ran == [name]


def test_fake_shapes_under_export():
    """Each op traces as one graph node with its output shapes."""

    class Decode(torch.nn.Module):
        def forward(self, det, tag, need, prev, rdet, rtag):
            val, pos = torch.ops.litepose.nms_topk(det, M, 5)
            cid, ncl = torch.ops.litepose.group_hungarian(
                tag, val, *_group_args(_group_cfg("hungarian")))
            return pos, cid, ncl, torch.ops.litepose.refine_argmax(need, prev, rdet, rtag)

    det = _planes(1)
    tag, _ = _group_inputs(1, 2)
    args = (det, tag[:2], *_refine_inputs(1, 2))
    ep = torch.export.export(Decode(), args, strict=False)
    targets = [str(n.target) for n in ep.graph.nodes if "litepose" in str(n.target)]
    assert targets == ["litepose.nms_topk.default", "litepose.group_hungarian.default",
                       "litepose.refine_argmax.default"]
    out = [n for n in ep.graph.nodes if n.op == "output"][0].args[0]
    assert [tuple(o.meta["val"].shape) for o in out] == [(2, K, M), (2, K, M), (2,), (2, K, 6)]
    for got, want in zip(ep.module()(*args), Decode()(*args)):
        assert torch.equal(got, want)


def test_wrappers_check_before_the_op():
    """Shape and dtype errors come from the wrappers, as before the ops."""
    from litepose_tpu_torch.ops.group import group_hungarian
    from litepose_tpu_torch.ops.refine import refine_argmax
    from litepose_tpu_torch.ops.topk import nms_topk

    with pytest.raises(TypeError, match="float32 or bfloat16"):
        nms_topk(torch.zeros(1, 1, 8, 8, dtype=torch.float16), 4)
    tag, val = _group_inputs(0, 1)
    with pytest.raises(ValueError, match="M == max_people"):
        group_hungarian(tag[:, :, :4].contiguous(), val[:, :, :4].contiguous(),
                        _group_cfg("hungarian"))
    need, prev, det, tag = _refine_inputs(0, 1)
    with pytest.raises(TypeError, match="need int32"):
        refine_argmax(need.long(), prev, det, tag)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the ops' CUDA implementations launch kernels")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("index", range(len(CASE_IDS)), ids=CASE_IDS)
def test_opcheck_cuda(cuda, index):
    """On the card each op launches its kernel: opcheck passes and the
    result equals the twin's."""
    name, args, twin = _cases(cuda)[index]
    op = getattr(torch.ops.litepose, name)
    torch.library.opcheck(op.default, args)
    got = op(*args)
    want = twin(*args)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("index", range(len(CASE_IDS)), ids=CASE_IDS)
def test_call_skips_the_dispatcher_on_card(cuda, index, monkeypatch):
    """On a plain card tensor ``library.call`` runs the CUDA implementation
    itself, equal to the twin; under a fake-tensor mode it takes the op."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    name, args, twin = _cases(cuda)[index]
    op = library._OP[name]
    monkeypatch.setitem(library._OP, name, None)
    assert library.eager(args[0])
    got = library.call(name, *args)
    torch.cuda.synchronize()
    assert _equal(got, twin(*args))
    monkeypatch.setitem(library._OP, name, op)
    with FakeTensorMode(allow_non_fake_inputs=True):
        assert not library.eager(args[0])


@pytest.fixture
def second_card():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: launches on cuda:1 from a thread on cuda:0")
    return torch.device("cuda", 1)


@pytest.mark.cuda
@pytest.mark.parametrize("index", range(len(CASE_IDS)), ids=CASE_IDS)
def test_launch_on_the_tensors_card(second_card, index):
    """Inputs on cuda:1 while the thread's current device is cuda:0 (a mesh
    engine's shard thread before it sets its device): each op launches on
    cuda:1, leaves the current device alone, and equals its twin."""
    name, args, twin = _cases(second_card)[index]
    torch.cuda.set_device(0)
    for run in (getattr(torch.ops.litepose, name), lambda *a: library.call(name, *a)):
        got = run(*args)
        torch.cuda.synchronize(second_card)
        assert torch.cuda.current_device() == 0
        want = twin(*args)
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert g.device == second_card and torch.equal(g, w)
