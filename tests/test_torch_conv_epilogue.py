"""The epilogue of a folded dense conv: bias, residual (same shape or
nearest-upsampled) and activation in one pass (``ops/epilogue.py``,
``csrc/conv_epilogue.cu``, K7).

On the CPU: the op is its twin, and the twin is the unfused sequence the
layers ran before (``+ bias.to(bf16)``, the nearest upsample and ``+
residual``, ``torch.clamp`` / ``torch.relu``) bit for bit in either layout;
the wrapper refuses what the contract leaves out; ``conv_bn`` routes every
bf16 eval dense conv of a folded pair to the op (70 a LitePose forward, one
a pair in HigherHRNet) and nothing at fp32, in training, with a gradient or
in EfficientHRNet; both models' bf16 forwards keep their bits; an exported
serving engine holds the op.  On the card (marked ``cuda``, skipped without
one): the kernel equals the twin bit for bit at every epilogue of the three
serving configurations, with NaN, +-0 and +-inf planted, on planes no
multiple of 8 and from bases off 16 bytes, and a forward of each launches
it once a dense pair.  No jax here: ``pytest --noconftest -m cuda`` runs
this file on the card."""

import numpy as np
import pytest
import torch
import torch.nn as nn
from torch._subclasses.fake_tensor import FakeTensorMode

from litepose_tpu_torch.models import layers as L
from litepose_tpu_torch.ops.epilogue import ACTS, conv_epilogue, conv_epilogue_ref

torch.set_num_threads(2)
CL = torch.channels_last
RESIDUALS = {"none": None, "same": 0, "up2": 1, "up4": 2, "up8": 3}


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t.view(torch.int32)


def _inputs(B, C, H, W, kind, fmt=torch.contiguous_format, bias_dtype=torch.float32, seed=0,
            device="cpu"):
    g = torch.Generator().manual_seed(seed)
    y = torch.randn((B, C, H, W), generator=g).mul(3).to(torch.bfloat16)
    bias = torch.randn((C,), generator=g).to(bias_dtype)
    k = RESIDUALS[kind]
    res = None if k is None else torch.randn((B, C, H << k, W << k),
                                             generator=g).mul(3).to(torch.bfloat16)
    move = lambda t: t.to(device).contiguous(memory_format=fmt)  # noqa: E731
    return move(y), bias.to(device), None if res is None else move(res)


def unfused(y, bias, res, act):
    """The layers' sequence before the kernel: the bias add, the fuse's
    ``acc + upsample(contrib)`` or the block's ``y + x``, then the
    activation."""
    t = y + bias.to(y.dtype)[:, None, None]
    if res is not None:
        f = res.shape[-1] // y.shape[-1]
        t = res + L.upsample_nearest(t, f) if f > 1 else t + res
    return {"none": t, "relu6": torch.clamp(t, 0.0, 6.0), "relu": torch.relu(t),
            "silu": t * torch.sigmoid(t)}[act]


@pytest.mark.parametrize("bias_dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("fmt", [torch.contiguous_format, CL], ids=["nchw", "nhwc"])
@pytest.mark.parametrize("kind", list(RESIDUALS))
@pytest.mark.parametrize("act", ACTS)
def test_twin_is_the_unfused_sequence(act, kind, fmt, bias_dtype):
    # odd C, a 3x5 plane: neither C nor H*W a multiple of 8
    y, bias, res = _inputs(2, 5, 3, 5, kind, fmt, bias_dtype)
    want = unfused(y, bias, res, act)
    got = conv_epilogue(y, bias, res, act)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert got.is_contiguous(memory_format=fmt)
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(conv_epilogue_ref(y, bias, res, act)), _bits(want))


@pytest.mark.parametrize("kind,fmt,act", [("none", torch.contiguous_format, "relu6"),
                                          ("same", CL, "relu"), ("up4", CL, "relu"),
                                          ("up2", torch.contiguous_format, "none")])
def test_opcheck_cpu(kind, fmt, act):
    y, bias, res = _inputs(2, 8, 4, 6, kind, fmt)
    torch.library.opcheck(torch.ops.litepose.conv_epilogue.default, (y, bias, res, act))


@pytest.mark.parametrize("shape,k,fmt", [((2, 8, 15, 17), None, CL), ((1, 3, 7, 7), 0, None),
                                         ((4, 16, 5, 5), 3, CL), ((2, 6, 3, 9), 1, None)])
def test_fake_shapes(shape, k, fmt):
    fmt = fmt or torch.contiguous_format
    B, C, H, W = shape
    out_shape = shape if k is None else (B, C, H << k, W << k)
    with FakeTensorMode():
        y = torch.empty(shape, dtype=torch.bfloat16, memory_format=fmt)
        res = None if k is None else torch.empty(out_shape, dtype=torch.bfloat16,
                                                 memory_format=fmt)
        out = torch.ops.litepose.conv_epilogue(y, torch.empty(C), res, "relu")
    assert tuple(out.shape) == out_shape and out.dtype == torch.bfloat16
    assert out.is_contiguous(memory_format=fmt)


def test_wrapper_checks():
    y, bias, res = _inputs(2, 4, 6, 6, "up2")
    with pytest.raises(ValueError, match="act"):
        conv_epilogue(y, bias, None, "gelu")
    with pytest.raises(ValueError, match="bias"):
        conv_epilogue(y, bias[:3], None, "none")
    with pytest.raises(ValueError, match="bias"):
        conv_epilogue(y[0], bias, None, "none")
    with pytest.raises(TypeError, match="bf16"):
        conv_epilogue(y.float(), bias, None, "none")
    with pytest.raises(TypeError, match="bf16"):
        conv_epilogue(y, bias.double(), None, "none")
    with pytest.raises(TypeError, match="bf16"):
        conv_epilogue(y, bias, res.float(), "none")
    for bad in (res[:, :, :9, :12], res[:, :, :, :6], torch.zeros((2, 4, 96, 96)).bfloat16(),
                res[:1], res[:, :2]):
        with pytest.raises(ValueError, match="residual"):
            conv_epilogue(y, bias, bad.contiguous(), "relu")
    with pytest.raises(ValueError, match="layout"):
        conv_epilogue(y, bias, res.contiguous(memory_format=CL), "relu")
    with pytest.raises(ValueError, match="layout"):
        conv_epilogue(y.transpose(2, 3), bias, None, "relu")
    for b, r in ((bias.to("meta"), None), (bias, res.to("meta"))):
        with pytest.raises(ValueError, match="one device"):
            conv_epilogue(y, b, r, "relu")


def test_eager_is_only_a_plain_card_tensor_outside_tracing():
    from litepose_tpu_torch.ops.library import eager

    assert not eager(torch.zeros(2))
    with FakeTensorMode():
        assert not eager(torch.empty(2))


# -- the dispatch in conv_bn ---------------------------------------------------


@pytest.fixture
def spy(monkeypatch):
    calls = []

    def counted(y, bias, residual, act):
        calls.append((tuple(y.shape), None if residual is None else tuple(residual.shape), act))
        return conv_epilogue(y, bias, residual, act)

    monkeypatch.setattr(L, "conv_epilogue", counted)
    return calls


def _moved(module: nn.Module, seed: int = 3) -> nn.Module:
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Conv2d):
                m.weight.normal_(0.0, 0.3, generator=g)
            elif isinstance(m, nn.BatchNorm2d):
                for t in (m.weight, m.bias, m.running_mean):
                    t.uniform_(-0.5, 0.5, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
    return module


def _unfused_path(mp):
    mp.setattr(L, "fused_epilogue", lambda y, residual: False)


ROUTES = {
    # name: (module, dtype, train, grad, residual, the op runs)
    "eval-bf16-expand": (lambda: L.ConvBNReLU6(8, 16, 1), torch.bfloat16, False, False, False,
                         True),
    "eval-bf16-project-residual": (lambda: L.ConvBNReLU6(8, 8, 1, act=False), torch.bfloat16,
                                   False, False, True, True),
    "eval-bf16-3x3-stride2": (lambda: L.ConvBNReLU6(8, 8, 3, 2), torch.bfloat16, False, False,
                              False, True),
    "training": (lambda: L.ConvBNReLU6(8, 8, 1, act=False), torch.bfloat16, True, False, True,
                 False),
    "fp32-parity": (lambda: L.ConvBNReLU6(8, 8, 1, act=False), torch.float32, False, False,
                    True, False),
    "grad-to-the-input": (lambda: L.ConvBNReLU6(8, 8, 1, act=False), torch.bfloat16, False,
                          True, True, False),
    "depthwise": (lambda: L.ConvBNReLU6(8, 8, 7, 1, groups=8), torch.bfloat16, False, False,
                  False, False),
}


@pytest.mark.parametrize("name", list(ROUTES))
def test_conv_bn_routes(name, spy):
    make, dtype, train, grad, with_res, fused = ROUTES[name]
    module = _moved(make()).train(train)
    g = torch.Generator().manual_seed(1)
    x = torch.randn((2, 8, 12, 12), generator=g).to(dtype).requires_grad_(grad)
    res = x if with_res else None
    got = module(x, dtype, res)
    assert len(spy) == int(fused)
    with pytest.MonkeyPatch.context() as mp:
        _unfused_path(mp)
        want = module(x, dtype, res)
    assert torch.equal(_bits(got.detach()), _bits(want.detach()))


def test_litepose_bf16_forward_keeps_its_bits(spy):
    from litepose_tpu_torch.arch import get_arch
    from litepose_tpu_torch.models.litepose import LitePose, ModelSpec, init_litepose

    arch = get_arch("auto-XS")
    model = init_litepose(ModelSpec(), arch, torch.Generator().manual_seed(0),
                          compute_dtype=torch.bfloat16)
    model = _moved(model).eval()
    images = torch.randn((2, 3, 64, 64), generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        got = model(images)
        with pytest.MonkeyPatch.context() as mp:
            _unfused_path(mp)
            n = len(spy)
            want = model(images)
            assert len(spy) == n
    dense = [c for c, _ in model._conv_bn_pairs()
             if not c.groups == c.in_channels == c.out_channels > 1]
    assert len(spy) == len(dense) == 70
    assert sum(r is not None for _, r, _ in spy) == 30
    assert {a for *_, a in spy} == {"relu6", "none"}
    for g, w in zip(got, want):
        assert torch.equal(_bits(g), _bits(w))
    fp32 = LitePose(ModelSpec(), arch, compute_dtype=torch.float32)
    fp32.load_state_dict(model.state_dict())
    spy.clear()
    with torch.no_grad():
        fp32.eval()(images)
        model.train()(images)
    assert spy == []


def test_higher_hrnet_bf16_forward_keeps_its_bits(spy):
    import plain_higher_hrnet as plain
    from litepose_tpu_torch.models.higher_hrnet import HighResolutionModule
    from test_torch_hrnet_serving import J, LAYOUT, images, seeded

    model = seeded(torch.bfloat16).eval()
    # channels-last (a permuted NHWC batch), so the 3x3 stride-1 pairs take
    # the dense conv op with its epilogue (K8) and every other pair K7's
    x = plain.Reference(model.state_dict(), LAYOUT, J, "cpu").normalize(images())
    k8, dense = [], L.conv3x3_bn_act
    with torch.no_grad(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(L, "conv3x3_bn_act", lambda *args: k8.append(args[0].shape) or dense(*args))
        got = model(x)
        n = len(spy)
        _unfused_path(mp)
        want = model(x)
    taken = sum(1 for c, _ in model._conv_bn_pairs() if L.conv3x3_kernel_takes(c))
    assert taken > 0 and len(k8) == 2 * taken
    assert n == len(spy) == len(model._conv_bn_pairs()) - taken
    # each fuse term from a coarser branch: its 1x1 conv's output upsampled
    # by 2, 4 or 8 into the running sum
    ups = [(s, r) for s, r, _ in spy if r is not None and r != s]
    coarser = sum(j > i for m in model.modules() if isinstance(m, HighResolutionModule)
                  and m.fuse_layers is not None for i, row in enumerate(m.fuse_layers)
                  for j in range(len(row)))
    assert sorted({r[-1] // s[-1] for s, r in ups}) == [2, 4, 8] and len(ups) == coarser
    for g, w in zip(got, want):
        assert torch.equal(_bits(g), _bits(w))
    spy.clear()
    with torch.no_grad():
        seeded(torch.float32).eval()(x)
        model.train()(x)
    assert spy == []


def test_efficient_hrnet_keeps_its_unfolded_path(spy, monkeypatch):
    """EfficientHRNet keeps its unfolded path in training and at fp32 (no
    op); at bf16 eval it folds and sends the epilogue of every dense conv-BN
    pair to the op, one a pair (Swish in the backbone, the projects'
    residuals, ReLU in the transitions and stages), and each depthwise conv
    to K6, and its maps keep the bits of the unfused sequence."""
    from litepose_tpu_torch.models.efficient_hrnet import EffHRNetSpec, init_efficient_hrnet
    from litepose_tpu_torch.models.higher_hrnet import StageSpec

    depthwise, k6 = [], L.depthwise_conv
    monkeypatch.setattr(L, "depthwise_conv", lambda *args: depthwise.append(args[4]) or k6(*args))
    spec = EffHRNetSpec(depth_mult=0.483, width_mult=0.684, scale_factor=-5,
                        stage2=StageSpec(1, 2, "BASIC", (1, 1), (32, 64)),
                        stage3=StageSpec(1, 3, "BASIC", (1, 1, 1), (32, 64, 128)),
                        stage4=StageSpec(1, 4, "BASIC", (1, 1, 1, 1), (32, 64, 128, 256)),
                        deconv_num_basic_blocks=1)
    model = init_efficient_hrnet(spec, torch.Generator().manual_seed(0),
                                 compute_dtype=torch.bfloat16)
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.weight.uniform_(0.5, 1.5, generator=g)
                m.bias.uniform_(-0.2, 0.2, generator=g)
                m.running_mean.uniform_(-0.2, 0.2, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
    x = torch.randn((1, 3, 64, 64), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        model.train()(x)
        assert spy == [] and depthwise == []
        got = model.eval()(x)
        n = len(spy)
        with pytest.MonkeyPatch.context() as mp:
            _unfused_path(mp)
            mp.setattr(L, "fused_depthwise", lambda conv, x, pad=None: False)
            want = model(x)
    pairs = model._conv_bn_pairs()
    convs = [c for c, _ in pairs if c.groups > 1]
    assert n == len(spy) == len(pairs) - len(convs) and len(depthwise) == len(convs) > 0
    assert {a for *_, a in spy} == {"silu", "none", "relu"} and set(depthwise) == {"silu"}
    assert sum(r is not None for _, r, _ in spy) > 0
    for g, w in zip(got, want):
        assert torch.equal(_bits(g), _bits(w))
    spy.clear()
    depthwise.clear()
    fp32 = init_efficient_hrnet(spec, torch.Generator().manual_seed(0),
                                compute_dtype=torch.float32)
    with torch.no_grad():
        fp32.eval()(x)
    assert spy == [] and depthwise == []


def test_export_holds_the_op():
    from litepose_tpu_torch.arch import ArchManager
    from litepose_tpu_torch.core.engine import EngineConfig, PoseEngine
    from litepose_tpu_torch.core.export import export_engine
    from litepose_tpu_torch.core.inference import InferenceFlags
    from litepose_tpu_torch.data.flip import flip_index_for
    from litepose_tpu_torch.models.litepose import ModelSpec, init_litepose
    from litepose_tpu_torch.ops.group import GroupParams

    size = 64
    model = init_litepose(ModelSpec(num_joints=14), ArchManager().fixed_sample(reso=size,
                                                                               ratio=0.25),
                          torch.Generator().manual_seed(0)).eval()
    dense = sum(1 for c, _ in model._conv_bn_pairs()
                if not c.groups == c.in_channels == c.out_channels > 1)
    flags = InferenceFlags(num_joints=14, with_heatmaps_loss=(True, True),
                           with_ae_loss=(True, False), test_with_heatmaps=(True, True),
                           test_with_ae=(True, False), flip_test=False,
                           flip_index=tuple(flip_index_for("crowd_pose")))
    config = EngineConfig(input_size=size, scale_factors=(1.0,), with_adjust=False,
                          with_refine=False, project2image=False, assignment="greedy",
                          topk_method="approx")
    engine = PoseEngine(model, flags, GroupParams(num_joints=14, detection_threshold=0.1),
                        config, device="cpu")
    ep = export_engine(engine, batch=2)
    nodes = [str(n.target) for n in ep.graph.nodes if "conv_epilogue" in str(n.target)]
    assert nodes == ["litepose.conv_epilogue.default"] * dense and dense > 0
    images = torch.from_numpy(np.random.default_rng(7).integers(
        0, 255, (2, size, size, 3)).astype(np.uint8))
    want = engine.run_batch(images)[2:]
    for g, w in zip(ep.module()(images), want):
        assert torch.equal(g, w)


# -- on the card -----------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K7 kernel has no CPU mode")
    return torch.device("cuda")


def _held_on_card(y, bias, res, act):
    from litepose_tpu_torch.tools.epilogue_clock import held

    before = conv_epilogue.launches
    check = held(y, bias, res, act)
    torch.cuda.synchronize()
    assert conv_epilogue.launches == before + 1
    assert check["equal"], check
    return check


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", [torch.contiguous_format, CL], ids=["nchw", "nhwc"])
@pytest.mark.parametrize("kind", list(RESIDUALS))
@pytest.mark.parametrize("shape", [(2, 5, 3, 5), (2, 48, 14, 14), (3, 16, 7, 7),
                                   (1, 8, 20, 24)], ids=["odd", "196", "49", "wide"])
def test_kernel_equals_the_twin_on_card(cuda, shape, kind, fmt):
    for i, act in enumerate(ACTS):
        bias_dtype = (torch.float32, torch.bfloat16)[i % 2]
        _held_on_card(*_inputs(*shape, kind, fmt, bias_dtype, seed=i, device=cuda), act)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", [torch.contiguous_format, CL], ids=["nchw", "nhwc"])
@pytest.mark.parametrize("kind", ["none", "same", "up2"])
def test_kernel_special_values_and_offset_bases_on_card(cuda, kind, fmt):
    from litepose_tpu_torch.tools.epilogue_clock import planted

    for act in ACTS:
        y, bias, res = planted(*_inputs(2, 16, 6, 10, kind, fmt, device=cuda))
        assert _held_on_card(y, bias, res, act)["nan"] > 0
    # bases 2 bytes past an allocation: the 2-byte instance
    y, bias, res = _inputs(2, 16, 6, 10, kind, fmt, device=cuda)
    shifted = [None if t is None else torch.cat([t.new_zeros(1), t.permute(0, 2, 3, 1).flatten()
                                                 if fmt is CL else t.flatten()])[1:]
               for t in (y, res)]
    views = [None if s is None else (s.view(t.permute(0, 2, 3, 1).shape).permute(0, 3, 1, 2)
                                      if fmt is CL else s.view(t.shape))
             for s, t in zip(shifted, (y, res))]
    assert views[0].data_ptr() % 16 == 2
    _held_on_card(views[0], bias, views[1], "relu6")


@pytest.mark.cuda
def test_the_op_and_the_eager_launch_agree_on_card(cuda):
    """The wrapper launches an eager card tensor without the dispatcher
    (``library.call``); the registered op (an exported program's node) runs
    the same launch, counted too."""
    y, bias, res = _inputs(2, 16, 6, 10, "up2", CL, device=cuda)
    before = conv_epilogue.launches
    got = torch.ops.litepose.conv_epilogue(y, bias, res, "relu")
    want = conv_epilogue(y, bias, res, "relu")
    torch.cuda.synchronize()
    assert conv_epilogue.launches == before + 2
    assert torch.equal(_bits(got), _bits(want)) and got.is_contiguous(memory_format=CL)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,fmt", [("none", torch.contiguous_format), ("same", CL),
                                      ("up2", CL)])
def test_overwrite_writes_into_y_on_card(cuda, kind, fmt):
    """The wrapper overwrites y: an output of y's shape lands in y itself,
    bit-equal to the twin; an upsampled one in a new tensor.  Through the
    op, y is left as it was."""
    y, bias, res = _inputs(2, 16, 6, 10, kind, fmt, device=cuda)
    want = conv_epilogue_ref(y, bias, res, "relu")
    kept = y.clone()
    assert torch.equal(_bits(torch.ops.litepose.conv_epilogue(y, bias, res, "relu")),
                       _bits(want))
    assert torch.equal(_bits(y), _bits(kept))
    got = conv_epilogue(y, bias, res, "relu")
    torch.cuda.synchronize()
    assert (got.data_ptr() == y.data_ptr()) == (kind != "up2")
    assert torch.equal(_bits(got), _bits(want)) and got.is_contiguous(memory_format=fmt)


@pytest.mark.cuda
def test_kernel_limits_on_card(cuda):
    y, bias, res = _inputs(1, 8, 4, 4, "same", device=cuda)
    before = conv_epilogue.launches
    assert conv_epilogue(y[:0], bias, res[:0], "none").shape == (0, 8, 4, 4)
    assert conv_epilogue.launches == before  # nothing to launch
    with pytest.raises(ValueError, match="layout"):
        conv_epilogue(y, bias, res.contiguous(memory_format=CL), "relu")


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["auto-S", "auto-XS", "w48"])
def test_every_serving_epilogue_on_card(cuda, config):
    """At every epilogue of one forward of each serving configuration (a
    smaller batch than the cells', the same shapes else): the kernel equals
    the twin, and the forward launches it once a dense pair."""
    from litepose_tpu_torch.tools import epilogue_clock as clock

    model, x, pairs = clock.serving_model(config, cuda, batch=2)
    calls, launched = clock.record_epilogues(lambda: model(x))
    assert launched == len(calls) == pairs
    for call in calls:
        assert clock.held(*call)["equal"]
