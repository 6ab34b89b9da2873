"""The depthwise conv of a folded conv + BN with its bias and activation
(``ops/depthwise.py``, ``csrc/depthwise_conv.cu``, K6).

On the CPU: the op is its twin, and the twin is the unfused sequence the
layers ran before (``F.conv2d``, ``+ bias.to(dtype)``, ``torch.clamp`` /
``torch.relu``) bit for bit; ``conv_bn`` routes an eval bf16 depthwise conv
to the op and keeps every other conv on ``F.conv2d``; a bf16 LitePose
forward keeps its bits; the fake implementation traces, and an exported
serving engine holds the op and runs it.  On the card (marked ``cuda``,
skipped without one): the kernel equals the same window sum taken in its
order, lies within one ulp of ``F.conv2d`` and within the conv's gap plus
one ulp of the twin, passes NaN as the twin does, and counts its launches.
No jax here: ``pytest --noconftest -m cuda`` runs this file on the card."""

import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode

from litepose_tpu_torch.models import layers as L
from litepose_tpu_torch.ops.depthwise import ACTS, depthwise_conv, depthwise_conv_ref

CASES = [(k, s, act) for k in (3, 5, 7) for s in (1, 2) for act in ACTS]


def _inputs(B, C, H, W, k, dtype, seed=0, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((B, C, H, W), generator=g).to(dtype)
    w = (torch.randn((C, 1, k, k), generator=g) / k).to(dtype)
    bias = torch.randn((C,), generator=g)
    return x.to(device), w.to(device), bias.to(device)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t.view(torch.int32)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("hw", [(9, 11), (8, 12)], ids=["odd", "even"])
@pytest.mark.parametrize("k,stride,act", CASES)
def test_twin_is_the_unfused_sequence(k, stride, act, hw, dtype):
    x, w, bias = _inputs(2, 3, *hw, k, dtype)
    y = F.conv2d(x, w, None, stride, k // 2, 1, 3)
    y = y + bias.to(y.dtype)[:, None, None]
    want = {"none": y, "relu6": torch.clamp(y, 0.0, 6.0), "relu": torch.relu(y),
            "silu": y * torch.sigmoid(y)}[act]
    got = depthwise_conv(x, w, bias, stride, act)
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(depthwise_conv_ref(x, w, bias, stride, act)), _bits(want))


@pytest.mark.parametrize("hw", [(9, 11), (8, 12)], ids=["odd", "even"])
@pytest.mark.parametrize("act", ["silu", "relu6"])
@pytest.mark.parametrize("k", [3, 5, 7])
def test_same_pad_twin_is_the_padded_sequence(k, act, hw):
    """At stride 2 the pad k // 2 - 1 (TensorFlow's SAME at even sizes, as
    EfficientHRNet's module pads before a conv of its own padding 0): the
    twin is ``F.pad`` with that pad before and k - 1 - pad after, the conv,
    the bias and the activation, with (H - 1) // 2 + 1 rows; at even sizes
    it equals the module's SAME pad (pad before, pad + 1 after)."""
    x, w, bias = _inputs(2, 3, *hw, k, torch.bfloat16)
    p = k // 2 - 1
    got = depthwise_conv(x, w, bias, 2, act, p)
    assert got.shape[-2:] == ((hw[0] - 1) // 2 + 1, (hw[1] - 1) // 2 + 1)
    y = F.conv2d(F.pad(x, (p, k - 1 - p) * 2), w, None, 2, 0, 1, 3)
    y = y + bias.to(y.dtype)[:, None, None]
    want = y * torch.sigmoid(y) if act == "silu" else torch.clamp(y, 0.0, 6.0)
    assert torch.equal(_bits(got), _bits(want))
    if hw[0] % 2 == 0 and hw[1] % 2 == 0:
        y = F.conv2d(F.pad(x, (p, p + 1) * 2), w, None, 2, 0, 1, 3)
        y = y + bias.to(y.dtype)[:, None, None]
        same = y * torch.sigmoid(y) if act == "silu" else torch.clamp(y, 0.0, 6.0)
        assert torch.equal(_bits(got), _bits(same))
    with pytest.raises(ValueError, match="pad"):
        depthwise_conv(x, w, bias, 1, act, p)  # SAME is a stride-2 pad


@pytest.mark.parametrize("k,stride,act", [(7, 1, "relu6"), (5, 2, "relu"), (3, 1, "none")])
def test_opcheck_cpu(k, stride, act):
    x, w, bias = _inputs(2, 4, 10, 9, k, torch.bfloat16)
    torch.library.opcheck(torch.ops.litepose.depthwise_conv.default, (x, w, bias, stride, act))


@pytest.mark.parametrize("shape,k,stride", [((2, 8, 15, 17), 7, 2), ((1, 3, 28, 28), 5, 1),
                                            ((4, 2, 1, 1), 3, 2), ((1, 1, 16, 7), 7, 1)])
def test_fake_shapes(shape, k, stride):
    C = shape[1]
    with FakeTensorMode():
        x = torch.empty(shape, dtype=torch.bfloat16)
        out = torch.ops.litepose.depthwise_conv(
            x, torch.empty((C, 1, k, k), dtype=torch.bfloat16), torch.empty(C), stride, "relu6")
    real = depthwise_conv_ref(*_inputs(*shape, k, torch.bfloat16), stride, "relu6")
    assert out.shape == real.shape and out.dtype == torch.bfloat16


def test_wrapper_checks():
    x, w, bias = _inputs(1, 2, 8, 8, 7, torch.bfloat16)
    with pytest.raises(ValueError, match="act"):
        depthwise_conv(x, w, bias, 1, "gelu")
    with pytest.raises(ValueError, match="stride"):
        depthwise_conv(x, w, bias, 3, "none")
    with pytest.raises(ValueError, match="k in"):
        depthwise_conv(x, w[:, :, :4, :4], bias, 1, "none")
    with pytest.raises(ValueError, match="k in"):
        depthwise_conv(x, w[:1], bias, 1, "none")
    with pytest.raises(TypeError, match="dtype"):
        depthwise_conv(x, w.float(), bias, 1, "none")


# -- the dispatch in conv_bn ---------------------------------------------------


@pytest.fixture
def spy(monkeypatch):
    calls = []

    def counted(x, w, bias, stride, act):
        calls.append((tuple(x.shape), w.shape[-1], stride, act))
        return depthwise_conv(x, w, bias, stride, act)

    monkeypatch.setattr(L, "depthwise_conv", counted)
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


ROUTES = {
    # name: (module, its input channels, compute dtype, train, grad, the op runs)
    "eval-bf16-depthwise-relu6": (lambda: L.ConvBNReLU6(8, 8, 7, 1, groups=8), 8,
                                  torch.bfloat16, False, False, True),
    "eval-bf16-depthwise-stride2": (lambda: L.ConvBNReLU6(8, 8, 5, 2, groups=8), 8,
                                    torch.bfloat16, False, False, True),
    "eval-bf16-sepconv-relu": (lambda: L.SepConv2d(8, 4, 5), 8, torch.bfloat16, False, False,
                               True),
    "training": (lambda: L.ConvBNReLU6(8, 8, 7, 1, groups=8), 8, torch.bfloat16, True, False,
                 False),
    "dense-7x7-resnet-stem": (lambda: L.ConvBNReLU6(8, 16, 7, 1), 8, torch.bfloat16, False,
                              False, False),
    "fp32-parity": (lambda: L.ConvBNReLU6(8, 8, 7, 1, groups=8), 8, torch.float32, False,
                    False, False),
    "grad-to-the-input": (lambda: L.ConvBNReLU6(8, 8, 7, 1, groups=8), 8, torch.bfloat16,
                          False, True, False),
    "pointwise": (lambda: L.ConvBNReLU6(8, 8, 1), 8, torch.bfloat16, False, False, False),
}


@pytest.mark.parametrize("name", list(ROUTES))
def test_conv_bn_routes(name, spy):
    make, cin, dtype, train, grad, fused = ROUTES[name]
    module = _moved(make()).train(train)
    x = torch.randn((2, cin, 12, 12), generator=torch.Generator().manual_seed(1))
    x = x.to(dtype).requires_grad_(grad)
    got = module(x, dtype)
    assert len(spy) == int(fused)
    # the same module on the path it had before the kernel
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(L, "fused_depthwise", lambda conv, x: False)
        want = module(x, dtype)
    assert torch.equal(_bits(got.detach()), _bits(want.detach()))


def test_resnet_stem_stays_dense(spy):
    from litepose_tpu_torch.models.litepose_resnet import FusedMBConv

    block = _moved(FusedMBConv(8, 8, 7, 2, 1)).eval()
    block(torch.randn((1, 8, 10, 10)).to(torch.bfloat16), torch.bfloat16)
    assert spy == []


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
            mp.setattr(L, "fused_depthwise", lambda conv, x: False)
            want = model(images)
    depthwise = [m for m in model.modules() if isinstance(m, nn.Conv2d)
                 and m.groups == m.in_channels == m.out_channels > 1]
    assert len(spy) == len(depthwise) == 39
    assert {a for *_, a in spy} == {"relu6", "relu"}
    for g, w in zip(got, want):
        assert torch.equal(_bits(g), _bits(w))
    fp32 = LitePose(ModelSpec(), arch, compute_dtype=torch.float32)
    fp32.load_state_dict(model.state_dict())
    spy.clear()
    with torch.no_grad():
        fp32.eval()(images)
    assert spy == []


def test_export_holds_the_op():
    from litepose_tpu_torch.arch import ArchManager
    from litepose_tpu_torch.core.engine import EngineConfig, PoseEngine
    from litepose_tpu_torch.core.export import export_engine, load_artifact, save_artifact
    from litepose_tpu_torch.core.inference import InferenceFlags
    from litepose_tpu_torch.data.flip import flip_index_for
    from litepose_tpu_torch.models.litepose import ModelSpec, init_litepose
    from litepose_tpu_torch.ops.group import GroupParams

    size = 64
    model = init_litepose(ModelSpec(num_joints=14), ArchManager().fixed_sample(reso=size,
                                                                               ratio=0.25),
                          torch.Generator().manual_seed(0)).eval()
    depthwise = sum(1 for m in model.modules() if isinstance(m, nn.Conv2d)
                    and m.groups == m.in_channels == m.out_channels > 1)
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
    nodes = [str(n.target) for n in ep.graph.nodes if "depthwise_conv" in str(n.target)]
    assert nodes == ["litepose.depthwise_conv.default"] * depthwise and depthwise > 0
    images = torch.from_numpy(np.random.default_rng(7).integers(
        0, 255, (2, size, size, 3)).astype(np.uint8))
    want = engine.run_batch(images)[2:]
    for g, w in zip(ep.module()(images), want):
        assert torch.equal(g, w)


# -- on the card -----------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K6 kernel has no CPU mode")
    return torch.device("cuda")


def _held_on_card(x, w, bias, stride, act, pad=-1):
    from litepose_tpu_torch.tools.depthwise_clock import held, ok

    before = depthwise_conv.launches
    check = held(x, w, bias, stride, act, pad)
    torch.cuda.synchronize()
    assert depthwise_conv.launches == before + 2  # the op, and the conv alone
    assert ok(check), check
    return check


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(15, 17), (28, 28), (16, 16), (1, 1), (9, 600)],
                         ids=["odd", "28", "16", "one-pixel", "wide"])
@pytest.mark.parametrize("k,stride,act", CASES)
def test_kernel_on_card(cuda, k, stride, act, hw):
    _held_on_card(*_inputs(2, 5, *hw, k, torch.bfloat16, seed=k + stride, device=cuda),
                  stride, act)


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(240, 240), (60, 60), (30, 30), (15, 17)],
                         ids=["240", "60", "30", "odd"])
@pytest.mark.parametrize("k,act", [(3, "silu"), (5, "silu"), (7, "relu6")])
def test_same_pad_kernel_on_card(cuda, k, act, hw):
    """The stride-2 SAME pad (k // 2 - 1) held to both twins, at
    EfficientHRNet-H-1@480's stride-2 depthwise planes and an odd one."""
    check = _held_on_card(*_inputs(2, 5, *hw, k, torch.bfloat16, seed=k, device=cuda), 2, act,
                          k // 2 - 1)
    assert check["pad"] == k // 2 - 1 and check["order_equal"]


@pytest.mark.cuda
def test_kernel_nan_and_offset_input_on_card(cuda):
    x, w, bias = _inputs(2, 6, 56, 56, 7, torch.bfloat16, device=cuda)
    x.view(-1)[::997] = float("nan")
    assert _held_on_card(x, w, bias, 1, "relu6")["nan"] > 0
    flat = torch.cat([torch.zeros(1, dtype=x.dtype, device=cuda), x.flatten()])[1:]
    _held_on_card(flat.view(x.shape), w, bias, 2, "relu")  # 2 bytes off: cell-by-cell staging


@pytest.mark.cuda
def test_kernel_limits_on_card(cuda):
    x, w, bias = _inputs(1, 2, 8, 8, 7, torch.bfloat16, device=cuda)
    with pytest.raises(TypeError, match="fp32 bias"):
        depthwise_conv(x, w, bias.to(torch.bfloat16), 1, "none")
    before = depthwise_conv.launches
    assert depthwise_conv(x[:0], w, bias, 1, "none").shape == (0, 2, 8, 8)
    assert depthwise_conv.launches == before  # nothing to launch
