"""The dense 3x3 stride-1 conv of a folded conv-BN pair with its epilogue
in one kernel (``ops/dense_conv.py``, ``csrc/dense_conv3x3.cu``, K8).

On the CPU: the op is its twin, and the twin is the sequence the layers ran
before (``F.conv2d`` in bf16, then ``ops.epilogue.unfused``) bit for bit,
at each of HigherHRNet-W48's seven 3x3 stride-1 shape classes (small
planes); the wrapper refuses what the contract leaves out;
``layers.fused_conv3x3`` takes exactly the contract's pairs; a W48 eval
forward routes its 221 3x3 stride-1 pairs through the op and keeps its
bits at bf16 and fp32, while Auto-S, Auto-XS and EfficientHRNet route none.
On the card (marked ``cuda``, skipped without one): at the seven shapes at
b2 the kernel's conv lies within 1 bf16 ulp of the conv in float64, its
epilogue equals ``unfused`` of its own conv output bit for bit (also with
NaN, +-0 and +-inf planted in the residual), a batch at the kernel's size
limit gives each image what the image alone gets, and a W48 forward
launches it 221 times, whether the model was put in eval mode before or
after it moved to the card.  No jax here: ``pytest --noconftest -m cuda`` runs this file on the
card."""

import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode

from litepose_tpu_torch.models import layers as L
from litepose_tpu_torch.ops.dense_conv import MAX_ELEMENTS, conv3x3_bn_act, conv3x3_bn_act_ref
from litepose_tpu_torch.ops.dense_conv import ACTS
from litepose_tpu_torch.ops.epilogue import unfused

torch.set_num_threads(2)
CL = torch.channels_last
W48_CONFIG = "configs/crowd_pose/higher_hrnet/w48_640_adam_lr1e-3.yaml"
W48_PAIRS = 221  # 3x3 stride-1 conv-BN pairs of a W48 forward: 113 plain, 108 with a residual
# W48's seven 3x3 stride-1 shape classes, Cin -> Cout @ plane: (Cin, Cout,
# the plane at 640, a small plane for the CPU)
SHAPES = {"48@160": (48, 48, 160, 9), "48@320": (48, 48, 320, 13), "96@80": (96, 96, 80, 7),
          "192@40": (192, 192, 40, 5), "384@20": (384, 384, 20, 4),
          "64@160": (64, 64, 160, 9), "256-48@160": (256, 48, 160, 6)}


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _inputs(B, cin, cout, H, W, residual, seed=0, device="cpu", w_layout=CL):
    """x, w (fan-in scaled), an fp32 bias and a residual, bf16 channels-last
    (w in ``w_layout``)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((B, cin, H, W), generator=g).to(torch.bfloat16)
    w = (torch.randn((cout, cin, 3, 3), generator=g) / (9 * cin) ** 0.5).to(torch.bfloat16)
    bias = torch.randn((cout,), generator=g)
    res = torch.randn((B, cout, H, W), generator=g).to(torch.bfloat16) if residual else None
    x, w, bias = x.to(device).contiguous(memory_format=CL), w.to(device), bias.to(device)
    w = w.contiguous(memory_format=w_layout)
    return x, w, bias, None if res is None else res.to(device).contiguous(memory_format=CL)


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("residual", [False, True], ids=["plain", "residual"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_twin_is_the_parents_sequence(shape, residual, act):
    cin, cout, _, hw = SHAPES[shape]
    x, w, bias, res = _inputs(2, cin, cout, hw, hw + 1, residual,
                              w_layout=torch.contiguous_format)
    want = unfused(F.conv2d(x, w, None, 1, 1), bias, res, act)
    got = conv3x3_bn_act(x, w, bias, res, act)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert got.is_contiguous(memory_format=CL)
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(conv3x3_bn_act_ref(x, w, bias, res, act)), _bits(want))


@pytest.mark.parametrize("residual,act", [(False, "relu"), (True, "relu6"), (True, "none")])
def test_opcheck_cpu(residual, act):
    x, w, bias, res = _inputs(2, 16, 32, 5, 6, residual, w_layout=torch.contiguous_format)
    torch.library.opcheck(torch.ops.litepose.conv3x3_bn_act.default, (x, w, bias, res, act))


@pytest.mark.parametrize("residual", [False, True])
def test_fake_shapes(residual):
    with FakeTensorMode():
        x = torch.empty((2, 32, 7, 9), dtype=torch.bfloat16, memory_format=CL)
        w = torch.empty((48, 32, 3, 3), dtype=torch.bfloat16)
        res = torch.empty((2, 48, 7, 9), dtype=torch.bfloat16, memory_format=CL) \
            if residual else None
        out = torch.ops.litepose.conv3x3_bn_act(x, w, torch.empty(48), res, "relu")
    assert tuple(out.shape) == (2, 48, 7, 9) and out.dtype == torch.bfloat16
    assert out.is_contiguous(memory_format=CL)


def test_wrapper_refuses_what_the_contract_leaves_out():
    x, w, bias, res = _inputs(2, 16, 32, 6, 6, True)
    with pytest.raises(ValueError, match="channels-last"):  # an NCHW input
        conv3x3_bn_act(x.contiguous(), w, bias, res, "relu")
    with pytest.raises(ValueError, match="residual"):  # the output of a stride-2 conv
        conv3x3_bn_act(x, w, bias, res[:, :, ::2, ::2].contiguous(memory_format=CL), "relu")
    with pytest.raises(ValueError, match="3, 3"):  # a 1x1 conv
        conv3x3_bn_act(x, w[:, :, :1, :1].contiguous(), bias, res, "relu")
    x3, w3, b3, _ = _inputs(2, 3, 32, 6, 6, False, w_layout=torch.contiguous_format)
    with pytest.raises(ValueError, match="multiples of 16"):  # the 3-channel stem
        conv3x3_bn_act(x3, w3, b3, None, "relu")
    x24, w24, b24, _ = _inputs(2, 16, 24, 6, 6, False, w_layout=torch.contiguous_format)
    with pytest.raises(ValueError, match="multiples of 16"):  # Cout off 16
        conv3x3_bn_act(x24, w24, b24, None, "relu")
    with pytest.raises(ValueError, match="one device"):
        conv3x3_bn_act(x, w, bias.to("meta"), res, "relu")
    with pytest.raises(TypeError, match="bf16"):  # fp32
        conv3x3_bn_act(x.float(), w.float(), bias, res.float(), "relu")
    with pytest.raises(TypeError, match="fp32 bias"):  # a bf16 bias
        conv3x3_bn_act(x, w, bias.to(torch.bfloat16), res, "relu")
    with pytest.raises(ValueError, match="act"):
        conv3x3_bn_act(x, w, bias, res, "gelu")
    with pytest.raises(ValueError, match="bias"):
        conv3x3_bn_act(x, w, bias[:16], res, "relu")


# -- the dispatch in conv_bn ---------------------------------------------------


def _pair(cin, cout, k=3, stride=1, groups=1, dilation=1):
    conv = nn.Conv2d(cin, cout, k, stride, dilation * (k // 2), dilation, groups, bias=False)
    bn = L.bn2d(cout).eval()
    L.prepare_eval_(nn.Sequential(conv, bn), [(conv, bn)], torch.bfloat16)
    return conv, bn


PREDICATE = {
    # name: (pair, x (B, Cin, H, W), layout, dtype, residual, grad, takes it)
    "3x3-plain": ((32, 48), (2, 32, 6, 6), CL, torch.bfloat16, False, False, True),
    "3x3-residual": ((48, 48), (2, 48, 6, 6), CL, torch.bfloat16, True, False, True),
    "nchw": ((32, 48), (2, 32, 6, 6), torch.contiguous_format, torch.bfloat16, False, False,
             False),
    "fp32": ((32, 48), (2, 32, 6, 6), CL, torch.float32, False, False, False),
    "grad": ((32, 48), (2, 32, 6, 6), CL, torch.bfloat16, False, True, False),
    "stride-2": ((32, 48, 3, 2), (2, 32, 6, 6), CL, torch.bfloat16, False, False, False),
    "1x1": ((32, 48, 1), (2, 32, 6, 6), CL, torch.bfloat16, False, False, False),
    "stem-3ch": ((3, 64), (2, 3, 6, 6), CL, torch.bfloat16, False, False, False),
    "cout-24": ((32, 24), (2, 32, 6, 6), CL, torch.bfloat16, False, False, False),
    "cout-528": ((32, 528), (2, 32, 6, 6), CL, torch.bfloat16, False, False, False),
    "depthwise": ((32, 32, 3, 1, 32), (2, 32, 6, 6), CL, torch.bfloat16, False, False, False),
    "dilated": ((32, 48, 3, 1, 1, 2), (2, 32, 6, 6), CL, torch.bfloat16, False, False, False),
    "wide": ((16, 16), (1, 16, 2, 1025), CL, torch.bfloat16, False, False, False),
}


@pytest.mark.parametrize("name", list(PREDICATE))
def test_fused_conv3x3_takes_exactly_the_contracts_pairs(name):
    spec, shape, fmt, dtype, with_res, grad, takes = PREDICATE[name]
    conv, bn = _pair(*spec)
    x = torch.randn(shape).to(dtype).contiguous(memory_format=fmt).requires_grad_(grad)
    res = None
    if with_res:
        res = torch.randn((shape[0], spec[1]) + shape[2:]).to(dtype).contiguous(memory_format=fmt)
    assert L.fused_conv3x3(conv, x, res) is takes
    if takes:
        # an upsampled residual (a fuse's) and an NCHW one go elsewhere
        up = torch.zeros((shape[0], spec[1], 2 * shape[2], 2 * shape[3]), dtype=dtype)
        assert not L.fused_conv3x3(conv, x, up.contiguous(memory_format=CL))
        assert not L.fused_conv3x3(conv, x, torch.zeros((shape[0], spec[1]) + shape[2:],
                                                        dtype=dtype))
        # a pair not folded (no stored weight) goes elsewhere too
        del conv._buffers["folded_w"]
        assert not L.fused_conv3x3(conv, x, res)


# W48's 48 -> 48 @ 320^2 convs at the largest batch the kernel takes
EDGE_BATCH = MAX_ELEMENTS // (48 * 320 * 320)


def test_the_kernels_size_limit_routes_elsewhere():
    """A batch past the kernel's B H W max(Cin, Cout) < 2^31 goes to
    cuDNN's conv and K7 (the predicate declines it) and the op refuses it;
    the batch below it is taken.  Shapes only: meta tensors."""
    from litepose_tpu_torch.ops.dense_conv import contract

    assert EDGE_BATCH == 436
    conv, _ = _pair(48, 48)
    w = torch.empty((48, 48, 3, 3), dtype=torch.bfloat16, device="meta", memory_format=CL)
    bias = torch.empty((48,), device="meta")
    for batch, takes in ((EDGE_BATCH, True), (EDGE_BATCH + 1, False)):
        x = torch.empty((batch, 48, 320, 320), dtype=torch.bfloat16, device="meta",
                        memory_format=CL)
        assert L.fused_conv3x3(conv, x, None) is takes
        if takes:
            assert contract(x, w, bias, None, "relu") == (batch, 48, 320, 320)
        else:
            with pytest.raises(ValueError, match="2\\^31"):
                contract(x, w, bias, None, "relu")


@pytest.fixture
def spy(monkeypatch):
    calls = []

    def counted(x, w, bias, residual, act):
        calls.append((tuple(x.shape), tuple(w.shape), residual is not None, act))
        return conv3x3_bn_act(x, w, bias, residual, act)

    monkeypatch.setattr(L, "conv3x3_bn_act", counted)
    return calls


def _w48(dtype):
    from litepose_tpu_torch.config import default_config, update_config
    from litepose_tpu_torch.models import get_model

    cfg = update_config(default_config(), W48_CONFIG)
    model = get_model("pose_higher_hrnet", cfg, device="cpu", seed=0, compute_dtype=dtype,
                      out_dtype=dtype).train()
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.weight.uniform_(0.5, 1.5, generator=g)
                m.bias.uniform_(-0.2, 0.2, generator=g)
                m.running_mean.uniform_(-0.2, 0.2, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
    return model.eval()


def _image(size=64, batch=2):
    g = torch.Generator().manual_seed(2)
    return torch.randn((batch, 3, size, size), generator=g).contiguous(memory_format=CL)


def test_w48_forward_routes_its_221_pairs(spy):
    from collections import Counter

    model = _w48(torch.bfloat16)
    with torch.no_grad():
        model(_image())
    assert len(spy) == W48_PAIRS == sum(1 for c, _ in model._conv_bn_pairs()
                                        if L.conv3x3_kernel_takes(c))
    assert sum(r for _, _, r, _ in spy) == 108 and {a for *_, a in spy} == {"relu"}
    classes = Counter((w[1], w[0]) for _, w, _, _ in spy)
    assert classes == {(48, 48): 72, (96, 96): 64, (192, 192): 56, (384, 384): 24,
                       (64, 64): 4, (256, 48): 1}


def test_litepose_and_efficient_hrnet_route_none(spy, monkeypatch):
    """Auto-S, Auto-XS (NCHW, no 3x3 stride-1 dense pair) and EfficientHRNet
    route no pair to K8: EfficientHRNet's 3x3 stride-1 pairs (its stages'
    and transitions') have widths no multiple of 16 at its published scale
    factors (11..85 at -5 here, 26, 52, 103 and 206 at H-1's -1), so even
    channels-last, as on a card, they take cuDNN's conv and K7's epilogue
    (one a dense pair), and its depthwise convs K6 (one each)."""
    from litepose_tpu_torch.arch import get_arch
    from litepose_tpu_torch.models.efficient_hrnet import EffHRNetSpec, init_efficient_hrnet
    from litepose_tpu_torch.models.higher_hrnet import StageSpec
    from litepose_tpu_torch.models.litepose import ModelSpec, init_litepose

    k6, k7, depthwise, epilogue = [], [], L.depthwise_conv, L.conv_epilogue
    monkeypatch.setattr(L, "depthwise_conv", lambda *args: k6.append(1) or depthwise(*args))
    monkeypatch.setattr(L, "conv_epilogue", lambda *args: k7.append(1) or epilogue(*args))
    with torch.no_grad():
        for name in ("auto-S", "auto-XS"):
            model = init_litepose(ModelSpec(), get_arch(name), torch.Generator().manual_seed(0),
                                  compute_dtype=torch.bfloat16).eval()
            model(torch.randn((1, 3, 64, 64)))
        spec = EffHRNetSpec(depth_mult=0.483, width_mult=0.684, scale_factor=-5,
                            stage2=StageSpec(1, 2, "BASIC", (1, 1), (32, 64)),
                            stage3=StageSpec(1, 3, "BASIC", (1, 1, 1), (32, 64, 128)),
                            stage4=StageSpec(1, 4, "BASIC", (1, 1, 1, 1), (32, 64, 128, 256)),
                            deconv_num_basic_blocks=1)
        model = init_efficient_hrnet(spec, torch.Generator().manual_seed(0),
                                     compute_dtype=torch.bfloat16).eval()
        k6.clear()
        k7.clear()
        model(torch.randn((1, 3, 64, 64)).contiguous(memory_format=CL))
    assert spy == []
    pairs = model._conv_bn_pairs()
    dense = [c for c, _ in pairs if c.groups == 1]
    assert len(k6) == len(pairs) - len(dense) > 0 and len(k7) == len(dense)
    assert any(L.conv3x3_kernel_takes(c) is False and c.kernel_size == (3, 3)
               and c.stride == (1, 1) for c in dense)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_w48_maps_keep_their_bits(dtype, spy):
    """The W48 eval maps through the op equal the parent's route (cuDNN's
    conv, then the epilogue op), bit for bit on the CPU."""
    model = _w48(dtype)
    x = _image()
    with torch.no_grad():
        got = model(x)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(L, "fused_conv3x3", lambda conv, x, residual: False)
            n = len(spy)
            want = model(x)
            assert len(spy) == n
    assert len(spy) == (W48_PAIRS if dtype == torch.bfloat16 else 0)
    for g, w in zip(got, want):
        assert g.dtype == dtype and torch.equal(_bits(g), _bits(w))


# -- on the card -----------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K8 kernel has no CPU mode")
    return torch.device("cuda")


def _ulps(a: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """|a - ref| in bf16 ulps at ref (a bf16, ref fp32): the larger of the
    two spacings beside ref rounded to bf16, so that either neighbour of
    ref reads at most 1, also where ref lies at the edge of a binade."""
    r16 = ref.to(torch.bfloat16)
    inf = torch.full_like(r16, float("inf"))
    spacing = torch.maximum(torch.nextafter(r16, inf).float() - r16.float(),
                            r16.float() - torch.nextafter(r16, -inf).float())
    return (a.float() - ref).abs() / spacing.clamp_min(torch.finfo(torch.float32).tiny)


def _held(x, w, bias, res, act):
    """The kernel's conv output y (bias 0, no residual, no activation) and
    its epilogue against ``unfused(y, ...)``: the second bit for bit."""
    from litepose_tpu_torch.ops.dense_conv import conv3x3_bn_act as k8

    before = k8.launches
    y = k8(x, w, torch.zeros_like(bias), None, "none")
    out = k8(x, w, bias, res, act)
    torch.cuda.synchronize()
    assert k8.launches == before + 2
    want = unfused(y, bias, res, act)
    assert out.is_contiguous(memory_format=CL)
    same = _bits(out) == _bits(want)
    assert bool(same.all()), f"{int((~same).sum())} of {same.numel()} differ"
    return y


@pytest.mark.cuda
@pytest.mark.parametrize("residual", [False, True], ids=["plain", "residual"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_kernel_on_w48_shapes_on_card(cuda, shape, residual):
    """The conv within 1 bf16 ulp of the conv in float64 on at least 99.9%
    of elements, and on every element whose sum cancels by less than a
    factor 256 (|y| >= sum |x w| / 256): the tensor cores sum K = 9 Cin
    products in fp32 in their own order (their adds truncate rather than
    round), so where the products cancel further that drift may reach half
    an ulp of y and a sum near a rounding boundary may round past its
    neighbour.  The epilogue equal to ``unfused`` of the kernel's y bit
    for bit."""
    cin, cout, hw, _ = SHAPES[shape]
    x, w, bias, res = _inputs(2, cin, cout, hw, hw, residual, device=cuda)
    for act in ACTS:
        y = _held(x, w, bias, res, act)
    xd, wd = x.cpu().double(), w.cpu().double()
    ref = F.conv2d(xd, wd, None, 1, 1)
    mag = F.conv2d(xd.abs(), wd.abs(), None, 1, 1)
    ulps = _ulps(y.cpu(), ref.float())
    assert float((ulps <= 1).float().mean()) >= 0.999
    kept = ref.abs() >= mag / 256
    assert bool((ulps[kept] <= 1).all()), float(ulps[kept].max())


@pytest.mark.cuda
@pytest.mark.parametrize("act", ACTS)
def test_kernel_specials_in_the_residual_on_card(cuda, act):
    from litepose_tpu_torch.tools.epilogue_clock import planted

    x, w, bias, res = _inputs(2, 48, 48, 40, 40, True, device=cuda)
    _, bias_p, res_p = planted(torch.zeros_like(res), bias, res)
    assert int(res_p.isnan().sum()) > 0 and int(res_p.isinf().sum()) > 0
    out = conv3x3_bn_act(x, w, bias_p, res_p, act)
    assert int(out.isnan().sum()) > 0
    _held(x, w, bias_p, res_p, act)


@pytest.mark.cuda
@pytest.mark.parametrize("B,cin,cout,H,W", [(3, 16, 16, 7, 13), (1, 32, 80, 5, 29),
                                            (2, 48, 32, 1, 1), (1, 64, 512, 3, 4),
                                            (2, 16, 64, 33, 2), (1, 96, 48, 2, 300)])
def test_kernel_on_odd_shapes_on_card(cuda, B, cin, cout, H, W):
    """Every instance (BN 96, 64, 48, 32, 16) on planes no tile divides."""
    x, w, bias, res = _inputs(B, cin, cout, H, W, True, device=cuda)
    y = _held(x, w, bias, res, "relu")
    ref = F.conv2d(x.cpu().double(), w.cpu().double(), None, 1, 1).float()
    assert float((_ulps(y.cpu(), ref) <= 1).float().mean()) >= 0.999


@pytest.mark.cuda
def test_the_op_and_the_eager_launch_agree_on_card(cuda):
    x, w, bias, res = _inputs(2, 32, 48, 6, 10, True, device=cuda)
    got = torch.ops.litepose.conv3x3_bn_act(x, w, bias, res, "relu")
    want = conv3x3_bn_act(x, w, bias, res, "relu")
    assert torch.equal(_bits(got), _bits(want))
    with pytest.raises(ValueError, match="channels-last"):
        conv3x3_bn_act(x, w.contiguous(), bias, res, "relu")


@pytest.mark.cuda
def test_w48_forward_launches_221_on_card(cuda):
    from litepose_tpu_torch.ops.epilogue import conv_epilogue
    from litepose_tpu_torch.tools.epilogue_clock import dense_pairs

    model = _w48(torch.bfloat16).train().to(cuda).eval()  # its weights stored on the card
    x = _image(128, 1).to(cuda)
    k8, k7 = conv3x3_bn_act.launches, conv_epilogue.launches
    with torch.inference_mode():
        model(x)
    torch.cuda.synchronize()
    assert conv3x3_bn_act.launches - k8 == W48_PAIRS
    assert conv_epilogue.launches - k7 == dense_pairs(model) == len(model._conv_bn_pairs()) - W48_PAIRS


@pytest.mark.cuda
def test_w48_put_in_eval_before_the_move_launches_221_on_card(cuda):
    """Folded on the host, then moved: the stored weights are laid out
    channels-last on the card all the same, and every 3x3 stride-1 pair
    takes the kernel."""
    model = _w48(torch.bfloat16).to(cuda)
    assert all(c.folded_w.is_contiguous(memory_format=CL) for c, _ in model._conv_bn_pairs())
    x = _image(128, 1).to(cuda)
    k8 = conv3x3_bn_act.launches
    with torch.inference_mode():
        model(x)
    torch.cuda.synchronize()
    assert conv3x3_bn_act.launches - k8 == W48_PAIRS


@pytest.mark.cuda
def test_kernel_at_its_size_limit_on_card(cuda):
    """W48's 48 -> 48 @ 320^2 at the largest batch the kernel takes (B H W
    Cin just below 2^31): the first and the last image equal what the
    kernel gives each alone, bit for bit (a tile never spans two images,
    so the sums run in the same order); one image more is refused."""
    _, w, bias, _ = _inputs(1, 48, 48, 320, 320, False, device=cuda)
    big = torch.empty((EDGE_BATCH + 1, 48, 320, 320), device=cuda, dtype=torch.bfloat16,
                      memory_format=CL).normal_()
    with pytest.raises(ValueError, match="2\\^31"):
        conv3x3_bn_act(big, w, bias, None, "relu")
    xs = big[:EDGE_BATCH]
    assert xs.is_contiguous(memory_format=CL)
    res = torch.randn_like(xs)
    out = conv3x3_bn_act(xs, w, bias, res, "relu")
    for i in (0, EDGE_BATCH - 1):
        alone = conv3x3_bn_act(xs[i:i + 1], w, bias, res[i:i + 1], "relu")
        assert torch.equal(_bits(out[i:i + 1]), _bits(alone)), i
