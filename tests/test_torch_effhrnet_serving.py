"""EfficientHRNet on the port's serving path against the plain reference
(``bench_h100/reference/efficient_hrnet.py``: the published forward in fp32
plain ``torch``, every BN unfolded, TensorFlow's SAME padding) on the CPU,
at a narrow seeded size: H-1's backbone (WIDTH_MULT 0.909, DEPTH_MULT
0.833), its HRNet stages at SCALE_FACTOR -5 with one module a stage and one
block a branch, every BN's affine and statistics and every conv bias drawn
off the identity so that the fold has work to do.

At eval the port folds its BNs (``layers.FoldsBN``): each conv-BN pair runs
as ``layers.conv_bn`` with its pad, each squeeze-excitation as
``ops.squeeze_excite``.  Held here: the folded forward to the reference in
fp32 and in bf16, the squeeze-excitation op to its twin and the twin to the
module's sequence, no ATen BN, ``rsqrt`` or pad in the eval forward but the
stem's pad, the ``litepose.effhrnet.*`` spans, the benchmark's drawn weights
loading with ``strict=True`` and the reference refusing a weight of another
shape.  On the card (marked ``cuda``, skipped without one): the
squeeze-excitation kernels within one bf16 ulp of the twin, an H-1@480
forward's K6, K7, SE and K8 launches, and the committed heatmap bias shift
of the benchmark's configuration.  No jax here."""

import json
import os
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from litepose_tpu_torch.models import layers as L
from litepose_tpu_torch.models.efficient_hrnet import (DEPTH_TAPS, EFFNET_SETTINGS,
                                                       EffHRNetSpec, init_efficient_hrnet)
from litepose_tpu_torch.models.higher_hrnet import StageSpec
from litepose_tpu_torch.ops.squeeze_excite import squeeze_excite, squeeze_excite_ref

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "bench_h100")
CONFIG = os.path.join(BENCH, "configs", "efficient_hrnet_h1_480.json")
torch.set_num_threads(2)

STAGES = ((1, 2, (1, 1), (32, 64)), (1, 3, (1, 1, 1), (32, 64, 128)),
          (1, 4, (1, 2, 1, 1), (32, 64, 128, 256)))
NARROW = EffHRNetSpec(depth_mult=0.833, width_mult=0.909, scale_factor=-5,
                      stage2=StageSpec(STAGES[0][0], STAGES[0][1], "BASIC", *STAGES[0][2:]),
                      stage3=StageSpec(STAGES[1][0], STAGES[1][1], "BASIC", *STAGES[1][2:]),
                      stage4=StageSpec(STAGES[2][0], STAGES[2][1], "BASIC", *STAGES[2][2:]),
                      deconv_num_basic_blocks=1)
# the same model as a configuration file lays it out
LAYOUT = {"width_mult": 0.909, "depth_mult": 0.833, "scale_factor": -5, "stem_channels": 32,
          "blocks": [list(b) for b in EFFNET_SETTINGS], "taps": list(DEPTH_TAPS[0.833]),
          "stages": [{"num_modules": m, "num_branches": n, "block": "BASIC",
                      "num_blocks": list(b), "num_channels": list(c)} for m, n, b, c in STAGES],
          "final_conv_kernel": 1,
          "deconv": {"num_deconvs": 1, "num_channels": [32], "kernel_size": [4],
                     "num_basic_blocks": 1, "cat_output": [True]}}
J = NARROW.num_joints


def bench_modules():
    """The benchmark's reference and the cell's driver, imported as the
    benchmark imports them."""
    if BENCH not in sys.path:
        sys.path.insert(0, BENCH)
    from drivers import serve_effhrnet_closed_loop as driver
    from reference import efficient_hrnet as reference

    return reference, driver


def seeded(dtype=torch.float32, seed=0):
    """The narrow model in training mode, its BNs and conv biases drawn off
    the identity."""
    model = init_efficient_hrnet(NARROW, torch.Generator().manual_seed(seed), compute_dtype=dtype,
                                 out_dtype=dtype)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                for t, draw in ((m.weight, rng.uniform(0.5, 1.5, c)),
                                (m.bias, rng.normal(0, 0.2, c)),
                                (m.running_mean, rng.normal(0, 0.2, c)),
                                (m.running_var, rng.uniform(0.5, 1.5, c))):
                    t.copy_(torch.from_numpy(draw.astype(np.float32)))
            elif isinstance(m, torch.nn.Conv2d) and m.bias is not None:
                m.bias.copy_(torch.from_numpy(rng.normal(0, 0.2, m.out_channels)
                                              .astype(np.float32)))
    return model


def images(n=2, size=64, seed=2):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 256, (n, size, size, 3),
                                                                 dtype=np.uint8))


def reference_of(model):
    ref_mod, _ = bench_modules()
    return ref_mod.Reference(model.state_dict(), LAYOUT, J, "cpu")


def test_folded_forward_matches_the_plain_reference_in_fp32():
    """fp32 on both sides: only the fold's rounding and the summation order
    differ, below 1e-6 of the outputs' scale; 1e-5 of it leaves room and
    still catches a wrong bias, a BN applied twice or a pad on the wrong
    side."""
    model = seeded().eval()
    ref = reference_of(model)
    x = images()
    with torch.no_grad():
        got = model(ref.normalize(x))
    want = ref.outputs(x)
    assert [g.shape for g in got] == [w.shape for w in want] == [(2, 28, 16, 16), (2, 14, 32, 32)]
    for g, w in zip(got, want):
        assert (g - w).abs().max() <= 1e-5 * w.abs().max()


def test_folded_forward_in_bf16_is_near_the_plain_reference():
    """bf16 weights and activations round each conv's operands to 8 bits of
    mantissa (2^-9 relative) through the model's depth: the outputs' RMS gap
    to the fp32 reference is about 2%, held to 5%; a forward that lost a BN,
    a bias, a Swish or a gate is off by far more."""
    model = seeded(torch.bfloat16).eval()
    ref = reference_of(model)
    x = images()
    with torch.no_grad():
        got = model(ref.normalize(x))
    for g, w in zip(got, ref.outputs(x)):
        assert g.dtype == torch.bfloat16
        rel = ((g.double() - w.double()).norm() / w.double().norm()).item()
        assert rel < 0.05, rel


def _se_inputs(B=2, C=24, R=6, H=5, W=7, dtype=torch.bfloat16, seed=0, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    y = torch.randn((B, C, H, W), generator=g).mul(2).to(dtype)
    w1 = (torch.randn((R, C), generator=g) / C ** 0.5).to(dtype)
    b1 = torch.randn((R,), generator=g).mul(0.2).to(dtype)
    w2 = (torch.randn((C, R), generator=g) / R ** 0.5).to(dtype)
    b2 = torch.randn((C,), generator=g).mul(0.2).to(dtype)
    return tuple(t.to(device) for t in (y, w1, b1, w2, b2))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_squeeze_excite_twin_is_the_module_sequence(dtype):
    """The op on the CPU is its twin, and the twin is the sequence the
    module ran before the op: the mean in fp32 cast back, each linear's
    product and bias add in the activation dtype, Swish, the sigmoid, the
    product."""
    y, w1, b1, w2, b2 = _se_inputs(dtype=dtype)
    m = y.float().mean(dim=(2, 3)).to(dtype)
    h = m @ w1.t() + b1
    h = h * torch.sigmoid(h)
    want = y * torch.sigmoid(h @ w2.t() + b2)[:, :, None, None]
    for got in (squeeze_excite(y, w1, b1, w2, b2), squeeze_excite_ref(y, w1, b1, w2, b2)):
        assert got.dtype == dtype and torch.equal(got, want)


def test_squeeze_excite_op_checks():
    args = _se_inputs()
    torch.library.opcheck(torch.ops.litepose.squeeze_excite.default, args)
    y, w1, b1, w2, b2 = args
    with pytest.raises(ValueError, match="w1"):
        squeeze_excite(y, w1[:, :-1], b1, w2, b2)
    with pytest.raises(TypeError, match="dtype"):
        squeeze_excite(y, w1.float(), b1, w2, b2)
    with pytest.raises(ValueError, match="B, C, H, W"):
        squeeze_excite(y[0], w1, b1, w2, b2)


def test_module_takes_the_op_at_bf16_eval(monkeypatch):
    """Each squeeze-excitation of a bf16 eval forward calls the op once, with
    the linears' weights stored in bf16 (no cast a call); training, fp32 and
    a gradient to carry take the twin."""
    from litepose_tpu_torch.models import efficient_hrnet

    calls, op = [], efficient_hrnet.squeeze_excite
    monkeypatch.setattr(efficient_hrnet, "squeeze_excite",
                        lambda y, *w: calls.append([t.data_ptr() for t in w]) or op(y, *w))
    model = seeded(torch.bfloat16).eval()
    blocks = [m for m in model.modules() if isinstance(m, efficient_hrnet.SqueezeExcitation)]
    x = torch.randn((1, 3, 64, 64), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        model(x)
    assert len(calls) == len(blocks) == 16
    stored = [[m.se[i].cast_w.data_ptr() for i in (1, 3)] for m in blocks]
    assert [[c[0], c[2]] for c in calls] == stored
    calls.clear()
    with torch.no_grad():
        seeded(torch.float32).eval()(x)
        model.train()(x)
    assert calls == []


def _outside(e, name):
    p = e.cpu_parent
    while p is not None:
        if p.name.startswith(name):
            return False
        p = p.cpu_parent
    return True


def test_bf16_eval_forward_runs_no_batch_norm_rsqrt_or_pad_but_the_stem_s():
    """Under the profiler one bf16 eval forward on the CPU runs no ATen BN
    and no ``rsqrt`` (the BNs are folded, the head BN's affine stored), and
    one pad outside the ops: the stem's, an asymmetric SAME pad before a
    dense stride-2 conv, which cuDNN's symmetric padding cannot give (the
    depthwise op's CPU twin pads inside the op; its kernel reads zeros)."""
    model = seeded(torch.bfloat16).eval()
    x = torch.randn((1, 3, 64, 64), generator=torch.Generator().manual_seed(1))
    with profile(activities=[ProfilerActivity.CPU]) as prof, torch.no_grad():
        model(x)
    events = prof.events()
    names = [e.name for e in events]
    assert "aten::batch_norm" not in names and "aten::rsqrt" not in names
    pads = [e for e in events if e.name == "aten::constant_pad_nd"
            and _outside(e, "litepose::depthwise_conv")]
    assert len(pads) == 1


def test_forward_opens_each_span():
    """One eval forward opens the backbone once, a squeeze-excitation a
    block inside it, a transition, a module's branches and its fuse once a
    stage (one module a stage), and the head once."""
    model = seeded().eval()
    x = reference_of(model).normalize(images(1))
    with profile(activities=[ProfilerActivity.CPU]) as prof, torch.no_grad():
        model(x)
    got = {}
    for e in prof.events():
        if e.name.startswith(("litepose.hrnet.", "litepose.effhrnet.")):
            got[e.name] = got.get(e.name, 0) + 1
    assert got == {"litepose.effhrnet.backbone": 1, "litepose.effhrnet.se": 16,
                   "litepose.hrnet.transition": 3, "litepose.hrnet.branches": 3,
                   "litepose.hrnet.fuse": 3, "litepose.hrnet.head": 1}


def test_the_drawn_state_dict_loads_into_the_port():
    """The cell's weights (``serve_effhrnet_closed_loop.weights``), drawn
    from the configuration alone, load into the port's H-1 with
    ``strict=True``: the same names and shapes.  The heatmap biases are the
    configuration's shift, the tag biases 0, and a seed draws the same
    tensors."""
    from litepose_tpu_torch.models.efficient_hrnet import EfficientHRNet

    _, driver = bench_modules()
    with open(CONFIG) as f:
        cfg = json.load(f)
    sd = driver.weights(cfg)
    model = EfficientHRNet(driver.effhrnet_spec(cfg), compute_dtype=torch.float32)
    model.load_state_dict(sd, strict=True)
    for k in ("final_layers.0.bias", "final_layers.1.bias"):
        assert sd[k][:J].tolist() == pytest.approx(cfg["heatmap_bias_shift"])
    assert not sd["final_layers.0.bias"][J:].any()
    again = driver.weights(cfg)
    assert all(torch.equal(sd[k], again[k]) for k in sd)


def test_the_reference_refuses_a_weight_of_another_shape():
    """A depthwise weight that came as a dense one, and a 1x1 fuse conv that
    came as a 3x3 one, are refused, not run at the weights' size."""
    ref_mod, _ = bench_modules()
    sd = seeded().state_dict()
    x = images(1)
    for name, shape in (("features.1.conv.0.1.weight", lambda s: (s[0], s[0], 3, 3)),
                        ("stage2.0.fuse_layers.0.1.0.weight", lambda s: (*s[:2], 3, 3))):
        bad = dict(sd, **{name: torch.zeros(shape(tuple(sd[name].shape)))})
        with pytest.raises(ValueError, match="kernel"):
            ref_mod.Reference(bad, LAYOUT, J, "cpu").outputs(x)


# -- on the card -------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the squeeze-excitation kernels have no CPU mode")
    return torch.device("cuda")


def _ulp(t):
    """One bf16 ulp at each value of ``t`` (bf16), as fp32."""
    bits = t.float().abs().clamp_min(2.0 ** -126).view(torch.int32) & 0x7F800000
    return bits.view(torch.float32) * 2.0 ** -7


# H-1@480's squeeze-excitations: (C, R, plane)
SE_SHAPES = {"32@240": (32, 8, 240), "96@120": (96, 4, 120), "144@60": (144, 6, 60),
             "432@30": (432, 18, 30), "1056@15": (1056, 44, 15)}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(SE_SHAPES))
def test_squeeze_excite_kernels_within_an_ulp_on_card(cuda, shape):
    """At H-1@480's shapes (b4): the kernels' output lies within one bf16
    ulp of the twin run on the card (ATen's mean and cuBLAS's dots with bf16
    reductions off), and equals it on most outputs: only the fp32 sums'
    order differs.  Two launches a call; the dispatcher's path (a new
    tensor) and the eager one (written into y) agree."""
    from litepose_tpu_torch.ops import library

    C, R, n = SE_SHAPES[shape]
    y, w1, b1, w2, b2 = _se_inputs(4, C, R, n, n, seed=C, device=cuda)
    saved = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        want = squeeze_excite_ref(y, w1, b1, w2, b2).float()
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = saved
    before = squeeze_excite.launches
    new = library.squeeze_excite_cuda(y, w1, b1, w2, b2)
    got = squeeze_excite(y.clone(), w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert squeeze_excite.launches == before + 4
    assert torch.equal(new, got)
    gap = (got.float() - want).abs()
    assert bool((gap <= _ulp(want.to(torch.bfloat16))).all()), gap.max()
    assert float((gap == 0).float().mean()) > 0.99


@pytest.mark.cuda
def test_h1_forward_launches_on_card(cuda):
    """One bf16 eval forward of H-1@480 at b2 on the card: 16 K6 launches
    (one a depthwise conv, Swish in each), one K7 a dense conv-BN pair (195:
    the backbone's stem, 15 expand and 16 project convs, 9 transitions, 96
    block convs in the stages and 4 in the head, 25 1x1 and 33 stride-2
    fuse convs), two
    squeeze-excitation launches a block, no K8 launch (no width a multiple
    of 16), and no ATen BN, ``rsqrt`` or pad but the stem's pad."""
    from litepose_tpu_torch.models.efficient_hrnet import EfficientHRNet
    from litepose_tpu_torch.ops.dense_conv import conv3x3_bn_act
    from litepose_tpu_torch.ops.depthwise import depthwise_conv
    from litepose_tpu_torch.ops.epilogue import conv_epilogue

    _, driver = bench_modules()
    with open(CONFIG) as f:
        cfg = json.load(f)
    model = EfficientHRNet(driver.effhrnet_spec(cfg), compute_dtype=torch.bfloat16,
                           out_dtype=torch.bfloat16)
    model.load_state_dict(driver.weights(cfg))
    model = model.to(cuda).eval()
    pairs = model._conv_bn_pairs()
    dense = sum(c.groups == 1 for c, _ in pairs)
    x = torch.randn((2, 3, 480, 480), device=cuda)
    with torch.no_grad():
        model(x)  # warm-up: the kernels build and load
        counts = (depthwise_conv.launches, conv_epilogue.launches, squeeze_excite.launches,
                  conv3x3_bn_act.launches)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            outs = model(x)
        torch.cuda.synchronize()
    got = (depthwise_conv.launches - counts[0], conv_epilogue.launches - counts[1],
           squeeze_excite.launches - counts[2], conv3x3_bn_act.launches - counts[3])
    assert got == (16, dense, 32, 0) and len(pairs) - dense == 16 and dense == 195
    names = [e.name for e in prof.events()]
    assert "aten::batch_norm" not in names and "aten::rsqrt" not in names
    assert names.count("aten::constant_pad_nd") == 1
    assert [tuple(o.shape) for o in outs] == [(2, 28, 120, 120), (2, 14, 240, 240)]
    assert all(bool(o.isfinite().all()) for o in outs)


@pytest.mark.cuda
def test_the_committed_heatmap_bias_shift_is_the_reference_s(cuda):
    """The configuration's ``heatmap_bias_shift`` is what the fp32
    reference gives on the card from the cell's weights, within 1e-4 of
    each value's scale (the maps are of order 1; fp32 convs summed in
    another order move the k-th value by about 1e-6)."""
    _, driver = bench_modules()
    with open(CONFIG) as f:
        cfg = json.load(f)
    got = driver.heatmap_bias_shift(cfg, "cuda")
    assert got == pytest.approx(cfg["heatmap_bias_shift"], rel=1e-4, abs=1e-4)
