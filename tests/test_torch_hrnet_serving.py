"""HigherHRNet on the port's serving path against the plain reference
(``tests/plain_higher_hrnet.py``: the published forward in fp32 plain
``torch``, every BN unfolded) on the CPU, at a narrow seeded size: widths
8/16/32/64, one module a stage, every BN's affine and statistics drawn off
the identity so that the fold has work to do.

At eval the port folds its BNs (``layers.FoldsBN``): each conv-BN pair runs
as ``layers.conv_bn`` and the head's convs keep their weights in the
compute dtype.  Held here: the folded forward to the reference in fp32 and
in bf16, ``PoseEngine.process_batch_square``'s people to the reference's
maps decoded by the twins, the benchmark's copy of the reference to this
one bit for bit, its fp8 control outside the benchmark's limits, the
switches between training and eval, and the ``litepose.hrnet.*`` spans;
and for every family that folds (LitePose, LitePose-ResNet, HigherHRNet,
EfficientHRNet) the eval constants ``fold_bn_`` stores.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from litepose_tpu_torch.models import layers as L
from litepose_tpu_torch.models.higher_hrnet import (HigherHRNet, HRNetSpec, StageSpec,
                                                    init_higher_hrnet)
from litepose_tpu_torch.utils import spans

import plain_higher_hrnet as plain

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "bench_h100")
torch.set_num_threads(2)

NARROW = HRNetSpec(
    stem_inplanes=8,
    stage2=StageSpec(1, 2, "BASIC", (1, 2), (8, 16)),
    stage3=StageSpec(1, 3, "BASIC", (1, 1, 2), (8, 16, 32)),
    stage4=StageSpec(1, 4, "BASIC", (1, 1, 1, 1), (8, 16, 32, 64)),
    deconv_channels=(8,), deconv_num_basic_blocks=1)
# the same model as a configuration file lays it out
LAYOUT = {"stem_inplanes": 8,
          "stages": [{"num_modules": s.num_modules, "num_branches": s.num_branches,
                      "block": s.block, "num_blocks": list(s.num_blocks),
                      "num_channels": list(s.num_channels)}
                     for s in (NARROW.stage2, NARROW.stage3, NARROW.stage4)],
          "final_conv_kernel": 1,
          "deconv": {"num_deconvs": 1, "num_channels": [8], "kernel_size": [4],
                     "num_basic_blocks": 1, "cat_output": [True]}}
J = NARROW.num_joints
ENGINE_SIZE = 128


def off_identity(model, seed=0):
    """``model`` with every BN's affine and statistics drawn off the
    identity."""
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
    return model


def seeded(dtype=torch.float32, seed=0):
    """The narrow model in training mode, its BNs drawn off the identity."""
    return off_identity(init_higher_hrnet(NARROW, torch.Generator().manual_seed(seed),
                                          compute_dtype=dtype, out_dtype=dtype), seed)


def images(n=2, size=64, seed=2):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 256, (n, size, size, 3),
                                                                 dtype=np.uint8))


def forward(model, ref, imgs):
    with torch.no_grad():
        return model(ref.normalize(imgs))


def bench_modules():
    """The benchmark's check and its copy of the reference, imported as the
    benchmark imports them."""
    if BENCH not in sys.path:
        sys.path.insert(0, BENCH)
    from reference import check, higher_hrnet

    return check, higher_hrnet


def bench_config():
    with open(os.path.join(BENCH, "configs", "higher_hrnet_w48_640.json")) as f:
        return json.load(f)


def _litepose(dtype):
    from litepose_tpu_torch.arch import get_arch
    from litepose_tpu_torch.models.litepose import ModelSpec, init_litepose

    return init_litepose(ModelSpec(), get_arch("auto-XS"), torch.Generator().manual_seed(0),
                         compute_dtype=dtype, out_dtype=dtype)


def _litepose_resnet(dtype):
    from litepose_tpu_torch.models.litepose import ModelSpec
    from litepose_tpu_torch.models.litepose_resnet import init_litepose_resnet

    return init_litepose_resnet(ModelSpec(deconv_kernels=(3, 3, 3)),
                                torch.Generator().manual_seed(0), compute_dtype=dtype,
                                out_dtype=dtype)


def _efficient_hrnet(dtype):
    from litepose_tpu_torch.models.efficient_hrnet import EffHRNetSpec, init_efficient_hrnet

    spec = EffHRNetSpec(depth_mult=0.483, width_mult=0.684, scale_factor=-5,
                        stage2=StageSpec(1, 2, "BASIC", (1, 1), (32, 64)),
                        stage3=StageSpec(1, 3, "BASIC", (1, 1, 1), (32, 64, 128)),
                        stage4=StageSpec(1, 4, "BASIC", (1, 1, 1, 1), (32, 64, 128, 256)),
                        deconv_num_basic_blocks=1)
    return init_efficient_hrnet(spec, torch.Generator().manual_seed(0), compute_dtype=dtype,
                                out_dtype=dtype)


# family: (the model in training mode, its convs outside a pair, its BNs outside a pair)
FOLDING = {
    # 6 transposed convs, the 4 heads' pointwise convs; the 3 head BNs
    "litepose": (_litepose, 10, 3),
    # 6 upsampling convs, 4 final convs with a bias; the 3 head BNs
    "litepose-resnet": (_litepose_resnet, 10, 3),
    # 2 final convs with a bias, the transposed conv; its BN
    "higher-hrnet": (lambda dtype: init_higher_hrnet(NARROW, torch.Generator().manual_seed(0),
                                                     compute_dtype=dtype, out_dtype=dtype),
                     3, NARROW.num_deconvs),
    # the 10 squeeze-excitations' two linears, 2 final convs, the transposed
    # conv; its BN
    "efficient-hrnet": (_efficient_hrnet, 23, 1),
}
CONVS = (torch.nn.Conv2d, torch.nn.ConvTranspose2d)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("family", list(FOLDING))
def test_eval_folds_every_conv_bn_pair_and_training_drops_them(family, dtype):
    """``eval()`` stores every constant of the eval forward once
    (``layers.prepare_eval_``): each conv-BN pair's folded weight and its
    fp32 bias, ``fold_bn``'s; every other conv's weight and bias as cast at
    call time; every other BN's affine as ``bn_affine`` gives it, cast.
    The readers take the stored copies, none is in the state dict, and
    ``train()`` drops them all."""
    make, n_convs, n_bns = FOLDING[family]
    model = off_identity(make(dtype))
    pairs = model._conv_bn_pairs()
    paired = {id(m) for pair in pairs for m in pair}
    convs = [m for m in model.modules() if isinstance(m, CONVS) and id(m) not in paired]
    bns = [m for m in model.modules()
           if isinstance(m, torch.nn.BatchNorm2d) and id(m) not in paired]
    assert len({id(c) for c, _ in pairs}) == len(pairs) == len(paired) // 2
    assert (len(convs), len(bns)) == (n_convs, n_bns)

    def held():
        return [name for m in model.modules() for name in L.EVAL_BUFFERS
                if m._buffers.get(name) is not None]

    assert held() == []
    model.eval()
    for conv, bn in pairs:
        w, bias = L.fold_bn(conv, bn, dtype)
        assert conv.folded_b.dtype == torch.float32
        assert torch.equal(conv.folded_w, w) and torch.equal(conv.folded_b, bias)
    for m in convs:
        assert m.cast_w.dtype == dtype and torch.equal(m.cast_w, m.weight.to(dtype))
        assert L.weight(m, dtype) is m.cast_w
        if m.bias is None:
            assert "cast_b" not in m._buffers
        else:
            assert m.cast_b.dtype == dtype and torch.equal(m.cast_b, m.bias.to(dtype))
    for bn in bns:
        inv, bias = L.bn_affine(bn)
        assert torch.equal(bn.eval_inv, inv.to(dtype)) and torch.equal(bn.eval_b, bias.to(dtype))
    assert len(held()) == 2 * len(pairs) + len(convs) + sum(
        m.bias is not None for m in convs) + 2 * len(bns)
    assert not set(held()) & {k.rsplit(".", 1)[-1] for k in model.state_dict()}
    model.train()
    assert held() == []


def test_litepose_bf16_eval_forward_casts_no_parameter():
    """Under the profiler one bf16 eval forward of LitePose on the CPU
    derives nothing from the weights: no BN affine (``aten::rsqrt``) and no
    cast of a weight.  Its only casts are the folded pairs' fp32 biases,
    one a pair, which the CPU twins of the depthwise and epilogue kernels
    round to bf16 as the kernels do."""
    model = off_identity(_litepose(torch.bfloat16)).eval()
    x = torch.randn((1, 3, 64, 64), generator=torch.Generator().manual_seed(1)).bfloat16()
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof, \
            torch.no_grad():
        model(x)
    names = [e.name for e in prof.events()]
    assert "aten::convolution" in names and "aten::rsqrt" not in names
    casts = sorted(tuple(e.input_shapes[0]) for e in prof.events() if e.name == "aten::_to_copy")
    assert casts == sorted((c.out_channels,) for c, _ in model._conv_bn_pairs())


def test_channels_last_input_gives_the_nchw_outputs():
    """On a card the eval forward runs channels-last; on the CPU a
    channels-last input takes the same layers (the fuse's
    ``layers.upsample_nearest`` repeats each pixel in either layout and
    keeps the layout) and gives the NCHW forward's outputs within fp32
    rounding."""
    x = torch.randn(2, 6, 5, 7)
    for f in (2, 4, 8):
        want = x.repeat_interleave(f, dim=2).repeat_interleave(f, dim=3)
        assert torch.equal(L.upsample_nearest(x, f), want)
        got = L.upsample_nearest(x.contiguous(memory_format=torch.channels_last), f)
        assert got.is_contiguous(memory_format=torch.channels_last) and torch.equal(got, want)
    model = seeded().eval()
    x = plain.Reference(model.state_dict(), LAYOUT, J, "cpu").normalize(images())
    with torch.no_grad():
        want = model(x)
        got = model(x.contiguous(memory_format=torch.channels_last))
    for g, w in zip(got, want):
        assert (g - w).abs().max() <= 1e-5 * w.abs().max()


def test_folded_forward_matches_the_plain_reference_in_fp32():
    """fp32 on both sides, TF32 off: only the fold's rounding and the
    summation order differ, about 1.3e-6 of the outputs' scale; 1e-5 of it
    leaves room and still catches a wrong bias or a BN applied twice."""
    model = seeded().eval()
    ref = plain.Reference(model.state_dict(), LAYOUT, J, "cpu")
    x = images()
    got, want = forward(model, ref, x), ref.outputs(x)
    assert [g.shape for g in got] == [w.shape for w in want] == [(2, 28, 16, 16), (2, 14, 32, 32)]
    for g, w in zip(got, want):
        assert (g - w).abs().max() <= 1e-5 * w.abs().max()


def test_folded_forward_in_bf16_is_near_the_plain_reference():
    """bf16 weights and activations round each conv's operands to 8 bits of
    mantissa (2^-9 relative) through the model's 25 convs in depth: the
    outputs' RMS gap to the fp32 reference is about 1.4%, held to 3%; a
    forward that lost a BN or a bias is off by far more."""
    model = seeded(torch.bfloat16).eval()
    ref = plain.Reference(model.state_dict(), LAYOUT, J, "cpu")
    x = images()
    for g, w in zip(forward(model, ref, x), ref.outputs(x)):
        assert g.dtype == torch.bfloat16
        rel = ((g.double() - w.double()).norm() / w.double().norm()).item()
        assert rel < 0.03, rel


def test_engine_people_match_the_reference_maps_decoded_by_the_twins():
    """``process_batch_square`` (serving form, fp32) on two bench scenes,
    the heatmap biases shifted so that 2% of each plane of the reference's
    maps lies above the threshold: the people, scores and counts of the
    twins' decode of the reference's maps, coordinates within 1e-3 px and
    scores within 1e-4 (the fp32 maps differ by about 1e-6)."""
    from litepose_tpu_torch.core.engine import EngineConfig, PoseEngine
    from litepose_tpu_torch.core.inference import InferenceFlags
    from litepose_tpu_torch.data.synthetic import bench_scene_batch
    from litepose_tpu_torch.ops.group import GroupParams, parse_batch

    model = seeded(seed=6)
    imgs = bench_scene_batch(2, ENGINE_SIZE, seed=3)
    det, _ = plain.Reference(model.state_dict(), LAYOUT, J, "cpu").maps(torch.from_numpy(imgs))
    shift = plain.peak_shift(det, share=0.02)
    with torch.no_grad():
        for conv in model.final_layers:
            conv.bias[:J] += shift
    model.eval()
    ref = plain.Reference(model.state_dict(), LAYOUT, J, "cpu")
    flags = InferenceFlags(num_joints=J, with_heatmaps_loss=(True, True),
                           with_ae_loss=(True, False), test_with_heatmaps=(True, True),
                           test_with_ae=(True, False))
    engine = PoseEngine(model, flags, GroupParams(num_joints=J, detection_threshold=0.1),
                        EngineConfig(input_size=ENGINE_SIZE, assignment="greedy",
                                     topk_method="approx", with_adjust=False,
                                     with_refine=False, project2image=False),
                        device="cpu")
    people, scores, counts = engine.process_batch_square(imgs)
    det, tag = ref.maps(torch.from_numpy(imgs))
    want = parse_batch(det, tag, engine.group_cfg, False, False, tag_layout="thw")
    np.testing.assert_array_equal(counts, want[2].numpy())
    assert counts.min() > 0
    np.testing.assert_allclose(people, want[0].numpy(), atol=1e-3, rtol=0)
    np.testing.assert_allclose(scores, want[1].numpy(), atol=1e-4, rtol=0)


@pytest.mark.parametrize("precision", ["fp32", "fp8"])
def test_benchmark_copy_of_the_reference_equals_it_bit_for_bit(precision):
    _, bench_ref = bench_modules()
    model = seeded(seed=4).eval()
    x = images(seed=5)
    a = plain.Reference(model.state_dict(), LAYOUT, J, "cpu", precision=precision)
    b = bench_ref.Reference(model.state_dict(), LAYOUT, J, "cpu", precision=precision)
    for u, v in zip(a.outputs(x), b.outputs(x)):
        assert torch.equal(u, v)
    for u, v in zip(a.maps(x), b.maps(x)):
        assert torch.equal(u, v)
    assert torch.equal(plain.peak_shift(a.maps(x)[0]), bench_ref.peak_shift(b.maps(x)[0]))


def test_fp8_control_fails_a_limit_the_bf16_program_meets():
    """The benchmark's comparison (``reference/check.py:numbers``) at the
    cell's limits: the port's bf16 maps and decode meet every limit; the
    reference in fp8 with a bf16 decode, put in the program's place, fails
    at least one."""
    check, bench_ref = bench_modules()
    from litepose_tpu_torch.core.inference import InferenceFlags, make_infer_fn
    from litepose_tpu_torch.ops.group import GroupParams, StaticGroupCfg, parse_batch

    cfg = bench_config()
    model = seeded(torch.bfloat16, seed=7)
    imgs = images(2, ENGINE_SIZE, seed=8).numpy()
    det, _ = bench_ref.Reference(model.state_dict(), LAYOUT, J, "cpu").maps(
        torch.from_numpy(imgs))
    with torch.no_grad():
        for conv in model.final_layers:
            conv.bias[:J] += bench_ref.peak_shift(det, share=0.02)
    model.eval()
    ref = bench_ref.Reference(model.state_dict(), LAYOUT, J, "cpu")
    control = bench_ref.Reference(model.state_dict(), LAYOUT, J, "cpu", precision="fp8")

    flags = InferenceFlags(num_joints=J, with_heatmaps_loss=(True, True),
                           with_ae_loss=(True, False), test_with_heatmaps=(True, True),
                           test_with_ae=(True, False), decode_bf16=True)
    with torch.inference_mode():
        det_p, tag_p = make_infer_fn(model, flags)(torch.from_numpy(imgs))
    group = StaticGroupCfg.from_params(
        GroupParams(num_joints=J, max_num_people=cfg["max_people"],
                    detection_threshold=cfg["detection_threshold"],
                    tag_threshold=cfg["tag_threshold"], nms_kernel=cfg["nms_kernel"],
                    nms_padding=cfg["nms_kernel"] // 2, joint_order=cfg["joint_order"],
                    max_clusters=cfg["max_clusters"]),
        assignment="greedy", topk_method="approx")
    people = parse_batch(det_p, tag_p, group, False, False, tag_layout="thw")
    program = check.numbers(ref, cfg, imgs, det_p, tag_p, *(t.numpy() for t in people))
    assert all(program[k] <= limit for k, limit in cfg["limits"].items()), program
    got = check.numbers(ref, cfg, imgs, *check.control_outputs(control, cfg, imgs))
    assert [k for k, limit in cfg["limits"].items() if got[k] > limit], got
    assert got["det_rel_rms"] > cfg["limits"]["det_rel_rms"], got


def test_fold_train_eval_serves_the_trained_weights():
    """Folded at eval, trained (an SGD step and the BN statistics of a
    training forward; a ``fold_bn_`` in training mode changes nothing), then
    eval again: the forward is that of a fresh model holding the trained
    state, not the weights folded before training."""
    model = seeded().eval()
    ref = plain.Reference(model.state_dict(), LAYOUT, J, "cpu")
    x = ref.normalize(images())
    with torch.no_grad():
        before = model(x)
    model.train()
    model.fold_bn_()  # stored copies are not read in training
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    loss = sum(o.square().mean() for o in model(x))
    loss.backward()
    heads = list(model.final_layers) + [stage[0][0] for stage in model.deconv_layers]
    assert all(m.weight.grad is not None for m in heads)
    opt.step()
    model.eval()
    fresh = fresh_model(model.state_dict())
    with torch.no_grad():
        after, want = model(x), fresh(x)
    for a, w in zip(after, want):
        assert torch.equal(a, w)
    assert not torch.equal(before[0], after[0])


def fresh_model(state_dict):
    model = HigherHRNet(NARROW, compute_dtype=torch.float32, out_dtype=torch.float32)
    model.load_state_dict(state_dict)
    return model.eval()


def test_forward_opens_each_hrnet_span():
    """Under the profiler one eval forward of the narrow model opens the
    stem and the head once, a transition, a module's branches and its fuse
    once a stage (one module a stage)."""
    model = seeded().eval()
    x = plain.Reference(model.state_dict(), LAYOUT, J, "cpu").normalize(images(1))
    with profile(activities=[ProfilerActivity.CPU]) as prof, torch.no_grad():
        model(x)
    got = {}
    for e in prof.events():
        if e.name.startswith("litepose.hrnet."):
            got[e.name] = got.get(e.name, 0) + 1
    assert got == {"litepose.hrnet.stem": 1, "litepose.hrnet.transition": 3,
                   "litepose.hrnet.branches": 3, "litepose.hrnet.fuse": 3,
                   "litepose.hrnet.head": 1}
    assert set(got) == set(spans.HRNET_SPANS)


def test_no_profiler_makes_no_record_function(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a RecordFunction with no profiler on")

    model = seeded().eval()
    x = plain.Reference(model.state_dict(), LAYOUT, J, "cpu").normalize(images(1))
    monkeypatch.setattr(spans, "record_function", refuse)
    with torch.no_grad():
        out = model(x)
    assert [o.shape for o in out] == [(1, 28, 16, 16), (1, 14, 32, 32)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the channels-last eval forward runs on a card only")
    return torch.device("cuda")


@pytest.mark.cuda
def test_eval_forward_on_the_card(cuda):
    """On the card the folded weights are stored channels-last and the eval
    forward runs so: fp32 with TF32 off, its outputs are the CPU forward's
    within 1e-5 of their scale."""
    model = seeded().eval()
    x = plain.Reference(model.state_dict(), LAYOUT, J, "cpu").normalize(images())
    with torch.no_grad():
        want = model(x)
    model = model.to(cuda).eval().fold_bn_()
    assert all(c.folded_w.is_contiguous(memory_format=torch.channels_last)
               for c, _ in model._conv_bn_pairs())
    heads = list(model.final_layers) + [stage[0][0] for stage in model.deconv_layers]
    assert all(m.cast_w.is_contiguous(memory_format=torch.channels_last) for m in heads)
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            got = model(x.to(cuda))
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    for g, w in zip(got, want):
        assert g.is_contiguous(memory_format=torch.channels_last)
        assert (g.cpu() - w).abs().max() <= 1e-5 * w.abs().max()
