"""Serving artifacts (``core/export.py``), the counterparts of
``tests/test_export.py``: the exported program (weights as arguments or
baked in) equals the live engine bit for bit on the CPU, saved and loaded
too; its graph holds the kernels as ``torch.ops.litepose.*`` nodes (the
counterpart of ``"tpu_custom_call" in mlir``); a fresh interpreter loads and
runs it with no model, arch, config or engine code; the CPU artifact agrees
with the JAX package's live engine on the same bridged weights; the export
CLI writes an artifact.  Small sizes: ``ArchManager().fixed_sample(reso=64,
ratio=0.25)``, batch 2."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from litepose_tpu_torch.core.engine import EngineConfig, PoseEngine
from litepose_tpu_torch.core.export import (engine_weights, export_engine, fused_body,
                                            load_artifact, save_artifact)
from litepose_tpu_torch.core.inference import InferenceFlags
from litepose_tpu_torch.data.flip import flip_index_for
from litepose_tpu_torch.models.litepose import ModelSpec, init_litepose
from litepose_tpu_torch.ops.group import GroupParams

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 64
FLAGS = dict(num_joints=14, with_heatmaps_loss=(True, True), with_ae_loss=(True, False),
             test_with_heatmaps=(True, True), test_with_ae=(True, False), flip_test=False,
             flip_index=tuple(flip_index_for("crowd_pose")))
SERVING = dict(input_size=SIZE, scale_factors=(1.0,), with_adjust=False, with_refine=False,
               project2image=False, assignment="greedy", topk_method="approx")
EVAL = dict(SERVING, with_adjust=True, with_refine=True, project2image=True,
            assignment="hungarian", topk_method="exact")


def _arch():
    from litepose_tpu_torch.arch import ArchManager

    return ArchManager().fixed_sample(reso=SIZE, ratio=0.25)


def _engine(config=SERVING, flip=False, model=None):
    torch.manual_seed(0)
    if model is None:
        model = init_litepose(ModelSpec(num_joints=14), _arch(),
                              torch.Generator().manual_seed(0)).eval()
    return PoseEngine(model, InferenceFlags(**dict(FLAGS, flip_test=flip)),
                      GroupParams(num_joints=14, detection_threshold=0.1),
                      EngineConfig(**config), device="cpu")


def _images(seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 255, (2, SIZE, SIZE, 3)).astype(np.uint8))


def _assert_equal(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.equal(g, w)


@pytest.fixture(scope="module")
def serving():
    return _engine()


def test_export_args_mode_bitmatches_live_program(serving, tmp_path):
    imgs = _images(3)
    want = serving.run_batch(imgs)[2:]
    with torch.no_grad():
        _assert_equal(fused_body(serving)(imgs), want)

    ep = export_engine(serving, batch=2, bake_params=False)
    assert not ep.state_dict  # the weights are arguments, not in the program
    path = str(tmp_path / "args_mode.pt2")
    info = save_artifact(ep, path)
    assert info.batch == 2 and info.in_hw == (SIZE, SIZE) and info.nbytes > 0
    assert info.device == "cpu" and info.nbytes == os.path.getsize(path)

    serve = load_artifact(path, device="cpu")
    _assert_equal(serve(engine_weights(serving), imgs), want)


def test_baked_artifact_roundtrip(serving, tmp_path):
    imgs = _images(4)
    ep = export_engine(serving, batch=2)
    in_memory = ep.module()(imgs)
    path = str(tmp_path / "baked.pt2")
    assert save_artifact(ep, path).device == "cpu"
    serve = load_artifact(path, device="cpu")  # no model code needed from here on
    got = serve(imgs)
    _assert_equal(got, in_memory)
    _assert_equal(got, serving.run_batch(imgs)[2:])
    assert got[0].shape == (2, 40, 14, 4) and got[2].shape == (2,)


def _litepose_targets(ep):
    return sorted(str(n.target) for n in ep.graph.nodes if "litepose" in str(n.target))


def test_graph_holds_the_kernels(serving):
    """The counterpart of ``"tpu_custom_call" in mlir``: each kernel is one
    node of the exported graph, K1 + K2 on the serving path, K1 + K3 + K4
    under ``--exact --eval-decode`` (flip test and projection too), and the
    bf16 forward's depthwise convs one K6 node each and its other folded
    convs' epilogues one K7 node each (flip test runs one forward over the
    doubled batch)."""
    pairs = [c for c, _ in serving.apply_fn._conv_bn_pairs()]
    dw = sum(1 for c in pairs if c.groups == c.in_channels == c.out_channels > 1)
    forward = (["litepose.conv_epilogue.default"] * (len(pairs) - dw)
               + ["litepose.depthwise_conv.default"] * dw)
    assert dw > 0 and len(pairs) > dw
    assert _litepose_targets(export_engine(serving, batch=2)) == [
        *forward, "litepose.group_greedy.default", "litepose.nms_topk.default"]
    evaluator = _engine(EVAL, flip=True, model=serving.apply_fn)
    ep = export_engine(evaluator, batch=2)
    assert _litepose_targets(ep) == [*forward, "litepose.group_hungarian.default",
                                     "litepose.nms_topk.default",
                                     "litepose.refine_argmax.default"]
    imgs = _images(5)
    _assert_equal(ep.module()(imgs), evaluator.run_batch(imgs)[2:])


_FRESH = """
import sys
import torch
from litepose_tpu_torch.core.export import load_artifact

serve = load_artifact(sys.argv[1], device="cpu")
data = torch.load(sys.argv[2])
got = serve(data["images"])
assert all(torch.equal(g, w) for g, w in zip(got, data["want"])), "artifact != live"
bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.") or any(
    m == p or m.startswith(p + ".") for p in (
        "litepose_tpu_torch.models", "litepose_tpu_torch.arch", "litepose_tpu_torch.config",
        "litepose_tpu_torch.core.engine", "litepose_tpu_torch.core.inference",
        "litepose_tpu"))]
assert not bad, bad
print("ok", got[2].tolist())
"""


def test_fresh_interpreter_loads_without_model_code(serving, tmp_path):
    imgs = _images(6)
    path = str(tmp_path / "serving.pt2")
    save_artifact(export_engine(serving, batch=2), path)
    torch.save({"images": imgs, "want": serving.run_batch(imgs)[2:]}, tmp_path / "data.pt")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    out = subprocess.run([sys.executable, "-c", _FRESH, path, str(tmp_path / "data.pt")],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("ok")


def test_cpu_artifact_matches_jax_live_engine(tmp_path):
    """The port's CPU artifact against the JAX engine on the same weights
    (bridged from the JAX init, fp32 on both sides): equal counts, people
    within the tolerance of ``tests/test_torch_engine.py``."""
    import jax

    from litepose_tpu.arch.manager import ArchManager as JArchManager
    from litepose_tpu.core.engine import EngineConfig as JEngineConfig
    from litepose_tpu.core.engine import PoseEngine as JPoseEngine
    from litepose_tpu.core.inference import InferenceFlags as JFlags
    from litepose_tpu.models.layers import Policy
    from litepose_tpu.models.litepose import ModelSpec as JSpec
    from litepose_tpu.models.litepose import apply_litepose
    from litepose_tpu.models.litepose import init_litepose as j_init
    from litepose_tpu.ops.group_ref import GroupParams as JGroupParams
    from litepose_tpu_torch.models.convert import litepose_from_jax
    from test_torch_arch import port_arch

    torch.backends.cudnn.allow_tf32 = False
    arch = JArchManager().fixed_sample(reso=SIZE, ratio=0.25)
    spec = JSpec(num_joints=14)
    params, state = j_init(jax.random.PRNGKey(0), spec, arch)
    params, state = jax.tree.map(np.asarray, (params, state))

    def apply_fn(p, s, x):
        return apply_litepose(p, s, x, spec, arch, train=False, policy=Policy.exact())[0]

    j_engine = JPoseEngine(apply_fn, params, state, JFlags(**FLAGS),
                           JGroupParams(num_joints=14, detection_threshold=0.1),
                           JEngineConfig(**SERVING))
    model = litepose_from_jax(params, state, ModelSpec(num_joints=14), port_arch(arch),
                              compute_dtype=torch.float32)
    assert port_arch(arch) == _arch()
    path = str(tmp_path / "cpu.pt2")
    save_artifact(export_engine(_engine(model=model), batch=2), path)
    serve = load_artifact(path, device="cpu")
    imgs = _images(8).numpy()
    tp, ts, tn = (t.numpy() for t in serve(torch.from_numpy(imgs)))
    jp, js, jn = j_engine.process_batch_square(imgs)
    np.testing.assert_array_equal(tn, jn)
    assert jn.min() > 0
    np.testing.assert_allclose(tp[..., :2], jp[..., :2], atol=1e-3, rtol=0)
    np.testing.assert_allclose(ts, js, atol=1e-4, rtol=0)
    np.testing.assert_allclose(tp[..., 2:], jp[..., 2:], atol=1e-4, rtol=0)


def test_export_cli_writes_an_artifact(tmp_path, capsys):
    from litepose_tpu_torch.tools import export as cli

    out = str(tmp_path / "cli.pt2")
    info = cli.main(["--arch", "auto-XS", "--input-size", str(SIZE), "--batch", "2",
                     "--device", "cpu", "--exact", "--eval-decode", "--out", out])
    text = capsys.readouterr()
    assert "WARNING: exporting randomly-initialized weights" in text.err
    assert f"wrote {out}: device=cpu batch=2 input={SIZE}x{SIZE}x3 uint8 size=" in text.out
    assert "outputs: [(2, 40, 14, 4), (2, 40), (2,)]" in text.out
    assert info.batch == 2 and os.path.getsize(out) == info.nbytes
    people, scores, counts = load_artifact(out, device="cpu")(_images(7))
    assert people.shape == (2, 40, 14, 4) and torch.isfinite(people).all()


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_cuda_defaults_raise_without_a_card(serving, tmp_path):
    from litepose_tpu_torch.tools import export as cli

    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--arch", "auto-XS", "--input-size", str(SIZE), "--batch", "2",
                  "--out", str(tmp_path / "x.pt2")])
    path = str(tmp_path / "cpu.pt2")
    save_artifact(export_engine(serving, batch=2), path)
    for kwargs in ({}, {"device": "cuda"}):  # a CPU artifact too loads on the card by default
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load_artifact(path, **kwargs)
