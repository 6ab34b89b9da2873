"""The profilers and the serving sweep of the port
(``litepose_tpu_torch/tools/{profile_model,profile_eval,sweep_serve}.py``)
and their shared timing helpers (``tools/timing.py``).

On the CPU each tool runs to its end at a tiny size (Auto-XS at 128 px,
batch 1-2, one round; torch on two threads) and prints every section;
its numbers are host-clock times of the plain twins and are not checked.
``sweep_serve`` goes on past a batch that runs out of device memory and
fails on any other error.  The kernel families put each port kernel's
CUDA kernels in a family of its own.  On the card (marked ``cuda``)
``profile_eval``'s pieces in the step sum to its whole step within the
15% that ``chip_smoke.py`` phase 20 holds them to, at b8 (host-bound)
and b32, and every piece's port kernel shows device time."""

import math

import pytest
import torch

from litepose_tpu_torch.arch import get_arch
from litepose_tpu_torch.tools import cupti_check, profile_eval, profile_model, sweep_serve, timing

SIZE = 128  # the bench scenes need 80 px or more
XS_CKPT = str(profile_model.REPO / "assets" / "bench_ckpt_xs.msgpack")


@pytest.fixture
def small(monkeypatch):
    """Two torch threads, and every tool's zoo arch at SIZE px."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    for tool in (profile_model, profile_eval, sweep_serve):
        monkeypatch.setattr(tool, "get_arch", lambda name: get_arch(name).with_img_size(SIZE))
    yield
    torch.set_num_threads(threads)


def _run(tool, argv, **kw):
    lines = []
    out = tool.main(argv + ["--device", "cpu"], log=lines.append, **kw)
    return out, "\n".join(lines)


def _timed(result):
    return all(math.isfinite(r["ms"]) and r["ms"] > 0 for r in result["sections"].values())


def test_profile_model_runs_every_section(small):
    out, text = _run(profile_model, ["--arch", "auto-XS", "--batch", "2", "--rounds", "1",
                                     "--sections", "--train"])
    want = ["forward (eval, bf16)", "serve step (fwd + decode)", "train step (fwd+bwd+adam)"]
    want += [f"stage{i} inv_bottleneck" for i in range(4)]
    for label in want:
        assert label in text, label
    assert len(out["sections"]) == 7 and _timed(out)
    assert "random init (affines moved off identity)" in text  # no checkpoint for auto-XS
    assert "not measured (no card)" in text and out["device"] == "cpu (host clock)"


def test_profile_model_forward_only_stops_after_the_forward(small):
    out, _ = _run(profile_model, ["--arch", "auto-XS", "--batch", "1", "--rounds", "1",
                                  "--forward-only", "--ckpt", XS_CKPT])
    assert list(out["sections"]) == ["forward (eval, bf16)"]


def test_profile_eval_runs_every_piece(small):
    out, text = _run(profile_eval, ["--arch", "auto-XS", "--batch", "2", "--rounds", "1",
                                    "--ckpt", XS_CKPT])
    for label in ("flip-concat forward (2B)", *profile_eval.PIECES, "TOTAL protocol step",
                  "glue (infer - forward)", "sum of pieces", "scheduling slack"):
        assert label in text, label
    assert _timed(out)
    assert list(out["in_step"]) == list(profile_eval.PIECES)
    assert all(ms > 0 for ms in out["in_step"].values()), out["in_step"]
    assert out["sum_ms"] == pytest.approx(sum(out["in_step"].values()))
    assert out["alone_sum_ms"] == pytest.approx(
        sum(out["sections"][p]["ms"] for p in profile_eval.PIECES))
    assert out["slack_ms"] == pytest.approx(out["total_ms"] - out["sum_ms"])


def test_profile_eval_needs_the_trained_checkpoint(small):
    with pytest.raises(SystemExit, match="trained checkpoint required"):
        _run(profile_eval, ["--arch", "auto-XS", "--ckpt", "no/such.msgpack"])


def test_sweep_serve_runs_the_ladder(small):
    out, text = _run(sweep_serve, ["--arch", "auto-XS", "--batches", "1", "2", "--iters", "1",
                                   "--rounds", "1", "--ckpt", XS_CKPT])
    assert set(out["batches"]) == {1, 2} and out["best"] in (1, 2)
    assert "bs=   1:" in text and "bs=   2:" in text and "# best: bs=" in text


def _failing_measure(error):
    real = sweep_serve.measure

    def measure(engine, images, args, device):
        if len(images) == 2:
            raise error
        return real(engine, images, args, device)

    return measure


def test_sweep_serve_goes_on_past_out_of_memory(small, monkeypatch):
    monkeypatch.setattr(sweep_serve, "measure", _failing_measure(
        torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB\nmore")))
    out, text = _run(sweep_serve, ["--arch", "auto-XS", "--no-ckpt", "--batches", "1", "2", "3",
                                   "--iters", "1", "--repeats", "1"])
    assert out["batches"][2] == {"out_of_memory": "CUDA out of memory. Tried to allocate "
                                                  "2.00 GiB\nmore"}
    assert "bs=   2: out of device memory (CUDA out of memory. Tried to allocate 2.00 GiB)" in text
    assert set(out["batches"][3]) == {"img_per_s", "ms"} and out["best"] in (1, 3)


def test_sweep_serve_fails_on_any_other_error(small, monkeypatch):
    monkeypatch.setattr(sweep_serve, "measure", _failing_measure(RuntimeError("a fault")))
    with pytest.raises(RuntimeError, match="a fault"):
        _run(sweep_serve, ["--arch", "auto-XS", "--no-ckpt", "--batches", "1", "2", "3",
                           "--iters", "1", "--repeats", "1"])


@pytest.mark.parametrize("tool", [profile_model, profile_eval, sweep_serve])
def test_tools_run_on_the_card_unless_told(tool):
    """``--device`` defaults to the card: without one the tool raises
    rather than running on the host."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    assert tool.build_parser().parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(["--arch", "auto-XS"], log=lambda line: None)


def test_cupti_check_traces_only_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the check runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cupti_check.main([], log=lambda line: None)
    with pytest.raises(SystemExit, match="traces the card"):
        cupti_check.main(["--device", "cpu"], log=lambda line: None)


@pytest.mark.parametrize("name,family", [
    ("void nms_topk_band_kernel<__nv_bfloat16, 2>(__nv_bfloat16 const*, unsigned long long*)",
     "K1 nms_topk"),
    ("_Z21nms_topk_merge_kernelPKyPfPiiii", "K1 nms_topk"),
    ("void nms_topk_loop_kernel<float, true>(float const*, float*, int*)", "K1' nms_topk_loop"),
    ("group_greedy_kernel(float const*, float const*, int const*)", "K2 group_greedy"),
    ("group_hungarian_kernel(float const*, float const*)", "K3 group_hungarian"),
    ("void refine_argmax_tile_kernel<2>(int const*, float const*)", "K4 refine_argmax"),
    ("refine_finalize_kernel(int const*, unsigned long long const*, int*, int)",
     "K4 refine_argmax"),
    ("void heatmap_nms_kernel<__nv_bfloat16, 2>(__nv_bfloat16 const*)", "K5 heatmap_nms"),
    ("void at::native::conv_depthwise2d_forward_kernel<3, c10::BFloat16, int>", "depthwise conv"),
    ("void (anonymous namespace)::depthwise_conv_kernel<7, 1>(unsigned short const*)",
     "depthwise conv"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32", "cuDNN / GEMM"),
    ("nvjet_tst_256x96_64x4_1x1_v_ssched_bz_coopA_NNT", "cuDNN / GEMM"),
    ("void at::native::(anonymous namespace)::upsample_bilinear2d_out_frame<float, float>",
     "resize (bilinear)"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add>",
     "elementwise"),
    ("Memcpy HtoD (Pageable -> Device)", "memcpy / memset"),
    ("void at::native::index_elementwise_kernel", "elementwise"),
    ("void at::native::(anonymous namespace)::gatherTopK<float>", "other"),
])
def test_each_port_kernel_is_a_family_of_its_own(name, family):
    assert timing.family_of(name) == family


def test_time_rounds_on_the_host():
    calls = []
    t = timing.time_rounds(lambda: calls.append(1), torch.device("cpu"), rounds=3, iters=4,
                           warmup=2)
    assert len(calls) == 2 + 3 * 4 and t.rounds == 3 and t.lo <= t.median <= t.hi
    assert timing.breakdown(lambda: None, torch.device("cpu")).families == {}


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the profilers time the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [8, 32])
def test_profile_eval_pieces_sum_to_the_step_on_card(cuda, batch):
    # b8: the host sets the step's pace; b32 (the eval protocol's batch): the card does
    out = profile_eval.main(["--batch", str(batch), "--rounds", "3"], log=print)
    assert abs(out["slack_ms"]) <= 0.15 * out["total_ms"], out
    sections = out["sections"]
    for piece, family in ((profile_eval.PIECES[1], "K1 nms_topk"),
                          (profile_eval.PIECES[2], "K3 group_hungarian"),
                          (profile_eval.PIECES[4], "K4 refine_argmax")):
        assert sections[piece]["families"].get(family, 0) > 0, (piece, sections[piece])
        assert sections["TOTAL protocol step"]["families"].get(family, 0) > 0, family
        assert not sections[piece]["missing"]
