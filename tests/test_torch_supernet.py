"""The port's NAS supernet (``litepose_tpu_torch.models.super_litepose``)
against ``litepose_tpu.models.super_litepose`` on the CPU.

A narrow search space (stages ((8,1,2),(8,2,2),(16,2,2),(16,1,1)), deconv
(16,16,8)) and 64-px inputs; the JAX supernet's init with every BN's
statistics, scale and bias moved off identity goes through the bridge
(``models.convert.supernet_from_jax``).  fp32 on both sides (JAX under
``Policy.exact()``):

* the masked forward at ratios 0.25, 0.5 and 1.0, eval and train, and
  with a block at kernel 5 and one at kernel 3: outputs within atol 2e-4 /
  rtol 1e-3 (the bound of tests/test_supernet.py), the new BN statistics
  within 1e-5, inactive channels' statistics bit-unchanged;
* ``extract_subnet``, ``inject_subnet`` and ``reorganize_weights`` on the
  same bridged weights: bit for bit (a kernel-cropped depthwise weight,
  a matmul through ``lin5`` / ``lin3``, within 1e-6 relative);
* the bridge round trip, the supernet's msgpack in both directions, and
  ``load_pretrained_backbone`` (the JAX rule drops the blocks' ``lin5`` /
  ``lin3``; the port keeps them, and differs in them alone)."""

import dataclasses

import numpy as np
import pytest
import torch

from litepose_tpu_torch.arch import ArchConfig, ArchManager
from litepose_tpu_torch.models.convert import supernet_from_jax, supernet_to_jax
from litepose_tpu_torch.models.litepose import ModelSpec
from litepose_tpu_torch.models.super_litepose import (SuperDims, arch_to_mask_desc,
                                                      extract_subnet, inject_subnet,
                                                      reorganize_weights)

IMG = 64
NARROW = dict(deconv_setting=(16, 16, 8),
              stage_setting=((8, 1, 2), (8, 2, 2), (16, 2, 2), (16, 1, 1)))


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def port_manager(**kw) -> ArchManager:
    return ArchManager(**NARROW, **kw)


def port_dims() -> SuperDims:
    return SuperDims.from_manager(port_manager())


def jax_side():
    """(JAX manager, dims, spec) of the narrow space."""
    from litepose_tpu.arch.manager import ArchManager as JManager
    from litepose_tpu.models.litepose import ModelSpec as JSpec
    from litepose_tpu.models.super_litepose import SuperDims as JDims

    jm = JManager(**NARROW)
    return jm, JDims.from_manager(jm), JSpec()


HEAD_LIVE = 8  # the narrowest input of a final head at any arch of the narrow space


def perturbed(params, state, seed, whole_heads=False):
    """Numpy trees with BN statistics, scales and biases off identity.  The
    final heads' depthwise BNs keep the identity beyond their first
    ``HEAD_LIVE`` channels unless ``whole_heads``: there the JAX supernet,
    whose heads are unmasked, is its extracted subnet (and the port)."""
    import jax

    rng = np.random.default_rng(seed)

    def f(path, x):
        x = np.asarray(x)
        key = jax.tree_util.keystr(path)
        if "'var'" in key:
            y = rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        elif "'mean'" in key or (x.ndim == 1 and "lin" not in key):
            y = (x + rng.normal(0, 0.2, x.shape)).astype(np.float32)
        else:
            return x.copy()
        if "'final_" in key and not whole_heads:
            y[HEAD_LIVE:] = x[HEAD_LIVE:]
        return y

    return jax.tree_util.tree_map_with_path(f, params), jax.tree_util.tree_map_with_path(f, state)


def head_widths(arch: ArchConfig) -> dict:
    """{JAX path of a final head: the active width of its input}."""
    widths = [arch.input_channel] + [st.channel for st in arch.backbone_setting]
    out = {}
    for i in range(1, len(arch.deconv_setting)):
        out[f"['final_refined'][{i - 1}]"] = arch.deconv_setting[i]
        out[f"['final_raw'][{i - 1}]"] = widths[-i - 3]
    return out


def assert_heads_aside(got, want, arch, atol, rtol=0.0):
    """Trees within ``atol`` / ``rtol``, the final heads' depthwise BN leaves
    on their active channels only: JAX's unmasked heads move the inactive
    ones (statistics, and the bias through ``relu``'s gradient of 1/2 at
    0), the port's masked heads do not."""
    import jax

    widths = head_widths(arch)
    for (path, a), (_, b) in zip(leaves(got), leaves(want)):
        key = jax.tree_util.keystr(path)
        a, b = np.asarray(a), np.asarray(b)
        head = next((n for h, n in widths.items() if key.startswith(h)), None)
        if head is not None and "['bn']" in key:
            a, b = a[:head], b[:head]
        np.testing.assert_allclose(a, b, atol=atol, rtol=rtol, err_msg=key)


@pytest.fixture(scope="module")
def jax_supernet():
    """(params, state) of the narrow JAX supernet, perturbed, as numpy."""
    import jax

    from litepose_tpu.models.super_litepose import init_super_litepose

    _, jd, jspec = jax_side()
    return perturbed(*init_super_litepose(jax.random.PRNGKey(0), jspec, jd), seed=1)


def port_supernet(trees, dtype=torch.float32):
    return supernet_from_jax(*trees, ModelSpec(), port_dims(), compute_dtype=dtype)


def leaves(tree):
    import jax

    return jax.tree_util.tree_leaves_with_path(tree)


def assert_trees_equal(got, want, close=()):
    """Bit for bit, except the leaves whose path names one of ``close``
    (within 1e-6 relative)."""
    import jax

    got, want = leaves(got), leaves(want)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        key = jax.tree_util.keystr(path)
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, key
        if any(c in key for c in close):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7, err_msg=key)
        else:
            np.testing.assert_array_equal(a, b, err_msg=key)


def images(seed=0, n=2, img=IMG):
    return np.random.default_rng(seed).standard_normal((n, img, img, 3)).astype(np.float32)


def nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()


def with_kernels(arch, kernels):
    """``arch`` with the block kernels ``kernels[si][bi]``."""
    return dataclasses.replace(arch, backbone_setting=tuple(
        dataclasses.replace(st, block_setting=tuple((t, k) for (t, _), k in
                                                    zip(st.block_setting, kernels[si])))
        for si, st in enumerate(arch.backbone_setting)))


def active_counts(arch: ArchConfig, dims: SuperDims) -> dict:
    """{masked BN prefix: active channels} of an arch."""
    out = {"first.3": arch.input_channel}
    cin = arch.input_channel
    for si, n in enumerate(dims.stage_blocks):
        c = arch.backbone_setting[si].channel
        for bi in range(n):
            out[f"stage.{si}.{bi}.inv.1"] = out[f"stage.{si}.{bi}.depth_conv.1"] = cin * 6
            out[f"stage.{si}.{bi}.point_conv.1"] = c
            cin = c
    for i, d in enumerate(arch.deconv_setting):
        out[f"deconv_bnrelu.{i}.0"] = d
    for key, n in head_widths(arch).items():
        name, i = key[2:].split("'][")
        out[f"{name}.{i[:-1]}.conv.1"] = n
    return out


def residual_free_arch() -> ArchConfig:
    """Ratio 0.5 with the last stage at 16 wide.  The last stage has stride 1,
    so at equal widths of the last two stages the fixed LitePose adds a
    residual to its first block where the supernet adds none (blocks after
    the first only): the default space's widths never meet there, the
    narrow space's would."""
    arch = port_manager().fixed_sample(IMG, 0.5)
    stages = list(arch.backbone_setting)
    stages[3] = dataclasses.replace(stages[3], channel=16)
    return dataclasses.replace(arch, backbone_setting=tuple(stages))


KERNELS_53 = [[7], [5, 7], [7, 3], [7]]  # one block at 5, one at 3


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("case", ["0.25", "0.5", "1.0", "k5k3"])
def test_masked_forward_matches_jax(jax_supernet, case, train):
    from litepose_tpu.models.layers import Policy
    from litepose_tpu.models.super_litepose import apply_super_litepose
    from litepose_tpu.models.super_litepose import arch_to_mask_desc as jdesc

    jm, jd, jspec = jax_side()
    sp, ss = jax_supernet
    ratio = 0.5 if case == "k5k3" else float(case)
    kernels = KERNELS_53 if case == "k5k3" else None
    jarch = jm.fixed_sample(IMG, ratio)
    x = images()
    outs, new_state = apply_super_litepose(sp, ss, x, jdesc(jarch, jm), jspec, jd,
                                           kernels=kernels, train=train, policy=Policy.exact())

    model = port_supernet(jax_supernet).train(train)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    arch = ArchConfig.from_dict(jarch.to_dict())
    with torch.no_grad():
        got = model(nchw(x), arch_to_mask_desc(arch), kernels=kernels)
    assert len(got) == len(outs)
    for g, w in zip(got, outs):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w).transpose(0, 3, 1, 2),
                                   atol=2e-4, rtol=1e-3)
    assert_heads_aside(supernet_to_jax(model)[1], new_state, arch, atol=1e-5)
    if not train:
        assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
        return
    after = model.state_dict()
    for prefix, n in active_counts(arch, port_dims()).items():
        for leaf in ("running_mean", "running_var"):
            key = f"{prefix}.{leaf}"
            assert torch.equal(after[key][n:], before[key][n:]), key  # inactive: frozen
            assert not torch.equal(after[key][:n], before[key][:n]), key  # active: moved


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_masked_forward_is_the_extracted_subnet(jax_supernet, train):
    """With every channel of the final heads' depthwise BNs off identity (as
    training at max width leaves them), the port's supernet at an arch is
    the JAX-extracted subnet (``extract_subnet`` then ``apply_litepose``)
    within atol 2e-4 / rtol 1e-3, and its new BN statistics are the
    subnet's on the active channels; the JAX supernet is not (its heads
    take the inactive channels' ``relu(bias - mean * inv)``)."""
    import jax

    from litepose_tpu.models.layers import Policy
    from litepose_tpu.models.litepose import apply_litepose
    from litepose_tpu.models.super_litepose import apply_super_litepose, extract_subnet
    from litepose_tpu.models.super_litepose import arch_to_mask_desc as jdesc

    from litepose_tpu_torch.models.convert import state_dict_from_jax

    jm, jd, jspec = jax_side()
    from litepose_tpu.arch.schema import ArchConfig as JArch

    trees = perturbed(*jax_supernet, seed=5, whole_heads=True)
    arch = residual_free_arch()
    jarch = JArch.from_dict(arch.to_dict())
    x = images(1)
    exact = Policy.exact()
    sub_p, sub_s = extract_subnet(*trees, jarch, jd, jspec)
    want, want_state = apply_litepose(sub_p, sub_s, x, jspec, jarch, train=train, policy=exact)
    leaky, _ = apply_super_litepose(*trees, x, jdesc(jarch, jm), jspec, jd, train=train,
                                    policy=exact)
    model = port_supernet(trees).train(train)
    with torch.no_grad():
        got = model(nchw(x), arch_to_mask_desc(arch))
    for g, w, j in zip(got, want, leaky):
        w, j = np.asarray(w).transpose(0, 3, 1, 2), np.asarray(j).transpose(0, 3, 1, 2)
        np.testing.assert_allclose(g.numpy(), w, atol=2e-4, rtol=1e-3)
    assert np.abs(j - w).max() > 1e-2
    if train:
        sd = model.state_dict()
        sub_sd = state_dict_from_jax(*jax.tree.map(np.asarray, (sub_p, want_state)),
                                     ModelSpec(), arch)
        for k, v in sub_sd.items():
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(sd[k][tuple(slice(0, n) for n in v.shape)].numpy(),
                                           v.numpy(), atol=1e-5, rtol=0, err_msg=k)


@pytest.mark.parametrize("case", ["0.25", "0.5", "1.0", "k5k3"])
def test_extract_subnet_matches_jax(jax_supernet, case):
    from litepose_tpu.models.super_litepose import extract_subnet as jextract

    from litepose_tpu_torch.models.convert import jax_from_state_dict

    jm, jd, jspec = jax_side()
    ratio = 0.5 if case == "k5k3" else float(case)
    jarch = jm.fixed_sample(IMG, ratio)
    if case == "k5k3":
        jarch = with_kernels(jarch, KERNELS_53)
    want = jextract(*jax_supernet, jarch, jd, jspec)
    arch = ArchConfig.from_dict(jarch.to_dict())
    sub = extract_subnet(port_supernet(jax_supernet), arch)
    assert sub.arch == arch and not sub.training
    got = jax_from_state_dict(sub.state_dict(), ModelSpec(), arch)
    cropped = ("[1][0]['depth']", "[2][1]['depth']") if case == "k5k3" else ()
    assert_trees_equal(got, want, close=tuple(f"{c}['conv']" for c in cropped))


def test_inject_subnet_matches_jax(jax_supernet):
    """A LitePose drawn from another seed, injected into the supernet by
    both packages: equal supernets; extracting it back gives the LitePose;
    a kernel-cropped arch is refused."""
    import jax

    from litepose_tpu.models.litepose import init_litepose as jinit
    from litepose_tpu.models.super_litepose import inject_subnet as jinject

    from litepose_tpu_torch.models.convert import jax_from_state_dict, litepose_from_jax

    jm, jd, jspec = jax_side()
    jarch = jm.fixed_sample(IMG, 0.5)
    arch = ArchConfig.from_dict(jarch.to_dict())
    p, s = perturbed(*jinit(jax.random.PRNGKey(7), jspec, jarch), seed=2)
    want = jinject(*jax_supernet, p, s, jarch, jd, jspec)
    supernet = port_supernet(jax_supernet)
    sub = litepose_from_jax(p, s, ModelSpec(), arch, compute_dtype=torch.float32)
    assert inject_subnet(supernet, sub) is supernet
    assert_trees_equal(supernet_to_jax(supernet), jax.tree.map(np.asarray, want))
    back = jax_from_state_dict(extract_subnet(supernet, arch).state_dict(), ModelSpec(), arch)
    assert_trees_equal(back, (p, s))
    with pytest.raises(ValueError, match="not invertible"):
        inject_subnet(supernet, litepose_from_jax(
            *jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(7), jspec,
                                            with_kernels(jarch, KERNELS_53))),
            ModelSpec(), with_kernels(arch, KERNELS_53)))


def test_reorganize_weights_matches_jax(jax_supernet):
    """Equal permuted supernets; the full-width function is kept."""
    import jax

    from litepose_tpu.models.super_litepose import reorganize_weights as jreorg

    want = jax.tree.map(np.asarray, jreorg(*jax.tree.map(np.copy, jax_supernet)))
    supernet = port_supernet(jax_supernet)
    x = nchw(images(3))
    with torch.no_grad():
        before = supernet(x)
        assert reorganize_weights(supernet) is supernet
        after = supernet(x)
    assert_trees_equal(supernet_to_jax(supernet), want)
    assert not np.array_equal(want[0]["first"]["conv2"]["w"], jax_supernet[0]["first"]["conv2"]["w"])
    for a, b in zip(after, before):
        torch.testing.assert_close(a, b, atol=2e-4, rtol=1e-3)


def test_bridge_round_trip(jax_supernet):
    """JAX trees -> the port's supernet -> JAX trees, bit for bit, and the
    state dict has the reference names plus lin5 / lin3."""
    model = port_supernet(jax_supernet)
    assert_trees_equal(supernet_to_jax(model), jax_supernet)
    sd = model.state_dict()
    assert sd["stage.1.1.lin5.weight"].shape == (25, 25)
    assert sd["stage.1.1.lin3.bias"].shape == (9,)
    assert sd["stage.0.0.inv.0.weight"].shape == (144, 24, 1, 1)  # feat_max = 24 * 6


def test_supernet_msgpack_crosses_packages(jax_supernet, tmp_path):
    """The port's ``save_params`` / ``save_checkpoint`` of a supernet load in
    JAX; the JAX ``save_params`` loads in the port."""
    import jax
    import optax

    from litepose_tpu.train import checkpoint as jck

    from litepose_tpu_torch.train import checkpoint as tck
    from litepose_tpu_torch.train import optim

    model = port_supernet(jax_supernet).train()
    tck.save_params(str(tmp_path / "port.msgpack"), model)
    got = jck.load_params(str(tmp_path / "port.msgpack"),
                          *jax.tree.map(np.zeros_like, jax_supernet))
    assert_trees_equal(jax.tree.map(np.asarray, got), jax_supernet)

    opt, sched = optim.make_optimizer("adam", model.parameters(),
                                      optim.multistep_lr(1e-3, [10], 0.1, 10))
    tck.save_checkpoint(str(tmp_path), tck.init_train_state(model, opt, sched, step=3, epoch=1))
    tx = optax.chain(optax.scale_by_adam(), optax.scale_by_schedule(lambda c: -1e-3))
    template = jck.init_train_state(*jax.tree.map(np.zeros_like, jax_supernet),
                                    tx.init(jax.tree.map(np.zeros_like, jax_supernet[0])))
    jts = jck.auto_resume(str(tmp_path), template)
    assert int(jts.step) == 3 and int(jts.epoch) == 1
    assert_trees_equal(jax.tree.map(np.asarray, (jts.params, jts.model_state)), jax_supernet)

    jck.save_params(str(tmp_path / "jax.msgpack"), *jax_supernet)
    fresh = port_supernet(perturbed(*jax_supernet, seed=9))
    tck.load_model_params(str(tmp_path / "jax.msgpack"), fresh)
    assert_trees_equal(supernet_to_jax(fresh), jax_supernet)


def test_load_pretrained_backbone_matches_jax(jax_supernet):
    """A full LitePose state dict at the max arch: the JAX rule loads its
    stem and backbone and keeps the head, and its supernet blocks come out
    without lin5 / lin3 (ROADMAP Queue 3); the port's equals it leaf for leaf
    and keeps its own lin5 / lin3.  A state dict without head keys is
    refused by both."""
    import jax

    from litepose_tpu.models.litepose import ModelSpec as JSpec
    from litepose_tpu.train.checkpoint import load_pretrained_backbone as jload

    from litepose_tpu_torch.models.litepose import init_litepose
    from litepose_tpu_torch.train.checkpoint import load_pretrained_backbone

    dims = port_dims()
    arch = dims.max_arch(IMG)
    donor = init_litepose(ModelSpec(), arch, torch.Generator().manual_seed(3))
    torch_sd = {"module." + k: v for k, v in donor.state_dict().items()}
    jm, jd, jspec = jax_side()
    from litepose_tpu.arch.schema import ArchConfig as JArch

    want_p, want_s = jload(*jax.tree.map(np.copy, jax_supernet), torch_sd, JSpec(),
                           JArch.from_dict(arch.to_dict()))
    for stage in want_p["stage"]:
        assert all("lin5" not in b and "lin3" not in b for b in stage)

    model = port_supernet(jax_supernet).train()
    lin_before = {k: v.clone() for k, v in model.state_dict().items() if ".lin" in k}
    load_pretrained_backbone(model, torch_sd)
    got_p, got_s = supernet_to_jax(model)
    for stage in got_p["stage"]:
        for b in stage:
            b.pop("lin5"), b.pop("lin3")
    assert_trees_equal((got_p, got_s), jax.tree.map(np.asarray, (want_p, want_s)))
    assert all(torch.equal(model.state_dict()[k], v) for k, v in lin_before.items())
    head = supernet_to_jax(port_supernet(jax_supernet))[0]["deconv_refined"]
    np.testing.assert_array_equal(got_p["deconv_refined"][0]["w"], head[0]["w"])
    assert not np.array_equal(got_p["first"]["conv2"]["w"], jax_supernet[0]["first"]["conv2"]["w"])
    backbone_only = {k: v for k, v in torch_sd.items() if "deconv" not in k and "final" not in k}
    with pytest.raises(ValueError, match="no head keys"):
        load_pretrained_backbone(model, backbone_only)
    with pytest.raises(ValueError, match="no head keys"):
        jload(*jax_supernet, backbone_only, JSpec(), JArch.from_dict(arch.to_dict()))
