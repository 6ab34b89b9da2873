"""The weight bridge: ``state_dict_from_jax`` against the JAX package's own
``litepose_to_torch``, and the port's msgpack reader against flax."""

import os

import jax
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from litepose_tpu.arch.manager import ArchManager
from litepose_tpu.models.litepose import ModelSpec as JSpec
from litepose_tpu.models.litepose import init_litepose
from litepose_tpu.models.torch_convert import litepose_to_torch

from litepose_tpu_torch.models.convert import litepose_from_jax, state_dict_from_jax
from litepose_tpu_torch.models.litepose import LitePose, ModelSpec
from litepose_tpu_torch.train import checkpoint as ckpt
from test_torch_arch import port_arch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = ["bench_ckpt.msgpack", "bench_ckpt_xs.msgpack"]


def _random_bn(tree, rng):
    """Randomize BN affines and statistics so no identity hides a swap."""
    if isinstance(tree, dict):
        if set(tree) == {"scale", "bias"}:
            return {"scale": rng.normal(1.0, 0.2, tree["scale"].shape).astype(np.float32),
                    "bias": rng.normal(0.0, 0.2, tree["bias"].shape).astype(np.float32)}
        if set(tree) == {"mean", "var"}:
            return {"mean": rng.normal(0.0, 0.2, tree["mean"].shape).astype(np.float32),
                    "var": rng.uniform(0.5, 1.5, tree["var"].shape).astype(np.float32)}
        return {k: _random_bn(v, rng) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_random_bn(v, rng) for v in tree]
    return np.asarray(tree)


@pytest.mark.parametrize("with_skips", [True, False])
def test_state_dict_matches_litepose_to_torch(with_skips):
    arch = ArchManager().fixed_sample(reso=128, ratio=0.25)
    params, state = init_litepose(jax.random.PRNGKey(3), JSpec(), arch,
                                  with_skips=with_skips)
    rng = np.random.default_rng(0)
    params, state = _random_bn(params, rng), _random_bn(state, rng)
    want = litepose_to_torch(params, state, JSpec(), arch, with_skips=with_skips)
    got = state_dict_from_jax(params, state, ModelSpec(), port_arch(arch), with_skips=with_skips)
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].dtype == torch.from_numpy(np.array(v)).dtype, k
        assert got[k].shape == v.shape, k
        assert np.asarray(got[k]).tobytes() == np.asarray(v).tobytes(), k
    # the module's own names are exactly the reference layout
    model = LitePose(ModelSpec(), port_arch(arch), with_skips=with_skips)
    assert sorted(model.state_dict()) == sorted(want)
    litepose_from_jax(params, state, ModelSpec(), port_arch(arch), with_skips=with_skips)


@pytest.mark.parametrize("name", ASSETS)
def test_reader_matches_flax_on_checkpoints(name):
    data = open(os.path.join(REPO, "assets", name), "rb").read()
    got = jax.tree_util.tree_leaves_with_path(ckpt.msgpack_restore(data))
    want = jax.tree_util.tree_leaves_with_path(serialization.msgpack_restore(data))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path


def test_load_params_restores_lists():
    params, state = ckpt.load_params(os.path.join(REPO, "assets", ASSETS[1]))
    assert isinstance(params["stage"], list) and len(params["stage"]) == 4
    assert isinstance(params["stage"][0], list)
    assert isinstance(state["deconv_bn"], list)
    assert params["first"]["cbr0"]["conv"]["w"].shape == (3, 3, 3, 32)


def test_reader_matches_msgpack_on_every_wire_type():
    obj = {
        "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32, 2**63 - 1,
                 -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**63],
        "floats": [0.5, -1.25e300, float("inf")],
        "strs": ["", "a" * 31, "b" * 32, "c" * 300, "d" * 70000, "été"],
        "bins": [b"", b"\x00" * 300, b"\x01" * 70000],
        "misc": [None, True, False, list(range(20)), {str(i): i for i in range(20)}],
    }
    data = msgpack.packb(obj, use_bin_type=True)
    assert ckpt.unpackb(data) == msgpack.unpackb(data, raw=False)
    single = msgpack.packb([1.5, -0.25], use_single_float=True)
    assert ckpt.unpackb(single) == [1.5, -0.25]


@pytest.mark.parametrize("size", [1, 2, 4, 8, 16, 3, 300, 70000])
def test_reader_ext_sizes_and_types(size):
    """Every ext header width reaches the ndarray decoder; other ext types
    are refused."""
    arr = np.arange(max(size // 4, 1), dtype=np.float32)
    payload = serialization.msgpack_serialize({"w": arr})
    np.testing.assert_array_equal(ckpt.msgpack_restore(payload)["w"], arr)
    with pytest.raises(ValueError, match="ext type 9"):
        ckpt.unpackb(msgpack.packb(msgpack.ExtType(9, b"x" * size)))


def test_reader_matches_flax_on_array_types():
    """Every dtype flax writes for an ndarray, including bf16."""
    tree = {
        "f32": np.arange(6, dtype=np.float32).reshape(2, 3),
        "f64": np.linspace(0, 1, 5),
        "i8": np.array([-3, 4], np.int8),
        "u16": np.array([1, 65535], np.uint16),
        "i64": np.array([[2**40]], np.int64),
        "bool": np.array([True, False]),
        "empty": np.zeros((0, 3), np.float32),
        "scalar": np.array(2.5, np.float32),
    }
    data = serialization.msgpack_serialize(tree)
    got, want = ckpt.msgpack_restore(data), serialization.msgpack_restore(data)
    assert sorted(got) == sorted(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), k

    bf = jax.numpy.asarray([1.5, -2.0, 3.25], jax.numpy.bfloat16)
    got_bf = ckpt.msgpack_restore(serialization.msgpack_serialize({"w": bf}))["w"]
    np.testing.assert_array_equal(got_bf, np.asarray(bf.astype(np.float32)))


def test_reader_rejects_truncated_data():
    data = msgpack.packb({"a": [1, 2, 3]})
    with pytest.raises(ValueError):
        ckpt.unpackb(data[:-1])
    with pytest.raises(ValueError):
        ckpt.unpackb(data + b"\x00")
