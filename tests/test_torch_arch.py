"""The port's own arch descriptors (``litepose_tpu_torch.arch``) against the
JAX package's: every zoo entry, the dict round trip of a sampled arch, the
channel rounding and the loader's validation.

``port_arch`` turns a JAX ``ArchConfig`` into the port's; the other port
tests use it wherever an arch built by the JAX package goes into the port.
"""

import pytest

from litepose_tpu.arch import ArchManager
from litepose_tpu.arch import make_divisible as j_make_divisible
from litepose_tpu.arch.zoo import ARCH_ZOO as J_ZOO

from litepose_tpu_torch.arch import (ARCH_ZOO, ArchConfig, get_arch, load_arch,
                                     make_divisible, validate_arch)


def port_arch(jax_arch) -> ArchConfig:
    """The port's ``ArchConfig`` of a JAX one."""
    return ArchConfig.from_dict(jax_arch.to_dict())


@pytest.mark.parametrize("name", sorted(J_ZOO))
def test_zoo_matches_jax(name):
    assert get_arch(name).to_dict() == J_ZOO[name].to_dict()
    assert get_arch(name).stage_channels == J_ZOO[name].stage_channels


def test_zoo_has_the_jax_names():
    assert sorted(ARCH_ZOO) == sorted(J_ZOO)
    with pytest.raises(KeyError):
        get_arch("auto-XXL")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sampled_arch_round_trips(seed):
    """A sampled JAX arch through the port's dict round trip: equal dicts,
    equal derived widths, and ``with_img_size`` on both sides."""
    jax_arch = ArchManager(seed=seed).random_sample()
    arch = port_arch(jax_arch)
    assert ArchConfig.from_dict(arch.to_dict()) == arch
    assert arch.to_dict() == jax_arch.to_dict()
    assert arch.stage_channels == jax_arch.stage_channels
    assert arch.with_img_size(320).to_dict() == jax_arch.with_img_size(320).to_dict()
    assert load_arch(jax_arch.to_dict()) == arch


def test_make_divisible_matches_jax():
    for v in (3, 8, 12, 15, 24 * 0.5, 96, 120.0, 160 * 0.75, 191, 577):
        for d in (4, 8, 16):
            assert make_divisible(v, d) == j_make_divisible(v, d), (v, d)


def test_load_arch_validates():
    bad = get_arch("auto-S").to_dict()
    bad["img_size"] = 450
    bad["backbone_setting"][0]["block_setting"][0] = [6, 4]
    errs = validate_arch(bad)
    assert len(errs) == 2, errs
    with pytest.raises(ValueError, match="img_size 450"):
        load_arch(bad)
