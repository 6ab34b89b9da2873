"""``utils/summary.py``: the port's parameter count and summary text equal
the JAX package's for the same arch."""

import pytest
import torch

from litepose_tpu_torch.arch import get_arch
from litepose_tpu_torch.models.litepose import LitePose, ModelSpec
from litepose_tpu_torch.utils.summary import count_params, model_summary


@pytest.mark.parametrize("name", ["auto-XS", "auto-S"])
def test_summary_matches_jax(name):
    import jax

    from litepose_tpu.arch.zoo import get_arch as j_get_arch
    from litepose_tpu.models.litepose import ModelSpec as JSpec
    from litepose_tpu.models.litepose import init_litepose
    from litepose_tpu.utils.summary import count_params as j_count
    from litepose_tpu.utils.summary import model_summary as j_summary

    params, _ = jax.eval_shape(lambda k: init_litepose(k, JSpec(num_joints=14),
                                                       j_get_arch(name)),
                               jax.random.PRNGKey(0))
    model = LitePose(ModelSpec(num_joints=14), get_arch(name)).eval()
    assert count_params(model) == j_count(params)
    assert count_params(model) < sum(t.numel() for t in model.state_dict().values())
    assert model_summary(model) == j_summary(params)
    text = model_summary(model, get_arch(name))
    assert text == j_summary(params, j_get_arch(name))
    assert text.splitlines()[1].startswith(f"MACs @ {get_arch(name).img_size}x")
    assert isinstance(count_params(torch.nn.Linear(3, 2)), int)
