"""One APG update (``minimize``) of shape_rope_hard in the port against
``unidom_tpu``'s on the CPU, cut to 2 push sub-steps of 4 substeps, through
tests/test_torch_train_envs.py's helpers: its first state comes through the
host reset, whose ten pushes (shape_rope's 2, then 8 more) are recorded on
both sides and held equal, as tests/test_torch_mpm_big_train.py holds
shape_rope's; the update then starts from the scene at rest, with the policy
steered to a push that reaches the rope. Also: the port's registry holds
every DaXBench env of JAX's."""

import pytest
from test_torch_train_envs import (
    check_clipped_gradient_and_adam_step,
    check_loss_and_gradient,
    minimize_both,
)

from unidom_tpu.envs import registration as jreg
from unidom_tpu.envs.plb_tasks import PLB_SCENES
from unidom_torch.envs import registration


@pytest.fixture(scope="module")
def one_minimize():
    return minimize_both("shape_rope_hard")


def test_minimize_loss_and_gradient_match_jax(one_minimize):
    check_loss_and_gradient(*one_minimize)


def test_minimize_clipped_gradient_and_adam_step_match_jax(one_minimize):
    check_clipped_gradient_and_adam_step(*one_minimize)


def test_registry_covers_every_daxbench_env_of_jax():
    """Every name of JAX's registry but PlasticineLab's scenes, the aliases
    included, builds the port's counterpart of JAX's class."""
    daxbench = {n: c for n, c in jreg.env_functions.items() if n not in PLB_SCENES}
    assert {"fold_cloth1_para", "unfold_cloth1", "unfold_cloth3", "push_rope",
            "push_rope_hard"} <= set(daxbench)
    assert set(daxbench) <= set(registration.env_functions)
    for name, jcls in daxbench.items():
        assert registration.env_functions[name].__name__ == jcls.__name__, name
