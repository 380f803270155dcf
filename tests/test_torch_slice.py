"""The port's fold_cloth3 policy rollout against ``unidom_tpu`` on the CPU:
the same reset, the same policy weights and the same sampling noise through
both packages, compared reward by reward. Also checks that the port imports
nothing of JAX."""

import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from unidom_tpu.algorithms.apg import build_apg
from unidom_tpu.engine.cloth import ClothConf as JaxClothConf
from unidom_tpu.envs.cloth_tasks import FoldCloth3Env as JaxFoldCloth3Env
from unidom_tpu.models.distribution import NormalTanhDistribution as JaxNormalTanh
from unidom_tpu.models.mlp import make_policy_model
from unidom_tpu.parallel.mesh import make_env_mesh
from unidom_torch.algorithms.apg import run_eval
from unidom_torch.engine.cloth import ClothConf, ClothState
from unidom_torch.envs.cloth_tasks import FoldCloth3Env, goal_path
from unidom_torch.models.distribution import NormalTanhDistribution
from unidom_torch.utils.convert import policy_from_jax

torch.set_num_threads(1)

B = 2
SMALL = dict(N=40, n_substeps=10, gripper_radius=0.04, goal_path=goal_path("fold_cloth3"),
             task="fold_cloth3")
# Tolerances. One macro step from the same state: both sides run the same
# float32 operations, and rewards agree to 5e-6. Positions drift further
# over the 40 robot steps: the JAX package's own Pallas kernel and its XLA
# oracle differ by 7.7e-4 in x after one macro step of this configuration.
TOL_REWARD = dict(rtol=0, atol=1e-4)
TOL_X = dict(rtol=0, atol=1e-3)


def _jax_reset_shift(key):
    """The (2,) cloth shift that ``unidom_tpu``'s ``reset(key)`` draws."""
    key, _ = jax.random.split(key)
    return np.asarray(jax.random.normal(key, (2,)) * 0.05)


def _to_torch(jstate):
    fields = ClothState.__dataclass_fields__
    return ClothState(**{f: torch.from_numpy(np.array(getattr(jstate, f))) for f in fields})


@pytest.fixture(scope="module")
def pair():
    jenv = JaxFoldCloth3Env(B, conf=JaxClothConf(**SMALL))
    tenv = FoldCloth3Env(B, conf=ClothConf(**SMALL), device="cpu")
    key = jax.random.PRNGKey(1)
    _, jstate = jenv.reset(key)
    _, tstate = tenv.reset_from_shift(_jax_reset_shift(key))
    model = make_policy_model(12, jenv.observation_size)
    params = model.init(jax.random.PRNGKey(0))
    policy = policy_from_jax(jax.device_get(params), device="cpu")
    return jenv, jstate, tenv, tstate, model, params, policy


def _jax_rollout(env, state, params):
    *_, run_eval_jax = build_apg(env, episode_length=4, mesh=make_env_mesh(1))
    final, actions, rewards = run_eval_jax(
        params, None, state, jax.random.PRNGKey(2), deterministic=True
    )
    return final, np.asarray(actions), np.asarray(rewards)


def test_rollout_matches_jax_per_macro_step(pair):
    """JAX's deterministic ``run_eval``, replayed macro step by macro step:
    from each JAX state the port picks the same action and earns the same
    reward."""
    jenv, jstate, tenv, _, _, params, policy = pair
    _, jactions, jrewards = _jax_rollout(jenv, jstate, params)
    dist = NormalTanhDistribution(event_size=6)
    for t in range(4):
        _, jreward, _, jinfo = jenv.step_diff(jactions[t], jstate)
        # the same JAX step outside run_eval's jit: other fusions, same values
        np.testing.assert_allclose(np.asarray(jreward), jrewards[t], rtol=0, atol=1e-6)
        tstate = _to_torch(jstate)
        with torch.no_grad():
            tactions = torch.sigmoid(dist.mode(policy(tenv.get_obs(tstate))))
            _, treward, _, tinfo = tenv.step_diff(tactions, tstate)
        np.testing.assert_allclose(tactions.numpy(), jactions[t], rtol=0, atol=1e-5)
        np.testing.assert_allclose(treward.numpy(), jrewards[t], **TOL_REWARD)
        np.testing.assert_allclose(tinfo["state"].x.numpy(), np.asarray(jinfo["state"].x), **TOL_X)
        jstate = jinfo["state"]


def test_free_running_rollout_stays_within_the_kernels_spread(pair):
    """The port's own 4-step episode. The cloth is chaotic under the
    grippers: from the second macro step on, rounding differences left by
    the first one change which particles the gripper holds. So the episode
    is held to the spread between the JAX package's Pallas kernel and its
    XLA oracle on the same episode (2.8e-2 in reward), and its first step
    to the tight tolerance."""
    jenv, jstate, tenv, tstate, _, params, policy = pair
    jfinal, jactions, jrewards = _jax_rollout(jenv, jstate, params)
    pconf = JaxClothConf(**SMALL, backend="pallas")  # interpret mode on the CPU
    penv = JaxFoldCloth3Env(B, conf=pconf)
    assert penv.simulator.backend == "pallas"
    _, _, prewards = _jax_rollout(penv, jstate, params)

    tfinal, tactions, trewards = run_eval(policy, None, tenv, tstate, deterministic=True)
    assert trewards.shape == (4, B)
    assert torch.isfinite(trewards).all()
    np.testing.assert_array_equal(tfinal.cur_step.numpy(), np.asarray(jfinal.cur_step))
    np.testing.assert_allclose(tactions[0].numpy(), jactions[0], rtol=0, atol=1e-6)
    np.testing.assert_allclose(trewards[0].numpy(), jrewards[0], **TOL_REWARD)
    spread = np.abs(prewards - jrewards).max()
    assert np.abs(trewards.numpy() - jrewards).max() <= spread


def test_sampled_step_matches_jax(pair):
    """One sampled macro step, both sides fed the same numpy noise."""
    jenv, jstate, tenv, tstate, model, params, policy = pair
    eps = np.random.default_rng(5).standard_normal((B, 6)).astype(np.float32)

    jdist = JaxNormalTanh(event_size=6)
    loc, scale = jdist._loc_scale(model.apply(params, jenv.get_obs(jstate)))
    jactions = jax.nn.sigmoid(jax.numpy.tanh(loc + scale * eps))
    _, jreward, jdone, jinfo = jenv.step_diff(jactions, jstate)

    with torch.no_grad():
        logits = policy(tenv.get_obs(tstate))
        tactions = torch.sigmoid(
            NormalTanhDistribution(event_size=6).sample_from_eps(logits, torch.from_numpy(eps))
        )
        obs, treward, tdone, tinfo = tenv.step_diff(tactions, tstate)

    np.testing.assert_allclose(tactions.numpy(), np.asarray(jactions), rtol=0, atol=1e-6)
    np.testing.assert_allclose(treward.numpy(), np.asarray(jreward), **TOL_REWARD)
    np.testing.assert_allclose(tinfo["state"].x.numpy(), np.asarray(jinfo["state"].x), **TOL_X)
    np.testing.assert_allclose(
        tinfo["real_reward"].numpy(), np.asarray(jinfo["real_reward"]), rtol=0, atol=1e-5
    )
    np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
    assert tinfo["obs_list"].shape == (40, B, tenv.observation_size)
    np.testing.assert_allclose(
        tinfo["obs_list"].numpy(), np.asarray(jinfo["obs_list"]), **TOL_X
    )


# The port imports neither JAX nor the JAX package, nor a YAML parser: the
# card's machine has none (unidom_torch/configs are JSON).
_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|unidom_tpu|yaml)\b", re.MULTILINE)


def test_port_imports_no_jax():
    repo = Path(__file__).resolve().parents[1]
    root = repo / "unidom_torch"
    sources = sorted(root.rglob("*.py")) + [repo / "chip_smoke.py"]
    names = {str(p.relative_to(repo)) for p in sources}
    for module in ("ops/m3.py", "ops/svd3.py", "ops/quat.py", "ops/sdf.py", "engine/primitives.py",
                   "engine/mpm.py", "ops/cuda/mpm_kernel.py", "envs/base_mpm.py",
                   "envs/mpm_tasks.py"):
        assert f"unidom_torch/{module}" in names
    offenders = [str(p) for p in sources if _FORBIDDEN.search(p.read_text())]
    assert offenders == []
