"""The port's whip_rope env against ``unidom_tpu`` on the CPU, at the full
``WhipRopeConf`` with 2 envs: the scene and observation contract, two
``step_diff`` macro steps from one state, the recorded reference fixture,
auto-reset, a short ``run_eval`` that launches no kernel, and the entry
points' default device."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unidom_tpu.envs.mpm_tasks import WhipRopeEnv as JaxWhipRopeEnv
from unidom_torch import make_env
from unidom_torch.algorithms.apg import run_eval
from unidom_torch.engine.mpm import MPMSimulator
from unidom_torch.envs.mpm_tasks import WhipRopeConf, WhipRopeEnv
from unidom_torch.models.mlp import PolicyMLP
from unidom_torch.ops.cuda.mpm_kernel import mpm_step
from unidom_torch.utils.convert import mpm_state_from_jax

torch.set_num_threads(1)

B = 2
ACTIONS = np.array([[0.5, 0.1, -0.3, 0.2, 0.0, 0.0], [-0.4, 0.0, 0.6, 0.0, 0.1, 0.0]], np.float32)
# Tolerances for one or two macro steps (70 substeps each) from the same
# state: both sides run the same float32 operations with sums in another
# order; tests/test_golden.py holds the JAX env to its reference at the same
# rtol 1e-4 / atol 1e-5 on the particle block.
TOL_PARTICLES = dict(rtol=1e-4, atol=1e-5)
TOL_REWARD = dict(rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def envs():
    jenv = JaxWhipRopeEnv(batch_size=B, seed=1)
    _, jstate = jenv.reset(jax.random.PRNGKey(1))
    tenv = WhipRopeEnv(B, seed=1, device="cpu")
    return jenv, jax.device_get(jstate), tenv


def test_whip_rope_contract_and_scene_match_jax(envs):
    jenv, _, tenv = envs
    assert tenv.simulator.n_particles == jenv.simulator.n_particles == 67
    assert tenv.observation_size == 67 * 6 + 71 * 3 == 615
    assert tenv.simulator.transfer_mode == "dense"
    assert (tenv.action_squash, tenv.reset_mode, tenv.max_steps) == (None, "auto_reset", 70)
    jinit = jax.device_get(jenv.init_state)
    init = tenv.init_state
    np.testing.assert_array_equal(init.x.numpy(), np.asarray(jinit.x))
    np.testing.assert_array_equal(init.primitives[0].position.numpy(),
                                  np.asarray(jinit.primitives[0].position))
    for name in ("F", "J", "friction", "mu", "lamda", "yield_stress"):
        np.testing.assert_allclose(getattr(init, name).numpy(), np.asarray(getattr(jinit, name)),
                                   rtol=1e-7, err_msg=name)
    np.testing.assert_array_equal(tenv.simulator.material, np.asarray(jenv.simulator.material))


def test_auto_reset_with_jax_shifts_matches_jax_reset(envs):
    """Handed the shifts that JAX's reset drew from its per-env keys,
    ``auto_reset`` gives JAX's reset state."""
    jenv, jstate, tenv = envs
    keys = np.asarray(jax.device_get(jenv.init_state.key))
    shifts = np.stack([np.asarray(jax.random.normal(jax.random.split(k)[0], (2,)) * 0.02)
                       for k in keys])
    state = tenv.auto_reset(tenv.init_state, shift=shifts)
    np.testing.assert_allclose(state.x.numpy(), np.asarray(jstate.x), rtol=0, atol=1e-7)
    np.testing.assert_allclose(state.primitives[0].position.numpy(),
                               np.asarray(jstate.primitives[0].position), rtol=0, atol=1e-7)
    assert (state.cur_step.numpy() == 0).all()


def test_get_obs_matches_jax(envs):
    jenv, jstate, tenv = envs
    obs = tenv.get_obs(mpm_state_from_jax(jstate, device="cpu"))
    np.testing.assert_array_equal(obs.numpy(), np.asarray(jenv.get_obs(jstate)))


def test_two_macro_steps_match_jax(envs):
    jenv, jstate, tenv = envs
    tstate = mpm_state_from_jax(jstate, device="cpu")
    for t in range(2):
        action = ACTIONS * (1 + t)
        jobs, jreward, jdone, jinfo = jenv.step_diff(jnp.asarray(action), jstate)
        obs, reward, done, info = tenv.step_diff(torch.from_numpy(action), tstate)
        P6 = 67 * 6
        np.testing.assert_allclose(obs[:, :P6].numpy(), np.asarray(jobs)[:, :P6], **TOL_PARTICLES)
        np.testing.assert_allclose(obs[:, P6:].numpy(), np.asarray(jobs)[:, P6:], atol=1e-6)
        np.testing.assert_allclose(reward.numpy(), np.asarray(jreward), **TOL_REWARD)
        np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
        assert info["obs_list"].shape == (1, B, 615)
        np.testing.assert_allclose(info["obs_list"].numpy(), np.asarray(jinfo["obs_list"]),
                                   **TOL_PARTICLES)
        jstate = jax.device_get(jinfo["state"])
        tstate = info["state"]
        assert (tstate.cur_step.numpy() == t + 1).all()
    moved = np.abs(np.asarray(jstate.x) - np.asarray(envs[1].x)).max()
    assert moved > 1e-3


def test_recorded_reference_fixture():
    """tests/test_golden.py's whip_rope mapping, on the port: the particle
    block of the recorded reference obs, one macro step from its state, and
    the primitive rows 1..steps-1 that the reference and this package share."""
    fix_path = os.path.join(os.path.dirname(__file__), "fixtures", "whip_rope_ref_obs.npz")
    fix = np.load(fix_path)
    steps = int(fix["steps"])
    env = WhipRopeEnv(B, seed=1, conf=dataclasses.replace(WhipRopeConf, steps=steps),
                      device="cpu")
    _, state = env.reset(torch.Generator().manual_seed(1))
    P = env.simulator.n_particles
    assert env.observation_size == P * 6 + (steps + 1) * 3
    assert fix["obs0"].shape[-1] == P * 6 + steps * 3

    prim = state.primitives[0]
    pos = torch.zeros_like(prim.position)
    pos[:, :steps] = torch.from_numpy(fix["prim_pos0"])
    rot = torch.zeros_like(prim.rotation)
    rot[:, :steps] = torch.from_numpy(fix["prim_rot0"])
    state = state.replace(x=torch.from_numpy(fix["x0"]), v=torch.from_numpy(fix["v0"]),
                          primitives=(prim.replace(position=pos, rotation=rot),))
    obs = env.get_obs(state).numpy()
    np.testing.assert_allclose(obs[:, :P * 6], fix["obs0"][:, :P * 6], atol=1e-6)

    _, _, _, info = env.step_diff(torch.from_numpy(fix["actions"][0]), state)
    obs1 = env.get_obs(info["state"]).numpy()
    ref1 = fix["obs1"]
    np.testing.assert_allclose(obs1[:, :P * 6], ref1[:, :P * 6], **TOL_PARTICLES)
    ours = obs1[:, P * 6:].reshape(B, steps + 1, 3)
    ref = ref1[:, P * 6:].reshape(B, steps, 3)
    np.testing.assert_allclose(ours[:, 1:steps], ref[:, 1:steps], atol=1e-5)
    np.testing.assert_allclose(ref[:, 0], ours[:, steps - 1], atol=1e-5)
    np.testing.assert_allclose(ours[:, 0], ours[:, steps], atol=1e-6)


def _short_env(max_steps):
    """whip_rope's scene with 10 substeps per macro step, for speed."""
    return WhipRopeEnv(B, seed=3, max_steps=max_steps,
                       conf=dataclasses.replace(WhipRopeConf, steps=10), device="cpu")


def test_auto_reset_on_done_and_reset_is_seeded():
    env = _short_env(max_steps=1)
    _, s0 = env.reset(torch.Generator().manual_seed(7))
    _, s0_again = env.reset(torch.Generator().manual_seed(7))
    torch.testing.assert_close(s0.x, s0_again.x, rtol=0, atol=0)
    shift = (s0.x - env.init_state.x)[:, 0]
    assert (shift[:, 1] == 0).all() and (shift.abs() < 0.2).all() and (shift.abs() > 0).any()

    _, _, done, info = env.step_diff(torch.from_numpy(ACTIONS), s0)
    assert done.all()
    s = info["state"]
    assert (s.cur_step == 0).all()
    d = (s.x - env.init_state.x)  # a fresh auto-reset shift, the same for every particle
    torch.testing.assert_close(d, d[:, :1].expand_as(d), rtol=0, atol=1e-6)
    assert (d[..., 1].abs() < 1e-6).all()
    torch.testing.assert_close(s.v, torch.zeros_like(s.v), rtol=0, atol=0)
    torch.testing.assert_close(s.primitives[0].position[:, 0] - env.init_state.primitives[0].position[:, 0],
                               d[:, 0])


def test_run_eval_on_cpu_launches_no_kernel():
    env = _short_env(max_steps=2)
    policy = PolicyMLP(env.observation_size, 12, generator=torch.Generator().manual_seed(0),
                       device="cpu")
    _, s0 = env.reset()
    before = mpm_step.launches
    final, actions, rewards = run_eval(policy, None, env, s0,
                                       generator=torch.Generator().manual_seed(1))
    assert mpm_step.launches == before
    assert actions.shape == (2, B, 6) and rewards.shape == (2, B)
    assert torch.isfinite(rewards).all() and (actions.abs() <= 1).all()
    assert torch.isfinite(final.x).all()


def test_entry_points_default_to_the_card_mpm(envs):
    """make_env("whip_rope"), MPMSimulator and mpm_state_from_jax run on the
    card unless asked for the CPU: without a GPU the default raises."""
    _, jstate, _ = envs
    defaults = [
        lambda: make_env("whip_rope", batch_size=2),
        lambda: MPMSimulator(WhipRopeConf, 2),
        lambda: mpm_state_from_jax(jstate),
    ]
    if torch.cuda.is_available():
        assert defaults[0]().init_state.x.is_cuda
        assert defaults[1]().grid_idx_3d.is_cuda
        assert defaults[2]().x.is_cuda
    else:
        for make in defaults:
            with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
                make()
    env = make_env("whip_rope", batch_size=2, device="cpu")
    assert env.device.type == "cpu" and env.init_state.x.device.type == "cpu"
