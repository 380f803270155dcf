"""The port's big-grid and shape_rope-family MPM envs against ``unidom_tpu``
on the CPU: pour_soup's and shape_elasto_plastic's scenes and observation
contracts, one ``step_diff`` of pour_water, pour_soup (on a 24x32x24 grid
with 2 substeps) and shape_elasto_plastic (2 push sub-steps of 8
substeps) from a JAX state carried across by
``convert.mpm_state_from_jax``, shape_rope's reset pushes, the two base-env
hooks (the push moves with the focus shift; a done shape_rope env keeps its
state), ``run_eval`` on pour_soup, and the entry points' default device."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unidom_tpu.envs import mpm_tasks as jtasks
from unidom_tpu.envs.registration import env_functions as jax_env_functions
from unidom_torch import make_env
from unidom_torch.algorithms.apg import run_eval
from unidom_torch.engine.mpm import ELASTIC, PLASTIC_CLIP, WATER, kernel_route
from unidom_torch.envs import mpm_tasks as ttasks
from unidom_torch.envs.registration import env_functions
from unidom_torch.models.mlp import PolicyMLP
from unidom_torch.ops.cuda.mpm_big_kernel import mpm_big_step
from unidom_torch.ops.cuda.mpm_kernel import mpm_step
from unidom_torch.ops.gradops import tree_flatten
from unidom_torch.utils.convert import mpm_state_from_jax

torch.set_num_threads(1)

B = 2
# One macro step from the same state: the same float32 operations on both
# sides with sums in another order (tests/test_torch_mpm_env.py's
# tolerances, which tests/test_golden.py holds the JAX env to; for the
# state's v, F and J, tests/test_torch_mpm.py's of one simulator step:
# sigma-clip plasticity rounds F's small entries at the clip).
TOL_PARTICLES = dict(rtol=1e-4, atol=1e-5)
TOL_STATE = {"x": (1e-4, 1e-5), "v": (1e-3, 1e-4), "F": (1e-3, 1e-4), "J": (1e-3, 1e-5)}
TOL_PRIMITIVE = dict(rtol=0, atol=1e-6)
TOL_REWARD = dict(rtol=0, atol=1e-6)


def _np(t):
    return np.asarray(t)


# pour_soup cut to a grid that still holds the soup: tests/test_golden.py's
# res (16, 8, 16) leaves it above the grid (y 0.2 is cell 25), where nothing
# moves
SOUP_SMALL = dict(res=(24, 32, 24), steps=2)


class _JaxElasto(jtasks.ShapeElastoPlasticEnv):
    PUSH_SUBSTEPS = 2


class _Elasto(ttasks.ShapeElastoPlasticEnv):
    PUSH_SUBSTEPS = 2


def _pair(name):
    """(JAX env, its reset state as numpy, the port's env on the CPU)."""
    if name == "pour_water":
        jenv = jtasks.PourWaterEnv(batch_size=B, seed=1)
        tenv = ttasks.PourWaterEnv(B, seed=1, device="cpu")
    elif name == "pour_soup":
        jenv = jtasks.PourSoupEnv(batch_size=B, seed=1, conf=dataclasses.replace(
            jtasks.PourSoupConf, **SOUP_SMALL))
        tenv = ttasks.PourSoupEnv(B, seed=1, device="cpu", conf=dataclasses.replace(
            ttasks.PourSoupConf, **SOUP_SMALL))
    else:  # shape_elasto_plastic, max_steps 1: done after its one step
        jenv = _JaxElasto(batch_size=B, seed=1, max_steps=1, conf=dataclasses.replace(
            jtasks.ShapeElastoPlasticConf, steps=8))
        tenv = _Elasto(B, seed=1, max_steps=1, device="cpu", conf=dataclasses.replace(
            ttasks.ShapeElastoPlasticConf, steps=8))
    _, jstate = jenv.reset(jax.random.PRNGKey(1))
    return jenv, jax.device_get(jstate), tenv


ACTIONS = {
    "pour_water": np.array([[0.5, 0.2, -0.3, 0.0, 0.0, 0.4], [-0.4, 0.0, 0.6, 0.3, 0.0, 0.0]],
                           np.float32),
    "pour_soup": np.array([[0.5, 0.2, -0.3, 0.0, 0.0, 0.4], [-0.4, 0.0, 0.6, 0.3, 0.0, 0.0]],
                          np.float32),
    # pushes from outside the slab (x 0.4-0.6, z 0.44-0.56) into its side:
    # cut to 16 substeps, a push is 20x faster than in the env, and one
    # that starts inside the slab throws particles about chaotically
    "shape_elasto_plastic": np.array([[0.37, 0.0, 0.5, 0.40, 0.0, 0.5],
                                      [0.5, 0.0, 0.42, 0.5, 0.0, 0.45]], np.float32),
}


@pytest.fixture(scope="module", params=list(ACTIONS))
def pair(request):
    return (request.param,) + _pair(request.param)


def test_scene_and_contract_match_jax(pair):
    name, jenv, jstate, tenv = pair
    jsim, tsim = jenv.simulator, tenv.simulator
    assert tsim.n_particles == jsim.n_particles
    assert tenv.observation_size == jenv.observation_size
    np.testing.assert_array_equal(tsim.material, _np(jsim.material))
    np.testing.assert_array_equal(tsim.h, _np(jsim.h))
    assert tsim.sdf_names == jsim.sdf_names
    assert (tenv.action_squash, tenv.reset_mode, tenv.max_steps) == (
        jenv.action_squash, jenv.reset_mode, jenv.max_steps)
    solid = tsim.material != WATER  # water is drawn from each side's own generator
    np.testing.assert_array_equal(tenv.init_state.x.numpy()[:, solid], _np(jstate.x)[:, solid])
    for i, p in enumerate(tenv.init_state.primitives):
        jp = jstate.primitives[i]
        np.testing.assert_array_equal(p.size.numpy(), _np(jp.size))
        np.testing.assert_array_equal(p.position.numpy()[:, 1:], _np(jp.position)[:, 1:])
    for field in ("mu", "lamda", "yield_stress", "friction"):
        np.testing.assert_allclose(getattr(tenv.init_state, field).numpy(),
                                   _np(getattr(jstate, field)), rtol=1e-6, err_msg=field)


def test_step_diff_matches_jax(pair):
    name, jenv, jstate, tenv = pair
    action = ACTIONS[name]
    jobs, jreward, jdone, jinfo = jenv.step_diff(jnp.asarray(action), jstate)
    tstate = mpm_state_from_jax(jstate, device="cpu")
    obs, reward, done, info = tenv.step_diff(torch.from_numpy(action), tstate)
    P6 = tenv.simulator.n_particles * 6
    np.testing.assert_allclose(obs[:, :P6].numpy(), _np(jobs)[:, :P6], **TOL_PARTICLES)
    np.testing.assert_allclose(obs[:, P6:].numpy(), _np(jobs)[:, P6:], **TOL_PRIMITIVE)
    np.testing.assert_allclose(reward.numpy(), _np(jreward), **TOL_REWARD)
    np.testing.assert_array_equal(done.numpy(), _np(jdone))
    assert info["obs_list"].shape == _np(jinfo["obs_list"]).shape
    np.testing.assert_allclose(info["obs_list"].numpy(), _np(jinfo["obs_list"]), **TOL_PARTICLES)
    js = jax.device_get(jinfo["state"])
    for field, (rtol, atol) in TOL_STATE.items():
        np.testing.assert_allclose(getattr(info["state"], field).numpy(), _np(getattr(js, field)),
                                   rtol=rtol, atol=atol, err_msg=field)
    for i, p in enumerate(info["state"].primitives):
        np.testing.assert_allclose(p.position.numpy(), _np(js.primitives[i].position),
                                   **TOL_PRIMITIVE)
        np.testing.assert_allclose(p.rotation.numpy(), _np(js.primitives[i].rotation),
                                   **TOL_PRIMITIVE)
    assert (info["state"].cur_step.numpy() == _np(js.cur_step)).all()
    assert np.abs(_np(js.x) - _np(jstate.x)).max() > 1e-5  # the step moved the particles


def test_big_grid_scenes_at_full_size():
    """pour_soup: 2877 water and 4817 elastic particles (2 x 343 tofu, 4131
    vegetable points), obs 46,242; shape_elasto_plastic: 23,940 sigma-clip
    particles, obs 143,691; both routed to K3-fwd, pour_water to K2."""
    soup = make_env("pour_soup", batch_size=1, device="cpu")
    mat = soup.simulator.material
    assert ((mat == WATER).sum(), (mat == ELASTIC).sum()) == (2877, 343 * 2 + 4131)
    assert soup.simulator.n_particles == 7694 and soup.observation_size == 46242
    assert soup.simulator.sdf_names == ["container", "container"]
    elasto = make_env("shape_elasto_plastic", batch_size=1, device="cpu")
    assert elasto.simulator.n_particles == 23940 and elasto.observation_size == 143691
    assert (elasto.simulator.material == PLASTIC_CLIP).all()
    assert kernel_route(soup.simulator) == kernel_route(elasto.simulator) == "k3"
    water = make_env("pour_water", batch_size=1, device="cpu")
    assert kernel_route(water.simulator) == "k2"
    assert (ttasks._veg_point_cloud() == np.load(ttasks.ASSET_DIR / "pour_soup_veg.npy")).all()


def test_registry_names_the_jax_envs():
    for name in ("pour_water", "pour_soup", "shape_rope", "push_rope", "shape_rope_hard",
                 "push_rope_hard", "shape_elasto_plastic", "whip_rope"):
        assert env_functions[name].__name__ == jax_env_functions[name].__name__, name


def _recorder(pushes, replace):
    """A stand-in ``step_diff`` that records the pushes and only counts the
    step (the physics of a push is held above)."""
    def step_diff(actions, state):
        pushes.append(np.asarray(actions))
        return None, None, None, {"state": replace(state, cur_step=state.cur_step + 1)}
    return step_diff


def test_shape_rope_reset_pushes_match_jax():
    """shape_rope_hard's reset: shape_rope's DO_RESET_PUSHES (2) random
    pushes through env 0's particles, drawn from numpy seeded with the env's
    seed, then 8 more, each followed by a restart of the step count."""
    jenv = jtasks.ShapeRopeHardEnv(batch_size=B, seed=3)
    tenv = ttasks.ShapeRopeHardEnv(B, seed=3, device="cpu")
    jpushes, tpushes = [], []
    jenv.step_diff = _recorder(jpushes, lambda s, **k: s._replace(**k))
    tenv.step_diff = _recorder(tpushes, lambda s, **k: s.replace(**k))
    _, jstate = jenv.reset(jax.random.PRNGKey(0))
    _, tstate = tenv.reset()
    assert len(tpushes) == len(jpushes) == 10
    np.testing.assert_array_equal(np.stack(tpushes), np.stack(jpushes))
    assert (tstate.cur_step.numpy() == 0).all() and (_np(jstate.cur_step) == 0).all()
    assert (np.stack(tpushes)[:, :, 1] == 0).all()


def test_push_moves_with_the_focus_shift():
    """The push's start and end are world positions; ``pre_step`` shifts the
    scene, and ``process_pre_step_actions`` moves the push with it (whip_rope
    and pour_water leave their actions as they are)."""
    env = _Elasto(1, seed=1, device="cpu", conf=dataclasses.replace(
        ttasks.ShapeElastoPlasticConf, steps=2))
    actions = torch.tensor([[0.45, 0.0, 0.5, 0.55, 0.0, 0.5]])
    shift = torch.tensor([[0.1, 0.0, -0.2]])
    moved = env.process_pre_step_actions(actions, shift)
    torch.testing.assert_close(moved, actions + torch.cat([shift, shift], 1))
    water = ttasks.PourWaterEnv(1, device="cpu")
    assert water.process_pre_step_actions(actions, shift) is actions
    # in the world, the pusher's first substep moves it from the push's start
    # by 1 / (push sub-steps x substeps) of the push
    _, s0 = env.reset()
    _, _, _, info = env.step_diff(actions, s0)
    first = info["state_list"][0].primitives[0].position[:, 1]
    step = 0.1 / env.PUSH_SUBSTEPS / env.conf.steps
    torch.testing.assert_close(first, torch.tensor([[0.45 + step, 0.01, 0.5]]), rtol=0, atol=1e-6)


def test_done_shape_rope_env_keeps_its_state_and_pour_water_restarts():
    env = _Elasto(B, seed=1, max_steps=1, device="cpu", conf=dataclasses.replace(
        ttasks.ShapeElastoPlasticConf, steps=2))
    _, s0 = env.reset()
    _, _, done, info = env.step_diff(torch.from_numpy(ACTIONS["shape_elasto_plastic"]), s0)
    assert done.all()
    s = info["state"]
    torch.testing.assert_close(s.x, info["state_list"][-1].x, rtol=0, atol=0)
    assert (s.cur_step == 1).all()
    assert (s.x - s0.x).abs().max() > 1e-5
    assert env.auto_reset(env.init_state, state=s) is s
    assert env.auto_reset(env.init_state) is env.init_state

    water = ttasks.PourWaterEnv(B, seed=1, max_steps=1, device="cpu",
                                conf=dataclasses.replace(ttasks.PourWaterConf, steps=2))
    _, w0 = water.reset(torch.Generator().manual_seed(0))
    _, _, done, info = water.step_diff(torch.from_numpy(ACTIONS["pour_water"]), w0)
    assert done.all()
    w = info["state"]
    torch.testing.assert_close(w.x, water.init_state.x, rtol=0, atol=0)
    assert (w.cur_step == 0).all()
    d = w.primitives[0].position[:, 0] - water.init_state.primitives[0].position[:, 0]
    assert (d[:, 1] == 0).all() and (d.abs() > 0).any() and (d.abs() < 0.2).all()
    torch.testing.assert_close(w.primitives[1].position, water.init_state.primitives[1].position)


def test_run_eval_on_pour_soup_launches_no_kernel():
    env = ttasks.PourSoupEnv(B, seed=2, max_steps=2, device="cpu",
                             conf=dataclasses.replace(ttasks.PourSoupConf, **SOUP_SMALL))
    policy = PolicyMLP(env.observation_size, 12, generator=torch.Generator().manual_seed(0),
                       device="cpu")
    _, s0 = env.reset(torch.Generator().manual_seed(1))
    before = (mpm_step.launches, mpm_big_step.launches, mpm_big_step.cuda_launches)
    final, actions, rewards = run_eval(policy, None, env, s0,
                                       generator=torch.Generator().manual_seed(1))
    assert (mpm_step.launches, mpm_big_step.launches, mpm_big_step.cuda_launches) == before
    assert actions.shape == (2, B, 6) and rewards.shape == (2, B)
    assert torch.isfinite(rewards).all() and torch.isfinite(final.x).all()
    assert (final.cur_step == 0).all()  # done after max_steps, and restarted


def test_mpm_state_from_jax_carries_two_primitives_and_per_particle_parameters(pair):
    name, _, jstate, _ = pair
    P = jstate.x.shape[1]
    rng = np.random.default_rng(4)
    jstate = jstate._replace(mu=rng.random((B, P)).astype(np.float32),
                             lamda=rng.random((B, P)).astype(np.float32))
    state = mpm_state_from_jax(jstate, device="cpu")
    assert len(state.primitives) == len(jstate.primitives)
    leaves = tree_flatten(state)[0]
    jleaves = [jstate.x, jstate.v, jstate.C, jstate.F, jstate.J, jstate.cur_step]
    for p in jstate.primitives:
        jleaves += [getattr(p, f.name) for f in dataclasses.fields(type(state.primitives[0]))]
    jleaves += [jstate.friction, jstate.mu, jstate.lamda, jstate.yield_stress]
    assert len(leaves) == len(jleaves)
    for t, j in zip(leaves, jleaves):
        np.testing.assert_array_equal(t.numpy(), _np(j))


def test_entry_points_default_to_the_card_big_grid():
    """make_env("pour_soup") and make_env("shape_elasto_plastic") run on the
    card unless asked for the CPU: without a GPU the default raises."""
    for name in ("pour_soup", "shape_elasto_plastic"):
        if torch.cuda.is_available():
            assert make_env(name, batch_size=1).init_state.x.is_cuda
        else:
            with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
                make_env(name, batch_size=1)
