"""The port's PlasticineLab scenes against ``unidom_tpu`` on the CPU: for each
of the seven sphere scenes at ``tests/test_plb.py``'s SMALL conf (a 32^3
grid, 5 substeps), the reset (particles, target, tracker, observation) and
one ``step_diff`` (state, reward, ``loss_info``); the gradient of one step's
reward with respect to the action against ``jax.grad``; the registry's
seven names, the three scenes that wait for their SDFs, and the kernel each
configuration takes on the card."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unidom_tpu.envs import plb_tasks as jplb
from unidom_tpu.envs.registration import env_functions as jax_env_functions
from unidom_torch import make_env
from unidom_torch.engine.mpm import VON_MISES, kernel_route
from unidom_torch.envs import plb_tasks as tplb
from unidom_torch.envs.registration import env_functions

torch.set_num_threads(1)

B = 2
SCENES = sorted(tplb.PLB_SCENES)
SMALL = dataclasses.replace(tplb.PLB_BASE_CONF, n_grid=32, steps=5, res=(32, 32, 32))
JSMALL = dataclasses.replace(jplb.PLB_BASE_CONF, n_grid=32, steps=5, res=(32, 32, 32))
SEED = 3

# One macro step from the same state: the same float32 operations with sums
# in another order (tests/test_torch_mpm_big_env.py's tolerances).
TOL_STATE = {"x": (1e-4, 1e-5), "v": (1e-3, 1e-4), "C": (1e-3, 1e-2), "F": (1e-3, 1e-4),
             "J": (1e-3, 1e-5)}
# The losses are sums over the grid of ~1e4: float32 rounds them by ~1e-3,
# and a reward is a difference of two of them.
LOSS_REL = 2e-6


def _np(t):
    return np.asarray(t)


def _confs(scene):
    n = len(tplb.PLB_SCENES[scene]["primitives"])
    return (dataclasses.replace(SMALL, n_primitive=n, task=scene),
            dataclasses.replace(JSMALL, n_primitive=n, task=scene))


def _actions(scene, n_act):
    """Velocities of the spheres from a numpy seed; plb_torus's scale is 1
    (200x the others'), so its actions are cut to keep a macro step's
    collider speed that of the others."""
    a = np.random.default_rng(0).uniform(-1, 1, (B, n_act)).astype(np.float32)
    return a * np.float32(0.01) if scene == "plb_torus" else a


@pytest.fixture(scope="module", params=SCENES)
def pair(request):
    scene = request.param
    conf, jconf = _confs(scene)
    tenv = tplb.PlbSceneEnv(scene, B, conf=conf, max_steps=4, device="cpu")
    jenv = jplb.PlbSceneEnv(scene, B, conf=jconf, max_steps=4)
    tobs, tstate = tenv.reset(torch.Generator().manual_seed(SEED))
    jobs, jstate = jenv.reset(jax.random.PRNGKey(SEED))
    return scene, tenv, tobs, tstate, jenv, jobs, jax.device_get(jstate)


def test_reset_matches_jax(pair):
    scene, tenv, tobs, tstate, jenv, jobs, jstate = pair
    tsim, jsim = tenv.simulator, jenv.simulator
    assert tsim.n_particles == jsim.n_particles >= 1000
    assert tsim.sdf_names == jsim.sdf_names == ["sphere"] * len(tstate.primitives)
    assert (tsim.material == VON_MISES).all()
    assert (tenv.observation_size, tenv.action_size, tenv.reset_mode) == (
        jenv.observation_size, jenv.action_size, jenv.reset_mode)
    # the same RandomState stream places the same particles
    np.testing.assert_array_equal(tstate.x.numpy(), _np(jstate.x))
    np.testing.assert_array_equal(tobs.numpy(), _np(jobs))
    for p, jp in zip(tstate.primitives, jstate.primitives):
        for f in ("size", "friction", "softness", "position"):
            np.testing.assert_array_equal(getattr(p, f).numpy(), _np(getattr(jp, f)), err_msg=f)
    for f in ("mu", "lamda", "yield_stress", "friction"):
        np.testing.assert_allclose(getattr(tstate, f).numpy(), _np(getattr(jstate, f)),
                                   rtol=1e-6, err_msg=f)
    tl, jl = tenv.target_loss, jenv.target_loss
    np.testing.assert_allclose(tl.target_density.numpy(), _np(jl.target_density), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tl.target_sdf.numpy(), _np(jl.target_sdf), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tenv.tracker.start_loss.numpy(), _np(jenv.tracker.start_loss),
                               rtol=LOSS_REL)
    # a reset from another seed places other particles
    _, other = tenv.reset(SEED + 1)
    assert not torch.equal(other.x, tstate.x)
    tenv.reset(torch.Generator().manual_seed(SEED))


def test_step_diff_matches_jax(pair):
    scene, tenv, _, tstate, jenv, _, jstate = pair
    a = _actions(scene, tenv.action_size)
    tobs, trew, tdone, tinfo = tenv.step_diff(torch.from_numpy(a), tstate)
    jobs, jrew, jdone, jinfo = jenv.step_diff(jnp.asarray(a), jstate)
    ts, js = tinfo["state"], jinfo["state"]
    for f, (rtol, atol) in TOL_STATE.items():
        np.testing.assert_allclose(getattr(ts, f).numpy(), _np(getattr(js, f)), rtol=rtol,
                                   atol=atol, err_msg=f)
    for p, jp in zip(ts.primitives, js.primitives):
        np.testing.assert_allclose(p.position.numpy(), _np(jp.position), rtol=0, atol=1e-6)
    moved = max((p.position[:, 0] - q.position[:, 0]).abs().max().item()
                for p, q in zip(ts.primitives, tstate.primitives))
    assert moved > 0
    scale = float(np.abs(_np(jenv.tracker.start_loss)).max())
    np.testing.assert_allclose(trew.numpy(), _np(jrew), rtol=0, atol=LOSS_REL * scale)
    np.testing.assert_array_equal(tdone.numpy(), _np(jdone))
    np.testing.assert_allclose(tobs.numpy(), _np(jobs), rtol=1e-3, atol=1e-4)
    tout, jout = tenv.loss_info(ts), jenv.loss_info(js)
    for key in ("loss", "sdf_loss", "density_loss", "reward"):
        np.testing.assert_allclose(tout[key].numpy(), _np(jout[key]), rtol=LOSS_REL,
                                   atol=LOSS_REL * scale, err_msg=key)
    for key in ("iou", "incremental_iou"):
        np.testing.assert_allclose(tout[key].numpy(), _np(jout[key]), rtol=1e-4, atol=1e-6,
                                   err_msg=key)


def test_reward_gradient_matches_jax():
    """d(the summed reward of one step) / d(action) through the plain step
    (autograd), against ``jax.grad`` of JAX's step, on plb_triplemove (three
    spheres)."""
    scene = "plb_triplemove"
    conf, jconf = _confs(scene)
    tenv = tplb.PlbSceneEnv(scene, B, conf=conf, max_steps=4, device="cpu")
    jenv = jplb.PlbSceneEnv(scene, B, conf=jconf, max_steps=4)
    _, tstate = tenv.reset(SEED)
    _, jstate = jenv.reset(jax.random.PRNGKey(SEED))
    a = _actions(scene, tenv.action_size)
    # the spheres start 0.08 short of their bodies: put each 0.01 into its
    # body's side, so that the step's reward feels the action
    z = np.float32(0.43)
    tstate = tstate.replace(primitives=tuple(
        p.replace(position=torch.cat([p.position[:, :1, :2], torch.full_like(
            p.position[:, :1, 2:], z), p.position[:, :1, 3:]], -1).expand_as(p.position)
            .contiguous()) for p in tstate.primitives))
    jstate = jstate._replace(primitives=tuple(
        p._replace(position=p.position.at[..., 2].set(z)) for p in jstate.primitives))

    jg = _np(jax.grad(lambda x: jenv.step_diff(x, jstate)[1].sum())(jnp.asarray(a)))
    ta = torch.from_numpy(a).requires_grad_()
    (tg,) = torch.autograd.grad(tenv.step_diff(ta, tstate)[1].sum(), ta)
    tg = tg.numpy()
    assert np.abs(jg).max() > 0 and np.isfinite(tg).all()
    np.testing.assert_allclose(tg, jg, rtol=2e-3, atol=2e-3 * np.abs(jg).max())


def test_registry_holds_the_seven_sphere_scenes():
    jax_plb = {n for n in jax_env_functions if n.startswith("plb_")}
    assert set(tplb.PLB_SCENES) | set(tplb.PLB_NOT_PORTED) == jax_plb
    assert set(tplb.PLB_SCENES) <= set(env_functions)
    assert len(tplb.PLB_SCENES) == 7
    for name in tplb.PLB_SCENES:
        assert env_functions[name].__name__ == jax_env_functions[name].__name__, name
        assert all(p.get("kind", "v3") == "v3" and "shape" not in p
                   for p in tplb.PLB_SCENES[name]["primitives"])
        assert tplb.PLB_SCENES[name] == jplb.PLB_SCENES[name], name
    env = make_env("plb_move", batch_size=1, device="cpu")
    assert (env.conf.res, env.conf.steps, env.action_size) == ((64, 64, 64), 40, 3)


@pytest.mark.parametrize("scene", sorted(tplb.PLB_NOT_PORTED))
def test_scenes_without_their_sdf_raise(scene):
    assert scene not in env_functions
    with pytest.raises(NotImplementedError, match=tplb.PLB_NOT_PORTED[scene]):
        tplb.PlbSceneEnv(scene, 1, device="cpu")


def test_kernel_route_small_k2_full_k3():
    """On the card: the SMALL conf fits K2; every scene at its 64^3 grid
    (262,144 cells) goes to K3."""
    small = tplb.PlbSceneEnv("plb_move", 1, conf=_confs("plb_move")[0], device="cpu")
    small.reset(SEED)
    assert kernel_route(small.simulator) == "k2"
    for scene in SCENES:
        env = tplb.PlbSceneEnv(scene, 1, device="cpu")
        sim = env.simulator
        sim.sdf_names = ["sphere"] * len(tplb.PLB_SCENES[scene]["primitives"])
        sim.n_particles = sum(s["n"] for s in tplb.PLB_SCENES[scene]["shapes"])
        assert kernel_route(sim) == "k3", scene
