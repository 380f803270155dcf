"""fold_tshirt in the port against ``unidom_tpu`` on the CPU: the t-shirt
mask, the reset and one macro step (40 robot steps) from the same numpy
state and actions, at 2 envs with the substeps cut to 2 on both sides."""

import copy

import jax
import numpy as np
import pytest
import torch

from unidom_tpu.engine.cloth import ClothConf as JaxClothConf
from unidom_tpu.envs.cloth_tasks import FoldTshirtEnv as JaxFoldTshirtEnv
from unidom_tpu.envs.cloth_tasks import _goal
from unidom_torch import make_env
from unidom_torch.engine.cloth import ClothConf, ClothState
from unidom_torch.envs.cloth_tasks import _tshirt_mask, goal_path

torch.set_num_threads(1)

B = 2
TSHIRT = dict(N=180, stiffness=5000.0, dt=0.5e-3, mu=0.9, n_substeps=2, task="fold_tshirt")
# tests/test_torch_cloth.py's per-step tolerances: both sides run the same
# float32 operations in the same order up to rounding
TOL_X = dict(rtol=1e-4, atol=1e-5)
TOL_REWARD = dict(rtol=0, atol=1e-6)
# v is rounding-chaotic over a macro step: the velocities of grounded
# particles chatter under dynamic friction (divided by sqrt(vx^2 + vz^2 +
# 1e-8)), and after 80 substeps the two packages' float32 v differ by up to
# ~6e-3 in 8% of the entries. So v is held as chip_smoke.py's [parity] gate
# holds a kernel: against the port's plain step in float64 (the same
# operations as JAX's), the port's float32 RMS error may be at most
# V_RATIO times JAX's float32 one, plus V_FLOOR.
V_RATIO = 2.0
V_FLOOR = 1e-6


def _to_torch(jstate):
    fields = ClothState.__dataclass_fields__
    return ClothState(**{f: torch.from_numpy(np.array(getattr(jstate, f))) for f in fields})


@pytest.fixture(scope="module")
def pair():
    jenv = JaxFoldTshirtEnv(B, conf=JaxClothConf(goal_path=_goal("fold_tshirt"), **TSHIRT))
    tenv = make_env("fold_tshirt", batch_size=B, conf=ClothConf(
        goal_path=goal_path("fold_tshirt"), **TSHIRT), device="cpu")
    key = jax.random.PRNGKey(3)
    jobs, jstate = jenv.reset(key)
    shift_key, _ = jax.random.split(key)
    tobs, tstate = tenv.reset_from_shift(np.asarray(jax.random.normal(shift_key, (2,)) * 0.05))
    return jenv, jobs, jstate, tenv, tobs, tstate


def test_mask_and_reset_match_jax(pair):
    jenv, jobs, jstate, tenv, tobs, tstate = pair
    np.testing.assert_array_equal(_tshirt_mask(180), np.asarray(jenv.simulator.cloth_mask))
    np.testing.assert_array_equal(_tshirt_mask(60), np.asarray(
        JaxFoldTshirtEnv(1, conf=JaxClothConf(N=60, task="fold_tshirt")).simulator.cloth_mask))
    assert (tenv.n_particles, tenv.observation_size, tenv.max_steps) == (3573, 10727, 5)
    default, jdefault = make_env("fold_tshirt", batch_size=1, device="cpu").conf, \
        JaxFoldTshirtEnv(1).conf
    for f in ("N", "gravity", "stiffness", "damping", "dt", "max_v", "mu", "n_substeps",
              "gripper_radius", "task", "goal_path", "use_substep_obs"):
        assert getattr(default, f) == getattr(jdefault, f), f
    assert (tenv.simulator.H, tenv.simulator.W) == (72, 78)
    np.testing.assert_array_equal(tenv.goal.numpy(), np.asarray(jenv.goal))
    for f in ClothState.__dataclass_fields__:
        np.testing.assert_array_equal(getattr(tstate, f).numpy(), np.asarray(getattr(jstate, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs))


def test_macro_step_matches_jax(pair):
    """One step_diff from the reset state under pick-and-place actions that
    grip the shirt: x, v, reward and obs."""
    jenv, _, jstate, tenv, _, _ = pair
    rng = np.random.default_rng(0)
    px = np.asarray(jenv.packed_x(jstate))
    picks = px[np.arange(B), rng.integers(0, px.shape[1], B)]
    places = px[np.arange(B), rng.integers(0, px.shape[1], B)]
    actions = np.concatenate([picks, places], 1).astype(np.float32)
    jobs, jreward, _, jinfo = jenv.step_diff(jax.numpy.asarray(actions), jstate)
    tobs, treward, _, tinfo = tenv.step_diff(torch.from_numpy(actions), _to_torch(jstate))
    jout, tout = jinfo["state"], tinfo["state"]
    assert float(np.abs(np.asarray(jout.x) - np.asarray(jstate.x)).max()) > 1e-3  # it moved
    np.testing.assert_allclose(tout.x.numpy(), np.asarray(jout.x), **TOL_X)
    sim64 = copy.copy(tenv.simulator)
    sim64.rest_len, sim64.nbr_valid = sim64.rest_len.double(), sim64.nbr_valid.double()
    state64 = _to_torch(jstate)
    state64 = state64.replace(**{f: getattr(state64, f).double() for f in (
        "x", "v", "primitive0", "primitive1", "action0", "action1", "stiffness", "mu")})
    for sub in tenv.get_pnp_actions(torch.from_numpy(actions).double(), state64):
        state64 = sim64.step_batch(state64, sub)
    v64 = state64.v.numpy()
    rms_port = np.sqrt(np.mean((tout.v.numpy() - v64) ** 2))
    rms_jax = np.sqrt(np.mean((np.asarray(jout.v) - v64) ** 2))
    assert rms_port <= V_RATIO * rms_jax + V_FLOOR, (rms_port, rms_jax)
    np.testing.assert_allclose(treward.numpy(), np.asarray(jreward), **TOL_REWARD)
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), **TOL_X)


def test_macro_step_vjp_matches_jax(pair):
    """The VJP of one step_diff (40 robot steps) with respect to the actions
    and the state's x and v, from cotangents on the final x and v, against
    ``jax.vjp`` of JAX's. The float32 gradient of a macro step carries the
    forward's rounding chaos, so it is held as v is above: against the
    port's plain step in float64, the port's float32 error (RMS over each
    input's cotangent) may be at most V_RATIO times JAX's, plus V_FLOOR of
    the reference's RMS.

    A cotangent on the reward gives 0 on both sides in float32: the chamfer's
    Gram expansion cancels to d^2 <= 0 for particles within ~2e-4 of a goal
    point (a few dozen of the t-shirt's 3573), sqrt's backward there is 0/0
    for the pairs that no min selects, and the first normalize_grad's
    nan_to_num zeroes the env's whole gradient, in JAX as in the port."""
    jenv, _, jstate, tenv, _, _ = pair
    rng = np.random.default_rng(1)
    px = np.asarray(jenv.packed_x(jstate))
    picks = px[np.arange(B), rng.integers(0, px.shape[1], B)]
    places = px[np.arange(B), rng.integers(0, px.shape[1], B)]
    actions = np.concatenate([picks, places], 1).astype(np.float32)
    cot_r = rng.standard_normal(B).astype(np.float32)
    cot_x, cot_v = (rng.standard_normal(jstate.x.shape).astype(np.float32) for _ in range(2))

    def jfn(a, x, v):
        _, reward, _, info = jenv.step_diff(a, jstate._replace(x=x, v=v))
        return reward, info["state"].x, info["state"].v

    _, vjp = jax.vjp(jfn, jax.numpy.asarray(actions), jstate.x, jstate.v)
    zero_r = np.zeros(B, np.float32)
    jgrads = [np.asarray(g) for g in vjp(tuple(jax.numpy.asarray(c)
                                               for c in (zero_r, cot_x, cot_v)))]
    jreward_grads = [np.asarray(g) for g in vjp(tuple(jax.numpy.asarray(c) for c in (
        cot_r, np.zeros_like(cot_x), np.zeros_like(cot_v))))]

    def port_grads(env, dtype, cots):
        s = _to_torch(jstate)
        s = s.replace(**{f: getattr(s, f).to(dtype) for f in (
            "x", "v", "primitive0", "primitive1", "action0", "action1", "stiffness", "mu")})
        inputs = [torch.tensor(actions, dtype=dtype, requires_grad=True),
                  s.x.requires_grad_(), s.v.requires_grad_()]
        _, reward, _, info = env.step_diff(inputs[0], s.replace(x=inputs[1], v=inputs[2]))
        outs = (reward, info["state"].x, info["state"].v)
        loss = sum((o * torch.from_numpy(c).to(dtype)).sum() for o, c in zip(outs, cots))
        return [g.numpy() for g in torch.autograd.grad(loss, inputs)]

    env64 = copy.copy(tenv)
    sim64 = env64.simulator = copy.copy(tenv.simulator)
    sim64.rest_len, sim64.nbr_valid = sim64.rest_len.double(), sim64.nbr_valid.double()
    env64.goal = tenv.goal.double()
    cots = (zero_r, cot_x, cot_v)
    tgrads, refs = port_grads(tenv, torch.float32, cots), port_grads(env64, torch.float64, cots)
    for name, t, j, r in zip(("actions", "x", "v"), tgrads, jgrads, refs):
        assert t.shape == j.shape and np.abs(r).max() > 0, name
        rms_port = np.sqrt(np.mean((t - r) ** 2))
        rms_jax = np.sqrt(np.mean((j - r) ** 2))
        assert rms_port <= V_RATIO * rms_jax + V_FLOOR * np.sqrt(np.mean(r ** 2)), \
            (name, rms_port, rms_jax)
    treward_grads = port_grads(tenv, torch.float32, (cot_r, np.zeros_like(cot_x),
                                                      np.zeros_like(cot_v)))
    for t, j in zip(treward_grads, jreward_grads):
        np.testing.assert_array_equal(t, j)
        assert not t.any()
