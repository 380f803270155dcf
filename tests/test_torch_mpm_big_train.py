"""The port's big-grid and shape_rope-family APG training against
``unidom_tpu`` on the CPU, on cut envs (few substeps and push sub-steps):
``step_diff``'s action gradient on shape_elasto_plastic and pour_soup; one
``minimize`` on shape_elasto_plastic and on shape_rope from the same first
state, policy weights and sampling noise (loss, every gradient leaf, the
clipped gradient, the parameters after Adam), with the policy steered to
pushes that start beside the material and reach it; ``reset_batch``'s
``host_reset`` arm; and ``train``'s resets, whose pushes draw from one numpy
stream in JAX's order. The port's MPM step is the plain one here (the
wrappers take it for CPU tensors)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from unidom_tpu.algorithms import apg as japg
from unidom_tpu.envs import mpm_tasks as jtasks
from unidom_tpu.envs import registration as jreg
from unidom_tpu.ops.gradops import global_norm_clip as jax_global_norm_clip
from unidom_tpu.ops.gradops import nan_to_num_tree as jax_nan_to_num_tree
from unidom_tpu.parallel.mesh import make_env_mesh
from unidom_torch.algorithms import apg
from unidom_torch.envs import mpm_tasks as ttasks
from unidom_torch.envs import registration
from unidom_torch.utils.convert import mpm_state_from_jax, policy_from_jax

torch.set_num_threads(1)

B, LR, MAX_NORM = 2, 1e-4, 0.3
# One macro step of the cut envs from the same state: the same float32
# operations on both sides summed in another order (tests/test_torch_mpm_
# big_env.py's forward tolerances); through the step's adjoint the action
# gradient agrees to ~1e-5 in relative norm (GRAD_REL_NORM keeps 10x).
GRAD_REL_NORM = 1e-4
TOL_LOSS = dict(rtol=1e-6, atol=0)
TOL_ADAM = dict(rtol=0, atol=2e-8)  # Adam's first step, as test_torch_mpm_train.py
CLEAR_OF_ROUNDING = 1e-2
# Cut to 2 push sub-steps of 4 substeps, a push is ~10x (shape_elasto_plastic)
# to ~25x (shape_rope) faster per substep than in the env; one that starts
# inside the material throws particles about chaotically, and one that
# never reaches it has a gradient of rounding noise. The pushes held here
# start beside the material and reach into it: the step_diff ones as given,
# the minimize ones from a policy steered to them (PUSH_TARGETS, world
# positions of start and end).
PUSH_TARGETS = {"shape_elasto_plastic": (0.37, 0.5, 0.5, 0.40, 0.5, 0.5),  # slab x >= 0.4
                "shape_rope": (0.52, 0.5, 0.475, 0.52, 0.5, 0.49)}  # rope z 0.497-0.503


class _JaxElasto(jtasks.ShapeElastoPlasticEnv):
    PUSH_SUBSTEPS = 2


class _Elasto(ttasks.ShapeElastoPlasticEnv):
    PUSH_SUBSTEPS = 2


class _JaxRope(jtasks.ShapeRopeEnv):
    PUSH_SUBSTEPS = 2


class _Rope(ttasks.ShapeRopeEnv):
    PUSH_SUBSTEPS = 2


def _envs(name):
    """(JAX env, the port's env on the CPU), cut."""
    if name == "shape_elasto_plastic":
        kw = dict(max_steps=2)
        return (_JaxElasto(batch_size=B, seed=1, conf=dataclasses.replace(
                    jtasks.ShapeElastoPlasticConf, steps=4), **kw),
                _Elasto(B, seed=1, device="cpu", conf=dataclasses.replace(
                    ttasks.ShapeElastoPlasticConf, steps=4), **kw))
    if name == "shape_rope":
        return (_JaxRope(batch_size=B, seed=1, conf=dataclasses.replace(
                    jtasks.ShapeRopeConf, steps=4)),
                _Rope(B, seed=1, device="cpu", conf=dataclasses.replace(
                    ttasks.ShapeRopeConf, steps=4)))
    small = dict(res=(24, 32, 24), steps=2)  # a grid that holds the soup
    return (jtasks.PourSoupEnv(batch_size=B, seed=1, conf=dataclasses.replace(
                jtasks.PourSoupConf, **small)),
            ttasks.PourSoupEnv(B, seed=1, device="cpu", conf=dataclasses.replace(
                ttasks.PourSoupConf, **small)))


def _rel(out, ref):
    return np.linalg.norm(np.asarray(out, np.float64) - ref) / np.linalg.norm(ref)


# ---------------------------------------------------------------- step_diff's gradient

ACTIONS = {
    # pushes from beside the slab (x 0.4-0.6, z 0.44-0.56) towards it
    "shape_elasto_plastic": [[0.37, 0.0, 0.5, 0.40, 0.0, 0.5], [0.5, 0.0, 0.42, 0.5, 0.0, 0.45]],
    "pour_soup": [[0.5, 0.2, -0.3, 0.0, 0.0, 0.4], [-0.4, 0.0, 0.6, 0.3, 0.0, 0.0]],
}


@pytest.mark.parametrize("name", list(ACTIONS))
def test_step_diff_action_gradient_matches_jax(name):
    jenv, tenv = _envs(name)
    _, jstate = jenv.reset(jax.random.PRNGKey(1))
    actions = np.asarray(ACTIONS[name], np.float32)

    def jloss(a):
        _, reward, _, info = jenv.step_diff(a, jstate)
        return jnp.sum(reward) + 1e-2 * jnp.sum(info["state"].x)

    ref = np.asarray(jax.grad(jloss)(jnp.asarray(actions)))
    a = torch.from_numpy(actions).requires_grad_()
    _, reward, _, info = tenv.step_diff(a, mpm_state_from_jax(jax.device_get(jstate), device="cpu"))
    (reward.sum() + 1e-2 * info["state"].x.sum()).backward()
    assert np.all(np.isfinite(a.grad.numpy())) and np.abs(ref).max() > 0
    assert _rel(a.grad.numpy(), ref) <= GRAD_REL_NORM


# ---------------------------------------------------------------- one minimize

def _leaves(params):
    """flax params -> the port's parameter order, kernels transposed."""
    out = []
    for i in range(len(params["params"])):
        layer = params["params"][f"dense_{i}"]
        out += [np.asarray(layer["kernel"]).T, np.asarray(layer["bias"])]
    return out


def _jax_noise(key, T):
    """The noise JAX's ``minimize`` draws from the training key."""
    _, key = jax.random.split(key)
    noise = []
    for _ in range(T):
        key, key_sample = jax.random.split(key)
        noise.append(np.asarray(jax.random.normal(key_sample, (B, 6))))
    return np.stack(noise)


def _steer(params, target):
    """The policy's weights with its last layer scaled down by 1e-3 and its
    bias set so that the sampled, squashed action is ``target`` with a
    spread of ~1e-3: loc = atanh(logit(target)), scale ~ softplus(-8)."""
    from flax.core import unfreeze

    p = jax.tree_util.tree_map(np.array, unfreeze(jax.device_get(params)))
    last = p["params"][f"dense_{len(p['params']) - 1}"]
    last["kernel"] = last["kernel"] * 1e-3
    target = np.asarray(target, np.float64)
    loc = np.arctanh(np.log(target / (1 - target)))
    last["bias"] = np.concatenate([loc, np.full(6, -8.0)]).astype(np.float32)
    return jax.tree_util.tree_map(jnp.asarray, p)


@pytest.fixture(scope="module", params=list(PUSH_TARGETS))
def one_minimize(request):
    """One update on both sides from JAX's host reset (shape_rope's two
    reset pushes are held below, not here: with them off the first state is
    the scene at rest), with the contact-distance aux reward on, as ``train``
    has it by default."""
    jenv, tenv = _envs(request.param)
    jenv.DO_RESET_PUSHES = tenv.DO_RESET_PUSHES = 0
    jenv.aux_reward = tenv.aux_reward = True
    ep_len = 1
    jenv.reset(jax.random.PRNGKey(0))
    init_ts, jmin, jreset_batch, _ = japg.build_apg(jenv, ep_len, LR, max_gradient_norm=MAX_NORM,
                                                    mesh=make_env_mesh(1))
    jts = init_ts(0)
    jts = jts._replace(policy_params=_steer(jts.policy_params, PUSH_TARGETS[request.param]))
    jstate = jax.device_get(jreset_batch(jax.random.PRNGKey(3)))
    noise = _jax_noise(jts.key, ep_len)
    _, key_grad = jax.random.split(jts.key)
    jgrad, (jrewards, _, _) = jmin.debug["loss_grad"](
        jts.policy_params, jts.normalizer_params, jstate, key_grad)
    jgrad = jax_nan_to_num_tree(jgrad)
    jclipped = jax_global_norm_clip(jgrad, MAX_NORM)
    updates, _ = jmin.debug["optimizer"].update(jclipped, jts.optimizer_state)
    jparams = optax.apply_updates(jts.policy_params, updates)
    ref = dict(loss=-float(np.mean(np.asarray(jrewards))), grad=_leaves(jgrad),
               clipped=_leaves(jclipped), params=_leaves(jparams))

    state = mpm_state_from_jax(jstate, device="cpu")
    tinit, tmin, _, _ = apg.build_apg(tenv, ep_len, LR, max_gradient_norm=MAX_NORM, device="cpu")
    ts = tinit(0)
    ts.policy.load_state_dict(policy_from_jax(jax.device_get(jts.policy_params),
                                              device="cpu").state_dict())
    params0 = [p.detach().clone() for p in ts.policy.parameters()]
    eps = torch.from_numpy(noise)
    ts, metrics = tmin(ts, state, eps)
    loss, grad = tmin.debug["last"]  # the update's own loss and raw gradient
    out = dict(loss=float(loss), grad=[g.numpy() for g in grad],
               clipped=[p.grad.numpy() for p in ts.policy.parameters()],
               params=[p.detach().numpy() for p in ts.policy.parameters()],
               params0=[p.numpy() for p in params0], metrics=metrics)
    return ref, out


def test_minimize_loss_and_gradient_match_jax(one_minimize):
    ref, out = one_minimize
    np.testing.assert_allclose(out["loss"], ref["loss"], **TOL_LOSS)
    assert len(out["grad"]) == len(ref["grad"]) == 6
    for g, r in zip(out["grad"], ref["grad"]):
        assert g.shape == r.shape and np.any(r != 0)
        assert _rel(g, r) <= GRAD_REL_NORM
    g_norm = np.sqrt(sum(np.sum(np.square(r, dtype=np.float64)) for r in ref["grad"]))
    np.testing.assert_allclose(float(out["metrics"]["grad_norm"]), g_norm, rtol=GRAD_REL_NORM)


def test_minimize_clipped_gradient_and_adam_step_match_jax(one_minimize):
    ref, out = one_minimize
    for g, r in zip(out["clipped"], ref["clipped"]):
        assert _rel(g, r) <= GRAD_REL_NORM
    opt = optax.adam(LR)
    p0 = [jnp.asarray(p) for p in out["params0"]]
    updates, _ = opt.update([jnp.asarray(g) for g in out["clipped"]], opt.init(p0))
    for p, want in zip(out["params"], optax.apply_updates(p0, updates)):
        np.testing.assert_allclose(p, np.asarray(want), **TOL_ADAM)
    for p, r, g in zip(out["params"], ref["params"], ref["clipped"]):
        clear = np.abs(g) > CLEAR_OF_ROUNDING * np.abs(g).max()
        assert clear.sum() > 0
        np.testing.assert_allclose(p[clear], r[clear], rtol=0, atol=1e-3 * LR)


# ---------------------------------------------------------------- host resets

def _recorder(pushes, replace):
    """A stand-in ``step_diff`` that records the pushes and only counts the
    step (the physics of a push is held above)."""
    def step_diff(actions, state):
        pushes.append(np.asarray(actions))
        return None, None, None, {"state": replace(state, cur_step=state.cur_step + 1)}
    return step_diff


def test_reset_batch_host_reset_arm_matches_jax():
    """shape_rope's first state of an iteration is its reset's: two random
    pushes through env 0's particles, forward, the step count restarted."""
    jenv, tenv = _envs("shape_rope")
    jpushes, tpushes = [], []
    jenv.step_diff = _recorder(jpushes, lambda s, **k: s._replace(**k))
    tenv.step_diff = _recorder(tpushes, lambda s, **k: s.replace(**k))
    jenv.reset(jax.random.PRNGKey(0))  # JAX's train sizes the env first
    jpushes.clear()
    _, _, jreset_batch, _ = japg.build_apg(jenv, 1, LR, mesh=make_env_mesh(1))
    _, _, treset_batch, _ = apg.build_apg(tenv, 1, LR, device="cpu")
    tenv.rng = np.random.RandomState(1)
    np.random.seed(1)
    jstate = jreset_batch(jax.random.PRNGKey(0))
    tstate = treset_batch(torch.Generator().manual_seed(0))
    assert len(tpushes) == len(jpushes) == tenv.DO_RESET_PUSHES == 2
    np.testing.assert_array_equal(np.stack(tpushes), np.stack(jpushes))
    assert (tstate.cur_step.numpy() == 0).all() and (np.asarray(jstate.cur_step) == 0).all()
    np.testing.assert_allclose(tstate.x.numpy(), np.asarray(jstate.x), rtol=1e-6, atol=1e-7)
    assert not tstate.x.requires_grad


def test_train_draws_the_reset_pushes_in_jaxs_order(tmp_path, monkeypatch):
    """``train`` on shape_rope, on both sides, with each env's ``step_diff``
    a recorder and the update and the evals stand-ins: the training env's
    first reset, the eval env's, then one per iteration, all from one numpy
    stream seeded ``seed + 666``."""
    seed, max_it, n_eval = 5, 1, 3
    jpushes, tpushes = [], []

    def jax_env(**kw):
        env = _JaxRope(**kw)
        env.step_diff = _recorder(jpushes, lambda s, **k: s._replace(**k))
        return env

    def port_env(**kw):
        env = _Rope(**kw)
        env.step_diff = _recorder(tpushes, lambda s, **k: s.replace(**k))
        return env

    def jax_build(env, *args, **kwargs):
        init_ts, _, reset_batch, _ = jax_build_apg(env, *args, **kwargs)
        zero = {"reward_sum": jnp.zeros(()), "grad_norm": jnp.zeros(())}
        return (init_ts, lambda ts, state: (ts, zero), reset_batch,
                lambda *a, **k: (None, None, jnp.zeros((1, env.batch_size))))

    def port_build(env, *args, **kwargs):
        init_ts, _, reset_batch, _ = port_build_apg(env, *args, **kwargs)
        zero = {"reward_sum": torch.zeros(()), "grad_norm": torch.zeros(())}
        return (init_ts, lambda ts, state: (ts, zero), reset_batch,
                lambda *a, **k: (None, None, torch.zeros(1, env.batch_size)))

    jax_build_apg, port_build_apg = japg.build_apg, apg.build_apg
    monkeypatch.setitem(jreg.env_functions, "shape_rope", jax_env)
    monkeypatch.setitem(registration.env_functions, "shape_rope", port_env)
    monkeypatch.setattr(japg, "build_apg", jax_build)
    monkeypatch.setattr(apg, "build_apg", port_build)
    japg.train("shape_rope", 1, B, seed=seed, max_it=max_it, eval_freq=1, num_eval_envs=n_eval,
               num_devices=1, logdir=str(tmp_path / "jax"))
    apg.train("shape_rope", 1, B, seed=seed, max_it=max_it, eval_freq=1, num_eval_envs=n_eval,
              logdir=str(tmp_path / "port"), device="cpu")
    # 2 pushes for each of: the training env's first reset (B envs), the eval
    # env's (n_eval), and each of the max_it + 1 iterations' (B)
    sizes = [B, B, n_eval, n_eval] + [B, B] * (max_it + 1)
    assert [len(p) for p in tpushes] == [len(p) for p in jpushes] == sizes
    for t, j in zip(tpushes, jpushes):
        np.testing.assert_array_equal(t, j)
