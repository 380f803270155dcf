"""One APG update (``minimize``) of pour_water and pour_soup in the port
against ``unidom_tpu``'s on the CPU, from the same first state (JAX's
``reset_batch``: the bowl's random shift per env), policy weights and
sampling noise: the loss, every gradient leaf, the clipped gradient and the
parameters after Adam, with the contact-distance aux reward on, as ``train``
has it. tests/test_torch_train_rope_hard.py holds shape_rope_hard's through
the helpers here.

The envs are cut to few substeps (pour_soup also to the 24x32x24 grid of
tests/test_torch_mpm_big_env.py); the port's MPM step is the plain one here
(the wrappers take it for CPU tensors)."""

import dataclasses

import jax
import numpy as np
import optax
import pytest
import torch

from unidom_tpu.algorithms import apg as japg
from unidom_tpu.envs import mpm_tasks as jtasks
from unidom_tpu.ops.gradops import global_norm_clip as jax_global_norm_clip
from unidom_tpu.ops.gradops import nan_to_num_tree as jax_nan_to_num_tree
from unidom_tpu.parallel.mesh import make_env_mesh
from unidom_torch.algorithms import apg
from unidom_torch.envs import mpm_tasks as ttasks
from unidom_torch.utils.convert import mpm_state_from_jax, policy_from_jax

torch.set_num_threads(1)

B, LR, MAX_NORM = 2, 1e-4, 0.3
# tests/test_torch_mpm_big_train.py's tolerances of one minimize: the same
# float32 operations on both sides summed in other orders, through the
# step's adjoint
GRAD_REL_NORM = 1e-4
TOL_LOSS = dict(rtol=1e-6, atol=0)
TOL_ADAM = dict(rtol=0, atol=2e-8)
CLEAR_OF_ROUNDING = 1e-2
# shape_rope's push of tests/test_torch_mpm_big_train.py: from beside the
# rope at rest (z 0.497-0.503) into it, world positions of start and end
ROPE_PUSH = (0.52, 0.5, 0.475, 0.52, 0.5, 0.49)


class _JaxRopeHard(jtasks.ShapeRopeHardEnv):
    PUSH_SUBSTEPS = 2


class _RopeHard(ttasks.ShapeRopeHardEnv):
    PUSH_SUBSTEPS = 2


def _envs(name):
    """(JAX env, the port's env on the CPU), cut."""
    if name == "pour_water":
        cut = dict(steps=4)
        return (jtasks.PourWaterEnv(batch_size=B, seed=1, conf=dataclasses.replace(
                    jtasks.PourWaterConf, **cut)),
                ttasks.PourWaterEnv(B, seed=1, device="cpu", conf=dataclasses.replace(
                    ttasks.PourWaterConf, **cut)))
    if name == "pour_soup":
        cut = dict(res=(24, 32, 24), steps=2)
        return (jtasks.PourSoupEnv(batch_size=B, seed=1, conf=dataclasses.replace(
                    jtasks.PourSoupConf, **cut)),
                ttasks.PourSoupEnv(B, seed=1, device="cpu", conf=dataclasses.replace(
                    ttasks.PourSoupConf, **cut)))
    cut = dict(steps=4)  # each env's own conf, cut
    return (_JaxRopeHard(batch_size=B, seed=1, conf=dataclasses.replace(
                _JaxRopeHard(batch_size=1).conf, **cut)),
            _RopeHard(B, seed=1, device="cpu", conf=dataclasses.replace(
                _RopeHard(1, device="cpu").conf, **cut)))


def _rel(out, ref):
    return np.linalg.norm(np.asarray(out, np.float64) - ref) / np.linalg.norm(ref)


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
    spread of ~1e-3 (tests/test_torch_mpm_big_train.py's)."""
    from flax.core import unfreeze

    p = jax.tree_util.tree_map(np.array, unfreeze(jax.device_get(params)))
    last = p["params"][f"dense_{len(p['params']) - 1}"]
    last["kernel"] = last["kernel"] * 1e-3
    target = np.asarray(target, np.float64)
    loc = np.arctanh(np.log(target / (1 - target)))
    last["bias"] = np.concatenate([loc, np.full(6, -8.0)]).astype(np.float32)
    return jax.tree_util.tree_map(jax.numpy.asarray, p)


def _recorder(pushes, replace):
    """A stand-in ``step_diff`` that records the pushes and only counts the step."""
    def step_diff(actions, state):
        pushes.append(np.asarray(actions))
        return None, None, None, {"state": replace(state, cur_step=state.cur_step + 1)}
    return step_diff


def _first_state(name, jenv, tenv, jreset_batch, treset_batch, pushes):
    """JAX's first state of an iteration, as numpy. For shape_rope_hard, the
    pushes of both sides' host resets (recorded into ``pushes``, their
    physics left out) held equal."""
    if name != "shape_rope_hard":
        return jax.device_get(jreset_batch(jax.random.PRNGKey(3)))
    jpushes, tpushes = pushes
    jpushes.clear()
    tpushes.clear()
    tenv.rng = np.random.RandomState(1)
    np.random.seed(1)
    jstate = jax.device_get(jreset_batch(jax.random.PRNGKey(3)))
    tstate = treset_batch(torch.Generator().manual_seed(3))
    assert len(tpushes) == len(jpushes) == tenv.DO_RESET_PUSHES + tenv.HARD_RESET_PUSHES == 10
    np.testing.assert_array_equal(np.stack(tpushes), np.stack(jpushes))
    assert (tstate.cur_step.numpy() == 0).all() and (np.asarray(jstate.cur_step) == 0).all()
    assert not tstate.x.requires_grad
    return jstate


def minimize_both(name):
    """(JAX's update, the port's) of ``name`` from JAX's first state."""
    jenv, tenv = _envs(name)
    jenv.aux_reward = tenv.aux_reward = True
    ep_len = 1
    pushes = [], []
    if name == "shape_rope_hard":
        jstep = jenv.step_diff
        jenv.step_diff = _recorder(pushes[0], lambda s, **k: s._replace(**k))
        tenv.step_diff = _recorder(pushes[1], lambda s, **k: s.replace(**k))
    jenv.reset(jax.random.PRNGKey(0))  # JAX's train sizes the env first
    init_ts, jmin, jreset_batch, _ = japg.build_apg(jenv, ep_len, LR, max_gradient_norm=MAX_NORM,
                                                    mesh=make_env_mesh(1))
    tinit, tmin, treset_batch, _ = apg.build_apg(tenv, ep_len, LR, max_gradient_norm=MAX_NORM,
                                                 device="cpu")
    jstate = _first_state(name, jenv, tenv, jreset_batch, treset_batch, pushes)
    if name == "shape_rope_hard":
        jenv.step_diff = jstep
        del tenv.step_diff
    jts = init_ts(0)
    if name == "shape_rope_hard":
        jts = jts._replace(policy_params=_steer(jts.policy_params, ROPE_PUSH))
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
    ts = tinit(0)
    ts.policy.load_state_dict(policy_from_jax(jax.device_get(jts.policy_params),
                                              device="cpu").state_dict())
    params0 = [p.detach().clone() for p in ts.policy.parameters()]
    eps = torch.from_numpy(noise)
    loss, grad, _ = tmin.debug["loss_grad"](ts, state, eps)
    ts, metrics = tmin(ts, state, eps)
    out = dict(loss=float(loss), grad=[g.numpy() for g in grad],
               clipped=[p.grad.numpy() for p in ts.policy.parameters()],
               params=[p.detach().numpy() for p in ts.policy.parameters()],
               params0=[p.numpy() for p in params0], metrics=metrics)
    return ref, out


@pytest.fixture(scope="module", params=["pour_water", "pour_soup"])
def one_minimize(request):
    return minimize_both(request.param)


def check_loss_and_gradient(ref, out):
    np.testing.assert_allclose(out["loss"], ref["loss"], **TOL_LOSS)
    assert len(out["grad"]) == len(ref["grad"]) == 6
    for g, r in zip(out["grad"], ref["grad"]):
        assert g.shape == r.shape and np.any(r != 0)
        assert _rel(g, r) <= GRAD_REL_NORM
    g_norm = np.sqrt(sum(np.sum(np.square(r, dtype=np.float64)) for r in ref["grad"]))
    np.testing.assert_allclose(float(out["metrics"]["grad_norm"]), g_norm, rtol=GRAD_REL_NORM)


def check_clipped_gradient_and_adam_step(ref, out):
    for g, r in zip(out["clipped"], ref["clipped"]):
        assert _rel(g, r) <= GRAD_REL_NORM
    opt = optax.adam(LR)
    p0 = [jax.numpy.asarray(p) for p in out["params0"]]
    updates, _ = opt.update([jax.numpy.asarray(g) for g in out["clipped"]], opt.init(p0))
    for p, want in zip(out["params"], optax.apply_updates(p0, updates)):
        np.testing.assert_allclose(p, np.asarray(want), **TOL_ADAM)
    for p, r, g in zip(out["params"], ref["params"], ref["clipped"]):
        clear = np.abs(g) > CLEAR_OF_ROUNDING * np.abs(g).max()
        assert clear.sum() > 0
        np.testing.assert_allclose(p[clear], r[clear], rtol=0, atol=1e-3 * LR)


def test_minimize_loss_and_gradient_match_jax(one_minimize):
    check_loss_and_gradient(*one_minimize)


def test_minimize_clipped_gradient_and_adam_step_match_jax(one_minimize):
    check_clipped_gradient_and_adam_step(*one_minimize)
