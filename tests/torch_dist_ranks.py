"""What tests/test_torch_dist.py runs on each rank of a data-parallel group
on the CPU. A module of its own, importing no JAX: the ranks are processes
started afresh, which import it by name (``tests/`` is on the path that
they inherit).

The three arms of the sharded update, each at the cut size of the port's
own train tests, and each on one reset mode of ``reset_batch``:
- ``cloth``: fold_cloth1 on tests/test_sharding.py's cloth (N = 20, 5
  substeps), ``reset``, with the observation normalizer on;
- ``whip_rope``: grad_test's conf, 2 macro steps, ``auto_reset``;
- ``shape_elasto_plastic``: 4 substeps per simulator call, 2 calls per push
  (tests/test_torch_mpm_big_train.py's cut), ``host_reset``.
"""

import dataclasses
import functools

import numpy as np
import torch

from unidom_torch.algorithms import apg, apg_para
from unidom_torch.engine.cloth import ClothConf
from unidom_torch.envs import mpm_tasks, registration
from unidom_torch.envs.cloth_tasks import FoldCloth1Env, FoldCloth1ParaEnv, goal_path
from unidom_torch.models.normalizer import NormalizerParams, update_normalizer
from unidom_torch.parallel import make_env_mesh

B_LOCAL = {"cloth": 1, "whip_rope": 2, "shape_elasto_plastic": 1}  # envs per rank
LR, MAX_NORM, SEED, RESET_SEED = 1e-4, 0.3, 0, 7
CLOTH = dict(N=20, n_substeps=5, gripper_radius=0.08, task="fold_cloth1",
             goal_path=goal_path("fold_cloth1"))
EP_LEN = {"cloth": 2, "whip_rope": 1, "shape_elasto_plastic": 1}
NORMALIZE = {"cloth": True, "whip_rope": False, "shape_elasto_plastic": False}


class _Elasto(mpm_tasks.ShapeElastoPlasticEnv):
    PUSH_SUBSTEPS = 2


def cloth_conf():
    return ClothConf(**CLOTH)


def make_arm_env(arm, batch_size):
    """The arm's env on the CPU with ``batch_size`` envs."""
    if arm == "cloth":
        return FoldCloth1Env(batch_size, conf=cloth_conf(), device="cpu")
    if arm == "whip_rope":
        return mpm_tasks.WhipRopeEnv(batch_size, conf=mpm_tasks.GRAD_TEST_CONF, max_steps=2,
                                     device="cpu")
    return _Elasto(batch_size, seed=1, max_steps=2, device="cpu", conf=dataclasses.replace(
        mpm_tasks.ShapeElastoPlasticConf, steps=4))


def build(arm, env, mesh=None):
    return apg.build_apg(env, EP_LEN[arm], LR, MAX_NORM, normalize_obs=NORMALIZE[arm],
                         device="cpu", mesh=mesh)


def sharded_update(arm):
    """One update of ``arm`` on this rank: (first state, parameters after it,
    metrics, the update's own loss and raw gradient, normalizer)."""
    mesh = make_env_mesh(device="cpu")
    env = make_arm_env(arm, B_LOCAL[arm])
    init_ts, minimize, reset_batch, _ = build(arm, env, mesh)
    ts = init_ts(SEED)
    state = reset_batch(torch.Generator().manual_seed(RESET_SEED))
    ts, metrics = minimize(ts, state)
    loss, grad = minimize.debug["last"]
    return dict(state=state, params=[p.detach() for p in ts.policy.parameters()],
                metrics=metrics, loss=loss, grad=list(grad), normalizer=ts.normalizer)


def jax_inputs_update(shifts, weights, noise):
    """One update on this rank from JAX's inputs: the cloth shifted by
    ``shifts[rank]``, the policy ``weights`` (a state dict) and the noise."""
    mesh = make_env_mesh(device="cpu")
    env = FoldCloth1Env(B_LOCAL["cloth"], conf=cloth_conf(), device="cpu")
    _, state = env.reset_from_shift(shifts[mesh.rank])
    init_ts, minimize, _, _ = apg.build_apg(env, EP_LEN["cloth"], LR, MAX_NORM, device="cpu",
                                            mesh=mesh)
    ts = init_ts(SEED)
    ts.policy.load_state_dict(weights)
    ts, metrics = minimize(ts, state, torch.from_numpy(noise))
    loss, grad = minimize.debug["last"]
    return dict(x=state.x, params=[p.detach() for p in ts.policy.parameters()],
                metrics=metrics, loss=loss, grad=list(grad))


def normalizer_update(params, obs):
    """``update_normalizer`` of ``obs[rank]`` over the group, from the
    numpy (count, mean, m2) ``params``."""
    mesh = make_env_mesh(device="cpu")
    p = NormalizerParams(*(torch.tensor(np.asarray(a)) for a in params))
    return update_normalizer(p, torch.from_numpy(obs[mesh.rank]), mesh)


def tiny_para(**kw):
    return FoldCloth1ParaEnv(conf=cloth_conf(), **kw)


def recorded_train_para(num_envs, logdir, num_devices=None):
    """``train_para`` on the tiny cloth for 2 iterations (one eval of one
    stiffness), every first state's stiffness recorded: (stiffness per
    iteration, history, final policy parameters)."""
    registration.env_functions["fold_cloth1_para"] = tiny_para
    seen = []
    randomize = apg_para.randomize_stiffness

    def recording(*args, **kwargs):
        state = randomize(*args, **kwargs)
        seen.append(state.stiffness.clone())
        return state

    apg_para.randomize_stiffness = recording
    try:
        ts, history = apg_para.train_para(
            "fold_cloth1_para", episode_length=1, num_envs=num_envs, max_it=1, eval_freq=2,
            num_eval_envs=1, n_eval_points=1, num_devices=num_devices, logdir=logdir,
            device="cpu")
    finally:
        apg_para.randomize_stiffness = randomize
    return seen, history, [p.detach() for p in ts.policy.parameters()]


def rank_jobs(jax_inputs, norm_inputs, para_logdir):
    """Everything the tests ask of one rank, in one process: each arm's
    sharded update, the update from JAX's inputs, the all-reduced normalizer
    and two ``train_para`` iterations."""
    out = {arm: sharded_update(arm) for arm in EP_LEN}
    out["jax_inputs"] = jax_inputs_update(*jax_inputs)
    out["normalizer"] = normalizer_update(*norm_inputs)
    out["para"] = recorded_train_para(2 * B_LOCAL["cloth"], para_logdir)
    return out


def tiny_train_rank(kwargs):
    """A rank of ``apg.train`` launched by the CLI, fold_cloth1 on the tiny cloth."""
    registration.env_functions["fold_cloth1"] = functools.partial(FoldCloth1Env,
                                                                  conf=cloth_conf())
    return apg._train_rank(kwargs)


def fail_on_rank_1():
    if make_env_mesh(device="cpu").rank == 1:
        raise RuntimeError("rank 1 fails")
