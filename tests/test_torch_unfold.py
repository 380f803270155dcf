"""unfold_cloth1 and unfold_cloth3 in the port against ``unidom_tpu`` on the
CPU: the reset (the flat cloth plus 1e-4 noise, then 1 or 3 random folds
through ``step_diff``) from JAX's noise and numpy's pick-and-place indices,
one ``step_diff`` at mu = 3 without substep observations, one ``minimize``,
the default configuration, and ``train``'s resets: the same noise every
iteration, new folds every iteration, drawn from one numpy stream in JAX's
order. The cloth is tests/test_apg.py's tiny one where the physics runs.

At mu = 3 a fold is rounding-chaotic in float32: the cloth lands under
static and dynamic friction, and over one fold JAX's float32 states and the
port's drift ~1e-2 apart, each as far from the float64 plain step as the
other (3e-3 RMS in x after one fold, 3e-2 after three). So the physics is
held as chip_smoke.py's gates hold a kernel: against the port's plain step
in float64 (the same operations as JAX's), the port's float32 error may be
at most RATIO times JAX's float32 one, plus a floor."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from unidom_tpu.algorithms import apg as japg
from unidom_tpu.engine.cloth import ClothConf as JaxClothConf
from unidom_tpu.envs import cloth_tasks as jtasks
from unidom_tpu.envs import registration as jreg
from unidom_tpu.parallel.mesh import make_env_mesh
from unidom_torch import make_env
from unidom_torch.algorithms import apg
from unidom_torch.engine.cloth import ClothConf, ClothState
from unidom_torch.envs import cloth_tasks as ttasks
from unidom_torch.envs import registration
from unidom_torch.utils.convert import policy_from_jax

torch.set_num_threads(1)

B, LR, MAX_NORM = 2, 1e-4, 0.3
SEED = 9  # numpy's, for the folds' indices
RATIO = 2.0
FLOOR = {"x": 1e-6, "v": 1e-5, "primitive0": 1e-6, "reward": 1e-6, "loss": 1e-6, "grad": 1e-4}
TOL_ADAM = dict(rtol=0, atol=2e-8)  # tests/test_torch_train.py's: optax's step of the same grads
FLOAT_FIELDS = ("x", "v", "primitive0", "primitive1", "action0", "action1", "stiffness", "mu")
ENVS = {1: (jtasks.UnfoldCloth1Env, ttasks.UnfoldCloth1Env),
        3: (jtasks.UnfoldCloth3Env, ttasks.UnfoldCloth3Env)}


def _tiny(n):
    task = f"unfold_cloth{n}"
    return dict(N=20, n_substeps=10, gripper_radius=0.08, mu=3.0, use_substep_obs=False,
                task=task, goal_path=ttasks.goal_path(task))


def _to_torch(jstate):
    fields = ClothState.__dataclass_fields__
    return ClothState(**{f: torch.from_numpy(np.array(getattr(jstate, f))) for f in fields})


def _f64(state):
    return state.replace(**{f: getattr(state, f).double() for f in FLOAT_FIELDS})


def _f64_env(env):
    """The port's env with its plain step, initial state and goal in float64."""
    env64 = copy.copy(env)
    sim = env64.simulator = copy.copy(env.simulator)
    sim.rest_len, sim.nbr_valid = sim.rest_len.double(), sim.nbr_valid.double()
    env64.goal = env.goal.double()
    env64._init_state = _f64(env._init_state)
    return env64


def _rms(a, ref):
    a, ref = (np.asarray(t, np.float64) for t in (a, ref))
    return float(np.sqrt(np.mean((a - ref) ** 2)))


def _gate(name, port, jax_out, ref, floor):
    e_port, e_jax = _rms(port, ref), _rms(jax_out, ref)
    assert e_port <= RATIO * e_jax + floor, (name, e_port, e_jax)


def _jax_reset(n, key, aux_reward=False, batch=B):
    """JAX's env, its reset from ``key`` with numpy seeded SEED, the noise it
    drew and the indices of its folds (numpy's draws, st then ed)."""
    jenv = ENVS[n][0](batch, conf=JaxClothConf(mem_saving_level=1, **_tiny(n)),
                      aux_reward=aux_reward)
    np.random.seed(SEED)
    jobs, jstate = jenv.reset(key)
    noise_key, _ = jax.random.split(key)
    noise = np.asarray(jax.random.normal(noise_key, jstate.x.shape) * 0.0001)
    rng = np.random.RandomState(SEED)
    indices = [(rng.randint(0, jenv.n_particles, size=(batch,)),
                rng.randint(0, jenv.n_particles, size=(batch,))) for _ in range(n)]
    return jenv, jobs, jstate, noise, indices


@pytest.mark.parametrize("n", [1, 3])
def test_reset_matches_jax(n):
    key = jax.random.PRNGKey(4)
    jenv, jobs, jstate, noise, indices = _jax_reset(n, key)
    tenv = ENVS[n][1](B, conf=ClothConf(**_tiny(n)), device="cpu")
    # the first fold's pick and place: the same particles of the same noisy cloth
    init = jenv.simulator.reset()
    jx0 = init._replace(x=init.x + jnp.asarray(noise))
    np.random.seed(SEED)
    jfirst = np.asarray(jenv.get_random_fold_action(jx0))
    tx0 = tenv._init_state.replace(x=tenv._init_state.x + torch.tensor(noise))
    tfirst = tenv.get_random_fold_action(tx0, np.random.RandomState(SEED))
    np.testing.assert_array_equal(tfirst.numpy(), jfirst)

    tobs, tstate = tenv.reset_from_noise(noise, indices)
    tenv.rng = np.random.RandomState(SEED)  # the same draws, made by the env
    _, drawn = tenv.reset_from_noise(noise)
    for f in FLOAT_FIELDS:
        assert torch.equal(getattr(drawn, f), getattr(tstate, f)), f
    _, ref = _f64_env(tenv).reset_from_noise(noise, indices)
    assert float(np.abs(np.asarray(jstate.x) - init.x).max()) > 1e-2  # it folded
    for f in ("x", "v", "primitive0"):
        _gate(f, getattr(tstate, f).numpy(), np.asarray(getattr(jstate, f)),
              getattr(ref, f).numpy(), FLOOR[f])
    for f in ("primitive1", "stiffness", "mu"):
        np.testing.assert_array_equal(getattr(tstate, f).numpy(), np.asarray(getattr(jstate, f)))
    assert (tstate.cur_step.numpy() == 0).all() and (np.asarray(jstate.cur_step) == 0).all()
    assert tobs.shape == jobs.shape
    assert torch.equal(tobs, tenv.get_obs(tstate))
    assert not tstate.x.requires_grad


def test_default_conf_and_contract_match_jax():
    for n, (jcls, tcls) in ENVS.items():
        jenv, tenv = jcls(1), make_env(f"unfold_cloth{n}", batch_size=1, device="cpu")
        assert isinstance(tenv, tcls) and tenv.N_FOLDS == jenv.N_FOLDS == n
        for f, v in vars(tenv.conf).items():
            assert getattr(jenv.conf, f) == v, f
        assert (tenv.conf.mu, tenv.conf.use_substep_obs) == (3.0, False)
        assert (tenv.max_steps, tenv.observation_size, tenv.reset_mode) == (
            jenv.max_steps, jenv.observation_size, jenv.reset_mode) == (15, 1544, "reset")
        np.testing.assert_array_equal(tenv.goal.numpy(), np.asarray(jenv.goal))


def test_step_diff_matches_jax():
    """One macro step of 8 envs from JAX's unfold_cloth1 reset (the gate's
    RMS pools them): the ground's friction is 3 and the observation list is
    the last observation alone."""
    n_env = 8
    jenv, _, jstate, _, _ = _jax_reset(1, jax.random.PRNGKey(6), aux_reward=True, batch=n_env)
    tenv = ttasks.UnfoldCloth1Env(n_env, conf=ClothConf(**_tiny(1)), aux_reward=True,
                                  device="cpu")
    state = _to_torch(jstate)
    assert (state.mu == 3.0).all()
    actions = np.random.default_rng(1).uniform(0.4, 0.6, (n_env, 6)).astype(np.float32)
    jobs, jreward, jdone, jinfo = jenv.step_diff(jnp.asarray(actions), jstate)
    tobs, treward, tdone, tinfo = tenv.step_diff(torch.from_numpy(actions), state)
    _, r64, _, info64 = _f64_env(tenv).step_diff(torch.from_numpy(actions).double(), _f64(state))
    assert tinfo["obs_list"] is tobs and np.asarray(jinfo["obs_list"]).shape == jobs.shape
    assert not tdone.any() and not np.asarray(jdone).any()
    assert (tinfo["state"].cur_step.numpy() == 1).all()
    assert float(np.abs(np.asarray(jinfo["state"].x) - np.asarray(jstate.x)).max()) > 1e-2
    for f in ("x", "v", "primitive0"):
        _gate(f, getattr(tinfo["state"], f).numpy(), np.asarray(getattr(jinfo["state"], f)),
              getattr(info64["state"], f).numpy(), FLOOR[f])
    _gate("reward", treward.numpy(), np.asarray(jreward), r64.numpy(), FLOOR["reward"])
    np.testing.assert_array_equal(tobs.numpy(), tenv.get_obs(tinfo["state"]).numpy())


def _leaves(params):
    """flax params -> the port's parameter order, kernels transposed."""
    out = []
    for i in range(len(params["params"])):
        layer = params["params"][f"dense_{i}"]
        out += [np.asarray(layer["kernel"]).T, np.asarray(layer["bias"])]
    return out


def test_minimize_matches_jax():
    """One update of unfold_cloth1 (ep_len 1, 3 envs) from JAX's reset, the
    same policy weights and sampling noise: the loss and every gradient leaf
    held to the float64 plain step's, the parameters after Adam to optax's
    step of the port's clipped gradient."""
    n_env = 3
    jenv = jtasks.UnfoldCloth1Env(n_env, conf=JaxClothConf(mem_saving_level=1, **_tiny(1)),
                                  aux_reward=True)
    np.random.seed(SEED)
    _, jstate = jenv.reset(jax.random.PRNGKey(4))
    init_ts, jmin, _, _ = japg.build_apg(jenv, 1, LR, MAX_NORM, mesh=make_env_mesh(1))
    jts = init_ts(0)
    _, key_grad = jax.random.split(jts.key)
    _, key_sample = jax.random.split(key_grad)
    noise = np.asarray(jax.random.normal(key_sample, (n_env, 6)))[None]
    jgrad, (jrewards, _, _) = jmin.debug["loss_grad"](
        jts.policy_params, jts.normalizer_params, jstate, key_grad)
    jloss = -float(np.mean(np.asarray(jrewards)))

    tenv = ttasks.UnfoldCloth1Env(n_env, conf=ClothConf(**_tiny(1)), aux_reward=True,
                                  device="cpu")
    state = _to_torch(jstate)
    tinit, tmin, _, _ = apg.build_apg(tenv, 1, LR, MAX_NORM, device="cpu")
    ts = tinit(0)
    ts.policy.load_state_dict(policy_from_jax(jax.device_get(jts.policy_params),
                                              device="cpu").state_dict())
    params0 = [p.detach().clone() for p in ts.policy.parameters()]
    eps = torch.from_numpy(noise)
    loss, grad, _ = tmin.debug["loss_grad"](ts, state, eps)
    _, tmin64, _, _ = apg.build_apg(_f64_env(tenv), 1, LR, MAX_NORM, device="cpu")
    ts64 = copy.copy(ts)
    ts64.policy = copy.deepcopy(ts.policy).double()
    loss64, grad64, _ = tmin64.debug["loss_grad"](ts64, _f64(state), eps.double())
    _gate("loss", float(loss), jloss, float(loss64), FLOOR["loss"])
    for g, r, r64 in zip(grad, _leaves(jgrad), grad64):
        r64 = r64.numpy()
        assert np.abs(r64).max() > 0
        scale = np.linalg.norm(r64) / np.sqrt(r64.size)  # the RMS gate relative to the leaf's
        _gate("grad", g.numpy() / scale, r / scale, r64 / scale, FLOOR["grad"])

    ts, metrics = tmin(ts, state, eps)
    clipped = [p.grad for p in ts.policy.parameters()]
    assert np.isclose(float(metrics["grad_norm"]),
                      np.sqrt(sum(float((g.double() ** 2).sum()) for g in grad)), rtol=1e-6)
    opt = optax.adam(LR)
    p0 = [jnp.asarray(p.numpy()) for p in params0]
    updates, _ = opt.update([jnp.asarray(g.numpy()) for g in clipped], opt.init(p0))
    for p, want in zip(ts.policy.parameters(), optax.apply_updates(p0, updates)):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want), **TOL_ADAM)


def test_train_repeats_the_noise_and_draws_new_folds_as_jax_does(tmp_path, monkeypatch):
    """``train`` on unfold_cloth3, on both sides, with each env's ``step_diff``
    a stand-in that only counts the step, and the update and the evals
    stand-ins: JAX's ``train`` resets from the same key every iteration, so
    its noise repeats, but its folds draw on numpy's global state, which
    advances, so every iteration folds anew. The port's fixed reset does the
    same: the folds' indices on both sides are one numpy stream seeded
    ``seed + 666`` (the eval env's reset first, then one per iteration)."""
    seed, max_it, n_eval, n = 5, 1, 3, 3
    jdraws, tdraws, jfirst, tfirst = [], [], [], []

    def counting(state):
        return None, None, None, {"state": state}

    def jax_env(**kw):
        env = jtasks.UnfoldCloth3Env(conf=JaxClothConf(mem_saving_level=1, **_tiny(n)), **kw)
        env.step_diff = lambda actions, state: counting(
            state._replace(cur_step=state.cur_step + 1))
        return env

    def port_env(**kw):
        env = ttasks.UnfoldCloth3Env(conf=ClothConf(**_tiny(n)), **kw)
        env.step_diff = lambda actions, state: counting(state.replace(cur_step=state.cur_step + 1))
        fold = env.get_random_fold_action

        def recording_fold(state, rng, indices=None):
            actions = fold(state, rng, indices)
            px = env.packed_x(state)
            tdraws.extend((px == actions[:, None, k:k + 3]).all(-1).float().argmax(1).numpy()
                          for k in (0, 3))
            return actions
        env.get_random_fold_action = recording_fold
        return env

    randint = np.random.randint

    def recording_randint(*args, **kwargs):
        out = randint(*args, **kwargs)
        jdraws.append(out)
        return out

    def stand_ins(build, first, zeros):
        def build_apg(env, *args, **kwargs):
            init_ts, _, reset_batch, _ = build(env, *args, **kwargs)

            def minimize(ts, state):
                first.append(state)
                return ts, {"reward_sum": zeros(()), "grad_norm": zeros(())}
            return init_ts, minimize, reset_batch, lambda *a, **k: (
                None, None, zeros((1, env.batch_size)))
        return build_apg

    monkeypatch.setitem(jreg.env_functions, "unfold_cloth3", jax_env)
    monkeypatch.setitem(registration.env_functions, "unfold_cloth3", port_env)
    monkeypatch.setattr(japg, "build_apg", stand_ins(japg.build_apg, jfirst, jnp.zeros))
    monkeypatch.setattr(apg, "build_apg", stand_ins(apg.build_apg, tfirst, torch.zeros))
    monkeypatch.setattr(np.random, "randint", recording_randint)
    japg.train("unfold_cloth3", 1, B, seed=seed, max_it=max_it, eval_freq=1,
               num_eval_envs=n_eval, num_devices=1, logdir=str(tmp_path / "jax"))
    monkeypatch.setattr(np.random, "randint", randint)
    apg.train("unfold_cloth3", 1, B, seed=seed, max_it=max_it, eval_freq=1,
              num_eval_envs=n_eval, logdir=str(tmp_path / "port"), device="cpu")
    # st and ed of each fold: the eval env's reset (n_eval envs), then each
    # of the max_it + 1 iterations' (B)
    sizes = [n_eval] * 2 * n + [B] * 2 * n * (max_it + 1)
    assert [len(d) for d in tdraws] == [len(d) for d in jdraws] == sizes
    for t, j in zip(tdraws, jdraws):
        np.testing.assert_array_equal(t, j)
    per_it = 2 * n
    it0, it1 = (np.concatenate(jdraws[per_it * (1 + k):per_it * (2 + k)]) for k in (0, 1))
    assert not np.array_equal(it0, it1)  # new folds every iteration
    for first in (jfirst, tfirst):
        assert len(first) == max_it + 1
        np.testing.assert_array_equal(np.asarray(first[0].x), np.asarray(first[1].x))  # same noise
        assert (np.asarray(first[1].cur_step) == 0).all()
