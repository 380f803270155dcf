"""The port's trajectory solver and its front ends against ``unidom_tpu`` on
the CPU: one ``TrajectorySolver`` update on plb_move (the rollout's
gradient, the new actions after Adam and the clamp, the rewards) and three
iterations of ``solve`` (the best-action bookkeeping) from the same initial
actions; the ``solve.py`` CLI's ``action`` and ``apg`` arms and the arms not
ported yet; the gym wrapper's NaN tripwire and automatic reset; and
``config.make`` against JAX's ``resolve_variant``."""

import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unidom_tpu import config as jconfig
from unidom_tpu.algorithms.solver import TrajectorySolver as JaxSolver
from unidom_tpu.envs import plb_tasks as jplb
from unidom_torch import config
from unidom_torch.algorithms import solve
from unidom_torch.algorithms.solver import TrajectorySolver
from unidom_torch.envs import plb_tasks as tplb
from unidom_torch.envs import registration
from unidom_torch.envs.gym_wrapper import GymWrapper, NaNError

torch.set_num_threads(1)

B, H, SEED = 2, 2, 3
SMALL = dataclasses.replace(tplb.PLB_BASE_CONF, n_grid=32, steps=5, res=(32, 32, 32),
                            n_primitive=1, task="plb_move")
JSMALL = dataclasses.replace(jplb.PLB_BASE_CONF, n_grid=32, steps=5, res=(32, 32, 32),
                             n_primitive=1, task="plb_move")


def _np(t):
    return np.asarray(t)


def _small_move(batch_size, seed=SEED, device="cpu", max_steps=4, **kw):
    return tplb.PlbSceneEnv("plb_move", batch_size, seed=seed, conf=SMALL, max_steps=max_steps,
                            device=device)


@pytest.fixture(scope="module")
def envs():
    tenv = _small_move(B)
    jenv = jplb.PlbSceneEnv("plb_move", B, conf=JSMALL, max_steps=4)
    _, tstate = tenv.reset(SEED)
    with jax.disable_jit():
        _, jstate = jenv.reset(jax.random.PRNGKey(SEED))
    # the first actions: the sphere pushed into the rope's end, along it
    a0 = np.random.default_rng(1).normal(0.0, 0.3, (B, H, 3)).astype(np.float32)
    a0[..., 0] -= 0.6
    # one JAX solver for both tests: its jitted update compiles once
    return tenv, tstate, jenv, jstate, a0, JaxSolver(jenv, H, lr=0.1)


def test_one_update_matches_jax(envs):
    tenv, tstate, jenv, jstate, a0, js = envs
    jg, (jrew, _) = jax.grad(js._rollout_loss, has_aux=True)(jnp.asarray(a0), jstate)
    ja, _, jrew2, _ = js._update(jnp.asarray(a0), js.optim.init(jnp.asarray(a0)), jstate)
    ts = TrajectorySolver(tenv, H, lr=0.1)
    actions = torch.from_numpy(a0.copy()).requires_grad_()
    opt = ts.make_optimizer(actions)
    trew, _, tg = ts.step(actions, opt, tstate)
    jg = _np(jg)
    # the gradient of -mean(summed rewards): every action feels the rope
    assert (np.abs(jg) > 1e-6 * np.abs(jg).max()).all()
    np.testing.assert_allclose(tg.numpy(), jg, rtol=2e-3, atol=2e-3 * np.abs(jg).max())
    scale = float(np.abs(_np(jenv.tracker.start_loss)).max())
    np.testing.assert_allclose(trew.numpy(), _np(jrew2), rtol=0, atol=2e-6 * scale)
    np.testing.assert_allclose(trew.numpy(), _np(jrew), rtol=0, atol=2e-6 * scale)
    # Adam's first step moves each action by lr (x sign of its gradient),
    # then the clamp to [-1, 1]
    np.testing.assert_allclose(actions.detach().numpy(), _np(ja), rtol=0, atol=1e-6)
    np.testing.assert_allclose(actions.detach().numpy(),
                               np.clip(a0 - 0.1 * np.sign(jg), -1, 1), atol=1e-5)


def test_solve_bookkeeping_matches_jax(envs):
    tenv, tstate, jenv, jstate, a0, js = envs
    jbest, jreward, jhist = js.solve(jstate, n_iters=3, actions=jnp.asarray(a0))
    tbest, treward, thist = TrajectorySolver(tenv, H, lr=0.1).solve(
        tstate, n_iters=3, actions=torch.from_numpy(a0))
    scale = float(np.abs(_np(jenv.tracker.start_loss)).max())
    np.testing.assert_allclose(thist, jhist, rtol=0, atol=4e-6 * scale)
    np.testing.assert_allclose(treward.numpy(), _np(jreward), rtol=0, atol=4e-6 * scale)
    # each env's best actions: those an update produced in the iteration of
    # its best reward (strictly better than before). After the first, an
    # Adam step moves an action by lr times a ratio of gradients, which the
    # gradients' rounding (2e-3 relative, above) moves by up to lr x 2e-3.
    np.testing.assert_allclose(tbest.numpy(), _np(jbest), rtol=0, atol=0.1 * 2e-3)
    assert tbest.shape == (B, H, 3) and not tbest.requires_grad
    assert (tbest.abs() <= 1).all()


def test_init_actions():
    env = _small_move(B)
    env.reset(SEED)
    s = TrajectorySolver(env, H)
    a = s.init_actions(torch.Generator().manual_seed(0), scale=0.1)
    assert a.shape == (B, H, 3) and 0 < a.abs().max() < 1
    torch.testing.assert_close(a, s.init_actions(torch.Generator().manual_seed(0), scale=0.1))
    assert s.init_actions().abs().max() < 0.1  # N(0, 0.01^2) from seed 0 by default


# ---------------------------------------------------------------- the CLI

def test_solve_cli_action_arm(monkeypatch, capsys):
    monkeypatch.setitem(registration.env_functions, "plb_move", _small_move)
    actions, reward, history = solve.main(["--algo", "action", "--env_name", "plb_move",
                                           "--batch_size", "2", "--horizon", "2", "--iters", "2",
                                           "--device", "cpu"])
    out = capsys.readouterr().out
    assert "solver it 0: reward" in out and "final reward:" in out
    assert actions.shape == (2, 2, 3) and len(history) == 2
    # each env's best total is at least its total of every iteration
    assert torch.isfinite(reward).all() and float(reward.mean()) >= max(history) - 1e-3


def test_solve_cli_apg_arm_calls_train(monkeypatch):
    calls = []
    monkeypatch.setattr("unidom_torch.algorithms.apg.train", lambda **kw: calls.append(kw))
    solve.main(["--algo", "apg", "--env_name", "plb_move", "--batch_size", "8", "--horizon",
                "3", "--iters", "5", "--seed", "2", "--device", "cpu"])
    assert calls == [dict(env_name="plb_move", episode_length=3, num_envs=8, max_it=5, seed=2,
                          device="cpu")]


@pytest.mark.parametrize("algo", sorted(solve.NOT_PORTED))
def test_solve_cli_arms_not_ported_raise(algo):
    with pytest.raises(NotImplementedError, match="ROADMAP Step 1[34]"):
        solve.main(["--algo", algo, "--device", "cpu"])


# ---------------------------------------------------------------- gym wrapper

class _NaNEnv:
    """A stand-in env whose second step's reward is NaN."""

    batch_size, observation_size, action_size, device = 2, 4, 3, torch.device("cpu")

    def __init__(self):
        self.steps = 0

    def reset(self, generator):
        return torch.zeros((2, 4)), {"t": 0}

    def step_diff(self, actions, state):
        self.steps += 1
        reward = torch.full((2,), float("nan") if self.steps == 2 else 1.0)
        return torch.zeros((2, 4)), reward, torch.zeros(2, dtype=torch.bool), {"state": state}


def test_gym_wrapper_dumps_actions_and_raises_on_nan(tmp_path):
    gym = GymWrapper(_NaNEnv(), dump_dir=str(tmp_path))
    gym.reset(seed=1)
    obs, rew, done, _ = gym.step(np.ones((2, 3)))
    assert (rew == 1).all() and not done.any()
    with pytest.raises(NaNError, match="action history dumped"):
        gym.step(np.full((2, 3), 2.0))
    (dump,) = tmp_path.glob("nan_action_dump_*.pkl")
    history = pickle.loads(dump.read_bytes())
    assert [h.tolist() for h in history] == [[[1.0] * 3] * 2, [[2.0] * 3] * 2]
    GymWrapper(_NaNEnv(), nan_fail=False).reset()


def test_gym_wrapper_resets_when_every_env_is_done():
    env = _small_move(1, max_steps=1)
    gym = GymWrapper(env)
    obs0 = gym.reset(seed=4)
    x0 = env.init_state.x.clone()
    obs, rew, done, info = gym.step(np.zeros((1, 3), np.float32))
    assert done.all() and np.isfinite(rew).all()
    # the episode ended: the wrapper drew a new reset, whose first obs it returns
    assert not torch.equal(env.init_state.x, x0)
    np.testing.assert_array_equal(obs, env.get_obs(env.init_state).numpy())
    assert obs.shape == obs0.shape == (1, env.observation_size)
    assert gym._action_history == []


# ---------------------------------------------------------------- config

@pytest.mark.parametrize("task", ["fold_cloth1", "shape_rope"])
def test_variants_match_jax(task):
    n = len(jconfig.load_task_yaml(task)["variants"])
    for version in range(0, n + 2):
        assert config.resolve_variant(task, version) == jconfig.resolve_variant(task, version)
    for spec in (f"{task}-v2", task, f"{task.upper()}-V3"):
        assert config.parse_env_spec(spec) == jconfig.parse_env_spec(spec)
    with pytest.raises(ValueError):
        config.parse_env_spec("no spaces-v1")


def test_make_applies_the_variant():
    env = config.make("shape_rope-v2", batch_size=2, device="cpu")
    assert type(env).__name__ == "ShapeRopeEnv"
    assert (env.batch_size, env.max_steps) == (2, jconfig.resolve_variant("shape_rope", 2)
                                               ["max_steps"])
    with pytest.raises(KeyError):
        config.make("no_such_task-v1")

