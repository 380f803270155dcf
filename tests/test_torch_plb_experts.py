"""The port's policy-through-simulator solver and expert factory against
``unidom_tpu`` on the CPU, on tests/test_solver.py's small cloth (N = 20, 10
substeps): one ``SolverNN`` update from JAX's parameters (the rewards and the
parameters after Adam), and ``generate_experts`` fed JAX's draws (the reset
shift, each env's stiffness uniform, the initial actions) against JAX's
records. Then the port alone: ``generate_experts`` on a cut plb_writer with
the yield stress drawn, and ``solve.py --algo nn`` on a cut plb_move. No JAX
plb env is built here (JAX compiles its target SDF once per process, ~60 s)."""

import dataclasses
import pickle

import jax
import numpy as np
import pytest
import torch

from unidom_tpu.algorithms.solver import SolverNN as JaxSolverNN
from unidom_tpu.algorithms.solver import generate_experts as jax_generate_experts
from unidom_tpu.engine.cloth import ClothConf as JaxClothConf
from unidom_tpu.envs.cloth_tasks import FoldCloth1Env as JaxFoldCloth1Env
from unidom_torch.algorithms import solve
from unidom_torch.algorithms.solver import SolverNN, generate_experts
from unidom_torch.engine.cloth import ClothConf
from unidom_torch.envs import plb_tasks as tplb
from unidom_torch.envs import registration
from unidom_torch.envs.cloth_tasks import FoldCloth1Env, goal_path
from unidom_torch.utils.convert import copy_policy_from_jax

torch.set_num_threads(1)

B, H = 2, 2
TINY = dict(N=20, n_substeps=10, gripper_radius=0.08, task="fold_cloth1",
            goal_path=goal_path("fold_cloth1"))
STIFF = (500.0, 1500.0)  # tests/test_solver.py's stiffness range
# One update of the same float32 cloth steps, summed in other orders
# (tests/test_torch_para.py's tolerances of one minimize)
TOL_REWARD = dict(rtol=1e-5, atol=1e-6)
RECORD_KEYS = {"action", "reward", "params", "pc_before", "pc_after", "seed", "instance"}
PLB_SMALL = dataclasses.replace(tplb.PLB_BASE_CONF, n_grid=32, steps=5, res=(32, 32, 32),
                                n_primitive=1)


def _shifted(key):
    """The shift JAX's cloth reset draws from ``key``."""
    shift_key, _ = jax.random.split(key)
    return np.asarray(jax.random.normal(shift_key, (2,)) * 0.05)


@pytest.fixture(scope="module")
def envs():
    jenv = JaxFoldCloth1Env(B, conf=JaxClothConf(mem_saving_level=1, **TINY), aux_reward=True)
    tenv = FoldCloth1Env(B, conf=ClothConf(**TINY), aux_reward=True, device="cpu")
    return jenv, tenv


def test_solver_nn_update_matches_jax(envs):
    """JAX's initial parameters carried into the port's policy: the
    rollout's rewards before the update and every parameter after Adam's
    first step (lr x g / (|g| + eps))."""
    jenv, tenv = envs
    key = jax.random.PRNGKey(0)
    _, jstate = jenv.reset(key)
    _, tstate = tenv.reset_from_shift(_shifted(key))
    js = JaxSolverNN(jenv, H, lr=1e-3, hidden=(16,))
    params = js.model.init(jax.random.PRNGKey(1))
    new_params, _, jrew = js._update(params, js.optim.init(params), jstate)
    ts = SolverNN(tenv, H, lr=1e-3, hidden=(16,), device="cpu")
    copy_policy_from_jax(ts.policy, jax.device_get(params))
    before = [p.detach().clone() for p in ts.policy.parameters()]
    trew = ts.step(tstate)
    assert trew.shape == (H, B)
    np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), **TOL_REWARD)
    dense = jax.device_get(new_params)["params"]
    for i, layer in enumerate(ts.policy.layers):
        np.testing.assert_allclose(layer.weight.detach().numpy(),
                                   np.asarray(dense[f"dense_{i}"]["kernel"]).T, rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(layer.bias.detach().numpy(),
                                   np.asarray(dense[f"dense_{i}"]["bias"]), rtol=0, atol=1e-6)
    moved = max((p.detach() - q).abs().max().item()
                for p, q in zip(ts.policy.parameters(), before))
    assert moved == pytest.approx(1e-3, rel=1e-2)
    with pytest.raises(ValueError, match="layer 0"):
        copy_policy_from_jax(SolverNN(tenv, H, hidden=(8,), device="cpu").policy,
                             jax.device_get(params))


def test_generate_experts_matches_jax(envs, tmp_path):
    """Two instances, horizon 1, two solver iterations, each env's stiffness
    drawn: the port, fed the reset shifts, uniforms and initial actions that
    JAX's keys give, writes JAX's records (keys, shapes, values)."""
    jenv, tenv = envs
    n, iters, lr = 2, 2, 0.02
    jrecs = jax_generate_experts(jenv, str(tmp_path / "jax"), n_instances=n, horizon=1,
                                 solver_iters=iters, param_ranges={"stiffness": STIFF}, seed=0,
                                 lr=lr)
    # JAX's draws, from its keys in its order
    key, shifts, draws = jax.random.PRNGKey(0), [], []
    for _ in range(n):
        key, k_reset, k_param, k_act = jax.random.split(key, 4)
        k_param, k = jax.random.split(k_param)
        shifts.append(_shifted(k_reset))
        draws.append({"u": {"stiffness": np.asarray(jax.random.uniform(k, (B,)))},
                      "actions": np.asarray(jax.random.normal(k_act, (B, 1, 6)) * 0.01)})
    shift_iter = iter(shifts)
    tenv.reset = lambda generator=None: tenv.reset_from_shift(next(shift_iter))
    try:
        trecs = generate_experts(tenv, str(tmp_path / "torch"), n, 1, solver_iters=iters,
                                 param_ranges={"stiffness": STIFF}, seed=0, lr=lr, draws=draws)
    finally:
        del tenv.reset
    assert sorted(p.name for p in (tmp_path / "torch").iterdir()) == [
        "expert_0000.pkl", "expert_0001.pkl"]
    for inst, (t, j) in enumerate(zip(trecs, jrecs)):
        on_disk = pickle.loads((tmp_path / "torch" / f"expert_{inst:04d}.pkl").read_bytes())
        assert set(t) == set(j) == set(on_disk) == RECORD_KEYS
        assert (t["seed"], t["instance"]) == (j["seed"], j["instance"]) == (0, inst)
        np.testing.assert_array_equal(on_disk["action"], t["action"])
        np.testing.assert_allclose(t["params"]["stiffness"], j["params"]["stiffness"], rtol=1e-6)
        assert ((t["params"]["stiffness"] >= STIFF[0]) & (t["params"]["stiffness"] < STIFF[1])).all()
        np.testing.assert_allclose(t["pc_before"], j["pc_before"], rtol=0, atol=1e-6)
        assert t["action"].shape == j["action"].shape == (B, 1, 6)
        assert isinstance(t["action"], np.ndarray) and isinstance(t["reward"], np.ndarray)
        # two Adam steps of lr from the same actions: each moves an action by
        # lr x a ratio of gradients, which their rounding moves by ~1e-3
        np.testing.assert_allclose(t["action"], j["action"], rtol=0, atol=lr * 2e-3)
        np.testing.assert_allclose(t["reward"], j["reward"], **TOL_REWARD)
        np.testing.assert_allclose(t["pc_after"], j["pc_after"], rtol=0, atol=1e-5)


def _small_writer(batch_size, seed=0, device="cpu", **kw):
    return tplb.PlbSceneEnv("plb_writer", batch_size, seed=seed,
                            conf=dataclasses.replace(PLB_SMALL, task="plb_writer"),
                            max_steps=4, device=device)


def test_generate_experts_plb_writer(tmp_path, capsys):
    """The port alone on plb_writer (32^3, 5 substeps): each instance's
    yield stress per env from the generator into the state, a reset of its
    own, the records on disk."""
    env = _small_writer(B)
    lo, hi = 100.0, 500.0
    recs = generate_experts(env, str(tmp_path), 2, 1, solver_iters=1,
                            param_ranges={"yield_stress": (lo, hi)}, seed=3)
    assert "expert 1: reward" in capsys.readouterr().out
    assert len(list(tmp_path.glob("expert_*.pkl"))) == 2
    for inst, rec in enumerate(recs):
        ys = rec["params"]["yield_stress"]
        assert ys.shape == (B,) and ((ys >= lo) & (ys < hi)).all() and ys[0] != ys[1]
        assert rec["action"].shape == (B, 1, 3) and np.isfinite(rec["reward"]).all()
        assert rec["pc_before"].shape == rec["pc_after"].shape == (B, 2000, 3)
        assert not np.array_equal(rec["pc_before"], rec["pc_after"])
        assert rec["instance"] == inst and rec["seed"] == 3
    # each instance resets from a seed of its own
    assert not np.array_equal(recs[0]["pc_before"], recs[1]["pc_before"])


def _small_move(batch_size, seed=0, device="cpu", **kw):
    return tplb.PlbSceneEnv("plb_move", batch_size, seed=seed,
                            conf=dataclasses.replace(PLB_SMALL, task="plb_move"),
                            max_steps=4, device=device)


def test_solve_cli_nn_arm(monkeypatch, capsys):
    monkeypatch.setitem(registration.env_functions, "plb_move", _small_move)
    policy, history = solve.main(["--algo", "nn", "--env_name", "plb_move", "--batch_size",
                                  "2", "--horizon", "1", "--iters", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "solver_nn it 0: reward" in out and "final reward:" in out
    assert len(history) == 2 and np.isfinite(history).all()
    assert [tuple(p.shape) for p in policy.parameters()][-1] == (3,)
