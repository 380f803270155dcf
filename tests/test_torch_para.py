"""The port's parameter-aware training against ``unidom_tpu`` on the CPU:
fold_cloth1_para's observation (the normalised stiffness at its end),
``randomize_stiffness`` from the same uniform draw, one ``minimize`` of
fold_cloth1_para under a per-env stiffness from the same first state, policy
weights and sampling noise (loss, every gradient leaf, the clipped gradient,
the Adam step), one iteration of ``train_para`` with its eval sweep, and the
CLI. The cloth is tests/test_apg.py's tiny one where the physics runs."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from unidom_tpu.algorithms.apg import build_apg as jax_build_apg
from unidom_tpu.algorithms.apg_para import randomize_stiffness as jax_randomize_stiffness
from unidom_tpu.engine.cloth import ClothConf as JaxClothConf
from unidom_tpu.envs.cloth_tasks import FoldCloth1ParaEnv as JaxFoldCloth1ParaEnv
from unidom_tpu.ops.gradops import global_norm_clip as jax_global_norm_clip
from unidom_tpu.ops.gradops import nan_to_num_tree as jax_nan_to_num_tree
from unidom_tpu.parallel.mesh import make_env_mesh
from unidom_torch import make_env
from unidom_torch.algorithms import apg, apg_para
from unidom_torch.engine.cloth import ClothConf, ClothState
from unidom_torch.envs import registration
from unidom_torch.envs.cloth_tasks import FoldCloth1ParaEnv, goal_path
from unidom_torch.utils.convert import policy_from_jax

torch.set_num_threads(1)

B, EP_LEN, LR, MAX_NORM = 3, 2, 1e-4, 0.3
STIFF = (1000.0, 1600.0)  # train_para's default training range
TINY = dict(N=20, n_substeps=10, gripper_radius=0.08, task="fold_cloth1",
            goal_path=goal_path("fold_cloth1"))
# tests/test_torch_train.py's tolerances of one minimize: the same float32
# operations on both sides, summed in other orders
TOL_LOSS = dict(rtol=1e-5, atol=0)
GRAD_REL_NORM = 1e-3
GRAD_COS = 1 - 1e-6
TOL_ADAM = dict(rtol=0, atol=2e-8)
CLEAR_OF_ROUNDING = 1e-2


def _shifted(key):
    """The shift JAX's cloth reset draws from ``key``."""
    shift_key, _ = jax.random.split(key)
    return np.asarray(jax.random.normal(shift_key, (2,)) * 0.05)


def test_para_obs_matches_jax():
    """Full width: 3 x 512 positions, both grippers and the stiffness
    normalised to the env's eval range, 1545 entries, per env."""
    jenv = JaxFoldCloth1ParaEnv(B)
    tenv = make_env("fold_cloth1_para", batch_size=B, device="cpu")
    assert tenv.observation_size == jenv.observation_size == 1545
    assert tenv.eval_min_max_stiff == jenv.eval_min_max_stiff == (100.0, 2000.0)
    assert tenv.conf.stiffness == jenv.conf.stiffness == 900
    key = jax.random.PRNGKey(2)
    _, jstate = jenv.reset(key)
    _, tstate = tenv.reset_from_shift(_shifted(key))
    stiffness = np.array([100.0, 777.5, 2000.0], np.float32)
    jstate = jstate._replace(stiffness=jnp.asarray(stiffness))
    tstate = tstate.replace(stiffness=torch.from_numpy(stiffness))
    jobs, tobs = np.asarray(jenv.get_obs(jstate)), tenv.get_obs(tstate).numpy()
    assert tobs.shape == (B, 1545)
    np.testing.assert_array_equal(tobs, jobs)
    np.testing.assert_allclose(tobs[:, -1], (stiffness - 100.0) / 1900.0, rtol=1e-6)
    # the plain env's observation has no stiffness entry
    assert make_env("fold_cloth1", batch_size=1, device="cpu").observation_size == 1544


def test_randomize_stiffness_matches_jax():
    """JAX draws one uniform per env and maps it to [lo, hi); the port maps
    the same draw to the same stiffness, and draws its own per env from a
    generator otherwise."""
    env = make_env("fold_cloth1_para", batch_size=B, device="cpu")
    _, state = env.reset()
    key = jax.random.PRNGKey(5)
    jstate = jax_randomize_stiffness(_jax_cloth_state(state), key, *STIFF)
    u = np.asarray(jax.random.uniform(key, (B,)))
    out = apg_para.randomize_stiffness(state, None, *STIFF, u=u)
    assert out.stiffness.dtype == torch.float32 and out.x is state.x
    np.testing.assert_allclose(out.stiffness.numpy(), np.asarray(jstate.stiffness), rtol=1e-7)
    drawn = apg_para.randomize_stiffness(state, torch.Generator().manual_seed(0), *STIFF)
    s = drawn.stiffness.numpy()
    assert s.shape == (B,) and len(set(s.tolist())) == B
    assert ((s >= STIFF[0]) & (s < STIFF[1])).all()
    again = apg_para.randomize_stiffness(state, torch.Generator().manual_seed(0), *STIFF)
    assert torch.equal(again.stiffness, drawn.stiffness)


def _jax_cloth_state(state):
    """A JAX ClothState holding the port's ``state`` (the key a fixed one)."""
    from unidom_tpu.engine.cloth import ClothState as JaxClothState

    fields = {f: jnp.asarray(getattr(state, f).numpy()) for f in ClothState.__dataclass_fields__}
    return JaxClothState(key=jax.random.PRNGKey(0), **fields)


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


def _rel(out, ref):
    return np.linalg.norm(out - ref) / np.linalg.norm(ref)


@pytest.fixture(scope="module")
def one_minimize():
    """One update on both sides from the same reset under the same per-env
    stiffness draw, the contact-distance aux reward on, as train_para has it."""
    jenv = JaxFoldCloth1ParaEnv(B, conf=JaxClothConf(mem_saving_level=1, **TINY),
                                aux_reward=True)
    init_ts, jmin, _, _ = jax_build_apg(jenv, EP_LEN, LR, MAX_NORM, mesh=make_env_mesh(1))
    jts = init_ts(0)
    key = jax.random.PRNGKey(3)
    _, jstate = jenv.reset(key)
    k_stiff = jax.random.PRNGKey(11)
    jstate = jax_randomize_stiffness(jstate, k_stiff, *STIFF)
    noise = _jax_noise(jts.key, EP_LEN)
    _, key_grad = jax.random.split(jts.key)
    jgrad, (jrewards, _, _) = jmin.debug["loss_grad"](
        jts.policy_params, jts.normalizer_params, jstate, key_grad)
    jgrad = jax_nan_to_num_tree(jgrad)
    jclipped = jax_global_norm_clip(jgrad, MAX_NORM)
    updates, _ = jmin.debug["optimizer"].update(jclipped, jts.optimizer_state)
    jparams = optax.apply_updates(jts.policy_params, updates)
    ref = dict(loss=-float(np.mean(np.asarray(jrewards))), grad=_leaves(jgrad),
               clipped=_leaves(jclipped), params=_leaves(jparams),
               stiffness=np.asarray(jstate.stiffness))

    env = FoldCloth1ParaEnv(B, conf=ClothConf(**TINY), aux_reward=True, device="cpu")
    _, state = env.reset_from_shift(_shifted(key))
    state = apg_para.randomize_stiffness(state, None, *STIFF,
                                         u=np.asarray(jax.random.uniform(k_stiff, (B,))))
    tinit, tmin, _, _ = apg.build_apg(env, EP_LEN, LR, MAX_NORM, device="cpu")
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
               params0=[p.numpy() for p in params0], metrics=metrics,
               stiffness=state.stiffness.numpy())
    return ref, out


def test_minimize_under_a_stiffness_draw_matches_jax(one_minimize):
    ref, out = one_minimize
    np.testing.assert_allclose(out["stiffness"], ref["stiffness"], rtol=1e-7)
    assert len(set(out["stiffness"].tolist())) == B
    np.testing.assert_allclose(out["loss"], ref["loss"], **TOL_LOSS)
    assert len(out["grad"]) == len(ref["grad"]) == 6
    for g, r in zip(out["grad"], ref["grad"]):
        assert g.shape == r.shape and np.any(r != 0)
        cos = np.sum(g.astype(np.float64) * r) / np.linalg.norm(g) / np.linalg.norm(r)
        assert cos >= GRAD_COS
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


def _tiny_para(**kw):
    return FoldCloth1ParaEnv(conf=ClothConf(**TINY), **kw)


def test_train_para_iteration_writes_the_sweep_and_checkpoints(tmp_path, monkeypatch):
    """One iteration on the tiny cloth: the eval sweep at n_eval_points
    stiffness values (each set in every eval env, each seen by the policy),
    metrics.jsonl, the per-eval and best checkpoints, and a training first
    state of the fixed reset under a fresh per-env draw."""
    monkeypatch.setitem(registration.env_functions, "fold_cloth1_para", _tiny_para)
    seen, first_states = [], []
    run_eval = apg.run_eval

    def recording_eval(policy, normalizer, env, state, **kw):
        seen.append(env.get_obs(state)[:, -1].clone())
        return run_eval(policy, normalizer, env, state, **kw)

    def recording_build(env, *args, **kwargs):
        init_ts, minimize, reset_batch, _ = build(env, *args, **kwargs)

        def recording_minimize(ts, state):
            first_states.append(state)
            return minimize(ts, state)
        return init_ts, recording_minimize, reset_batch, recording_eval

    build = apg.build_apg
    monkeypatch.setattr(apg_para, "build_apg", recording_build)
    logdir = tmp_path / "para"
    ts, history = apg_para.train_para(
        "fold_cloth1_para", episode_length=1, num_envs=2, max_it=1, eval_freq=2,
        num_eval_envs=2, n_eval_points=3, eval_min_stiff=10.0, eval_max_stiff=1800.0,
        logdir=str(logdir), device="cpu")
    sweep = [10.0, 905.0, 1800.0]
    assert [r["it"] for r in history] == [0, 1]
    assert list(history[0]["eval_sweep"]) == sweep and "eval_sweep" not in history[1]
    assert all(np.isfinite(r[k]) for r in history for k in ("train_reward", "grad_norm", "sps"))
    assert all(np.isfinite(v) for v in history[0]["eval_sweep"].values())
    # the policy saw each sweep point as its normalised stiffness, in every env
    for obs_stiff, s in zip(seen, sweep):
        np.testing.assert_allclose(obs_stiff.numpy(), (s - 10.0) / 1790.0, rtol=1e-6)
    # the same reset each iteration, under a fresh draw per env
    a, b = first_states
    assert torch.equal(a.x, b.x)
    assert not torch.equal(a.stiffness, b.stiffness)
    for s in (a, b):
        assert ((s.stiffness >= STIFF[0]) & (s.stiffness < STIFF[1])).all()
        assert s.stiffness[0] != s.stiffness[1]
    lines = [json.loads(line) for line in (logdir / "metrics.jsonl").read_text().splitlines()]
    assert [line["it"] for line in lines] == [0]
    assert [float(k) for k in lines[0]["eval_sweep"]] == sweep
    for name in ("apg_para_fold_cloth1_para_0.pt", "apg_para_fold_cloth1_para_best.pt"):
        saved = torch.load(logdir / name, weights_only=True)
        assert saved["it"] == 0 and list(saved["sweep"]) == sweep
        assert set(saved["policy"]) == set(ts.policy.state_dict())
    assert saved["mean"] == pytest.approx(np.mean(list(history[0]["eval_sweep"].values())))


def test_cli_parses_and_calls_train_para(monkeypatch):
    got = {}
    monkeypatch.setattr(apg_para, "train_para", lambda **kw: got.update(kw))
    apg_para.main(["--env", "fold_cloth1_para", "--ep_len", "2", "--num_envs", "8",
                   "--max_it", "3", "--train_min_stiff", "500", "--eval_max_stiff", "1500",
                   "--device", "cpu"])
    assert got["env_name"] == "fold_cloth1_para" and got["episode_length"] == 2
    assert (got["num_envs"], got["max_it"], got["device"]) == (8, 3, "cpu")
    assert (got["train_min_stiff"], got["train_max_stiff"]) == (500.0, 1600.0)
    assert (got["eval_min_stiff"], got["eval_max_stiff"]) == (10.0, 1500.0)
    defaults = {}
    monkeypatch.setattr(apg_para, "train_para", lambda **kw: defaults.update(kw))
    apg_para.main([])
    assert defaults["device"] == "cuda" and defaults["eval_freq"] == 100


def test_para_env_defaults_match_jax():
    t = dataclasses.asdict(make_env("fold_cloth1_para", batch_size=1, device="cpu").conf)
    j = JaxFoldCloth1ParaEnv(1).conf
    for f, v in t.items():
        assert getattr(j, f) == v, f
