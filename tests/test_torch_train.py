"""The port's APG training against ``unidom_tpu`` on the CPU: one
``minimize`` from the same first state, policy weights and sampling noise
(loss, every gradient leaf, the clipped gradient, the parameters after Adam,
the normalizer), the trainer's gradient pipeline and normalizer update, the
``train`` loop's metrics, checkpoints and resume, and the entry points'
default device."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from unidom_tpu.algorithms.apg import build_apg as jax_build_apg
from unidom_tpu.engine.cloth import ClothConf as JaxClothConf
from unidom_tpu.envs.cloth_tasks import FoldCloth3Env as JaxFoldCloth3Env
from unidom_tpu.models.normalizer import NormalizerParams as JaxNormalizerParams
from unidom_tpu.models.normalizer import normalize as jax_normalize
from unidom_tpu.models.normalizer import update_normalizer as jax_update_normalizer
from unidom_tpu.ops.gradops import global_norm_clip as jax_global_norm_clip
from unidom_tpu.ops.gradops import nan_to_num_tree as jax_nan_to_num_tree
from unidom_tpu.parallel.mesh import make_env_mesh
from unidom_torch import make_env
from unidom_torch.algorithms import apg
from unidom_torch.engine.cloth import ClothConf
from unidom_torch.envs.cloth_tasks import FoldCloth3Env, goal_path
from unidom_torch.models.mlp import PolicyMLP
from unidom_torch.models.normalizer import (
    create_observation_normalizer,
    normalize,
    update_normalizer,
)
from unidom_torch.ops.gradops import global_norm_clip, nan_to_num_tree
from unidom_torch.utils.convert import normalizer_from_jax, policy_from_jax

torch.set_num_threads(1)

B, EP_LEN, LR = 3, 2, 1e-4
# the tiny cloth of tests/test_apg.py (the gripper radius exceeds half the
# particle spacing, so the pick captures cloth), with fold_cloth3's goal
TINY = dict(N=20, stiffness=900.0, n_substeps=10, gripper_radius=0.08, task="fold_cloth3",
            goal_path=goal_path("fold_cloth3"))
# Tolerances of one minimize. The loss runs 2 macro steps of 40 robot steps of
# 10 substeps in float32 on both sides, the same operations summed in other
# orders: the losses agree to 1e-6 relative, and every gradient leaf to
# 3e-4 in relative norm (cosine 1 - 1e-7); the bounds keep 5x of headroom.
TOL_LOSS = dict(rtol=1e-5, atol=0)
GRAD_REL_NORM = 1e-3
GRAD_COS = 1 - 1e-6
# Adam's first step is -lr * g / (|g| + eps): the same update from the same
# gradient to a few float32 ulps of the weights (~0.05), and +-lr per entry,
# so a gradient entry within rounding of 0 may step either way. The port's
# parameters are held tightly to optax's step of the port's own gradient,
# and to JAX's parameters on the entries whose gradient is clear of rounding.
TOL_ADAM = dict(rtol=0, atol=2e-8)
CLEAR_OF_ROUNDING = 1e-2  # of the leaf's largest entry


def _leaves(params):
    """flax params -> the port's parameter order, kernels transposed."""
    out = []
    for i in range(len(params["params"])):
        layer = params["params"][f"dense_{i}"]
        out += [np.asarray(layer["kernel"]).T, np.asarray(layer["bias"])]
    return out


def _jax_noise(key, T):
    """The noise JAX's ``minimize`` draws: ``key, key_grad = split(ts.key)``,
    then per step ``key, key_sample = split(key)`` and ``normal(key_sample)``."""
    _, key = jax.random.split(key)
    noise = []
    for _ in range(T):
        key, key_sample = jax.random.split(key)
        noise.append(np.asarray(jax.random.normal(key_sample, (B, 6))))
    return np.stack(noise)


@pytest.fixture(scope="module", params=[(None, False, 0.3), (1, True, 0.01)],
                ids=["plain", "truncated-normalized-clipped"])
def one_minimize(request):
    truncation, normalize_obs, max_norm = request.param
    opts = dict(truncation_length=truncation, normalize_obs=normalize_obs,
                max_gradient_norm=max_norm)
    jenv = JaxFoldCloth3Env(B, conf=JaxClothConf(mem_saving_level=1, **TINY))
    init_ts, jmin, _, _ = jax_build_apg(jenv, EP_LEN, LR, mesh=make_env_mesh(1), **opts)
    jts = init_ts(0)
    key = jax.random.PRNGKey(3)
    _, jstate = jenv.reset(key)
    noise = _jax_noise(jts.key, EP_LEN)

    # JAX: minimize's own pipeline from minimize.debug, on one device
    _, key_grad = jax.random.split(jts.key)
    jgrad, (jrewards, jstates, _) = jmin.debug["loss_grad"](
        jts.policy_params, jts.normalizer_params, jstate, key_grad)
    jgrad = jax_nan_to_num_tree(jgrad)
    jclipped = jax_global_norm_clip(jgrad, max_norm)
    updates, _ = jmin.debug["optimizer"].update(jclipped, jts.optimizer_state)
    jparams = optax.apply_updates(jts.policy_params, updates)
    jnorm = None
    if normalize_obs:
        obs = jnp.concatenate([jenv.get_obs(jstate)[None], jax.vmap(jenv.get_obs)(jstates)])
        jnorm = jax_update_normalizer(jts.normalizer_params, obs)
    ref = dict(loss=-float(np.mean(np.asarray(jrewards))), grad=_leaves(jgrad),
               clipped=_leaves(jclipped), params=_leaves(jparams), normalizer=jnorm)

    # the port: the same first state (reset shift), weights and noise
    shift_key, _ = jax.random.split(key)
    env = FoldCloth3Env(B, conf=ClothConf(**TINY), device="cpu")
    _, state = env.reset_from_shift(np.asarray(jax.random.normal(shift_key, (2,)) * 0.05))
    tinit, tmin, _, _ = apg.build_apg(env, EP_LEN, LR, device="cpu", **opts)
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
               params0=[p.numpy() for p in params0], metrics=metrics, normalizer=ts.normalizer)
    return request.param, ref, out


def _rel(out, ref):
    return np.linalg.norm(out - ref) / np.linalg.norm(ref)


def test_minimize_loss_and_gradient_match_jax(one_minimize):
    _, ref, out = one_minimize
    np.testing.assert_allclose(out["loss"], ref["loss"], **TOL_LOSS)
    assert len(out["grad"]) == len(ref["grad"]) == 6
    for g, r in zip(out["grad"], ref["grad"]):
        assert g.shape == r.shape and np.any(r != 0)
        cos = np.sum(g.astype(np.float64) * r) / np.linalg.norm(g) / np.linalg.norm(r)
        assert cos >= GRAD_COS
        assert _rel(g, r) <= GRAD_REL_NORM
    g_norm = np.sqrt(sum(np.sum(np.square(r, dtype=np.float64)) for r in ref["grad"]))
    np.testing.assert_allclose(float(out["metrics"]["grad_norm"]), g_norm, rtol=GRAD_REL_NORM)


def test_minimize_clipped_gradient_matches_jax(one_minimize):
    (_, _, max_norm), ref, out = one_minimize
    for g, r in zip(out["clipped"], ref["clipped"]):
        assert _rel(g, r) <= GRAD_REL_NORM
    norm = np.sqrt(sum(np.sum(np.square(g, dtype=np.float64)) for g in out["clipped"]))
    raw = float(out["metrics"]["grad_norm"])
    np.testing.assert_allclose(norm, min(raw, max_norm), rtol=1e-5)


def test_minimize_adam_step_matches_jax(one_minimize):
    _, ref, out = one_minimize
    opt = optax.adam(LR)
    p0 = [jnp.asarray(p) for p in out["params0"]]
    updates, _ = opt.update([jnp.asarray(g) for g in out["clipped"]], opt.init(p0))
    for p, want in zip(out["params"], optax.apply_updates(p0, updates)):
        np.testing.assert_allclose(p, np.asarray(want), **TOL_ADAM)
    for p, r, g in zip(out["params"], ref["params"], ref["clipped"]):
        clear = np.abs(g) > CLEAR_OF_ROUNDING * np.abs(g).max()
        assert clear.sum() > 0
        np.testing.assert_allclose(p[clear], r[clear], rtol=0, atol=1e-3 * LR)
        assert np.abs(p - r).max() <= 2 * LR * (1 + 1e-3)


def test_minimize_normalizer_matches_jax(one_minimize):
    (_, normalize_obs, _), ref, out = one_minimize
    n = out["normalizer"]
    if not normalize_obs:
        assert float(n.count) == 0.0
        return
    assert float(n.count) == (1 + EP_LEN) * B  # the reset obs and each step's
    # the statistics of the rollout's states, which the two sides reach by
    # the same float32 operations in other orders: the means and m2 agree to
    # 3e-6 (positions ~0.4)
    jn = ref["normalizer"]
    np.testing.assert_allclose(n.mean.numpy(), np.asarray(jn.mean), rtol=0, atol=3e-5)
    np.testing.assert_allclose(n.m2.numpy(), np.asarray(jn.m2), rtol=1e-4, atol=3e-5)


@pytest.mark.parametrize("case", ["below", "above", "nonfinite"])
def test_gradient_pipeline_matches_jax(case):
    """nan_to_num then the global-norm clip, below and above the threshold
    and with NaN and inf leaves."""
    rng = np.random.default_rng(4)
    tree = {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": rng.standard_normal(5).astype(np.float32)}
    if case == "below":
        tree = {k: t * 1e-3 for k, t in tree.items()}
    if case == "nonfinite":
        tree["a"][0, 1], tree["a"][2, 2], tree["b"][3] = np.nan, np.inf, -np.inf
    max_norm = 0.3
    ref = jax_global_norm_clip(jax_nan_to_num_tree({k: jnp.asarray(t) for k, t in tree.items()}),
                               max_norm)
    out = global_norm_clip(nan_to_num_tree({k: torch.from_numpy(t) for k, t in tree.items()}),
                           max_norm)
    for k in tree:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=1e-6, atol=0)
        assert np.all(np.isfinite(out[k].numpy())) or case == "nonfinite"
    if case == "below":
        np.testing.assert_array_equal(out["a"].numpy(), tree["a"])


def test_update_normalizer_matches_jax():
    rng = np.random.default_rng(5)
    count, mean = np.float32(6.0), rng.standard_normal(8).astype(np.float32)
    m2 = rng.random(8).astype(np.float32) * 4
    obs = (rng.standard_normal((2, 5, 8)) * 3 + 1).astype(np.float32)
    jn = jax_update_normalizer(JaxNormalizerParams(jnp.asarray(count), jnp.asarray(mean),
                                                   jnp.asarray(m2)), jnp.asarray(obs))
    tn = update_normalizer(normalizer_from_jax(count, mean, m2, device="cpu"),
                           torch.from_numpy(obs))
    assert float(tn.count) == float(jn.count) == 16.0
    np.testing.assert_allclose(tn.mean.numpy(), np.asarray(jn.mean), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tn.m2.numpy(), np.asarray(jn.m2), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(normalize(tn, torch.from_numpy(obs)).numpy(),
                               np.asarray(jax_normalize(jn, jnp.asarray(obs))),
                               rtol=1e-5, atol=1e-5)


def test_train_writes_metrics_checkpoints_and_resumes(tmp_path):
    common = dict(env_name="fold_cloth3", episode_length=1, num_envs=2, eval_freq=1,
                  num_eval_envs=2, normalize_obs=True, env_kwargs={"conf": ClothConf(**TINY)},
                  device="cpu")
    ts, history = apg.train(max_it=1, logdir=str(tmp_path / "a"), **common)
    lines = [json.loads(x) for x in (tmp_path / "a" / "metrics.jsonl").read_text().splitlines()]
    assert [r["it"] for r in lines] == [0, 1] and lines == history
    for rec in lines:
        assert set(rec) == {"it", "train_reward", "grad_norm", "sps", "walltime"}
        assert all(np.isfinite(v) for v in rec.values())
        assert rec["sps"] > 0
    assert lines[0]["grad_norm"] > 0
    for name in ("apg_fold_cloth3_0.pt", "apg_fold_cloth3_1.pt", "apg_fold_cloth3_best.pt"):
        assert (tmp_path / "a" / name).is_file()

    # resume from the it-1 checkpoint: the new run's first checkpoint, written
    # before its first update, holds the same policy, optimizer and normalizer
    saved = torch.load(tmp_path / "a" / "apg_fold_cloth3_1.pt", weights_only=True)
    assert saved["it"] == 1 and saved["updates"] == 1
    assert float(saved["normalizer"]["count"]) == 2 * 2  # (1 + ep_len) x 2 envs, one update
    apg.train(max_it=0, logdir=str(tmp_path / "b"), resume=str(tmp_path / "a" / "apg_fold_cloth3_1.pt"),
              **common)
    again = torch.load(tmp_path / "b" / "apg_fold_cloth3_0.pt", weights_only=True)
    assert again["updates"] == saved["updates"]
    for k, t in saved["policy"].items():
        assert torch.equal(again["policy"][k], t)
    for k, t in saved["normalizer"].items():
        assert torch.equal(again["normalizer"][k], t)
    s_opt, a_opt = saved["optimizer"]["state"], again["optimizer"]["state"]
    assert s_opt.keys() == a_opt.keys() and len(s_opt) == 6
    for i in s_opt:
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(a_opt[i][k], s_opt[i][k])


def test_cli_maps_flags_to_train(monkeypatch):
    seen = {}
    monkeypatch.setattr(apg, "train", lambda **kw: seen.update(kw))
    apg.main(["--env", "fold_cloth3", "--ep_len", "3", "--num_envs", "1024", "--max_it", "3",
              "--max_grad_norm", "0.3", "--truncation_length", "2", "--device", "cpu",
              "--no_aux_reward", "--lr_decay"])
    assert seen["env_name"] == "fold_cloth3" and seen["episode_length"] == 3
    assert seen["num_envs"] == 1024 and seen["max_it"] == 3 and seen["device"] == "cpu"
    assert seen["truncation_length"] == 2 and seen["lr_decay"] and not seen["aux_reward"]
    apg.main([])
    assert seen["device"] == "cuda"


def test_lr_decay_is_optax_linear_schedule():
    env = FoldCloth3Env(1, conf=ClothConf(**TINY), device="cpu")
    _, minimize, _, _ = apg.build_apg(env, 1, learning_rate=1e-3, lr_decay_iters=10,
                                      device="cpu")
    schedule = optax.linear_schedule(init_value=1e-3, end_value=1e-5, transition_steps=10)
    for count in (0, 1, 5, 10, 20):
        np.testing.assert_allclose(minimize.debug["learning_rate_at"](count),
                                   float(schedule(count)), rtol=1e-6)


def test_entry_points_default_to_the_card():
    """No entry point runs on the CPU unless asked: without a GPU the default
    device raises (PyTorch's own error), with one everything lands on it."""
    conf = ClothConf(**TINY)
    defaults = [
        lambda: make_env("fold_cloth3", batch_size=2, conf=conf),
        lambda: PolicyMLP(20, 12),
        lambda: create_observation_normalizer(20),
        lambda: normalizer_from_jax(1.0, np.zeros(3), np.ones(3)),
    ]
    if torch.cuda.is_available():
        env = defaults[0]()
        assert env.device.type == "cuda" and env.simulator.link_code.is_cuda
        assert next(defaults[1]().parameters()).is_cuda
        assert defaults[2]().mean.is_cuda and defaults[3]().m2.is_cuda
    else:
        for make in defaults:
            with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
                make()
    env = make_env("fold_cloth3", batch_size=2, conf=conf, device="cpu")
    assert env.device.type == "cpu" and env.simulator.rest_len.device.type == "cpu"
    with pytest.raises(ValueError, match="build_apg was asked for cuda"):
        apg.build_apg(env, 1)  # the trainer's default device is the card
