"""The port's whip_rope APG training against ``unidom_tpu`` on the CPU: one
``minimize`` from the same first state, policy weights and sampling noise
(loss, every gradient leaf, the clipped gradient, the parameters after
Adam), truncation on an MPM state, ``reset_batch``'s ``auto_reset`` and
``host_reset`` arms, ``train`` drawing a fresh reset per iteration, the
CLI, and where a gradient under collision goes on CUDA. On grad_test's
small whip_rope (a 32-grid with a 16^3 focus region, 8 substeps), where the
plain macro step runs in a fraction of a second."""

import dataclasses
import functools
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from unidom_tpu.algorithms.apg import build_apg as jax_build_apg
from unidom_tpu.engine.mpm import MPMConf as JaxMPMConf
from unidom_tpu.envs.mpm_tasks import WhipRopeEnv as JaxWhipRopeEnv
from unidom_tpu.ops.gradops import global_norm_clip as jax_global_norm_clip
from unidom_tpu.ops.gradops import nan_to_num_tree as jax_nan_to_num_tree
from unidom_tpu.parallel.mesh import make_env_mesh
from unidom_torch.algorithms import apg
from unidom_torch.envs import registration
from unidom_torch.envs.mpm_tasks import GRAD_TEST_CONF, WhipRopeEnv
from unidom_torch.ops.gradops import tree_flatten
from unidom_torch.utils.convert import mpm_state_from_jax, policy_from_jax

torch.set_num_threads(1)

B, EP_LEN, LR, MAX_NORM = 4, 2, 1e-4, 0.3
# Tolerances of one minimize: two macro steps of 8 substeps in float32 on
# both sides, the same operations summed in other orders (the port's P2G
# adds with index_add_ or tensor contractions, JAX's with its own), then the
# policy's backward. The losses agree to ~1e-7 relative and the gradient
# leaves to ~1e-5 in relative norm; the bounds keep 10x of headroom.
TOL_LOSS = dict(rtol=1e-6, atol=0)
GRAD_REL_NORM = 1e-4
# Adam's first step: as tests/test_torch_train.py holds it
TOL_ADAM = dict(rtol=0, atol=2e-8)
CLEAR_OF_ROUNDING = 1e-2


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


@pytest.fixture(scope="module")
def one_minimize():
    jenv = JaxWhipRopeEnv(batch_size=B, seed=1,
                          conf=JaxMPMConf(**dataclasses.asdict(GRAD_TEST_CONF)))
    jenv.reset(jax.random.PRNGKey(0))  # sizes the JAX env's observation, as its train() does
    init_ts, jmin, jreset_batch, _ = jax_build_apg(jenv, EP_LEN, LR, max_gradient_norm=MAX_NORM,
                                                   mesh=make_env_mesh(1))
    jts = init_ts(0)
    jstate = jax.device_get(jreset_batch(jax.random.PRNGKey(3)))
    noise = _jax_noise(jts.key, EP_LEN)
    _, key_grad = jax.random.split(jts.key)
    jgrad, (jrewards, _, _) = jmin.debug["loss_grad"](
        jts.policy_params, jts.normalizer_params, jstate, key_grad)
    jgrad = jax_nan_to_num_tree(jgrad)
    jclipped = jax_global_norm_clip(jgrad, MAX_NORM)
    updates, _ = jmin.debug["optimizer"].update(jclipped, jts.optimizer_state)
    jparams = optax.apply_updates(jts.policy_params, updates)
    ref = dict(loss=-float(np.mean(np.asarray(jrewards))), grad=_leaves(jgrad),
               clipped=_leaves(jclipped), params=_leaves(jparams))

    # the port: the same first state, weights and noise
    env = WhipRopeEnv(B, seed=1, conf=GRAD_TEST_CONF, device="cpu")
    state = mpm_state_from_jax(jstate, device="cpu")
    tinit, tmin, _, _ = apg.build_apg(env, EP_LEN, LR, max_gradient_norm=MAX_NORM, device="cpu")
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


def _rel(out, ref):
    return np.linalg.norm(out - ref) / np.linalg.norm(ref)


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
    norm = np.sqrt(sum(np.sum(np.square(g, dtype=np.float64)) for g in out["clipped"]))
    np.testing.assert_allclose(norm, min(float(out["metrics"]["grad_norm"]), MAX_NORM), rtol=1e-5)
    opt = optax.adam(LR)
    p0 = [jnp.asarray(p) for p in out["params0"]]
    updates, _ = opt.update([jnp.asarray(g) for g in out["clipped"]], opt.init(p0))
    for p, want in zip(out["params"], optax.apply_updates(p0, updates)):
        np.testing.assert_allclose(p, np.asarray(want), **TOL_ADAM)
    for p, r, g in zip(out["params"], ref["params"], ref["clipped"]):
        clear = np.abs(g) > CLEAR_OF_ROUNDING * np.abs(g).max()
        assert clear.sum() > 0
        np.testing.assert_allclose(p[clear], r[clear], rtol=0, atol=1e-3 * LR)


def _small_env(batch=2, max_steps=70):
    return WhipRopeEnv(batch, seed=1, max_steps=max_steps, conf=GRAD_TEST_CONF, device="cpu")


def test_stop_gradient_detaches_an_mpm_state():
    env = _small_env()
    state = env.reset(torch.Generator().manual_seed(0))[1]
    leaves, rebuild = tree_flatten(state)
    needy = rebuild([t.float().requires_grad_() if t.is_floating_point() else t for t in leaves])
    out = apg._stop_gradient(needy)
    assert isinstance(out.primitives, tuple) and len(out.primitives) == 1
    out_leaves = tree_flatten(out)[0]
    assert len(out_leaves) == len(leaves)
    assert not any(t.requires_grad for t in out_leaves)
    for a, b in zip(out_leaves, leaves):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_truncated_minimize_on_whip_rope():
    """Truncation after every macro step: the loss's gradient reaches the
    policy only through each step's own action, and stays finite."""
    env = _small_env()
    s0 = env.reset(torch.Generator().manual_seed(0))[1]
    init_ts, minimize, _, _ = apg.build_apg(env, 2, truncation_length=1, device="cpu")
    ts = init_ts(0)
    eps = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 2, 6)).astype(np.float32))
    _, grad_t, (_, states) = minimize.debug["loss_grad"](ts, s0, eps)
    assert not any(t.requires_grad for t in tree_flatten(states[0])[0])
    assert all(torch.isfinite(g).all() for g in grad_t)
    ts, metrics = minimize(ts, s0, eps)
    assert float(metrics["grad_norm"]) > 0


def test_reset_batch_auto_reset_and_host_reset_arms():
    env = _small_env()
    _, _, reset_batch, _ = apg.build_apg(env, 1, device="cpu")
    state = reset_batch(torch.Generator().manual_seed(5))
    want = env.auto_reset(env.init_state, torch.Generator().manual_seed(5))
    for a, b in zip(tree_flatten(state)[0], tree_flatten(want)[0]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(state.x, env.init_state.x)  # shifted
    # a host_reset env's first state is its reset's
    env.reset_mode = "host_reset"
    state = reset_batch(torch.Generator().manual_seed(5))
    want = env.reset(torch.Generator().manual_seed(5))[1]
    for a, b in zip(tree_flatten(state)[0], tree_flatten(want)[0]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    env.reset_mode = "unknown"
    with pytest.raises(NotImplementedError, match="unknown"):
        reset_batch(torch.Generator().manual_seed(5))


def _recording_build_apg(firsts):
    build = apg.build_apg

    def wrapper(*args, **kwargs):
        init_ts, minimize, reset_batch, run_eval = build(*args, **kwargs)

        def recording(generator=None):
            state = reset_batch(generator)
            firsts.append(state.x.clone())
            return state

        return init_ts, minimize, recording, run_eval

    return wrapper


def test_train_draws_a_fresh_whip_rope_reset_each_iteration(tmp_path, monkeypatch):
    firsts = []
    monkeypatch.setattr(apg, "build_apg", _recording_build_apg(firsts))
    _, history = apg.train("whip_rope", 1, 2, max_it=1, eval_freq=100, num_eval_envs=2,
                           logdir=str(tmp_path), device="cpu",
                           env_kwargs=dict(conf=GRAD_TEST_CONF, max_steps=2))
    assert len(firsts) == 2 and len(history) == 2
    assert not torch.equal(firsts[0], firsts[1])
    assert all(np.isfinite(r["grad_norm"]) and r["grad_norm"] > 0 for r in history)


def test_cli_trains_whip_rope_on_the_cpu(tmp_path, monkeypatch):
    """``--env whip_rope --device cpu``, with the registry's whip_rope cut to
    grad_test's conf and 2 macro steps per episode."""
    monkeypatch.setitem(registration.env_functions, "whip_rope",
                        functools.partial(WhipRopeEnv, conf=GRAD_TEST_CONF, max_steps=2))
    apg.main(["--env", "whip_rope", "--ep_len", "1", "--num_envs", "2", "--max_it", "1",
              "--num_eval_envs", "2", "--eval_freq", "1", "--device", "cpu",
              "--logdir", str(tmp_path)])
    recs = [json.loads(line) for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["it"] for r in recs] == [0, 1]
    assert all(np.isfinite(r["train_reward"]) and r["grad_norm"] > 0 for r in recs)
    assert (tmp_path / "apg_whip_rope_best.pt").exists()


def test_gradient_request_under_collision_on_cuda_reaches_the_backward_kernel(monkeypatch):
    """On CUDA tensors a gradient under SDF collision goes to the
    differentiable kernel step (K2-fwd with checkpoints, K2-bwd with
    collide's adjoint in the backward), as under position control (a
    stand-in state reports a CUDA device; a recorder stands in for the
    kernel step)."""
    from unidom_torch.engine.mpm import ELASTIC, MPMSimulator
    from unidom_torch.ops.cuda import mpm_kernel

    sim = MPMSimulator(GRAD_TEST_CONF, 2, use_position_control=False, device="cpu")
    sim.sdf_names = ["box"]
    sim.material = np.full(4, ELASTIC)
    prepared = object()
    monkeypatch.setattr(sim, "prepare", lambda s, a: prepared)
    calls = []
    monkeypatch.setattr(mpm_kernel, "kernel_step", lambda *a: calls.append(a) or "step")
    state = types.SimpleNamespace(x=types.SimpleNamespace(device=torch.device("cuda", 0),
                                                          shape=(2, 4, 3)))
    action = torch.zeros(2, 6, requires_grad=True)
    assert mpm_kernel.mpm_step(sim, state, action) == "step"
    assert mpm_kernel.mpm_step(sim, state, action, ckpt_stride=12) == "step"
    assert calls == [(sim, prepared, None), (sim, prepared, 12)]
