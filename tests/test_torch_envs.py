"""The port's env layer, metrics and models against ``unidom_tpu`` on the
CPU: macro-action expansion, observations, chamfer (dense and chunked),
reset, and the policy weights carried over from flax."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import unidom_tpu.ops.metrics as jax_metrics
from unidom_tpu.engine.cloth import ClothConf as JaxClothConf
from unidom_tpu.envs.base_cloth import ClothEnv as JaxClothEnv
from unidom_tpu.envs.cloth_tasks import FoldCloth3Env as JaxFoldCloth3Env
from unidom_tpu.models.distribution import NormalTanhDistribution as JaxNormalTanh
from unidom_tpu.models.mlp import make_policy_model
from unidom_tpu.models.normalizer import NormalizerParams as JaxNormalizerParams
from unidom_tpu.models.normalizer import normalize as jax_normalize
from unidom_torch import make_env
from unidom_torch.engine.cloth import ClothConf, ClothState
from unidom_torch.envs.base_cloth import ClothEnv
from unidom_torch.envs.cloth_tasks import FoldCloth3Env, goal_path
from unidom_torch.models.distribution import NormalTanhDistribution
from unidom_torch.models.mlp import PolicyMLP
from unidom_torch.models.normalizer import normalize
from unidom_torch.ops import metrics
from unidom_torch.utils.convert import normalizer_from_jax, policy_from_jax

torch.set_num_threads(1)

SMALL = dict(N=40, n_substeps=10, gripper_radius=0.04, goal_path=goal_path("fold_cloth3"),
             task="fold_cloth3")


def _to_torch(jstate):
    fields = ClothState.__dataclass_fields__
    return ClothState(**{f: torch.from_numpy(np.array(getattr(jstate, f))) for f in fields})


def test_fold_cloth3_full_width_contract():
    env = make_env("fold_cloth3", batch_size=2, device="cpu")
    assert env.n_particles == 512
    assert env.observation_size == 1544
    assert (env.simulator.H, env.simulator.W) == (16, 32)
    assert env.max_steps == 4
    assert tuple(env.goal.shape) == (512, 3)


@pytest.fixture(scope="module")
def envs3():
    """B=3 JAX and torch envs in the same perturbed state."""
    jenv = JaxFoldCloth3Env(3, conf=JaxClothConf(**SMALL))
    tenv = FoldCloth3Env(3, conf=ClothConf(**SMALL), device="cpu")
    rng = np.random.default_rng(7)
    _, jstate = jenv.reset(jax.random.PRNGKey(0))
    x = np.asarray(jstate.x) + 0.01 * rng.standard_normal(jstate.x.shape).astype(np.float32)
    ps0 = rng.random((3, 4)).astype(np.float32)
    ps1 = rng.random((3, 4)).astype(np.float32)
    jstate = jstate._replace(x=jnp.asarray(x), primitive0=jnp.asarray(ps0),
                             primitive1=jnp.asarray(ps1))
    return jenv, jstate, tenv, _to_torch(jstate)


def test_get_pnp_actions_matches_jax(envs3):
    jenv, jstate, tenv, tstate = envs3
    actions = np.random.default_rng(8).random((3, 6)).astype(np.float32)
    ref = JaxClothEnv.get_pnp_actions(jnp.asarray(actions), jstate)
    out = ClothEnv.get_pnp_actions(torch.from_numpy(actions), tstate)
    assert tuple(out.shape) == (40, 3, 8)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-7)


def test_get_obs_matches_jax(envs3):
    jenv, jstate, tenv, tstate = envs3
    out = tenv.get_obs(tstate)
    assert tuple(out.shape) == (3, tenv.observation_size)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jenv.get_obs(jstate)))
    np.testing.assert_array_equal(tenv.packed_x(tstate).numpy(), np.asarray(jenv.packed_x(jstate)))


def test_reset_with_the_same_shift_gives_the_same_state():
    jenv = JaxFoldCloth3Env(2, conf=JaxClothConf(**SMALL))
    tenv = FoldCloth3Env(2, conf=ClothConf(**SMALL), device="cpu")
    key = jax.random.PRNGKey(4)
    jobs, jstate = jenv.reset(key)
    shift_key, _ = jax.random.split(key)
    shift = np.asarray(jax.random.normal(shift_key, (2,)) * 0.05)
    tobs, tstate = tenv.reset_from_shift(shift)
    for f in ClothState.__dataclass_fields__:
        np.testing.assert_array_equal(getattr(tstate, f).numpy(), np.asarray(getattr(jstate, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs))
    _, drawn = tenv.reset(torch.Generator().manual_seed(0))
    assert not torch.equal(drawn.x, tstate.x)
    _, default = tenv.reset()  # a generator seeded with conf.seed
    assert torch.equal(default.x, tenv.reset(torch.Generator().manual_seed(tenv.conf.seed))[1].x)


def test_pack_unpack_match_jax(envs3):
    jenv, jstate, tenv, tstate = envs3
    jsim, tsim = jenv.simulator, tenv.simulator
    packed = tsim.pack(tstate.x)
    fill = torch.full_like(tstate.x, -1.0)
    dense = tsim.unpack(packed, fill)
    ref = jsim.unpack(jnp.asarray(packed[1].numpy()), jnp.asarray(fill[1].numpy()))
    np.testing.assert_array_equal(dense[1].numpy(), np.asarray(ref))
    np.testing.assert_array_equal(tsim.pack(dense).numpy(), packed.numpy())


def test_random_fold_action_picks_two_cloth_particles(envs3):
    *_, tenv, tstate = envs3
    actions = tenv.get_random_fold_action(tstate, torch.Generator().manual_seed(0))
    assert tuple(actions.shape) == (3, 6)
    px = tenv.packed_x(tstate)
    for b in range(3):
        for half in (actions[b, :3], actions[b, 3:]):
            assert bool((px[b] == half).all(-1).any())


def _chamfer_inputs(B, Nx, Ny):
    rng = np.random.default_rng(11)
    return (rng.random((B, Nx, 3)).astype(np.float32) * 0.5 + 0.25,
            rng.random((Ny, 3)).astype(np.float32) * 0.5 + 0.25)


# float32 Gram expansion on both sides; sums in another order
TOL_CHAMFER = dict(rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("branch", ["dense", "chunked"])
def test_chamfer_matches_jax(branch, monkeypatch):
    x, goal = _chamfer_inputs(3, 256, 200)
    if branch == "chunked":  # lower both packages' limit to force the chunk loop
        monkeypatch.setattr(jax_metrics, "_CHAMFER_DENSE_LIMIT", 0)
        monkeypatch.setattr(metrics, "CHAMFER_DENSE_LIMIT", 0)
    ref = jax_metrics.chamfer(jnp.asarray(x), jnp.asarray(goal))
    out = metrics.chamfer(torch.from_numpy(x), torch.from_numpy(goal))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL_CHAMFER)


def test_chamfer_chunked_equals_dense():
    x, goal = _chamfer_inputs(2, 384, 512)
    x, goal = torch.from_numpy(x), torch.from_numpy(goal)
    np.testing.assert_allclose(metrics._chamfer_chunked(x, goal).numpy(),
                               metrics._chamfer_dense(x, goal).numpy(), **TOL_CHAMFER)


@pytest.fixture(scope="module")
def flax_policy():
    model = make_policy_model(12, 1544)
    params = model.init(jax.random.PRNGKey(0))
    return model, params, policy_from_jax(jax.device_get(params), device="cpu")


def test_policy_from_jax_round_trips(flax_policy):
    model, params, policy = flax_policy
    obs = np.random.default_rng(1).standard_normal((5, 1544)).astype(np.float32)
    ref = model.apply(params, jnp.asarray(obs))
    with torch.no_grad():
        out = policy(torch.from_numpy(obs))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


def test_policy_init_matches_flax_dense_init(flax_policy):
    """LeCun-normal kernels truncated at 2 std, zero biases, as flax draws them."""
    _, params, _ = flax_policy
    policy = PolicyMLP(1544, 12, generator=torch.Generator().manual_seed(0), device="cpu")
    for i, layer in enumerate(policy.layers):
        ref = np.asarray(params["params"][f"dense_{i}"]["kernel"])
        w = layer.weight.detach().numpy()
        assert w.shape == ref.T.shape
        np.testing.assert_allclose(w.std(), ref.std(), rtol=0.05)
        assert np.abs(w).max() <= 2.0 * ref.std() / 0.8796 * 1.06
        assert not layer.bias.detach().any()


def test_distribution_matches_jax(flax_policy):
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((4, 12)).astype(np.float32)
    eps = rng.standard_normal((4, 6)).astype(np.float32)
    jdist, tdist = JaxNormalTanh(6), NormalTanhDistribution(6)
    loc, scale = jdist._loc_scale(jnp.asarray(logits))
    np.testing.assert_allclose(tdist.mode(torch.from_numpy(logits)).numpy(),
                               np.asarray(jdist.mode(jnp.asarray(logits))), rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        tdist.sample_from_eps(torch.from_numpy(logits), torch.from_numpy(eps)).numpy(),
        np.asarray(jnp.tanh(loc + scale * eps)), rtol=0, atol=1e-6,
    )
    sample = tdist.sample(torch.from_numpy(logits), torch.Generator().manual_seed(0))
    assert sample.shape == (4, 6) and bool((sample.abs() < 1).all())


def test_normalizer_from_jax_matches_jax_normalize():
    rng = np.random.default_rng(3)
    count, mean = np.float32(17.0), rng.standard_normal(8).astype(np.float32)
    m2 = rng.random(8).astype(np.float32) * 5
    obs = rng.standard_normal((3, 8)).astype(np.float32)
    ref = jax_normalize(JaxNormalizerParams(jnp.asarray(count), jnp.asarray(mean),
                                            jnp.asarray(m2)), jnp.asarray(obs))
    out = normalize(normalizer_from_jax(count, mean, m2, device="cpu"), torch.from_numpy(obs))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
