"""The port's plain cloth robot step against the JAX package: the XLA oracle
(``ClothSimulator.step_batch``) and the Pallas kernel in interpret mode,
forward and gradients, plus ``normalize_grad``.

Inputs are made with numpy from a seed and handed to both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unidom_tpu.engine.cloth import ClothConf as JaxClothConf
from unidom_tpu.engine.cloth import ClothSimulator as JaxClothSimulator
from unidom_tpu.ops.gradops import normalize_grad as jax_normalize_grad
from unidom_tpu.ops.pallas.cloth_kernel import build_cloth_robot_step_kernel
from unidom_torch.engine.cloth import ClothConf, ClothSimulator, ClothState
from unidom_torch.ops.cuda.cloth_kernel import _ClothRobotStepFn, cloth_robot_step
from unidom_torch.ops.gradops import normalize_grad

torch.set_num_threads(1)

B = 8
# per-step tolerances of tests/test_pallas_cloth.py: one robot step of 10
# substeps in float32, same operations in the same order up to rounding
TOL_X = dict(rtol=1e-4, atol=1e-5)
TOL_V = dict(rtol=1e-4, atol=1e-4)
TOL_PS = dict(rtol=0, atol=1e-6)
# Gradients through 10 substeps with per-substep renormalisation: rtol of
# tests/test_pallas_cloth.py, and an atol scaled to the gradient's largest
# entry, because entries near the ground-friction switch are ill-conditioned
# in float32: against a float64 run of the same step, the torch and the JAX
# float32 gradients are each off by up to 3e-4 of the largest x entry.
GRAD_RTOL = 2e-3
GRAD_ATOL_OF_MAX = 1e-3


def identity_collision(x, v, idx_i, idx_j):
    return v


def _mask():
    mask = np.zeros((20, 20), np.float32)
    mask[8:12, 6:14] = 1.0  # 4 x 8 cloth
    return mask


def _to_torch(jstate):
    fields = ClothState.__dataclass_fields__
    return ClothState(**{f: torch.from_numpy(np.array(getattr(jstate, f))) for f in fields})


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    jsim = JaxClothSimulator(
        JaxClothConf(N=20, stiffness=900.0, mem_saving_level=0, n_substeps=10, gripper_radius=0.08),
        batch_size=B, collision_func=identity_collision, cloth_mask=_mask(),
    )
    jstate = jsim.reset()
    v = (rng.standard_normal(jstate.v.shape) * 0.3).astype(np.float32)
    # gripper 0 on the cloth's first particle
    ps0 = np.tile(np.append(np.asarray(jstate.x[0, 0, 0]), 0.08), (B, 1)).astype(np.float32)
    stiffness = (900.0 * (1.0 + 0.2 * rng.random(B))).astype(np.float32)
    mu = (0.5 * (1.0 + rng.random(B))).astype(np.float32)
    jstate = jstate._replace(
        v=jnp.asarray(v), primitive0=jnp.asarray(ps0),
        stiffness=jnp.asarray(stiffness), mu=jnp.asarray(mu),
    )
    action = np.zeros((B, 8), np.float32)
    action[:, 0] = 0.8
    action[:, 1] = 1.5
    action[:, 3] = 0.0  # suction engaged
    action[:, 4:7] = 0.1
    action[:, :3] += 0.05 * rng.standard_normal((B, 3)).astype(np.float32)

    tsim = ClothSimulator(
        ClothConf(N=20, stiffness=900.0, n_substeps=10, gripper_radius=0.08), B, _mask()
    )
    tstate = _to_torch(jstate)
    kernel_step = build_cloth_robot_step_kernel(jsim, interpret=True)
    return jsim, jstate, kernel_step, tsim, tstate, action


def _assert_state_close(out, ref):
    np.testing.assert_allclose(out.x.numpy(), np.asarray(ref.x), **TOL_X)
    np.testing.assert_allclose(out.v.numpy(), np.asarray(ref.v), **TOL_V)
    np.testing.assert_allclose(out.primitive0.numpy(), np.asarray(ref.primitive0), **TOL_PS)
    np.testing.assert_allclose(out.primitive1.numpy(), np.asarray(ref.primitive1), **TOL_PS)
    np.testing.assert_allclose(out.action0.numpy(), np.asarray(ref.action0), rtol=0, atol=1e-7)
    np.testing.assert_allclose(out.action1.numpy(), np.asarray(ref.action1), rtol=0, atol=1e-7)


@pytest.mark.parametrize("reference", ["xla_oracle", "pallas_interpret"])
def test_plain_step_matches_jax(setup, reference):
    jsim, jstate, kernel_step, tsim, tstate, action = setup
    step = jsim.step_batch if reference == "xla_oracle" else kernel_step
    ref, _ = step(jstate, jnp.asarray(action))
    out = tsim.step_batch(tstate, torch.from_numpy(action))
    _assert_state_close(out, ref)


def test_two_steps_match_oracle(setup):
    jsim, jstate, _, tsim, tstate, action = setup
    ref, _ = jsim.step_batch(jstate, jnp.asarray(action))
    ref, _ = jsim.step_batch(ref, jnp.asarray(action))
    out = tsim.step_batch(tstate, torch.from_numpy(action))
    out = tsim.step_batch(out, torch.from_numpy(action))
    np.testing.assert_allclose(out.x.numpy(), np.asarray(ref.x), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out.primitive0.numpy(), np.asarray(ref.primitive0), **TOL_PS)


def test_cpu_step_launches_no_kernel(setup):
    *_, tsim, tstate, action = setup
    before = cloth_robot_step.launches
    tsim.step_batch(tstate, torch.from_numpy(action))
    assert cloth_robot_step.launches == before


def test_kernel_wrapper_raises_off_cpu_and_cuda(setup):
    *_, tsim, tstate, action = setup
    meta = tstate.replace(x=tstate.x.to("meta"))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        cloth_robot_step(tsim, meta, torch.from_numpy(action))
    with pytest.raises(NotImplementedError):
        _ClothRobotStepFn.backward(None, None)


@pytest.fixture(scope="module")
def grads(setup):
    jsim, jstate, _, tsim, tstate, action = setup
    wx, wv = 1.7, 0.3  # loss: sum(x) * wx + sum(v) * wv + sum(primitive0)

    def jax_loss(action, state):
        s, _ = jsim.step_batch(state, action)
        return jnp.sum(s.x * wx) + jnp.sum(s.v * wv) + jnp.sum(s.primitive0)

    g_action, g_state = jax.grad(jax_loss, argnums=(0, 1), allow_int=True)(
        jnp.asarray(action), jstate
    )
    jax_grads = {
        "action": g_action, "x": g_state.x, "v": g_state.v,
        "stiffness": g_state.stiffness, "mu": g_state.mu,
    }

    leaves = {
        "action": torch.from_numpy(action).requires_grad_(),
        "x": tstate.x.clone().requires_grad_(),
        "v": tstate.v.clone().requires_grad_(),
        "stiffness": tstate.stiffness.clone().requires_grad_(),
        "mu": tstate.mu.clone().requires_grad_(),
    }
    state = tstate.replace(x=leaves["x"], v=leaves["v"], stiffness=leaves["stiffness"],
                           mu=leaves["mu"])
    s = tsim.step_batch(state, leaves["action"])
    (torch.sum(s.x * wx) + torch.sum(s.v * wv) + torch.sum(s.primitive0)).backward()
    torch_grads = {k: t.grad.numpy() for k, t in leaves.items()}
    return torch_grads, jax_grads


@pytest.mark.parametrize("wrt", ["action", "x", "v", "stiffness", "mu"])
def test_plain_step_grad_matches_oracle(grads, wrt):
    torch_grads, jax_grads = grads
    ref = np.asarray(jax_grads[wrt])
    assert np.all(np.isfinite(torch_grads[wrt]))
    assert np.any(ref != 0.0)
    atol = GRAD_ATOL_OF_MAX * np.abs(ref).max()
    np.testing.assert_allclose(torch_grads[wrt], ref, rtol=GRAD_RTOL, atol=atol)


@pytest.mark.parametrize("batched", [False, True])
def test_normalize_grad_matches_jax(batched):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 5, 6, 3)).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    if batched:
        g[1] = 0.0  # zero cotangent: 0/0 -> nan -> 0
    scale = 32.0
    jfn = jax_normalize_grad(scale)
    if batched:
        _, vjp = jax.vjp(jax.vmap(jfn), jnp.asarray(x))
    else:
        _, vjp = jax.vjp(jfn, jnp.asarray(x))
    (ref,) = vjp(jnp.asarray(g))

    xt = torch.from_numpy(x).requires_grad_()
    out = normalize_grad(xt, scale, batch_dims=1 if batched else 0)
    np.testing.assert_array_equal(out.detach().numpy(), x)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-9)
