"""The port's plain cloth robot step against the JAX package: the XLA oracle
(``ClothSimulator.step_batch``) and the Pallas kernel in interpret mode,
forward, gradients and the robot step's VJP (the backward kernel's plain
version), plus ``normalize_grad``.

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
from unidom_torch.engine.cloth import LINKS, ClothConf, ClothSimulator, ClothState
from unidom_torch.envs.cloth_tasks import _rect_mask, _tshirt_mask
from unidom_torch.ops.cuda import cloth_kernel
from unidom_torch.ops.cuda.cloth_kernel import (
    _check_cotangents,
    cloth_robot_step,
    cloth_robot_step_vjp,
    cloth_robot_step_vjp_plain,
)
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
        ClothConf(N=20, stiffness=900.0, n_substeps=10, gripper_radius=0.08), B, _mask(),
        device="cpu",
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
    before = cloth_robot_step.launches, cloth_robot_step.bwd_launches
    x = tstate.x.clone().requires_grad_()
    out = tsim.step_batch(tstate.replace(x=x), torch.from_numpy(action))
    out.x.sum().backward()  # torch autograd through the plain step
    assert x.grad is not None and torch.isfinite(x.grad).all()
    a0, a1 = tsim.prepare_actions(torch.from_numpy(action))
    inputs = (tstate.x, tstate.v, tstate.primitive0, tstate.primitive1, a0, a1,
              tstate.stiffness, tstate.mu)
    cot = [torch.ones_like(t) for t in inputs[:4]]
    with pytest.raises(ValueError, match="CUDA tensors only"):
        cloth_robot_step_vjp(tsim, inputs, cot)
    assert (cloth_robot_step.launches, cloth_robot_step.bwd_launches) == before


def test_kernel_wrapper_raises_off_cpu_and_cuda(setup):
    *_, tsim, tstate, action = setup
    meta = tstate.replace(x=tstate.x.to("meta"))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        cloth_robot_step(tsim, meta, torch.from_numpy(action))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        cloth_robot_step_vjp(tsim, (meta.x,), ())
    # the backward kernel's argument checks, on the cotangents of (x, v, ps0, ps1)
    good = [torch.zeros_like(t) for t in (tstate.x, tstate.v, tstate.primitive0, tstate.primitive1)]
    _check_cotangents(tsim, tstate.x, good)
    with pytest.raises(ValueError, match="cotangent of v has shape"):
        _check_cotangents(tsim, tstate.x, [good[0], good[1][:, :-1], *good[2:]])
    with pytest.raises(TypeError, match="cotangent of primitive1 has dtype"):
        _check_cotangents(tsim, tstate.x, [*good[:3], good[3].double()])


@pytest.fixture(scope="module")
def grads(setup):
    jsim, jstate, _, tsim, tstate, action = setup
    wx, wv, wp = 1.7, 0.3, 0.6  # loss: sum(x) wx + sum(v) wv + sum(ps0) + sum(ps1) wp

    def jax_loss(action, state):
        s, _ = jsim.step_batch(state, action)
        return (jnp.sum(s.x * wx) + jnp.sum(s.v * wv) + jnp.sum(s.primitive0)
                + jnp.sum(s.primitive1 * wp))

    g_action, g_state = jax.grad(jax_loss, argnums=(0, 1), allow_int=True)(
        jnp.asarray(action), jstate
    )
    jax_grads = {
        "action": g_action, "x": g_state.x, "v": g_state.v,
        "stiffness": g_state.stiffness, "mu": g_state.mu,
        "primitive0": g_state.primitive0, "primitive1": g_state.primitive1,
    }

    leaves = {
        "action": torch.from_numpy(action).requires_grad_(),
        "x": tstate.x.clone().requires_grad_(),
        "v": tstate.v.clone().requires_grad_(),
        "stiffness": tstate.stiffness.clone().requires_grad_(),
        "mu": tstate.mu.clone().requires_grad_(),
        "primitive0": tstate.primitive0.clone().requires_grad_(),
        "primitive1": tstate.primitive1.clone().requires_grad_(),
    }
    state = tstate.replace(x=leaves["x"], v=leaves["v"], stiffness=leaves["stiffness"],
                           mu=leaves["mu"], primitive0=leaves["primitive0"],
                           primitive1=leaves["primitive1"])
    s = tsim.step_batch(state, leaves["action"])
    (torch.sum(s.x * wx) + torch.sum(s.v * wv) + torch.sum(s.primitive0)
     + torch.sum(s.primitive1 * wp)).backward()
    torch_grads = {k: t.grad.numpy() for k, t in leaves.items()}
    return torch_grads, jax_grads


@pytest.mark.parametrize("wrt", ["action", "x", "v", "stiffness", "mu", "primitive0", "primitive1"])
def test_plain_step_grad_matches_oracle(grads, wrt):
    torch_grads, jax_grads = grads
    ref = np.asarray(jax_grads[wrt])
    assert np.all(np.isfinite(torch_grads[wrt]))
    assert np.any(ref != 0.0)
    atol = GRAD_ATOL_OF_MAX * np.abs(ref).max()
    np.testing.assert_allclose(torch_grads[wrt], ref, rtol=GRAD_RTOL, atol=atol)


VJP_OUTPUTS = ["x", "v", "primitive0", "primitive1", "action0", "action1", "stiffness", "mu"]


@pytest.fixture(scope="module")
def vjps(setup):
    """The robot step's VJP from the same inputs and random cotangents: the
    port's plain version, ``jax.vjp`` of the XLA oracle's substeps and of the
    Pallas kernel (its own ``bwd_call``, in interpret mode)."""
    jsim, jstate, kernel_step, tsim, tstate, action = setup
    rng = np.random.default_rng(1)
    cot = [rng.standard_normal(t.shape).astype(np.float32)
           for t in (tstate.x, tstate.v, tstate.primitive0, tstate.primitive1)]
    a0, a1 = tsim.prepare_actions(torch.from_numpy(action))
    inputs = (tstate.x, tstate.v, tstate.primitive0, tstate.primitive1, a0, a1,
              tstate.stiffness, tstate.mu)
    plain = cloth_robot_step_vjp_plain(tsim, inputs, [torch.from_numpy(c) for c in cot])
    plain = {n: g.numpy() for n, g in zip(VJP_OUTPUTS, plain)}

    def xla_substeps(*args):
        x, v, ps0, ps1, a0, a1, k, mu = args
        state = jstate._replace(x=x, v=v, primitive0=ps0, primitive1=ps1, action0=a0,
                                action1=a1, stiffness=k, mu=mu)

        def one(s):
            for _ in range(jsim.conf.n_substeps):
                s = jsim._substep(s)
            return s

        out = jax.vmap(one)(state)
        return out.x, out.v, out.primitive0, out.primitive1

    _, vjp = jax.vjp(xla_substeps, *[jnp.asarray(t.numpy()) for t in inputs])
    xla = dict(zip(VJP_OUTPUTS, (np.asarray(g) for g in vjp(tuple(jnp.asarray(c) for c in cot)))))

    packed, _ = kernel_step._pack(jstate, jnp.asarray(action))
    _, vjp = jax.vjp(kernel_step._core, packed)
    gx, gv = cot[0].reshape(B, -1, 3), cot[1].reshape(B, -1, 3)
    soa = tuple(jnp.asarray(g[:, :, c]) for g in (gx, gv) for c in range(3))
    (g,) = vjp(soa + (jnp.asarray(cot[2]), jnp.asarray(cot[3])))
    g = [np.asarray(t) for t in g]
    pallas = {
        "x": np.stack(g[0:3], -1).reshape(tstate.x.shape),
        "v": np.stack(g[3:6], -1).reshape(tstate.v.shape),
        "primitive0": g[6], "primitive1": g[7], "action0": g[8], "action1": g[9],
        "stiffness": g[10][:, 0], "mu": g[11][:, 0],
    }
    return plain, {"xla_oracle": xla, "pallas_interpret": pallas}


@pytest.mark.parametrize("reference", ["xla_oracle", "pallas_interpret"])
@pytest.mark.parametrize("output", VJP_OUTPUTS)
def test_vjp_plain_matches_jax(vjps, reference, output):
    """Every cotangent of the backward kernel's plain version against JAX,
    with the gradient tolerances above (the per-substep renormalisation makes
    every cotangent of x and v a unit vector divided by the particle count)."""
    plain, refs = vjps
    ref, out = refs[reference][output], plain[output]
    assert out.shape == ref.shape
    assert np.all(np.isfinite(out))
    if output != "action1":  # gripper 1 sits above the clip: its action gets nothing
        assert np.any(ref != 0.0)
    atol = GRAD_ATOL_OF_MAX * max(np.abs(ref).max(), 1e-30)
    np.testing.assert_allclose(out, ref, rtol=GRAD_RTOL, atol=atol)


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


# ---- the kernels' launch configuration and link codes (no card needed)

SMEM_PER_BLOCK = 232_448  # an H100 block's shared memory
TSHIRT_CONF = dict(N=180, stiffness=5000.0, dt=0.5e-3, mu=0.9)


def _border_mask():
    mask = np.zeros((80, 80), np.float32)
    mask[:32, :40] = 1.0  # the grid's corner: shortened diagonals, shared neighbours
    return mask


@pytest.fixture(scope="module")
def cloths():
    """Every cloth the port runs on the card: fold_cloth1/3's 16 x 32, the
    32 x 40 border cloth of chip_smoke.py and fold_tshirt's 72 x 78."""
    return {
        "fold_cloth3": ClothSimulator(ClothConf(), 1, _rect_mask(80, 16), device="cpu"),
        "border": ClothSimulator(ClothConf(), 1, _border_mask(), device="cpu"),
        "fold_tshirt": ClothSimulator(ClothConf(**TSHIRT_CONF), 1, _tshirt_mask(180),
                                      device="cpu"),
    }


@pytest.mark.parametrize("kind", ["fwd", "bwd"])
@pytest.mark.parametrize("cloth", ["fold_cloth3", "border", "fold_tshirt"])
def test_launch_config_fits_a_block(cloths, cloth, kind):
    sim = cloths[cloth]
    hw = sim.H * sim.W
    cfg = cloth_kernel.launch_config(sim.H, sim.W, sim.conf.n_substeps, kind)
    assert cfg.smem + cfg.static_smem <= SMEM_PER_BLOCK
    assert cfg.threads <= 1024 and cfg.threads % 32 == 0
    assert (cfg.threads, cfg.regs) in cloth_kernel.VARIANTS
    assert cfg.threads * cfg.slots >= hw > cfg.threads * (cfg.slots - 1)
    assert cfg.scratch == (max(cfg.slots - cfg.regs, 0) * cloth_kernel.SCRATCH_FLOATS[kind]
                           * cfg.threads)
    # shared memory holds x twice (and, backward, the neighbour terms), 12 B
    # per cell each, plus the backward's gripper states per substep
    planes = 6 if kind == "fwd" else 9
    extra = 0 if kind == "fwd" else 32 * sim.conf.n_substeps
    assert cfg.smem == 4 * planes * cfg.hw_padded + extra
    if cloth == "fold_cloth3":  # the main path: every particle in registers
        assert cfg.scratch == 0


@pytest.mark.parametrize("kind,side", [("fwd", 100), ("bwd", 80)])
def test_oversized_cloth_raises_before_launch(monkeypatch, kind, side):
    """A cloth whose block would exceed shared memory raises in Python,
    naming its size, before the library is built or loaded: 100 x 100 cells
    for the forward (240,000 B), 80 x 80 for the backward only."""
    N = max(side, 80)
    mask = np.zeros((N, N), np.float32)
    mask[:side, :side] = 1.0
    sim = ClothSimulator(ClothConf(N=N), 1, mask, device="cpu")
    if kind == "bwd":
        cloth_kernel.launch_config(side, side, sim.conf.n_substeps, "fwd")  # fits
    monkeypatch.setattr(cloth_kernel, "_lib", lambda: pytest.fail("the library was loaded"))
    s = sim.reset()
    a0, a1 = sim.prepare_actions(torch.zeros(1, 8))
    inputs = (s.x, s.v, s.primitive0, s.primitive1, a0, a1, s.stiffness, s.mu)
    match = rf"{side} x {side} = {side * side} bbox cells .* bytes .* {kind} kernel .* {SMEM_PER_BLOCK}"
    with pytest.raises(ValueError, match=match):
        if kind == "fwd":
            cloth_kernel._launch_fwd(sim, inputs)
        else:
            cloth_kernel._launch_bwd(sim, inputs, [torch.zeros_like(t) for t in inputs[:4]])


@pytest.mark.parametrize("hw", [(16, 32), (32, 40), (72, 78), (3, 5), (7, 7)])
def test_history_stride_is_16_byte_aligned(hw):
    """The backward's history per substep, and the x slice its bulk copy
    moves into shared memory, are multiples of 16 bytes."""
    cfg = cloth_kernel.launch_config(*hw, 50, "bwd")
    assert cfg.hw_padded % 4 == 0 and cfg.hw_padded >= hw[0] * hw[1]
    assert (4 * cfg.hist_stride) % 16 == 0
    assert (12 * cfg.hw_padded) % 16 == 0
    assert cfg.hist_stride == cloth_kernel.HIST_PLANES * cfg.hw_padded


@pytest.mark.parametrize("cloth", ["fold_cloth3", "border", "fold_tshirt"])
def test_link_code_decodes_to_the_plain_links(cloths, cloth):
    """Each cell's packed code gives back the plain step's springs: which
    links are valid, their rest lengths, and their neighbours as the plain
    step's edge padding finds them."""
    sim = cloths[cloth]
    H, W = sim.H, sim.W
    code = sim.link_code.numpy().view(np.uint32)
    valid = sim.nbr_valid.numpy().reshape(H * W, 8).T > 0
    rest = sim.rest_len.numpy().reshape(H * W, 8).T
    i, j = np.divmod(np.arange(H * W), W)
    for l, (di, dj) in enumerate(LINKS):
        nibble = ((code >> (4 * l)) & 15).astype(np.int64)
        on = nibble != 5
        np.testing.assert_array_equal(on, valid[l], err_msg=f"link {l}")
        ei, ej = nibble[on] // 4 - 1, nibble[on] % 4 - 1
        diag = (ei != 0) & (ej != 0)
        np.testing.assert_array_equal(np.asarray(sim.rest_lengths, np.float32)[diag.astype(int)],
                                      rest[l][on], err_msg=f"link {l}")
        q = (i[on] + ei) * W + j[on] + ej
        padded = np.clip(i[on] + di, 0, H - 1) * W + np.clip(j[on] + dj, 0, W - 1)
        np.testing.assert_array_equal(q, padded, err_msg=f"link {l}")
    if cloth == "border":  # a shortened diagonal at the grid's corner stays a spring
        assert (((code >> 20) & 15) == 9).any()
