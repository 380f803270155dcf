"""The port's MPM gradients against ``unidom_tpu`` on the CPU: the 3x3 SVD's
degenerate-safe backward, ``scrub_grad``, the plain macro step's VJP (the
MPM backward kernel's plain version) against ``jax.vjp`` of the JAX oracle
step under position control and collision, over the four materials and both
transfers, the same on whip_rope's scene, and whip_rope's ``grad_test``;
and K2-fwd's and K2-bwd's launch sizing (``fwd_launch_config``,
``launch_config``), which refuses in Python a configuration beyond the
card.
Inputs and cotangents are made with numpy from a seed and fed to both
sides."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unidom_tpu.engine import mpm as jmpm
from unidom_tpu.engine import primitives as jprim
from unidom_tpu.envs.mpm_tasks import WhipRopeEnv as JaxWhipRopeEnv
from unidom_tpu.ops import gradops as jgradops
from unidom_tpu.ops.svd3 import svd3 as jax_svd3
from unidom_torch.engine.mpm import ELASTIC, PLASTIC_CLIP, VON_MISES, WATER, MPMConf, MPMSimulator
from unidom_torch.engine.primitives import create_primitive
from unidom_torch.envs.mpm_tasks import GRAD_TEST_CONF, WhipRopeEnv, grad_test
from unidom_torch.ops import svd3
from unidom_torch.ops.cuda import mpm_kernel
from unidom_torch.ops.cuda.mpm_kernel import mpm_step
from unidom_torch.ops.gradops import scrub_grad, tree_flatten
from unidom_torch.utils.convert import mpm_state_from_jax

torch.set_num_threads(1)


# ---------------------------------------------------------------- svd3 backward

def _svd_case(case):
    rng = np.random.default_rng(10)
    n = 32
    if case == "random":
        F = rng.standard_normal((n, 3, 3))
    elif case == "identity":  # every reset starts at F = I
        F = np.broadcast_to(np.eye(3), (n, 3, 3)).copy()
    elif case == "near_repeated":
        F = np.broadcast_to(np.diag([1.0, 1.0, 1.0 + 1e-3]), (n, 3, 3)).copy()
    else:  # negative determinant
        F = rng.standard_normal((n, 3, 3))
        F[np.linalg.det(F) > 0, 0] *= -1
    cot = tuple(rng.standard_normal(s).astype(np.float32) for s in ((n, 3, 3), (n, 3), (n, 3, 3)))
    return F.astype(np.float32), cot


# The same float32 operations on both sides in another order. Where the
# singular values are well apart the adjoint agrees to ~1e-6 of its size; at
# F = I every 1/(s_j^2 - s_i^2) is an exact tie and turns into 0 on both
# sides; at diag(1, 1, 1 + 1e-3) it is ~5e2, and the rounding of U and V
# (~1e-7) is amplified by it: 1e-4 of the adjoint's size.
SVD_BWD_TOL = {"random": 1e-5, "identity": 1e-6, "near_repeated": 2e-4, "negative_det": 1e-5}


@pytest.mark.parametrize("case", ["random", "identity", "near_repeated", "negative_det"])
def test_svd3_backward_matches_jax_vjp(case):
    F, (gU, gS, gVh) = _svd_case(case)
    _, vjp = jax.vjp(jax_svd3, jnp.asarray(F))
    (ref,) = vjp((jnp.asarray(gU), jnp.asarray(gS), jnp.asarray(gVh)))
    ref = np.asarray(ref)
    A = torch.from_numpy(F).requires_grad_()
    U, S, Vh = svd3.svd3(A)
    (out,) = torch.autograd.grad((U, S, Vh), A, tuple(torch.from_numpy(g) for g in (gU, gS, gVh)))
    out = out.numpy()
    assert np.isfinite(out).all()
    scale = np.abs(ref).max()
    np.testing.assert_allclose(out, ref, rtol=0, atol=SVD_BWD_TOL[case] * scale)


def test_svd3_backward_float32_against_float64():
    """Near a repeated pair the float32 adjoint stays within the float64
    one's reach: on diag(1, 1, 1 + 1e-3) and det F < 0."""
    for case in ("near_repeated", "negative_det"):
        F, cot = _svd_case(case)
        outs = []
        for dtype in (torch.float32, torch.float64):
            A = torch.from_numpy(F).to(dtype).requires_grad_()
            (g,) = torch.autograd.grad(svd3.svd3(A), A, tuple(torch.from_numpy(c).to(dtype)
                                                               for c in cot))
            outs.append(g.double().numpy())
        err = np.abs(outs[0] - outs[1]).max() / np.abs(outs[1]).max()
        assert err < 2e-4, (case, err)


def test_scrub_grad_matches_jax():
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    g = np.array([[np.nan, 1.0, -np.inf], [np.inf, -2.0, 0.5]], np.float32)
    _, vjp = jax.vjp(jgradops.scrub_grad, jnp.asarray(x))
    (ref,) = vjp(jnp.asarray(g))
    t = torch.from_numpy(x).requires_grad_()
    out = scrub_grad(t)
    torch.testing.assert_close(out, t, rtol=0, atol=0)
    (tg,) = torch.autograd.grad(out, t, torch.from_numpy(g))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(ref))
    steps = torch.zeros(3, dtype=torch.int32)
    assert scrub_grad(steps) is steps


# ---------------------------------------------------------------- the plain macro step's VJP

B = 3
SMALL = dict(n_grid=32, dt=2e-4, steps=8, E=100.0, nu=0.1, res=(16, 16, 16),
             ground_friction=0.5, task="test", goal_path="")
# (position control?, materials, SDF): tests/test_torch_mpm.py's small scene,
# with a block of each of the four materials under position control and
# under collision, and its bowl of water
CONFIGS = {
    "pc_mixed": (True, "mixed", "box"),
    "collide_mixed": (False, "mixed", "box"),
    "bowl_water": (False, WATER, "container"),
}
MATERIALS = (WATER, ELASTIC, PLASTIC_CLIP, VON_MISES)
PRIMS = {
    "box": dict(size=[0.03] * 3, init_pos=[0.5, 0.06, 0.46], friction=0.2),
    "container": dict(size=[0.09, 0.0, 0.008], init_pos=[0.5, 0.17, 0.5], friction=0.1),
}
PRIM_FIELDS = ("position", "rotation", "size", "friction", "softness")
IN_NAMES = ("x", "v", "C", "F", "J", "mu", "lamda", "yield_stress", "friction") + tuple(
    f"primitive.{f}" for f in PRIM_FIELDS) + ("action",)
OUT_NAMES = ("x", "v", "C", "F", "J", "position", "rotation")


def _scene(sim, material, sdf_name, make_primitive):
    if material == "mixed":  # four blocks side by side, one per material
        state = None
        for i, m in enumerate(MATERIALS):
            state = sim.add_box(state, size=[0.06] * 3, init_pos=[0.35 + 0.1 * i, 0.08, 0.5],
                                material=m, density=1.5)
    else:
        state = sim.add_box(None, size=[0.06, 0.04, 0.06], init_pos=[0.5, 0.2, 0.5],
                            material=material, density=1.5)
    p = PRIMS[sdf_name]
    state.primitives.append(make_primitive(8, friction=p["friction"], softness=666.0,
                                           color=[0.5] * 3, size=p["size"], init_pos=p["init_pos"]))
    sim.register_primitive_sdf(sdf_name)
    return state


def _action(rng):
    a = np.zeros((B, 6), np.float32)
    a[:, :3] = (0.4, 0.2, -0.3)
    a[:, 3:] = 0.05
    return a + 0.05 * rng.standard_normal(a.shape).astype(np.float32)


def _jax_inputs(jstate, action):
    p = jstate.primitives[0]
    return ([jstate.x, jstate.v, jstate.C, jstate.F, jstate.J, jstate.mu, jstate.lamda,
             jstate.yield_stress, jstate.friction] + [getattr(p, f) for f in PRIM_FIELDS]
            + [jnp.asarray(action)])


def _jax_vjp(jsim, jstate, action, rng):
    """``jax.vjp`` of the JAX simulator's macro step (``step_batch``, the XLA
    oracle on the CPU) with respect to the state's float fields and the
    action, under random output cotangents of norm ~1e-3 per entry, small
    enough that the macro step's per-env norm clamp stays off. Returns
    (cotangents, input cotangents)."""
    def f(*ins):
        *s, a = ins
        prim = jstate.primitives[0]._replace(**dict(zip(PRIM_FIELDS, s[9:])))
        state = jstate._replace(**dict(zip(("x", "v", "C", "F", "J", "mu", "lamda",
                                            "yield_stress", "friction"), s[:9])),
                                primitives=(prim,))
        out = jsim.step_batch(state, a)[0]
        return (out.x, out.v, out.C, out.F, out.J, out.primitives[0].position,
                out.primitives[0].rotation)

    ins = _jax_inputs(jstate, action)
    cot = tuple(1e-3 * rng.standard_normal(o.shape) for o in jax.eval_shape(f, *ins))
    ref = jax.jit(lambda *i: jax.vjp(f, *i)[1](cot))(*ins)
    return cot, [np.asarray(g) for g in ref]


def _torch_vjp(sim, state, action, cot, ckpt_stride=None):
    """Autograd of ``mpm_step`` (the plain step for CPU tensors) with respect
    to the same inputs."""
    p = state.primitives[0]
    ins = [t.detach().clone().requires_grad_() for t in
           [state.x, state.v, state.C, state.F, state.J, state.mu, state.lamda,
            state.yield_stress, state.friction] + [getattr(p, f) for f in PRIM_FIELDS]
           + [action]]
    *s, a = ins
    prim = p.replace(**dict(zip(PRIM_FIELDS, s[9:])))
    st = state.replace(**dict(zip(("x", "v", "C", "F", "J", "mu", "lamda", "yield_stress",
                                   "friction"), s[:9])), primitives=(prim,))
    out = mpm_step(sim, st, a, ckpt_stride=ckpt_stride)
    outs = (out.x, out.v, out.C, out.F, out.J, out.primitives[0].position,
            out.primitives[0].rotation)
    grads = torch.autograd.grad(outs, ins, [torch.as_tensor(c, device=out.x.device) for c in cot],
                                allow_unused=True)
    return [np.zeros(t.shape, np.float32) if g is None else g.cpu().numpy()
            for g, t in zip(grads, ins)]


def _f64(tree):
    return jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float64) if jnp.issubdtype(a.dtype, jnp.floating) else a, tree)


@pytest.fixture(scope="module", params=list(CONFIGS))
def vjp_refs(request):
    """JAX's VJP of one macro step for one config in float64, from a
    perturbed state (random v and C, a yield stress that von Mises reaches)."""
    use_pc, material, sdf_name = CONFIGS[request.param]
    rng = np.random.default_rng(20)
    with jax.enable_x64(True):
        jsim = jmpm.MPMSimulator(jmpm.MPMConf(**SMALL, backend="xla"), batch_size=B,
                                 use_position_control=use_pc)
        s0 = jsim.reset(_scene(jsim, material, sdf_name, jprim.create_primitive))
        jstate = _f64(s0)._replace(
            v=jnp.asarray(0.2 * rng.standard_normal(s0.v.shape)),
            C=jnp.asarray(0.5 * rng.standard_normal(s0.C.shape)),
            yield_stress=jnp.full(s0.yield_stress.shape, 0.005))
        action = _action(rng).astype(np.float64)
        cot, ref = _jax_vjp(jsim, jstate, action, rng)
        jstate = jax.device_get(jstate)
    return request.param, jstate, action, cot, ref


def _torch_sim(config, transfer, batch=B):
    use_pc, material, sdf_name = CONFIGS[config]
    sim = MPMSimulator(MPMConf(**SMALL, transfer=transfer), batch, use_position_control=use_pc,
                       device="cpu")
    sim.reset(_scene(sim, material, sdf_name,
                     lambda *a, **k: create_primitive(*a, **k, device="cpu")))
    return sim


# Tolerances. The reference is JAX's VJP in float64. The port's float64 VJP
# runs the same formulas and agrees with it to rounding amplified by the
# SVD's adjoint, whose 1/(s_j^2 - s_i^2) is ~1e4 near F = I (gaps of
# dt |C| ~ 1e-4): 2e-9 of the norm on C and F (F64_REL). In float32 that
# amplification shows at up to 6e-4 of the norm on F, and under collision
# the friction's normal and tangent split at ~1e-3 on the ground friction;
# each port float32 cotangent must lie within F32_REL of the float64
# reference in relative norm, and be exactly 0 where the reference is (the
# primitive's size and softness under position control, mu of water). JAX's
# own float32 VJP is not the yardstick: on pc_elastic it misses its float64
# by 1e-1 on F and 1e-3 on v.
# The yield stress's cotangent is the exception in float32: von Mises works
# in log-sigma space, where at this strain the deviatoric log-stretch is
# ~1e-4 and float32 carries log(sigma) to ~6e-8, so it holds 1e-3 of the
# deviator; its cotangent lands 4.6e-3 off float64 (F32_REL_YIELD).
F64_REL = 1e-8
F32_REL = 2e-3
F32_REL_YIELD = 1e-2


def _assert_vjp_close(out, ref, rel, names=IN_NAMES, rel_by_name=None):
    for name, g, r in zip(names, out, ref):
        tol = (rel_by_name or {}).get(name, rel)
        assert g.shape == r.shape, name
        assert np.isfinite(g).all(), name
        g, r = g.astype(np.float64), r.astype(np.float64)
        n = np.linalg.norm(r)
        if n == 0:
            assert np.abs(g).max() == 0, name
            continue
        err = np.linalg.norm(g - r) / n
        assert err <= tol, f"{name}: relative error {err:.3e}"


def _cast(state, dtype):
    leaves, rebuild = tree_flatten(state)
    return rebuild([t.to(dtype) if t.is_floating_point() else t for t in leaves])


def _port_vjps(sim, jstate, action, cot):
    """The port's VJP in float64 and in float32 from the same inputs."""
    state = mpm_state_from_jax(jstate, device="cpu")
    out = {}
    for dtype in (torch.float64, torch.float32):
        out[dtype] = _torch_vjp(sim, _cast(state, dtype), torch.from_numpy(action).to(dtype),
                                [c.astype(np.float32) if dtype == torch.float32 else c
                                 for c in cot])
    return out[torch.float64], out[torch.float32]


@pytest.mark.parametrize("transfer", ["dense", "scatter"])
def test_plain_step_vjp_matches_jax(vjp_refs, transfer):
    config, jstate, action, cot, ref = vjp_refs
    sim = _torch_sim(config, transfer)
    assert sim.transfer_mode == transfer
    out64, out32 = _port_vjps(sim, jstate, action, cot)
    _assert_vjp_close(out64, ref, F64_REL)
    _assert_vjp_close(out32, ref, F32_REL, rel_by_name={"yield_stress": F32_REL_YIELD})
    # the gradient reaches the particles, the solids' stiffness, the yield
    # stress of von Mises and the action
    reached = ("x", "v", "C", "F", "action")
    if config != "bowl_water":
        reached += ("mu", "lamda", "yield_stress")
        assert sorted(set(sim.material.tolist())) == sorted(MATERIALS)
    for name in reached:
        assert np.abs(out32[IN_NAMES.index(name)]).max() > 0, name


def test_whip_rope_scene_vjp_matches_jax():
    """One macro step of whip_rope's scene (an elastic rope, a box under
    position control, the focus grid) on grad_test's conf."""
    rng = np.random.default_rng(21)
    with jax.enable_x64(True):
        jenv = JaxWhipRopeEnv(batch_size=2, seed=1,
                              conf=jmpm.MPMConf(**dataclasses.asdict(GRAD_TEST_CONF)))
        _, jstate = jenv.reset(jax.random.PRNGKey(1))
        jstate = _f64(jstate)
        # the env's focus shift: the rope's centre to the middle of the 16^3 grid
        shift = np.asarray(GRAD_TEST_CONF.res) * 0.5 / GRAD_TEST_CONF.n_grid - jstate.x.mean(1)
        shift = jnp.asarray(shift).at[:, 1].set(0.0)[:, None, :]
        prim = jstate.primitives[0]
        jstate = jstate._replace(
            x=jstate.x + shift, v=jnp.asarray(0.2 * rng.standard_normal(jstate.v.shape)),
            C=jnp.asarray(0.5 * rng.standard_normal(jstate.C.shape)),
            primitives=(prim._replace(position=prim.position + shift),))
        action = (np.array([[0.3, 0.0, 0.5, 0.0, 0.0, 0.0]] * 2) / 50.0
                  + 1e-3 * rng.standard_normal((2, 6)))
        cot, ref = _jax_vjp(jenv.simulator, jstate, action, rng)
        jstate = jax.device_get(jstate)
    env = WhipRopeEnv(2, seed=1, conf=GRAD_TEST_CONF, device="cpu")
    out64, out32 = _port_vjps(env.simulator, jstate, action, cot)
    _assert_vjp_close(out64, ref, F64_REL)
    _assert_vjp_close(out32, ref, F32_REL)
    assert np.abs(out32[IN_NAMES.index("action")][:, :3]).min() > 0


def test_grad_test_gives_finite_nonzero_gradients():
    results = grad_test(n_chained_steps=2, n_iters=2, device="cpu", verbose=False)
    assert len(results) == 2
    for g in results:
        assert g.shape == (1, 6) and np.isfinite(g).all()
    assert any(np.abs(g).sum() > 0 for g in results)
    # whip_rope's get_primitive_actions zeroes the rotation: no gradient reaches it
    assert all((g[:, 3:] == 0).all() for g in results)


# ---------------------------------------------------------------- K2-bwd's launch

@pytest.mark.parametrize("B, P, res, steps, cluster, threads", [
    # whip_rope at 1024 envs fills the card: a cluster of 1, the first
    # design's 128 threads for its 67 particles
    (1024, 67, (32, 32, 32), 70, 1, 128),
    # shape_rope: the cluster doubles while the envs' CTAs fit 132 SMs in
    # one wave, one particle per thread up to 320 threads
    (16, 582, (64, 6, 64), 133, 8, 128),
    (64, 582, (64, 6, 64), 133, 2, 320),
    (256, 582, (64, 6, 64), 133, 1, 320),
])
def test_k2_bwd_launch_config(B, P, res, steps, cluster, threads):
    cells = res[0] * res[1] * res[2]
    cfg = mpm_kernel.launch_config(B, P, cells, steps, 1)
    assert (cfg.cluster, cfg.threads) == (cluster, threads)
    assert cfg.per_cta == -(-P // cluster) and cfg.per_cta * cfg.cluster >= P
    assert cfg.list_cap == min(27 * cfg.per_cta, cells)
    assert cfg.smem == mpm_kernel.smem_bytes(cfg.per_cta, cells, steps, 1, True)
    assert cfg.smem + mpm_kernel.BWD_STATIC_SMEM <= mpm_kernel.SMEM_PER_BLOCK
    assert cfg.cluster == 1 or B * cfg.cluster <= mpm_kernel.N_SMS
    assert cfg.K == mpm_kernel.checkpoint_stride(B, P, steps)
    # the same launch with the cluster given, and the one-block design's size
    assert mpm_kernel.launch_config(B, P, cells, steps, 1, cluster=cluster) == cfg
    assert mpm_kernel.smem_bytes(P, cells, steps, 1, True) == (
        4 * (50 * P + (steps + 1) * 7) + 4 * min(27 * P, cells) + 8 + 24 * P)


@pytest.mark.parametrize("B, P, res, steps, cluster, threads", [
    # whip_rope at 1024 envs fills the card: a cluster of 1, 96 threads for
    # its 67 particles
    (1024, 67, (32, 32, 32), 70, 1, 96),
    # shape_rope: the cluster doubles while the envs' CTAs fit 132 SMs in
    # one wave, one particle per thread
    (16, 582, (64, 6, 64), 133, 8, 96),
    (64, 582, (64, 6, 64), 133, 2, 320),
    (256, 582, (64, 6, 64), 133, 1, 608),
])
def test_k2_fwd_launch_config(B, P, res, steps, cluster, threads):
    cells = res[0] * res[1] * res[2]
    cfg = mpm_kernel.fwd_launch_config(B, P, cells, steps, 1)
    assert (cfg.cluster, cfg.threads) == (cluster, threads)
    assert cfg.per_cta == -(-P // cluster) and cfg.per_cta * cfg.cluster >= P
    assert cfg.per_cta <= cfg.threads <= mpm_kernel.FWD_MAX_THREADS and cfg.threads % 32 == 0
    assert cfg.list_cap == min(27 * cfg.per_cta, cells)
    assert cfg.smem == mpm_kernel.smem_bytes(cfg.per_cta, cells, steps, 1, False)
    assert cfg.smem + mpm_kernel.FWD_STATIC_SMEM <= mpm_kernel.SMEM_PER_BLOCK
    assert cfg.cluster == 1 or B * cfg.cluster <= mpm_kernel.N_SMS
    assert cfg.cluster == mpm_kernel.launch_config(B, P, cells, steps, 1).cluster
    assert cfg.K == mpm_kernel.checkpoint_stride(B, P, steps)
    # the same launch with the cluster given, and the forward's shared memory
    assert mpm_kernel.fwd_launch_config(B, P, cells, steps, 1, cluster=cluster) == cfg
    assert mpm_kernel.smem_bytes(P, cells, steps, 1, False) == (
        4 * (25 * P + (steps + 1) * 7) + 4 * min(27 * P, cells))


def test_k2_fwd_launch_config_refuses_before_loading_the_library(monkeypatch):
    """A configuration no cluster of 8 CTAs holds raises in Python, naming
    the sizes, before the kernels' library is built or loaded, also from
    launch (K2-fwd without history) on a simulator of such a configuration."""

    def no_library(source):
        raise AssertionError(f"{source} was loaded")

    monkeypatch.setattr(mpm_kernel, "load_library", no_library)
    mpm_kernel._lib.cache_clear()
    with pytest.raises(ValueError, match=r"K2-fwd on 582 particles, 24576 grid cells, 8000 "
                                         r"substeps and 1 primitives needs 239724 bytes of "
                                         r"shared memory per CTA in a cluster of 8 \(73 "
                                         r"particles each\)"):
        mpm_kernel.fwd_launch_config(64, 582, 64 * 6 * 64, 8000, 1)
    with pytest.raises(ValueError, match="a cluster has 1 to 8 CTAs"):
        mpm_kernel.fwd_launch_config(64, 582, 64 * 6 * 64, 133, 1, cluster=16)
    steps = 8300  # 232,428 B of frames
    conf = dataclasses.replace(GRAD_TEST_CONF, steps=steps)
    sim = MPMSimulator(conf, 1, use_position_control=True, device="cpu")
    state = sim.add_box(None, size=(0.25, 0.06, 0.06), init_pos=(0.5, 0.08, 0.5),
                        material=ELASTIC, density=1.5)
    state.primitives.append(create_primitive(steps, 0.2, 666.0, [0.5] * 3, (0.03,) * 3,
                                             (0.5, 0.06, 0.46), device="cpu"))
    sim.register_primitive_sdf("box")
    state = sim.reset(state)
    P = sim.n_particles
    with pytest.raises(ValueError, match=f"K2-fwd on {P} particles, 4096 grid cells, {steps} "
                                         "substeps and 1 primitives needs"):
        mpm_kernel.launch(sim, sim.prepare(state, torch.zeros((1, 6))))


def test_k2_bwd_launch_config_refuses_before_loading_the_library(monkeypatch):
    """A configuration no cluster of 8 CTAs holds (every CTA keeps the
    frames of all substeps in shared memory: 28 B per substep and
    primitive) raises in Python, naming the sizes, before the kernels'
    library is built or loaded, also from kernel_step on a simulator of
    such a configuration."""

    def no_library(source):
        raise AssertionError(f"{source} was loaded")

    monkeypatch.setattr(mpm_kernel, "load_library", no_library)
    mpm_kernel._lib.cache_clear()
    with pytest.raises(ValueError, match=r"250320 bytes of shared memory per CTA in a cluster "
                                         r"of 8 \(73 particles each\)"):
        mpm_kernel.launch_config(64, 582, 64 * 6 * 64, 8000, 1)
    with pytest.raises(ValueError, match="a cluster has 1 to 8 CTAs"):
        mpm_kernel.launch_config(64, 582, 64 * 6 * 64, 133, 1, cluster=16)
    steps = 8300  # 232,428 B of frames
    conf = dataclasses.replace(GRAD_TEST_CONF, steps=steps)
    sim = MPMSimulator(conf, 1, use_position_control=True, device="cpu")
    state = sim.add_box(None, size=(0.25, 0.06, 0.06), init_pos=(0.5, 0.08, 0.5),
                        material=ELASTIC, density=1.5)
    state.primitives.append(create_primitive(steps, 0.2, 666.0, [0.5] * 3, (0.03,) * 3,
                                             (0.5, 0.06, 0.46), device="cpu"))
    sim.register_primitive_sdf("box")
    state = sim.reset(state)
    P = sim.n_particles
    with pytest.raises(ValueError, match=f"K2-bwd on {P} particles, 4096 grid cells, {steps} "
                                         "substeps and 1 primitives needs"):
        mpm_kernel.kernel_step(sim, sim.prepare(state, torch.zeros((1, 6))))
