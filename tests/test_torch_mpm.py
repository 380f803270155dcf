"""The port's MPM engine against ``unidom_tpu`` on the CPU: the 3x3 SVD, the
SDFs and their normals, the quaternion helpers, forward kinematics, the
macro step's gradient identities, ``l2_distance``, and the plain macro step
(the CUDA kernel's plain version) against the JAX oracle and the JAX
package's Pallas kernel in interpret mode. Inputs are made with numpy from
a seed and fed to both sides."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unidom_tpu.engine import mpm as jmpm
from unidom_tpu.engine import primitives as jprim
from unidom_tpu.ops import gradops as jgradops
from unidom_tpu.ops import metrics as jmetrics
from unidom_tpu.ops import quat as jquat
from unidom_tpu.ops import sdf as jsdf
from unidom_tpu.ops.svd3 import svd3 as jax_svd3
from unidom_torch.engine.mpm import ELASTIC, VON_MISES, WATER, MPMConf, MPMSimulator
from unidom_torch.engine.primitives import PrimitiveState, create_primitive, forward_kinematics
from unidom_torch.ops import quat, sdf, svd3
from unidom_torch.ops.cuda.mpm_kernel import check_supported, mpm_step
from unidom_torch.ops.gradops import clamp_grad_norm_tree, scrub_mpm_state
from unidom_torch.ops.metrics import l2_distance
from unidom_torch.utils.convert import mpm_state_from_jax

torch.set_num_threads(1)


def _np(t):
    return np.asarray(t)


# ---------------------------------------------------------------- svd3

def _svd_inputs(case):
    rng = np.random.default_rng(0)
    n = 64
    if case == "random":
        F = rng.standard_normal((n, 3, 3))
    elif case == "near_identity":
        F = np.eye(3) + 1e-2 * rng.standard_normal((n, 3, 3))
    elif case == "repeated":
        # exactly representable F with repeated singular values: F = I after
        # every reset, scaled identities, and signed permutations of
        # diagonals with a repeated pair
        perms = np.array([np.eye(3)[list(p)] for p in ((0, 1, 2), (1, 2, 0), (2, 0, 1))])
        diags = [(1, 1, 1), (1.5, 1.5, 1.5), (2, 2, 0.5), (0.7, 1.3, 1.3), (0.5, 2, 0.5), (0, 0, 1)]
        F = np.array([p @ np.diag(d) * s for p in perms for d in diags for s in (1, -1)])
    else:  # negative determinant
        F = rng.standard_normal((n, 3, 3))
        F[np.linalg.det(F) > 0, 0] *= -1
    return F.astype(np.float32)


# Tolerances: both sides run the same float32 operations (6 Jacobi sweeps),
# rounded in other places. Singular values come from the eigenvalues of
# A^T A, so each side's smallest ones are ~3e-6 off float64 (S_ATOL); with
# well-separated singular values U and V agree to ~1e-6, and near the
# identity, where the gaps are ~1e-2, rounding moves the singular vectors by
# up to ~1e-7 / 1e-2. Exactly representable inputs agree exactly.
S_ATOL = 5e-6
SVD_TOL = {"random": 1e-5, "near_identity": 1e-4, "repeated": 1e-6, "negative_det": 1e-5}


@pytest.mark.parametrize("case", ["random", "near_identity", "repeated", "negative_det"])
def test_svd3_matches_jax(case):
    F = _svd_inputs(case)
    jU, jS, jVh = (_np(t) for t in jax_svd3(jnp.asarray(F)))
    U, S, Vh = (t.numpy() for t in svd3.svd3(torch.from_numpy(F)))
    tol = SVD_TOL[case]
    np.testing.assert_allclose(S, jS, rtol=1e-6, atol=S_ATOL)
    np.testing.assert_allclose(U, jU, atol=tol)
    np.testing.assert_allclose(Vh, jVh, atol=tol)
    # and it is an SVD: U diag(S) Vh == F, U and Vh orthogonal, S sorted
    np.testing.assert_allclose((U * S[:, None, :]) @ Vh, F, atol=2e-5)
    eye = np.broadcast_to(np.eye(3), U.shape)
    np.testing.assert_allclose(U @ U.transpose(0, 2, 1), eye, atol=2e-6)
    np.testing.assert_allclose(Vh @ Vh.transpose(0, 2, 1), eye, atol=2e-6)
    assert (np.diff(S, axis=1) <= 0).all()


# ---------------------------------------------------------------- SDFs

def _lattice_points():
    """Grid nodes i / 32 around a primitive that sits on the lattice, so
    |p_i| - size_i and p_i hit 0 exactly, also on several axes at once."""
    idx = np.stack(np.meshgrid(*[np.arange(4, 13)] * 3, indexing="ij"), -1).reshape(-1, 3)
    return (idx / 32.0 - 0.25).astype(np.float32)


SDF_SIZES = {
    "box": [(3 / 32, 3 / 32, 3 / 32), (0.125, 0.0625, 3 / 32)],
    "container": [(0.09, 0.0, 0.008), (0.125, 0.0625, 1 / 32)],
}


@pytest.mark.parametrize("name", ["box", "container"])
def test_sdf_and_normal_match_jax_on_lattice_ties(name):
    p = _lattice_points()
    for size in SDF_SIZES[name]:
        size = np.asarray(size, np.float32)
        jfn = jsdf.get_sdf(name)
        ref = _np(jfn(jnp.asarray(size), jnp.asarray(p)))
        ref_n = _np(jsdf.sdf_normal(jfn)(jnp.asarray(size), jnp.asarray(p)))
        out = sdf.get_sdf(name)(torch.from_numpy(size), torch.from_numpy(p)).numpy()
        out_n = sdf.sdf_normal(name)(torch.from_numpy(size), torch.from_numpy(p)).numpy()
        np.testing.assert_allclose(out, ref, atol=1e-6)
        # same formulas, different rounding; the ties decide whole entries
        np.testing.assert_allclose(out_n, ref_n, atol=2e-6)
    if name == "box":  # the lattice does hit the box's kinks
        q = np.abs(p) - np.asarray(SDF_SIZES["box"][0], np.float32)
        assert (q == 0).any() and ((q == q.max(-1, keepdims=True)).sum(-1) > 1).any()
        assert (p == 0).any()


def test_sdf_raises_for_unported_shapes():
    """Every SDF of JAX's registry is ported; a name outside it raises."""
    assert sdf.get_sdf("torus") is sdf.sdf_torus
    with pytest.raises(KeyError, match="no SDF 'ellipsoid'"):
        sdf.get_sdf("ellipsoid")


# ---------------------------------------------------------------- quaternions, FK

def test_quaternion_helpers_match_jax():
    rng = np.random.default_rng(1)
    q = rng.standard_normal((32, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    r = rng.standard_normal((32, 4)).astype(np.float32)
    w = (0.3 * rng.standard_normal((32, 3))).astype(np.float32)
    w[0] = 0.0  # zero rotation
    v = rng.standard_normal((32, 3)).astype(np.float32)
    t = torch.from_numpy
    np.testing.assert_allclose(quat.qmul(t(q), t(r)).numpy(), _np(jquat.qmul(q, r)), atol=1e-6)
    np.testing.assert_allclose(quat.w2quat(t(w)).numpy(), _np(jquat.w2quat(w)), atol=1e-6)
    np.testing.assert_allclose(quat.qinv(t(q)).numpy(), _np(jquat.qinv(q)), atol=1e-6)
    np.testing.assert_allclose(quat.qrot(t(q), t(v)).numpy(),
                               _np(jax.vmap(jquat.qrot)(q, v)), atol=1e-6)


def test_forward_kinematics_matches_jax():
    rng = np.random.default_rng(2)
    B, steps = 3, 6
    jp = jprim.create_primitive(steps, 0.2, 666.0, [0.5] * 3, [0.03] * 3, [0.5, 0.06, 0.46])
    v = (0.4 * rng.standard_normal((B, steps, 3))).astype(np.float32)  # drives past +-2
    w = (0.2 * rng.standard_normal((B, steps, 3))).astype(np.float32)
    pos0 = (1.5 * rng.standard_normal((B, 3))).astype(np.float32)
    jstate = jax.tree_util.tree_map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), jp)
    jstate = jstate._replace(v=jnp.asarray(v), w=jnp.asarray(w),
                             position=jstate.position.at[:, 0].set(pos0))
    tstate = PrimitiveState(**{f.name: torch.tensor(_np(getattr(jstate, f.name)))
                               for f in dataclasses.fields(PrimitiveState)})
    jfk = jax.vmap(jprim.forward_kinematics, in_axes=(None, 0))
    for f in range(steps):
        jstate = jfk(f, jstate)
        tstate = forward_kinematics(f, tstate)
        np.testing.assert_allclose(tstate.position.numpy(), _np(jstate.position), atol=1e-6)
        np.testing.assert_allclose(tstate.rotation.numpy(), _np(jstate.rotation), atol=1e-6)
    assert np.abs(tstate.position.numpy()).max() == 2.0  # the clip was reached


# ---------------------------------------------------------------- gradient identities, metric

B_SMALL = 3


def _jax_state(rng, nan=False):
    P = 5
    f = lambda *s: jnp.asarray(rng.standard_normal((B_SMALL,) + s).astype(np.float32))  # noqa: E731
    x = f(P, 3)
    if nan:
        x = x.at[0, 1, 2].set(jnp.nan).at[1, 0, 0].set(jnp.inf)
    prim = jprim.create_primitive(4, 0.2, 666.0, [0.5] * 3, [0.03] * 3, [0.5, 0.06, 0.46])
    prim = jax.tree_util.tree_map(lambda a: jnp.broadcast_to(a, (B_SMALL,) + a.shape), prim)
    return jmpm.MPMState(
        x=x, v=f(P, 3), C=f(P, 3, 3), F=f(P, 3, 3), J=f(P), cur_step=jnp.zeros(B_SMALL, jnp.int32),
        primitives=(prim,), key=jax.random.split(jax.random.PRNGKey(0), B_SMALL),
        friction=f(1), mu=f(1), lamda=f(P), yield_stress=f(1))


def _cotangent(jstate, rng, scale, nan):
    def one(a):
        if not jnp.issubdtype(a.dtype, jnp.floating):
            return np.zeros(a.shape, jax.dtypes.float0)
        g = (scale * rng.standard_normal(a.shape)).astype(np.float32)
        if nan and g.ndim >= 2:
            g[0, 0] = np.nan
        return g
    return jax.tree_util.tree_map(one, jstate)


def _torch_leaves(state):
    """Float leaves of a port MPMState in the JAX tree's leaf order (``key``
    dropped)."""
    out = [state.x, state.v, state.C, state.F, state.J]
    out += [getattr(state.primitives[0], f.name) for f in dataclasses.fields(PrimitiveState)]
    return out + [state.friction, state.mu, state.lamda, state.yield_stress]


def _jax_leaves(jstate):
    prim = jstate.primitives[0]
    out = [jstate.x, jstate.v, jstate.C, jstate.F, jstate.J]
    out += [getattr(prim, f) for f in prim._fields]
    return out + [jstate.friction, jstate.mu, jstate.lamda, jstate.yield_stress]


@pytest.mark.parametrize("case", ["below", "above", "nonfinite"])
def test_scrub_mpm_state_matches_jax_vjp(case):
    rng = np.random.default_rng(3)
    jstate = _jax_state(rng, nan=True)
    scale = {"below": 0.01, "above": 1.0, "nonfinite": 1.0}[case]
    cot = _cotangent(jstate, rng, scale, nan=case == "nonfinite")
    jout, vjp = jax.vjp(jax.vmap(jgradops.scrub_mpm_state), jstate)
    (jgrad,) = vjp(cot)

    tstate = mpm_state_from_jax(jax.device_get(jstate), device="cpu")
    leaves = _torch_leaves(tstate)
    for t in leaves:
        t.requires_grad_()
    out = scrub_mpm_state(tstate)
    assert out.cur_step is tstate.cur_step
    grads = torch.autograd.grad(_torch_leaves(out), leaves,
                                [torch.from_numpy(np.asarray(g)) for g in _jax_leaves(cot)])
    for o, r in zip(_torch_leaves(out), _jax_leaves(jout)):
        np.testing.assert_array_equal(o.detach().numpy(), _np(r))
    for g, r in zip(grads, _jax_leaves(jgrad)):
        np.testing.assert_allclose(g.numpy(), _np(r), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("case", ["below", "above", "nonfinite"])
def test_clamp_grad_norm_tree_matches_jax_vjp(case):
    rng = np.random.default_rng(4)
    a = rng.standard_normal((B_SMALL, 6)).astype(np.float32)
    scale = {"below": 0.01, "above": 3.0, "nonfinite": 3.0}[case]
    g = (scale * rng.standard_normal(a.shape)).astype(np.float32)
    if case == "nonfinite":
        g[1, 2] = np.nan
    jout, vjp = jax.vjp(jax.vmap(jgradops.clamp_grad_norm_tree), jnp.asarray(a))
    (jg,) = vjp(jnp.asarray(g))
    ta = torch.from_numpy(a).requires_grad_()
    (out,) = clamp_grad_norm_tree([ta])
    (tg,) = torch.autograd.grad(out, ta, torch.from_numpy(g))
    np.testing.assert_array_equal(out.detach().numpy(), _np(jout))
    np.testing.assert_allclose(tg.numpy(), _np(jg), rtol=1e-6, atol=1e-7)


def test_l2_distance_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.random((4, 67, 3)).astype(np.float32)
    goal = rng.random((67, 3)).astype(np.float32)
    np.testing.assert_allclose(l2_distance(torch.from_numpy(x), torch.from_numpy(goal)).numpy(),
                               _np(jmetrics.l2_distance(x, goal)), rtol=1e-6)


# ---------------------------------------------------------------- scene construction

def test_scene_construction_matches_jax():
    """add_box (solid: a regular lattice), add_sphere and add_points give
    JAX's particles and materials; add_box's water draws its own count."""
    conf = dict(n_grid=32, res=(16, 16, 16), task="test", goal_path="")
    jsim = jmpm.MPMSimulator(jmpm.MPMConf(**conf), batch_size=1)
    tsim = MPMSimulator(MPMConf(**conf), 1, device="cpu")
    pts = np.random.default_rng(6).random((5, 3)).astype(np.float32)
    js = jsim.add_box(None, size=[0.2, 0.1, 0.1], init_pos=[0.4, 0.1, 0.5],
                      z_rotation_angle=0.3, material=ELASTIC, density=2.0)
    ts = tsim.add_box(None, size=[0.2, 0.1, 0.1], init_pos=[0.4, 0.1, 0.5],
                      z_rotation_angle=0.3, material=ELASTIC, density=2.0)
    js = jsim.add_sphere(js, 0.08, [0.3, 0.2, 0.3], hardness=0.5, material=VON_MISES)
    ts = tsim.add_sphere(ts, 0.08, [0.3, 0.2, 0.3], hardness=0.5, material=VON_MISES)
    js = jsim.add_points(js, pts, material=WATER)
    ts = tsim.add_points(ts, pts, material=WATER)
    np.testing.assert_array_equal(ts.x.numpy(), _np(js.x))
    np.testing.assert_array_equal(tsim.material, jsim.material)
    np.testing.assert_array_equal(tsim.h, jsim.h)
    jw = jsim.add_box(None, size=[0.1, 0.1, 0.1], init_pos=[0.3, 0.2, 0.3], material=WATER)
    tw = tsim.add_box(None, size=[0.1, 0.1, 0.1], init_pos=[0.3, 0.2, 0.3], material=WATER)
    assert tw.x.shape == jw.x.shape
    offset = np.abs(tw.x.numpy() - np.array([0.3, 0.2, 0.3], np.float32))
    assert (offset <= 0.05 + 1e-6).all()


# ---------------------------------------------------------------- the plain macro step

B = 4
SMALL = dict(n_grid=32, dt=2e-4, steps=8, E=100.0, nu=0.1, res=(16, 16, 16),
             ground_friction=0.5, task="test", goal_path="")
# (position control?, material, SDF, its size and place): tests/test_pallas_mpm.py's configs
CONFIGS = {
    "pc_elastic": (True, ELASTIC, "box"),
    "collide_elastic": (False, ELASTIC, "box"),
    "collide_water": (False, WATER, "box"),
    "collide_von_mises": (False, VON_MISES, "box"),
    "bowl_water": (False, WATER, "container"),
}
PRIMS = {
    "box": dict(size=[0.03] * 3, init_pos=[0.5, 0.06, 0.46], friction=0.2),
    "container": dict(size=[0.09, 0.0, 0.008], init_pos=[0.5, 0.17, 0.5], friction=0.1),
}


def _scene(sim, material, sdf_name, make_primitive, **extra):
    box = (dict(size=[0.25, 0.06, 0.06], init_pos=[0.5, 0.08, 0.5], density=1.5)
           if sdf_name == "box" else dict(size=[0.06, 0.04, 0.06], init_pos=[0.5, 0.2, 0.5],
                                          density=1.5))
    state = sim.add_box(None, material=material, **box, **extra)
    p = PRIMS[sdf_name]
    state.primitives.append(make_primitive(8, friction=p["friction"], softness=666.0,
                                           color=[0.5] * 3, size=p["size"], init_pos=p["init_pos"]))
    sim.register_primitive_sdf(sdf_name)
    return state


def _action():
    a = np.zeros((B, 6), np.float32)
    a[:, :3] = (0.4, 0.2, -0.3)
    a[:, 3:] = 0.05
    return a


@pytest.fixture(scope="module", params=list(CONFIGS))
def step_refs(request):
    """JAX's reference macro step for one config, from a perturbed state:
    the XLA oracle's and the Pallas kernel's (interpret mode)."""
    use_pc, material, sdf_name = CONFIGS[request.param]
    refs, state = {}, None
    for backend in ("xla", "pallas"):
        conf = jmpm.MPMConf(**SMALL, backend=backend)
        sim = jmpm.MPMSimulator(conf, batch_size=B, use_position_control=use_pc)
        s0 = sim.reset(_scene(sim, material, sdf_name, jprim.create_primitive))
        if state is None:
            rng = np.random.default_rng(0)
            state = s0._replace(
                v=jnp.asarray(0.2 * rng.standard_normal(s0.v.shape), jnp.float32),
                C=jnp.asarray(0.5 * rng.standard_normal(s0.C.shape), jnp.float32),
                yield_stress=jnp.full_like(s0.yield_stress, 0.05))
        assert sim.backend == backend
        refs[backend] = jax.device_get(sim.step_batch(state, jnp.asarray(_action()))[0])
    return request.param, jax.device_get(state), refs


def _torch_sim(config, transfer):
    """(simulator, its reset state) for one config, on the CPU."""
    use_pc, material, sdf_name = CONFIGS[config]
    sim = MPMSimulator(MPMConf(**SMALL, transfer=transfer), B, use_position_control=use_pc,
                       device="cpu")
    state = sim.reset(_scene(sim, material, sdf_name,
                             lambda *a, **k: create_primitive(*a, **k, device="cpu")))
    return sim, state


# Tolerances: tests/test_pallas_mpm.py's, between the JAX oracle and its
# Pallas kernel (float32 sums in another order over 8 substeps).
STEP_TOL = {"x": (1e-4, 1e-5), "v": (1e-3, 1e-4), "C": (1e-3, 1e-2), "F": (1e-3, 1e-4),
            "J": (1e-3, 1e-5)}


@pytest.mark.parametrize("reference", ["xla_oracle", "pallas_interpret"])
@pytest.mark.parametrize("transfer", ["dense", "scatter"])
def test_plain_step_matches_jax(step_refs, reference, transfer):
    config, jstate, refs = step_refs
    ref = refs["xla" if reference == "xla_oracle" else "pallas"]
    sim, _ = _torch_sim(config, transfer)
    assert sim.transfer_mode == transfer
    state = mpm_state_from_jax(jstate, device="cpu")
    out = sim.step_batch(state, torch.from_numpy(_action()))
    for name, (rtol, atol) in STEP_TOL.items():
        np.testing.assert_allclose(getattr(out, name).numpy(), _np(getattr(ref, name)),
                                   rtol=rtol, atol=atol, err_msg=name)
    for field in ("position", "rotation"):
        np.testing.assert_allclose(getattr(out.primitives[0], field).numpy(),
                                   _np(getattr(ref.primitives[0], field)), atol=1e-6)
    assert np.abs(_np(ref.x) - _np(jstate.x)).max() > 1e-4  # the step moved the particles


def test_cpu_step_launches_no_kernel_and_its_backward_raises():
    """The CPU step launches no kernel, and its backward (autograd of the
    plain step through the SVD's degenerate-safe backward; it raised until
    that was ported) is finite, from F = I."""
    sim, state = _torch_sim("pc_elastic", "scatter")
    before = (mpm_step.launches, mpm_step.bwd_launches, mpm_step.seg_launches)
    C = state.C.clone().requires_grad_()
    out = mpm_step(sim, state.replace(C=C), torch.from_numpy(_action()))
    out.x.sum().backward()
    assert (mpm_step.launches, mpm_step.bwd_launches, mpm_step.seg_launches) == before
    assert torch.isfinite(C.grad).all() and C.grad.abs().max() > 0


def test_kernel_wrapper_raises_on_what_it_does_not_take():
    sim, state = _torch_sim("collide_elastic", "dense")
    action = torch.from_numpy(_action())
    with pytest.raises(ValueError, match="CPU or CUDA"):
        mpm_step(sim, state.replace(x=state.x.to("meta")), action)
    check_supported(sim)
    sim.sdf_names = ["torus"]
    check_supported(sim)
    sim.sdf_names = ["ellipsoid"]
    with pytest.raises(NotImplementedError, match="SDFs"):
        check_supported(sim)
    big = MPMSimulator(MPMConf(**{**SMALL, "res": (128, 64, 128)}), B, device="cpu")
    big.sdf_names, big.n_particles = ["box"], 100
    with pytest.raises(NotImplementedError, match="K3"):
        check_supported(big)
