"""The port's PlasticineLab target losses and sphere SDF against
``unidom_tpu`` on the CPU: ``compute_grid_mass``, the jump-flooding target
SDF, ``TargetLoss.losses`` with and without the contact term (hard and soft),
the IoU, ``LossTracker``; the sphere's distance, normal and autograd at
lattice points and at p = 0; and the MPM kernels' packed SDF codes. Inputs
are made with numpy from a seed and fed to both sides. JAX's
``TargetLoss`` is built under ``jax.disable_jit()`` (``_jax_target_loss``):
its jump flood runs op by op, as ``test_target_sdf_jfa_matches_jax`` runs
it, where the XLA compile of the jitted flood takes ~70 s on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unidom_tpu.engine import losses as jlosses
from unidom_tpu.ops import sdf as jsdf
from unidom_torch.engine import losses
from unidom_torch.ops import sdf
from unidom_torch.ops.cuda.mpm_kernel import SDF_KIND_BITS, SDF_KINDS, check_supported, pack_sdf_kinds

torch.set_num_threads(1)

RES = (16, 12, 20)
INV_DX = 16.0


def _np(t):
    return np.asarray(t)


def _cloud(seed, n=300, lo=0.15, hi=0.55):
    """A particle cloud, some of it within a cell of the grid's faces (the
    stencil then reaches outside the grid)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    x[:20] = rng.uniform(0.0, 1.0 / INV_DX, (20, 3)).astype(np.float32)
    x[20:40, 0] = np.float32(RES[0] / INV_DX) - rng.uniform(0, 0.05, 20).astype(np.float32)
    return x


# Sums of the same float32 terms in another order: a cell holds at most a
# few particles' weights (~1 each).
TOL_GRID = dict(rtol=1e-5, atol=1e-6)


def test_compute_grid_mass_matches_jax():
    xs = np.stack([_cloud(0), _cloud(1)])
    ref = np.stack([_np(jlosses.compute_grid_mass(jnp.asarray(x), RES, INV_DX, 0.5)) for x in xs])
    got = losses.compute_grid_mass(torch.from_numpy(xs), RES, INV_DX, 0.5).numpy()
    assert got.shape == (2,) + RES
    np.testing.assert_allclose(got, ref, **TOL_GRID)
    # one env as JAX takes it, and out-of-grid nodes drop their share
    one = losses.compute_grid_mass(torch.from_numpy(xs[0]), RES, INV_DX).numpy()
    np.testing.assert_allclose(one, 2 * ref[0], **TOL_GRID)
    assert one.sum() < len(xs[0]) - 1


def _density(seed):
    return np.array(jlosses.compute_grid_mass(jnp.asarray(_cloud(seed, n=60, lo=0.3, hi=0.45)),
                                         RES, INV_DX))


def test_target_sdf_jfa_matches_jax():
    for seed in (2, 3):
        dens = _density(seed)
        jsdf_, jnear = (_np(t) for t in jlosses.target_sdf_jfa(jnp.asarray(dens), 1 / INV_DX))
        got, near = losses.target_sdf_jfa(torch.from_numpy(dens), 1 / INV_DX)
        # the same shifts in the same order, the same strict comparison:
        # every cell finds the same nearest occupied cell
        np.testing.assert_array_equal(near.numpy(), jnear)
        np.testing.assert_allclose(got.numpy(), jsdf_, rtol=1e-6, atol=1e-7)
        assert (got.numpy() == 0).sum() == (dens > 1e-4).sum() > 0
    empty = np.zeros(RES, np.float32)
    assert (losses.target_sdf_jfa(torch.from_numpy(empty), 1 / INV_DX)[0] == 1000.0).all()


def _jax_target_loss(points, **kw):
    """JAX's ``TargetLoss.from_particles(points, RES, INV_DX, **kw)``, op by op."""
    with jax.disable_jit():
        return jlosses.TargetLoss.from_particles(jnp.asarray(points), RES, INV_DX, **kw)


def _prim_dists(seed, n_env, n):
    """Two primitives' distances: the first's partly negative (clamped at
    0), the second's all positive."""
    rng = np.random.default_rng(seed)
    return [rng.uniform(lo, 0.3, (n_env, n)).astype(np.float32) for lo in (-0.02, 0.01)]


# The loss terms sum ~RES cells of float32 values of a few units: the sums'
# order moves them by ~1e-6 relative.
TOL_LOSS = dict(rtol=2e-6, atol=1e-6)


@pytest.mark.parametrize("contact", ["none", "hard", "soft"])
def test_target_loss_matches_jax(contact):
    target = _cloud(4, n=200, lo=0.3, hi=0.5)
    soft = contact == "soft"
    jloss = _jax_target_loss(target, soft_contact=soft)
    tloss = losses.TargetLoss.from_particles(torch.from_numpy(target), RES, INV_DX,
                                             soft_contact=soft)
    np.testing.assert_allclose(tloss.target_sdf.numpy(), _np(jloss.target_sdf), rtol=1e-6,
                               atol=1e-7)
    assert tloss._target_iou == pytest.approx(jloss._target_iou, rel=1e-6)
    xs = np.stack([_cloud(5, n=200), _cloud(6, n=200)])
    dists = _prim_dists(7, 2, 200) if contact != "none" else []
    ref = jax.vmap(lambda x, *d: jloss.losses(x, d))(jnp.asarray(xs), *map(jnp.asarray, dists))
    got = tloss.losses(torch.from_numpy(xs), [torch.from_numpy(d) for d in dists])
    for key in ("loss", "sdf_loss", "density_loss", "contact_loss", "iou"):
        np.testing.assert_allclose(got[key].numpy(), _np(ref[key]), err_msg=key, **TOL_LOSS)
    assert (got["contact_loss"].numpy() > 0).all() == (contact != "none")


def test_loss_tracker_matches_jax():
    target = _cloud(8, n=200, lo=0.3, hi=0.5)
    jloss = _jax_target_loss(target)
    tloss = losses.TargetLoss.from_particles(torch.from_numpy(target), RES, INV_DX)
    steps = [np.stack([_cloud(s, n=200), _cloud(s + 1, n=200)]) for s in (9, 11, 13)]
    jtr = jlosses.LossTracker.init(jax.vmap(jloss.losses)(jnp.asarray(steps[0])))
    ttr = losses.LossTracker.init(tloss.losses(torch.from_numpy(steps[0])))
    for xs in steps[1:]:
        jtr, jinfo = jtr.step(jax.vmap(jloss.losses)(jnp.asarray(xs)))
        ttr, tinfo = ttr.step(tloss.losses(torch.from_numpy(xs)))
        # reward and the step's loss are differences of losses ~1e3: the
        # losses' rounding (TOL_LOSS) is relative to those
        scale = float(np.abs(_np(jtr.start_loss)).max())
        for key in ("reward", "incremental_iou", "loss", "iou"):
            np.testing.assert_allclose(tinfo[key].numpy(), _np(jinfo[key]), err_msg=key,
                                       rtol=2e-6, atol=2e-6 * scale)
        np.testing.assert_allclose(ttr.last_loss.numpy(), _np(jtr.last_loss), rtol=2e-6)
    assert ((tinfo["incremental_iou"] >= 0) & (tinfo["incremental_iou"] <= 1)).all()


# ---------------------------------------------------------------- the sphere SDF

def _lattice_points():
    """Grid nodes i / 32 about the sphere's centre, p = 0 among them."""
    idx = np.stack(np.meshgrid(*[np.arange(4, 13)] * 3, indexing="ij"), -1).reshape(-1, 3)
    return (idx / 32.0 - 0.25).astype(np.float32)


@pytest.mark.parametrize("radius", [0.025, 3 / 32])
def test_sphere_sdf_and_normal_match_jax(radius):
    p = _lattice_points()
    assert (np.abs(p).sum(-1) == 0).any()
    size = np.asarray([radius, 0.0, 0.0], np.float32)
    jfn = jsdf.get_sdf("sphere")
    ref = _np(jfn(jnp.asarray(size), jnp.asarray(p)))
    ref_n = _np(jsdf.sdf_normal(jfn)(jnp.asarray(size), jnp.asarray(p)))
    out = sdf.get_sdf("sphere")(torch.from_numpy(size), torch.from_numpy(p)).numpy()
    out_n = sdf.sdf_normal("sphere")(torch.from_numpy(size), torch.from_numpy(p)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-7)
    np.testing.assert_allclose(out_n, ref_n, atol=1e-6)
    origin = np.abs(p).sum(-1) == 0
    assert (out_n[origin] == 0).all() and np.isfinite(out_n).all()
    assert np.abs(np.linalg.norm(out_n[~origin], axis=-1) - 1).max() < 1e-6


def test_sphere_autograd_matches_jax():
    """The VJPs of the distance and of the normal with respect to p and the
    size, the normal's at p = 0 included (there ~1e12: the normal divides a
    gradient of 0 by sqrt(0 + 1e-12))."""
    p = _lattice_points()
    rng = np.random.default_rng(3)
    size = np.asarray([0.05, 0.0, 0.0], np.float32)
    cd = rng.standard_normal(len(p)).astype(np.float32)
    cn = rng.standard_normal(p.shape).astype(np.float32)
    jfn = jsdf.get_sdf("sphere")
    jnormal = jsdf.sdf_normal(jfn)

    def jloss(s, q):
        return jnp.sum(jfn(s, q) * cd) + jnp.sum(jnormal(s, q) * cn)

    jds, jdp = (_np(t) for t in jax.grad(jloss, argnums=(0, 1))(jnp.asarray(size), jnp.asarray(p)))
    ts = torch.from_numpy(size).requires_grad_()
    tp = torch.from_numpy(p).requires_grad_()
    loss = ((sdf.get_sdf("sphere")(ts, tp) * torch.from_numpy(cd)).sum()
            + (sdf.sdf_normal("sphere")(ts, tp) * torch.from_numpy(cn)).sum())
    tds, tdp = torch.autograd.grad(loss, (ts, tp))
    origin = np.abs(p).sum(-1) == 0
    np.testing.assert_allclose(tdp.numpy()[~origin], jdp[~origin], rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(tdp.numpy()[origin], jdp[origin], rtol=1e-5)
    assert np.abs(jdp[origin]).max() > 1e11
    np.testing.assert_allclose(tds.numpy(), jds, rtol=1e-6)
    assert tds[0] == pytest.approx(-cd.sum(), rel=1e-6) and (tds[1:] == 0).all()


# ---------------------------------------------------------------- SDF codes

def test_sdf_kinds_pack_four_bits_per_primitive():
    """All eight SDFs have a code (every one of ops/sdf.py's), and four
    primitives' codes decode from the packed word in order."""
    assert set(SDF_KINDS) == set(sdf.SDF_REGISTRY) == set(jsdf.SDF_REGISTRY)
    assert sorted(SDF_KINDS.values()) == list(range(8))
    assert max(SDF_KINDS.values()) < 2**SDF_KIND_BITS
    names = sorted(SDF_KINDS, key=SDF_KINDS.get)
    for group in (names[:4], names[4:], ["sphere", "box", "container", "sphere"]):
        packed = pack_sdf_kinds(group)
        decoded = [(packed >> (SDF_KIND_BITS * i)) & (2**SDF_KIND_BITS - 1)
                   for i in range(len(group))]
        assert decoded == [SDF_KINDS[n] for n in group]
    assert pack_sdf_kinds(["chopsticks", "rolling_pin"]) == 7 + (6 << SDF_KIND_BITS)
    with pytest.raises(NotImplementedError, match="SDFs"):
        pack_sdf_kinds(["sphere", "ellipsoid"])
    with pytest.raises(NotImplementedError, match="at most 4 primitives"):
        pack_sdf_kinds(["sphere"] * 5)


def test_kernels_refuse_the_unported_plb_sdfs():
    """The kernels take every SDF of JAX's registry, and refuse a name they
    do not know (the card never falls back to the plain step)."""
    from unidom_torch.engine.mpm import MPMConf, MPMSimulator

    sim = MPMSimulator(MPMConf(res=(16, 16, 16)), 1, device="cpu")
    sim.n_particles = 100
    sim.sdf_names = ["sphere", "sphere", "sphere"]
    check_supported(sim)
    for name in ("capsule", "rolling_pin", "chopsticks", "cylinder", "torus"):
        sim.sdf_names = ["sphere", name]
        check_supported(sim)
    for name in ("ellipsoid", "Capsule"):
        sim.sdf_names = ["sphere", name]
        with pytest.raises(NotImplementedError, match="SDFs"):
            check_supported(sim)
