"""The port's capsule, rolling-pin, chopsticks, cylinder and torus SDFs
against ``unidom_tpu/ops/sdf.py`` on the CPU: the distance and the unit
normal (``jax.grad``, normalised) on random points and on grid nodes that
hit each SDF's kinks, and autograd of both with respect to the points and
the size against JAX's second derivatives. No env is built. Inputs are made
with numpy from a seed and fed to both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unidom_tpu.ops import sdf as jsdf
from unidom_torch.ops import sdf

torch.set_num_threads(1)

NEW = ("capsule", "rolling_pin", "chopsticks", "cylinder", "torus")
# The scenes' own sizes (plb_writer's capsule, plb_rollingpin's pin,
# plb_chopsticks' pair) and, for every SDF, one on the lattice of 1/64 so
# that grid nodes land on its kinks.
SIZES = {
    "capsule": [(0.03, 0.03, 0.0), (3 / 64, 2 / 64, 0.0)],
    "rolling_pin": [(0.03, 0.15, 0.0), (2 / 64, 5 / 64, 0.0)],
    "chopsticks": [(0.015, 0.06, 0.06), (1 / 64, 4 / 64, 4 / 64)],
    "cylinder": [(0.05, 0.04, 0.0), (4 / 64, 3 / 64, 0.0)],
    "torus": [(0.06, 0.02, 0.0), (4 / 64, 2 / 64, 0.0)],
}
CASES = [(name, i) for name in NEW for i in range(2)]


def _np(t):
    return np.asarray(t)


def _lattice():
    """Grid nodes of a 64^3 grid about a primitive at node 32 (x = 0.5):
    p = (i - 32) / 64 for i in 24..40, the axis and the midplane among them."""
    idx = np.stack(np.meshgrid(*[np.arange(24, 41)] * 3, indexing="ij"), -1).reshape(-1, 3)
    return ((idx - 32) / 64.0).astype(np.float32)


def _points(seed=0):
    rng = np.random.default_rng(seed)
    return np.concatenate([_lattice(), rng.uniform(-0.15, 0.15, (2000, 3)).astype(np.float32)])


def _jax(name, size, p):
    fn = jsdf.get_sdf(name)
    return (_np(fn(jnp.asarray(size), jnp.asarray(p))),
            _np(jsdf.sdf_normal(fn)(jnp.asarray(size), jnp.asarray(p))))


def _torch(name, size, p):
    s, q = torch.from_numpy(size), torch.from_numpy(p)
    return sdf.get_sdf(name)(s, q).numpy(), sdf.sdf_normal(name)(s, q).numpy()


@pytest.mark.parametrize("name, which", CASES)
def test_sdf_and_normal_match_jax(name, which):
    size = np.asarray(SIZES[name][which], np.float32)
    p = _points()
    ref, ref_n = _jax(name, size, p)
    out, out_n = _torch(name, size, p)
    # the same float32 operations (sums of two or three squares)
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(out_n, ref_n, rtol=1e-5, atol=1e-6)
    assert (out < 0).any() and (out > 0).any()


def _ties(name, size, p):
    """The lattice points on each kink of ``name`` (the point sets this file
    names): a dict of boolean masks."""
    s0, s1, s2 = (np.float32(v) for v in size)
    if name in ("capsule", "rolling_pin"):
        a = 1 if name == "capsule" else 0
        return {"clip": np.abs(p[:, a]) == s1}
    if name == "chopsticks":
        return {"midplane": p[:, 0] == 0, "clip": np.abs(p[:, 1]) == s1}
    lxz = np.sqrt(p[:, 0] * p[:, 0] + p[:, 2] * p[:, 2] + np.float32(1e-12))
    axis = (p[:, 0] == 0) & (p[:, 2] == 0)
    if name == "torus":
        return {"axis": axis}
    d = np.stack([lxz - s0, np.abs(p[:, 1]) - s1], -1)
    return {"axis": axis, "rim": (d[:, 0] == d[:, 1]) & (d[:, 0] == 0),
            "clip": (d == 0).any(-1), "max": d[:, 0] == d[:, 1]}


@pytest.mark.parametrize("name", NEW)
def test_lattice_kinks_match_jax(name):
    """Grid nodes on each kink: every named tie is hit, the normal there is
    JAX's, and on the chopsticks' midplane the two capsules' x-components
    cancel (the normal's x is 0)."""
    size = np.asarray(SIZES[name][1], np.float32)
    p = _lattice()
    ties = _ties(name, size, p)
    ref, ref_n = _jax(name, size, p)
    out, out_n = _torch(name, size, p)
    for kind, mask in ties.items():
        assert mask.sum() > 0, (name, kind)
        np.testing.assert_allclose(out[mask], ref[mask], atol=1e-7, err_msg=kind)
        np.testing.assert_allclose(out_n[mask], ref_n[mask], rtol=1e-5, atol=1e-6, err_msg=kind)
    if name == "chopsticks":
        mid = ties["midplane"]
        assert (out_n[mid, 0] == 0).all() and (ref_n[mid, 0] == 0).all()
        # off the midplane, in the capsules' plane z = 0 beside their
        # segments (off their axes), the nearer capsule's normal is along x
        near = ((~mid) & (p[:, 2] == 0) & (np.abs(p[:, 1]) < size[1])
                & (np.abs(p[:, 0]) != size[2]))
        assert near.sum() > 0 and (np.abs(out_n[near, 0]) > 0.999).all()
    if name == "cylinder":
        # on the rim both distances are 0: the outside term's gradient is
        # 0 / sqrt(1e-12), and the inside term's 1/2 (minimum with 0) is
        # shared by the two tied maxima, 1/4 each
        rim = ties["rim"]
        g = sdf._GRADS[name](torch.from_numpy(size), torch.from_numpy(p[rim])).numpy()
        np.testing.assert_allclose(np.abs(g[:, 1]), 0.25, rtol=1e-6)
        np.testing.assert_allclose(np.hypot(g[:, 0], g[:, 2]), 0.25, rtol=1e-6)
    if name in ("cylinder", "torus"):
        axis = ties["axis"]
        assert np.isfinite(out_n[axis]).all()
        np.testing.assert_array_equal(out_n[axis][:, [0, 2]], 0)


@pytest.mark.parametrize("name, which", CASES)
def test_autograd_matches_jax(name, which):
    """The VJPs of the distance and of the normal with respect to p and the
    size against ``jax.grad`` of the same sum: each point's cotangent of p
    relative to its own size (on the axis of the cylinder and the torus the
    normal's derivative is ~1e6: the 1e-12 in ``_length``), and the size's."""
    size = np.asarray(SIZES[name][which], np.float32)
    p = _points(1)
    rng = np.random.default_rng(3)
    cd = rng.standard_normal(len(p)).astype(np.float32)
    cn = rng.standard_normal(p.shape).astype(np.float32)
    jfn = jsdf.get_sdf(name)
    jnormal = jsdf.sdf_normal(jfn)

    def jloss(s, q):
        return jnp.sum(jfn(s, q) * cd) + jnp.sum(jnormal(s, q) * cn)

    jds, jdp = (_np(t) for t in jax.grad(jloss, argnums=(0, 1))(jnp.asarray(size),
                                                                 jnp.asarray(p)))
    ts = torch.from_numpy(size).requires_grad_()
    tp = torch.from_numpy(p).requires_grad_()
    loss = ((sdf.get_sdf(name)(ts, tp) * torch.from_numpy(cd)).sum()
            + (sdf.sdf_normal(name)(ts, tp) * torch.from_numpy(cn)).sum())
    tds, tdp = (t.numpy() for t in torch.autograd.grad(loss, (ts, tp)))
    assert np.isfinite(tdp).all() and np.isfinite(jdp).all()
    scale = np.abs(jdp).max(-1, keepdims=True)
    assert (np.abs(tdp - jdp) <= 1e-4 * scale + 1e-4).all(), np.abs(tdp - jdp).max()
    # the size's cotangent sums over ~7,000 points' terms of up to ~1e2
    np.testing.assert_allclose(tds, jds, rtol=1e-4, atol=1e-4 * np.abs(jds).max())
    if name == "chopsticks":
        assert jds[2] != 0  # the offset's cotangent
