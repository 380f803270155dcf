"""Signed-distance functions of the MPM engine's rigid primitives, with their
unit normals written out by hand.

Counterpart of ``unidom_tpu/ops/sdf.py`` for the three SDFs that the MPM
kernels take: ``box``, ``container`` and ``sphere`` (capsule, cylinder,
torus, rolling_pin and chopsticks wait for the envs that use them). ``size`` is (..., 3) and broadcasts against points ``p``
(..., 3) in the primitive's local frame.

The JAX package takes the normal as ``jax.grad`` of the SDF, normalised.
``sdf_normal`` writes that gradient out and keeps ``jax.grad``'s conventions
where the SDF has a kink, because grid nodes sit on a lattice and hit the
kinks exactly (a primitive at x = 0.5 sits on node 32 of 64):
  - ``abs'(0) = 1`` (``jax.lax.abs``'s derivative is +1 for x >= 0), in the
    normal and, through ``_abs``, in autograd of the distance and of the
    normal (``torch.abs``'s derivative is 0 at 0);
  - ``jnp.maximum`` and ``jnp.clip`` split the derivative 1/2 and 1/2 at a tie;
  - ``jnp.max`` over an axis splits it equally among the tied entries.
``unidom_torch/csrc/mpm_device.cuh`` evaluates the same formulas, and their
adjoint, on the card.
"""

import torch


def _length(x):
    return torch.sqrt(torch.sum(x * x, dim=-1) + 1e-12)


def _abs(x):
    """|x| with ``jax.lax.abs``'s derivative: +1 for x >= 0, else -1."""
    return torch.where(x >= 0, x, -x)


def sdf_box(size, p):
    """Axis-aligned box with half-extents ``size``."""
    q = _abs(p) - size
    out = _length(torch.clamp(q, min=0.0))
    inner = torch.clamp(q.max(dim=-1).values, max=0.0)
    return out + inner


def sdf_sphere(size, p):
    """Sphere of radius size[0]."""
    return _length(p) - size[..., 0]


def _container_q(size, p):
    r, h = size[..., 0], size[..., 1]
    w = torch.sqrt(torch.clamp(r * r - h * h, min=1e-12))
    q0 = torch.sqrt(p[..., 0] * p[..., 0] + p[..., 2] * p[..., 2] + 1e-12)
    return r, h, w, q0, p[..., 1]


def sdf_container(size, p):
    """Cut hollow sphere (an open bowl): radius r, cut height h, thickness t."""
    r, h, w, q0, q1 = _container_q(size, p)
    t = size[..., 2]
    cut = h * q0 < w * q1
    rim = torch.sqrt((q0 - w) ** 2 + (q1 - h) ** 2 + 1e-12) - t
    shell = _abs(torch.sqrt(q0 * q0 + q1 * q1 + 1e-12) - r) - t
    return torch.where(cut, rim, shell)


def _abs_grad(x):
    """d |x| / dx in ``jax.lax.abs``'s convention: +1 for x >= 0, else -1."""
    return torch.where(x >= 0, torch.ones_like(x), -torch.ones_like(x))


def _tie_half(lhs, rhs):
    """d max(lhs, rhs) / d lhs in ``jnp.maximum``'s convention: 1, 1/2 at a
    tie, 0."""
    return (lhs > rhs).to(lhs.dtype) + 0.5 * (lhs == rhs).to(lhs.dtype)


def _grad_box(size, p):
    q = _abs(p) - size
    qc = torch.clamp(q, min=0.0)
    # out = |clip(q, 0, inf)|: qc / |qc| where q > 0; qc = 0 at the tie q = 0
    g_out = qc / _length(qc)[..., None]
    # inner = clip(max(q), -inf, 0): 1 below 0, 1/2 at 0, shared equally by
    # the tied maxima of q
    m = q.max(dim=-1, keepdim=True).values
    ties = (q == m).to(p.dtype)
    c_min = _tie_half(-m, torch.zeros_like(m))
    g_in = c_min * ties / ties.sum(dim=-1, keepdim=True)
    return _abs_grad(p) * (g_out + g_in)


def _grad_sphere(size, p):
    # the gradient of sqrt(|p|^2 + 1e-12): p / |p|, and 0 at p = 0
    return p / _length(p)[..., None]


def _grad_container(size, p):
    r, h, w, q0, q1 = _container_q(size, p)
    cut = h * q0 < w * q1
    l_rim = torch.sqrt((q0 - w) ** 2 + (q1 - h) ** 2 + 1e-12)
    l_shell = torch.sqrt(q0 * q0 + q1 * q1 + 1e-12)
    s = _abs_grad(l_shell - r)
    g0 = torch.where(cut, (q0 - w) / l_rim, s * q0 / l_shell)
    g1 = torch.where(cut, (q1 - h) / l_rim, s * q1 / l_shell)
    return torch.stack([g0 * p[..., 0] / q0, g1, g0 * p[..., 2] / q0], dim=-1)


SDF_REGISTRY = {"box": sdf_box, "container": sdf_container, "sphere": sdf_sphere}
_GRADS = {"box": _grad_box, "container": _grad_container, "sphere": _grad_sphere}


def get_sdf(name):
    if name not in SDF_REGISTRY:
        raise KeyError(f"SDF {name!r} is not ported; unidom_torch has {sorted(SDF_REGISTRY)}")
    return SDF_REGISTRY[name]


def sdf_normal(name):
    """Unit normal field ``normal(size, p)`` of the SDF ``name``: its gradient
    in ``jax.grad``'s conventions, divided by ``sqrt(|g|^2 + 1e-12)``."""
    get_sdf(name)
    grad = _GRADS[name]

    def normal(size, p):
        g = grad(size, p)
        return g / _length(g)[..., None]

    return normal
