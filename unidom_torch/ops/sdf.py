"""Signed-distance functions of the MPM engine's rigid primitives, with their
unit normals written out by hand.

Counterpart of ``unidom_tpu/ops/sdf.py``: all eight of its SDFs, ``box``,
``container``, ``sphere``, ``capsule``, ``cylinder``, ``torus``,
``rolling_pin`` and ``chopsticks``, each of which the MPM kernels take.
``size`` is (..., 3) and broadcasts against points ``p`` (..., 3) in the
primitive's local frame.

The JAX package takes the normal as ``jax.grad`` of the SDF, normalised.
``sdf_normal`` writes that gradient out and keeps ``jax.grad``'s conventions
where the SDF has a kink, because grid nodes sit on a lattice and hit the
kinks exactly (a primitive at x = 0.5 sits on node 32 of 64):
  - ``abs'(0) = 1`` (``jax.lax.abs``'s derivative is +1 for x >= 0), in the
    normal and, through ``_abs``, in autograd of the distance and of the
    normal (``torch.abs``'s derivative is 0 at 0);
  - ``jnp.maximum``, ``jnp.minimum`` and ``jnp.clip`` split the derivative
    1/2 and 1/2 at a tie (``torch.maximum`` and ``torch.minimum`` do too;
    ``torch.clamp`` would not);
  - ``jnp.max`` over an axis splits it equally among the tied entries
    (``torch.amax`` does too).
Each gradient is written as ``jax.grad`` computes it, its tie factors
constants, so that autograd of a gradient is JAX's second derivative. The
kinks the lattice hits: the capsule's and the rolling pin's clip at
``|p_axis| = size[1]``; the cylinder's ``max(d_xz, d_y)`` on its rim and
its clips at 0; the axis ``p_x = p_z = 0`` of the cylinder and the torus
(``_length`` keeps its 1e-12 there); and the chopsticks' ``minimum`` of two
mirrored capsules on the midplane ``x = 0``, where the x-components of
their gradients cancel.
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


def _clip(x, lo, hi):
    """``jnp.clip(x, lo, hi)`` with tensor bounds, its derivative split 1/2
    and 1/2 at a tie (``jnp.clip`` is ``minimum(hi, maximum(lo, x))``)."""
    return torch.minimum(torch.maximum(x, lo), hi)


def _clip_grad(x, lo, hi):
    """d clip(x, lo, hi) / dx in ``jnp.clip``'s convention: 1 inside, 1/2 at a
    bound, 0 outside (1/4 where lo = x = hi)."""
    return _tie_half(x, lo) * _tie_half(hi, torch.maximum(x, lo))


def _capsule_q(size, p, axis):
    """p with its ``axis`` component less its clip to [-size[1], size[1]]."""
    s1 = size[..., 1]
    comps = list(p.unbind(-1))
    comps[axis] = comps[axis] - _clip(comps[axis], -s1, s1)
    return torch.stack(comps, dim=-1)


def sdf_capsule(size, p):
    """Vertical (y-axis) capsule: radius size[0], half-height size[1]."""
    return _length(_capsule_q(size, p, 1)) - size[..., 0]


def sdf_rolling_pin(size, p):
    """Horizontal (x-axis) capsule, the rolling pin: radius size[0],
    half-length size[1]."""
    return _length(_capsule_q(size, p, 0)) - size[..., 0]


def _lxz(p):
    return torch.sqrt(p[..., 0] * p[..., 0] + p[..., 2] * p[..., 2] + 1e-12)


def _cylinder_d(size, p):
    return torch.stack([_lxz(p) - size[..., 0], _abs(p[..., 1]) - size[..., 1]], dim=-1)


def sdf_cylinder(size, p):
    """Vertical cylinder: radius size[0], half-height size[1]."""
    d = _cylinder_d(size, p)
    zero = torch.zeros_like(d)
    outside = _length(torch.maximum(d, zero))
    inside = torch.minimum(d.amax(dim=-1), zero[..., 0])
    return outside + inside


def sdf_torus(size, p):
    """Torus in the xz-plane: major radius size[0], minor radius size[1]."""
    q = torch.stack([_lxz(p) - size[..., 0], p[..., 1]], dim=-1)
    return _length(q) - size[..., 1]


def _chopsticks_p(size, p):
    """p in the frames of the two capsules, at x = -size[2] and +size[2]."""
    off = size[..., 2]
    rest = p[..., 1:]
    return (torch.cat([(p[..., 0] - off)[..., None], rest], dim=-1),
            torch.cat([(p[..., 0] + off)[..., None], rest], dim=-1))


def sdf_chopsticks(size, p):
    """Two parallel vertical capsules separated along x by 2 size[2] (the
    chopsticks gripper): radius size[0], half-height size[1]."""
    pa, pb = _chopsticks_p(size, p)
    return torch.minimum(sdf_capsule(size, pa), sdf_capsule(size, pb))


def _grad_capsule_axis(size, p, axis):
    # d |q| / dq = q / |q|; q's axis component carries 1 - clip'
    q = _capsule_q(size, p, axis)
    u = q / _length(q)[..., None]
    s1 = size[..., 1]
    comps = list(u.unbind(-1))
    comps[axis] = comps[axis] * (1.0 - _clip_grad(p[..., axis], -s1, s1))
    return torch.stack(comps, dim=-1)


def _grad_capsule(size, p):
    return _grad_capsule_axis(size, p, 1)


def _grad_rolling_pin(size, p):
    return _grad_capsule_axis(size, p, 0)


def _grad_cylinder(size, p):
    lxz = _lxz(p)
    d = _cylinder_d(size, p)
    zero = torch.zeros_like(d)
    dc = torch.maximum(d, zero)
    # outside = |max(d, 0)|: d_i's share dc_i / |dc|, times max's 1, 1/2, 0;
    # inside = min(max(d), 0): 1 below 0, 1/2 at 0, shared equally by the
    # tied maxima of d
    m = d.amax(dim=-1, keepdim=True)
    ties = (d == m).to(p.dtype)
    g_d = (dc / _length(dc)[..., None] * _tie_half(d, zero)
           + _tie_half(zero[..., :1], m) * ties / ties.sum(dim=-1, keepdim=True))
    g_xz = g_d[..., 0] / lxz
    return torch.stack([g_xz * p[..., 0], g_d[..., 1] * _abs_grad(p[..., 1]),
                        g_xz * p[..., 2]], dim=-1)


def _grad_torus(size, p):
    lxz = _lxz(p)
    q = torch.stack([lxz - size[..., 0], p[..., 1]], dim=-1)
    u = q / _length(q)[..., None]
    g_xz = u[..., 0] / lxz
    return torch.stack([g_xz * p[..., 0], u[..., 1], g_xz * p[..., 2]], dim=-1)


def _grad_chopsticks(size, p):
    # minimum's 1, 1/2, 0 to each capsule
    pa, pb = _chopsticks_p(size, p)
    ca, cb = sdf_capsule(size, pa), sdf_capsule(size, pb)
    return (_tie_half(cb, ca)[..., None] * _grad_capsule(size, pa)
            + _tie_half(ca, cb)[..., None] * _grad_capsule(size, pb))


SDF_REGISTRY = {
    "box": sdf_box,
    "sphere": sdf_sphere,
    "capsule": sdf_capsule,
    "cylinder": sdf_cylinder,
    "torus": sdf_torus,
    "rolling_pin": sdf_rolling_pin,
    "chopsticks": sdf_chopsticks,
    "container": sdf_container,
}
_GRADS = {
    "box": _grad_box,
    "sphere": _grad_sphere,
    "capsule": _grad_capsule,
    "cylinder": _grad_cylinder,
    "torus": _grad_torus,
    "rolling_pin": _grad_rolling_pin,
    "chopsticks": _grad_chopsticks,
    "container": _grad_container,
}


def get_sdf(name):
    if name not in SDF_REGISTRY:
        raise KeyError(f"no SDF {name!r}; unidom_torch has {sorted(SDF_REGISTRY)}")
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
