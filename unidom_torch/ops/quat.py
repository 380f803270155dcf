"""Quaternion math for rigid-primitive kinematics.

Counterpart of ``unidom_tpu/ops/quat.py``. Quaternions are ``[w, x, y, z]``
with unit norm, in the last dimension; norms are written out as
``sqrt(sum(x * x))`` in the JAX version's order.
"""

import torch


def _norm(x):
    return torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))


def qmul(q, r):
    """Hamilton product q*r, renormalised to guard against drift."""
    w1, x1, y1, z1 = q.unbind(-1)
    w2, x2, y2, z2 = r.unbind(-1)
    out = torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )
    return out / torch.clamp(_norm(out), min=1e-12)


def w2quat(axis_angle):
    """Axis-angle (..., 3) -> unit quaternion, safe at zero rotation."""
    w = _norm(axis_angle) + 1e-12
    v = (axis_angle / w) * torch.sin(w / 2.0)
    return torch.cat([torch.cos(w / 2.0), v], dim=-1)


def qinv(q):
    """Conjugate of a unit quaternion (renormalised)."""
    conj = torch.cat([q[..., :1], -q[..., 1:]], dim=-1)  # q * (1, -1, -1, -1), exactly
    return conj / (_norm(conj) + 1e-12)


def qrot(q, v):
    """Rotate vectors v (..., 3) by quaternions q (..., 4) that broadcast
    against them."""
    qvec = q[..., 1:4].expand(v.shape)
    uv = torch.linalg.cross(qvec, v)
    uuv = torch.linalg.cross(qvec, uv)
    return v + 2.0 * (q[..., 0:1] * uv + uuv)
