"""Target-driven losses for MPM trajectory optimisation.

Counterpart of ``unidom_tpu/engine/losses.py``: a target density grid
defines an L1 density loss, an SDF loss (mass weighted by the distance to
the target) and a contact loss that pulls each manipulator to the material
(the hard minimum distance, or a soft weighted one), summed with
configurable weights; a mass-weighted IoU; and the reward and incremental-IoU
bookkeeping of an episode (``LossTracker``). The target's distance field is
a jump-flooding transform (``target_sdf_jfa``) in JAX's shift order, so its
ties resolve as JAX's do.

Plain PyTorch: no kernel of the JAX package computes any of this. A grid
function takes particles (..., P, 3) and returns (..., *res): any leading
dims are a batch of envs.
"""

from dataclasses import dataclass, replace
from typing import Sequence, Tuple

import numpy as np
import torch

_OFFSETS = np.array([[i, j, k] for i in range(3) for j in range(3) for k in range(3)])


def compute_grid_mass(x, res: Tuple[int, int, int], inv_dx: float, p_mass: float = 1.0):
    """Quadratic B-spline P2G of particle mass: x (..., P, 3) -> (..., *res).
    A stencil node outside the grid gets weight 0 at a clipped index."""
    lead, P = x.shape[:-2], x.shape[-2]
    x = x.reshape((-1, P, 3))
    n_env = x.shape[0]
    base = torch.floor(x * inv_dx - 0.5).to(torch.int32)
    fx = x * inv_dx - base.to(x.dtype)
    w = torch.stack([0.5 * (1.5 - fx) ** 2, 0.75 - (fx - 1.0) ** 2, 0.5 * (fx - 0.5) ** 2],
                    dim=-2)  # (n, P, 3 nodes, 3 dims)
    weight = (w[..., :, 0][..., :, None, None] * w[..., :, 1][..., None, :, None]
              * w[..., :, 2][..., None, None, :]).reshape(n_env, P, 27)
    offsets = torch.as_tensor(_OFFSETS, dtype=torch.int32, device=x.device)
    res_t = torch.as_tensor(res, dtype=torch.int32, device=x.device)
    node = base[..., None, :] + offsets  # (n, P, 27, 3)
    ok = torch.all((node >= 0) & (node < res_t), dim=-1)
    weight = torch.where(ok, weight, torch.zeros_like(weight))
    node = torch.minimum(torch.clamp(node, min=0), res_t - 1).long()
    cells = res[0] * res[1] * res[2]
    flat = (node[..., 0] * res[1] + node[..., 1]) * res[2] + node[..., 2]
    flat = flat + cells * torch.arange(n_env, device=x.device)[:, None, None]
    grid = torch.zeros((n_env * cells,), dtype=x.dtype, device=x.device).index_add_(
        0, flat.reshape(-1), (weight * p_mass).reshape(-1))
    return grid.reshape(lead + tuple(res))


# the jump flood's shifts, in JAX's order: ties keep the earlier candidate
_JFA_OFFSETS = [(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)
                if (i, j, k) != (0, 0, 0)]


def target_sdf_jfa(target_density, dx: float, threshold: float = 1e-4):
    """Distance-to-target field by jump flooding. Returns (sdf, nearest
    point). A cell with target mass gets sdf 0 and itself as its nearest
    point; an empty cell the distance to the nearest occupied cell's
    centre found by the flood (log2 rounds of 26 shifts, which wrap as
    ``jnp.roll`` does: a wrapped candidate is far away); 1000 where there is
    no target at all."""
    res = target_density.shape
    dev = target_density.device
    axes = [torch.arange(r, device=dev) for r in res]
    grids = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1).to(torch.float32) * dx
    occupied = target_density > threshold
    INF = 1e9
    nearest = torch.where(occupied[..., None], grids, torch.full_like(grids, INF))

    def dist(pts):
        return torch.sqrt(torch.sum((grids - pts) ** 2, -1) + 1e-8)

    step = max(res) // 2
    while step >= 1:
        for oi, oj, ok in _JFA_OFFSETS:
            cand = torch.roll(nearest, (oi * step, oj * step, ok * step), dims=(0, 1, 2))
            better = dist(cand) < dist(nearest)
            nearest = torch.where(better[..., None], cand, nearest)
        step //= 2

    sdf = torch.where(occupied, torch.zeros_like(target_density), dist(nearest))
    sdf = torch.where(torch.any(nearest >= INF, -1), torch.full_like(sdf, 1000.0), sdf)
    return sdf, nearest


@dataclass(frozen=True)
class LossWeights:
    sdf: float = 10.0
    density: float = 10.0
    contact: float = 1.0


class TargetLoss:
    """Per-env target loss over (particles, primitives), on the target
    density's device. ``losses(x, prim_dists)`` takes x (..., P, 3)."""

    def __init__(self, target_density, res, inv_dx, weights: LossWeights = LossWeights(),
                 soft_contact: bool = False):
        self.res = tuple(res)
        self.inv_dx = inv_dx
        self.dx = 1.0 / inv_dx
        self.weights = weights
        self.soft_contact = soft_contact
        self.target_density = torch.as_tensor(target_density)
        self.target_sdf, _ = target_sdf_jfa(self.target_density, self.dx)
        self._target_iou = float(self.iou(self.target_density))

    @staticmethod
    def from_particles(points, res, inv_dx, **kw):
        density = compute_grid_mass(torch.as_tensor(points), tuple(res), inv_dx)
        return TargetLoss(density, res, inv_dx, **kw)

    # ---------------- individual terms ---------------- #

    def _sum_grid(self, t):
        return t.sum(dim=(-3, -2, -1))

    def density_loss(self, grid_mass):
        return self._sum_grid(torch.abs(grid_mass - self.target_density))

    def sdf_loss(self, grid_mass):
        return self._sum_grid(self.target_sdf * grid_mass)

    @staticmethod
    def _soft_weight(d):
        return 1.0 / (1.0 + d * d * 10000.0)

    def contact_loss(self, prim_dists: Sequence[torch.Tensor]):
        """prim_dists: per primitive, the SDF distance (..., P) of every
        particle to the manipulator, clamped at 0 here."""
        total = 0.0
        for d in prim_dists:
            d = torch.clamp(d, min=0.0)
            if self.soft_contact:
                w = self._soft_weight(d)
                min_dist = (d * w).sum(-1) / (w.sum(-1) + 1e-12)
            else:
                min_dist = d.min(dim=-1).values
            total = total + min_dist**2
        return total

    def iou(self, grid_mass):
        """Mass-weighted IoU (the reference's iou_kernel)."""
        ma = grid_mass.amax(dim=(-3, -2, -1))
        mb = self.target_density.max()
        inter = self._sum_grid(grid_mass * self.target_density) / (ma * mb + 1e-30)
        union = self._sum_grid(grid_mass) / (ma + 1e-30) + self.target_density.sum() / (mb + 1e-30)
        return inter / (union - inter + 1e-30)

    # ---------------- combined ---------------- #

    def losses(self, x, prim_dists: Sequence[torch.Tensor] = ()):
        grid_mass = compute_grid_mass(x, self.res, self.inv_dx)
        d = self.density_loss(grid_mass)
        s = self.sdf_loss(grid_mass)
        c = self.contact_loss(prim_dists) if len(prim_dists) else torch.zeros_like(d)
        w = self.weights
        total = w.sdf * s + w.density * d + w.contact * c
        return {
            "loss": total,
            "sdf_loss": s,
            "density_loss": d,
            "contact_loss": c,
            "iou": self.iou(grid_mass),
            "target_iou": self._target_iou,
        }


@dataclass(frozen=True)
class LossTracker:
    """An episode's reward bookkeeping (the reference's compute_loss):
    reward = start_loss - step loss; the incremental IoU in [0, 1] against
    the target's self-IoU."""

    start_loss: torch.Tensor
    last_loss: torch.Tensor
    init_iou: torch.Tensor

    @staticmethod
    def init(loss_info):
        return LossTracker(start_loss=loss_info["loss"],
                           last_loss=torch.zeros_like(loss_info["loss"]),
                           init_iou=loss_info["iou"])

    def step(self, loss_info):
        """(the tracker after this step, the step's info with reward,
        incremental_iou and the step's loss)."""
        cur = loss_info["loss"] - self.last_loss
        reward = self.start_loss - cur
        inc_iou = torch.clamp((loss_info["iou"] - self.init_iou)
                              / (loss_info["target_iou"] - self.init_iou + 1e-12), 0.0, 1.0)
        info = dict(loss_info)
        info.update({"reward": reward, "incremental_iou": inc_iou, "loss": cur})
        return replace(self, last_loss=loss_info["loss"]), info
