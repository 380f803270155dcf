"""Differentiable mass-spring cloth simulator in PyTorch.

Counterpart of ``unidom_tpu/engine/cloth.py``: an N x N particle grid
restricted to a ``cloth_mask``, 8-neighbour springs, gravity, damping,
static and dynamic ground friction, two suction-ball grippers and a
per-substep gradient renormalisation. State is dense over the mask's
bounding box, (B, H, W, 3).

``ClothSimulator.step_batch`` runs one robot step (``n_substeps`` substeps)
for the whole batch. For CPU tensors it runs the plain PyTorch step
(``_robot_step_plain``), which mirrors the JAX oracle ``_substep`` operator
for operator, so torch autograd through it gives the oracle's gradients. For
CUDA tensors it launches the hand-written robot-step kernels, forward and
backward (``unidom_torch/ops/cuda/cloth_kernel.py``), or raises.
"""

import dataclasses
import math
from dataclasses import dataclass

import numpy as np
import torch

from unidom_torch.ops.cuda.cloth_kernel import cloth_robot_step
from unidom_torch.ops.gradops import clip as _clip
from unidom_torch.ops.gradops import normalize_grad


@dataclass
class ClothState:
    """Per-batch dynamic state; every tensor has a leading batch dim B."""

    x: torch.Tensor  # (B, H, W, 3) particle positions (dense bbox layout)
    v: torch.Tensor  # (B, H, W, 3) particle velocities
    primitive0: torch.Tensor  # (B, 4) gripper-0 [x, y, z, radius]
    primitive1: torch.Tensor  # (B, 4) gripper-1
    action0: torch.Tensor  # (B, 4) per-substep gripper-0 action [dx, dy, dz, suction]
    action1: torch.Tensor  # (B, 4)
    cur_step: torch.Tensor  # (B,) int32 macro-step counter
    stiffness: torch.Tensor  # (B,) spring stiffness
    mu: torch.Tensor  # (B,) ground friction coefficient

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


@dataclass
class ClothConf:
    """Static cloth configuration. ``stiffness``/``mu`` are the reset-time
    defaults; the live values are state."""

    N: int = 80
    gravity: float = 0.5
    stiffness: float = 900.0
    damping: float = 2.0
    dt: float = 2e-3
    max_v: float = 2.0
    small_num: float = 1e-8
    mu: float = 0.5
    seed: int = 1  # seeds the env's reset when no generator is given
    n_substeps: int = 50
    gripper_radius: float = 0.01  # must exceed half the particle spacing 1/N
    task: str = "cloth"
    goal_path: str = ""
    use_substep_obs: bool = True

    @property
    def cell_size(self):
        return 1.0 / self.N

    @property
    def size(self):
        return int(self.N / 5.0)


# 8-connected spring topology, (di, dj) per link
LINKS = np.array([[-1, 0], [1, 0], [0, -1], [0, 1], [-1, -1], [1, -1], [-1, 1], [1, 1]])


LINK_NONE = 5  # the nibble of offset (0, 0): no spring


def _pack_links(offset, rest, valid, cell_size):
    """Pack (H, W, 8) links (offset (di, dj) after the global-grid clip, rest
    length, validity) into an (H*W,) int32 code per cell and the rest lengths
    (axial, diagonal). Raises unless every spring's rest length is one of the
    two and its neighbour lies in the bbox, as the kernels assume."""
    H, W = rest.shape[:2]
    if not np.isin(valid, (0.0, 1.0)).all():
        raise ValueError("link validity must be 0 or 1")
    on = valid > 0
    diag = (offset[..., 0] != 0) & (offset[..., 1] != 0)
    lengths = np.float32(cell_size * np.array([1.0, np.sqrt(2.0)]))
    if not np.array_equal(rest[on], lengths[diag.astype(int)][on]):
        raise ValueError("a spring's rest length is neither the axial nor the diagonal one")
    i, j = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    ni, nj = i[..., None] + offset[..., 0], j[..., None] + offset[..., 1]
    if not ((ni[on] >= 0) & (ni[on] < H) & (nj[on] >= 0) & (nj[on] < W)).all():
        raise ValueError("a spring's neighbour lies outside the bbox")
    nibble = np.where(on, (offset[..., 0] + 1) * 4 + offset[..., 1] + 1, LINK_NONE)
    code = (nibble.astype(np.uint32) << (4 * np.arange(8, dtype=np.uint32))).sum(-1)
    return code.reshape(-1).astype(np.uint32).view(np.int32), tuple(float(r) for r in lengths)


def _edge_pad(x):
    """Edge-pad (B, H, W, C) by one cell on both spatial dims."""
    x = torch.cat([x[:, :1], x, x[:, -1:]], dim=1)
    return torch.cat([x[:, :, :1], x, x[:, :, -1:]], dim=2)


class ClothSimulator:
    """Owns the spring topology (host numpy, copied to ``device`` once) and
    the batched step and reset. ``device`` defaults to the GPU; pass
    ``device="cpu"`` for the plain step on the host."""

    def __init__(self, conf: ClothConf, batch_size: int, cloth_mask, device="cuda"):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.conf = conf
        self.batch_size = batch_size
        self.device = torch.device(device)

        N = conf.N
        mask = np.asarray(cloth_mask, dtype=np.float32)
        idx_i, idx_j = np.nonzero(mask)
        if len(idx_i) == 0:
            raise ValueError("empty cloth mask")
        self.n_particles = int(len(idx_i))
        self.particle_scale = float(mask.sum())  # normalize_grad divisor

        i0, i1 = int(idx_i.min()), int(idx_i.max()) + 1
        j0, j1 = int(idx_j.min()), int(idx_j.max()) + 1
        self.bbox = (i0, i1, j0, j1)
        self.H, self.W = i1 - i0, j1 - j0

        mask_bbox = mask[i0:i1, j0:j1]
        self.pack_idx = torch.as_tensor(
            np.flatnonzero(mask_bbox.reshape(-1) > 0), device=self.device
        )

        # Per-cell, per-link rest length and validity from the global-grid
        # clip rule: the neighbour index is clipped to [0, N-1], so the rest
        # length can shorten or vanish at the border. Links that leave the
        # mask (hence every link that leaves the bbox) are invalid.
        gi, gj = np.meshgrid(np.arange(i0, i1), np.arange(j0, j1), indexing="ij")
        cell = np.stack([gi, gj], axis=-1)  # (H, W, 2) global indices
        nbr = np.clip(cell[:, :, None, :] + LINKS[None, None], 0, N - 1)
        rest = conf.cell_size * np.linalg.norm(nbr - cell[:, :, None, :], axis=-1)
        valid = (rest != 0.0).astype(np.float32)
        valid *= mask[nbr[..., 0], nbr[..., 1]]
        valid *= mask_bbox[..., None]  # sources outside the mask are inert
        rest = np.clip(rest, 1e-12, np.inf).astype(np.float32)  # (H, W, 8)
        self.rest_len = torch.as_tensor(rest, device=self.device)
        self.nbr_valid = torch.as_tensor(valid, device=self.device)
        # The same links packed for the kernels: per cell one int32 with a
        # nibble per link, the neighbour's offset after the clip
        # ((di + 1) * 4 + (dj + 1)) or LINK_NONE, and the two rest lengths
        # (axial, diagonal) that every spring has.
        code, self.rest_lengths = _pack_links(nbr - cell[:, :, None, :], rest, valid,
                                              conf.cell_size)
        self.link_code = torch.as_tensor(code, device=self.device)
        self.damping_factor = float(np.exp(np.float32(-conf.damping * conf.dt)))

    # ------------------------------------------------------------------ #
    # layout helpers
    # ------------------------------------------------------------------ #

    def pack(self, x_dense):
        """Dense (..., H, W, 3) -> packed (..., P, 3) over mask cells."""
        flat = x_dense.reshape(x_dense.shape[:-3] + (self.H * self.W, 3))
        return flat.index_select(-2, self.pack_idx)

    def unpack(self, x_packed, fill):
        """Packed (..., P, 3) -> dense (..., H, W, 3); non-mask cells from ``fill``."""
        flat = fill.reshape(fill.shape[:-3] + (self.H * self.W, 3)).clone()
        flat[..., self.pack_idx, :] = x_packed
        return flat.reshape(fill.shape)

    # ------------------------------------------------------------------ #
    # plain dynamics (the kernel's reference and the CPU path)
    # ------------------------------------------------------------------ #

    def _spring_force(self, x, stiffness):
        """Sum of the 8 masked spring forces. x: (B, H, W, 3), stiffness: (B,)."""
        H, W = self.H, self.W
        xp = _edge_pad(x)
        stiffness = stiffness.view(-1, 1, 1, 1)
        force = torch.zeros_like(x)
        for l, (di, dj) in enumerate(LINKS):
            nb = xp[:, 1 + di : 1 + di + H, 1 + dj : 1 + dj + W]
            rel = nb - x
            cur = _clip(torch.sum(rel * rel, -1, keepdim=True), 1e-12, math.inf) ** 0.5
            rest = self.rest_len[:, :, l, None]
            fl = stiffness * rel / cur * (cur - rest) / rest
            force = force + fl * self.nbr_valid[:, :, l, None]
        return force

    def _primitive_collision(self, x, v, action, ps):
        """Suction-ball gripper: particles inside the ball move rigidly with
        it while suction is engaged (suction 0 engages, 1 releases)."""
        pos = ps[:, None, None, :3]
        radius = ps[:, 3, None, None]
        d_v = action[:, None, None, :3]
        suction = action[:, 3, None, None, None]

        dist = torch.linalg.vector_norm(x - pos, dim=-1)
        mask = (dist <= radius)[..., None]
        v = torch.where(mask, suction * v, v)
        x = torch.where(mask, x + d_v * (1.0 - suction), x)

        x = normalize_grad(x, self.particle_scale, batch_dims=1)
        v = normalize_grad(v, self.particle_scale, batch_dims=1)
        return x, v

    def _substep(self, state: ClothState):
        conf = self.conf
        dt = conf.dt
        small = conf.small_num
        x, v = state.x, state.v
        mu = state.mu.view(-1, 1, 1)

        v = v - x.new_tensor([0.0, conf.gravity * dt, 0.0])

        force = self._spring_force(x, state.stiffness)
        f0, f1, f2 = force.unbind(-1)
        f1 = f1 + (-conf.gravity)

        # ground friction
        friction_mask = x[..., 1] <= small
        muF = mu * _clip(f1, -math.inf, 0.0) * -1.0
        xV, yV = v[..., 0], v[..., 2]
        sV = torch.sqrt(xV**2 + yV**2 + small)

        dyn = (friction_mask & (sV > small)).float()
        f0 = f0 + -dyn * muF * xV / sV
        f2 = f2 + -dyn * muF * yV / sV

        stat = friction_mask & (sV <= small)
        xF, yF = f0, f2
        sF = torch.sqrt(xF**2 + yF**2 + small)

        zero = (stat & (muF > sF)).float()
        f0 = (1.0 - zero) * f0
        f2 = (1.0 - zero) * f2

        nonzero = (stat & (muF <= sF)).float()
        R = 1.0 - muF / sF
        f0 = (R * xF) * nonzero + f0 * (1.0 - nonzero)
        f2 = (R * yF) * nonzero + f2 * (1.0 - nonzero)
        force = torch.stack([f0, f1, f2], dim=-1)

        v = v + force * dt
        v = v * self.damping_factor

        x, v = self._primitive_collision(x, v, state.action0, state.primitive0)
        x, v = self._primitive_collision(x, v, state.action1, state.primitive1)

        zero_col = torch.zeros_like(state.action0[:, :1])
        ps0 = _clip(state.primitive0 + torch.cat([state.action0[:, :3], zero_col], 1), 0.0, 1.0)
        ps1 = _clip(state.primitive1 + torch.cat([state.action1[:, :3], zero_col], 1), 0.0, 1.0)

        x = _clip(x, 0.0, 1.0)
        v = _clip(v, -conf.max_v, conf.max_v)
        x = x + dt * v

        scale = self.particle_scale
        x = normalize_grad(x, scale, batch_dims=1)
        v = normalize_grad(v, scale, batch_dims=1)
        ps0 = normalize_grad(ps0, scale, batch_dims=1)
        ps1 = normalize_grad(ps1, scale, batch_dims=1)
        return state.replace(x=x, v=v, primitive0=ps0, primitive1=ps1)

    def prepare_actions(self, action):
        """(B, 8) robot action -> per-substep (B, 4) actions for both grippers:
        xyz clipped to +-2 and spread over the substeps, suction unscaled."""
        n = self.conf.n_substeps
        a0 = torch.cat([_clip(action[:, 0:3], -2.0, 2.0) / n, action[:, 3:4]], 1)
        a1 = torch.cat([_clip(action[:, 4:7], -2.0, 2.0) / n, action[:, 7:8]], 1)
        return a0, a1

    def _run_substeps(self, state: ClothState):
        """``n_substeps`` plain substeps under the state's per-substep actions."""
        for _ in range(self.conf.n_substeps):
            state = self._substep(state)
        return state

    def _robot_step_plain(self, state: ClothState, action):
        """One robot step in plain PyTorch: ``n_substeps`` substeps."""
        action0, action1 = self.prepare_actions(action)
        return self._run_substeps(state.replace(action0=action0, action1=action1))

    def step_batch(self, state: ClothState, action):
        """One robot step for the batch: plain on CPU, the CUDA kernel on CUDA."""
        return cloth_robot_step(self, state, action)

    # ------------------------------------------------------------------ #
    # reset
    # ------------------------------------------------------------------ #

    def reset(self):
        """Batched initial state: the flat cloth at rest on the ground."""
        conf = self.conf
        N = conf.N
        dev = self.device
        ii, jj = np.meshgrid(np.arange(N), np.arange(N), indexing="ij")
        grid = np.stack(
            [ii * conf.cell_size, np.zeros_like(ii, dtype=np.float64), (N - jj) * conf.cell_size],
            axis=-1,
        ).astype(np.float32)
        i0, i1, j0, j1 = self.bbox
        B = self.batch_size
        r = conf.gripper_radius
        f32 = dict(dtype=torch.float32, device=dev)
        x = torch.as_tensor(grid[i0:i1, j0:j1], device=dev)
        return ClothState(
            x=x.expand(B, -1, -1, -1).contiguous(),
            v=torch.zeros((B, self.H, self.W, 3), **f32),
            primitive0=torch.tensor([0.5, 0.5, 0.5, r], **f32).expand(B, 4).contiguous(),
            primitive1=torch.tensor([1.0, 1.0, 1.0, r], **f32).expand(B, 4).contiguous(),
            action0=torch.zeros((B, 4), **f32),
            action1=torch.zeros((B, 4), **f32),
            cur_step=torch.zeros((B,), dtype=torch.int32, device=dev),
            stiffness=torch.full((B,), conf.stiffness, **f32),
            mu=torch.full((B,), conf.mu, **f32),
        )
