"""Differentiable 3-D MLS-MPM simulator in PyTorch.

Counterpart of ``unidom_tpu/engine/mpm.py``: materials water (0), elastic
(1), sigma-clip plastic (2) and von-Mises plastic (3), the Lame parameters
and yield stress as state (scalar or per particle), quadratic B-spline
transfers in two forms (dense tensor products, which whip_rope picks, and a
flat-index scatter), rigid primitives under collision or position control,
ground friction and 3-cell walls, and primitive buffers of ``steps + 1``
rows.

``MPMSimulator.step_batch`` runs one macro step (``conf.steps`` substeps)
for the batch: for CPU tensors the plain PyTorch step (``_step_plain``),
which mirrors the JAX oracle operator for operator; for CUDA tensors a
hand-written macro-step kernel, or it raises: K2 (one block per env,
``unidom_torch/ops/cuda/mpm_kernel.py``) where it takes the configuration,
else K3-fwd (many blocks per env, ``unidom_torch/ops/cuda/mpm_big_kernel.py``),
as ``kernel_route`` decides. Every tensor of the state has a leading batch
dim B.
"""

import dataclasses
import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from unidom_torch.engine.primitives import PrimitiveState, forward_kinematics, make_collider, set_action
from unidom_torch.ops.cuda.mpm_big_kernel import check_supported_big, mpm_big_step
from unidom_torch.ops.cuda.mpm_kernel import check_supported, mpm_step
from unidom_torch.ops.gradops import clamp_grad_norm_tree, clip, scrub_mpm_state
from unidom_torch.ops.svd3 import svd3

# material enum
WATER, ELASTIC, PLASTIC_CLIP, VON_MISES = 0, 1, 2, 3


@dataclass
class MPMState:
    """Batched dynamic MPM state; every tensor has a leading batch dim B."""

    x: torch.Tensor  # (B, P, 3) positions
    v: torch.Tensor  # (B, P, 3) velocities
    C: torch.Tensor  # (B, P, 3, 3) affine velocity (APIC)
    F: torch.Tensor  # (B, P, 3, 3) deformation gradient
    J: torch.Tensor  # (B, P) volume ratio
    cur_step: torch.Tensor  # (B,) int32 macro-step counter
    primitives: Tuple[PrimitiveState, ...]
    friction: torch.Tensor  # (B, 1) ground friction
    mu: torch.Tensor  # (B, 1) or (B, P) Lame mu
    lamda: torch.Tensor  # (B, 1) or (B, P) Lame lambda
    yield_stress: torch.Tensor  # (B, 1) or (B, P) von-Mises yield stress

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


@dataclass
class MPMConf:
    """Static MPM configuration."""

    n_grid: int = 64
    dt: float = 1e-4
    steps: int = 70  # substeps per macro action
    E: float = 100.0
    nu: float = 0.1
    yield_stress: float = 50.0
    ground_friction: float = 0.1
    res: Tuple[int, int, int] = (32, 32, 32)
    gravity: Tuple[float, float, float] = (0.0, -9.8, 0.0)
    n_primitive: int = 1
    primitive_action_steps: int = 1
    seed: int = 0
    task: str = "mpm"
    goal_path: str = ""
    transfer: str = "auto"  # "auto" | "scatter" | "dense": the plain step's
    # particle <-> grid transfer; "auto" picks dense when its (P, plane)
    # intermediates stay under ~32 MB. The kernel scatters either way.

    @property
    def dx(self):
        return 1.0 / self.n_grid

    @property
    def inv_dx(self):
        return float(self.n_grid)

    @property
    def p_vol(self):
        return (self.dx * 0.5) ** 2

    @property
    def p_mass(self):
        return self.p_vol * 1.0  # p_rho = 1


_OFFSETS = np.array([[i, j, k] for i in range(3) for j in range(3) for k in range(3)])


def kernel_route(sim):
    """The macro-step kernel that runs ``sim`` on the card: ``"k2"`` when
    K2 takes its configuration (small grids, one block per env), else
    ``"k3"`` when K3-fwd does (big grids); raises when neither does. As the
    JAX engine picks its Pallas kernel: small when supported, else big."""
    try:
        check_supported(sim)
        return "k2"
    except NotImplementedError:
        check_supported_big(sim)
        return "k3"


class MPMSimulator:
    """Owns the static particle attributes (material, hardness), the
    primitives' SDFs and the batched step and reset, on ``device`` (the GPU
    unless the caller asks for the CPU)."""

    def __init__(self, conf: MPMConf, batch_size: int, use_position_control=False,
                 device="cuda"):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.conf = conf
        self.batch_size = batch_size
        self.use_position_control = use_position_control
        self.device = torch.device(device)

        self.n_particles = 0
        self.material = None  # (P,) np int32
        self.h = None  # (P,) np float32 hardness
        self.sdf_names = []  # one per primitive
        self._colliders = []  # (collide, position_control) per primitive

        res = conf.res
        idx = np.stack(np.indices(res), axis=-1)  # (rx, ry, rz, 3)
        self.grid_idx_3d = torch.as_tensor(idx, dtype=torch.int32, device=self.device)
        self.offsets = torch.as_tensor(_OFFSETS, dtype=torch.int32, device=self.device)
        self.res_t = torch.as_tensor(res, dtype=torch.int32, device=self.device)
        self._consts = {}

    # ------------------------------------------------------------------ #
    # scene construction (host side)
    # ------------------------------------------------------------------ #

    def register_primitive_sdf(self, sdf_name):
        self._colliders.append(make_collider(sdf_name))
        self.sdf_names.append(sdf_name)

    def add_box(self, state, size, init_pos, hardness=1.0, z_rotation_angle=0.0,
                material=WATER, density=1.0, generator=None):
        """Particles for a box region: uniform-random fill for water (drawn
        from ``generator``, by default one seeded with ``conf.seed``),
        regular-grid fill for solids."""
        conf = self.conf
        size = np.asarray(size, np.float64)
        init_pos = np.asarray(init_pos, np.float64)
        rot = np.array([
            [np.cos(z_rotation_angle), -np.sin(z_rotation_angle)],
            [np.sin(z_rotation_angle), np.cos(z_rotation_angle)],
        ])

        if material == WATER:
            n_points = int(size.prod() * conf.n_grid**3 * density)
            if generator is None:
                generator = torch.Generator().manual_seed(conf.seed)
            x_ = torch.rand((n_points, 3), generator=generator, dtype=torch.float32).numpy()
            x_ = (x_ * 2 - 1) * (0.5 * size)
            x_[:, [0, 2]] = x_[:, [0, 2]] @ rot.T
            x_ = x_ + init_pos
        else:
            n_grid = int(conf.n_grid * density)
            center = np.array([0.5, 0.01, 0.5])
            lower = -0.5 * size + center
            upper = 0.5 * size + center
            # the lattice points i / n_grid in [lower, upper] on each axis, in
            # the C order of np.indices((n_grid,) * 3): those of the whole
            # lattice that the box holds, without making the whole lattice
            axes = []
            for d in range(3):
                c = np.arange(n_grid) / n_grid
                axes.append(c[(c <= upper[d]) & (c >= lower[d])])
            x_ = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, 3) - center
            x_[:, [0, 2]] = x_[:, [0, 2]] @ rot.T
            x_ = x_ + init_pos

        return self._append_particles(state, x_.astype(np.float32), material, hardness)

    def add_sphere(self, state, radius, init_pos, hardness=1.0, material=WATER, density=1.0):
        """Regular-grid sphere of particles."""
        n_grid = int(self.conf.n_grid * density)
        # the lattice points i / n_grid - 0.5 within the radius, in the C
        # order of np.indices((n_grid,) * 3), from the cube of indices that
        # holds the sphere rather than the whole lattice
        c = np.arange(n_grid) / n_grid - 0.5
        near = np.flatnonzero(c * c <= radius * radius)
        c = c[near[0]:near[-1] + 1] if len(near) else c[:0]
        coords = np.stack(np.meshgrid(c, c, c, indexing="ij"), axis=-1)
        mask = (coords**2).sum(-1) <= radius * radius
        x_ = coords[mask] + np.asarray(init_pos, np.float64)
        return self._append_particles(state, x_.astype(np.float32), material, hardness)

    def add_points(self, state, points, hardness=1.0, material=WATER):
        return self._append_particles(state, np.asarray(points, np.float32), material, hardness)

    def _append_particles(self, state, x_, material, hardness):
        n = x_.shape[0]
        mat = np.full((n,), material, dtype=np.int32)
        h = np.full((n,), hardness, dtype=np.float32)
        if state is None:
            self.material, self.h = mat, h
        else:
            x_ = np.concatenate([state.x.cpu().numpy(), x_], axis=0)
            self.material = np.concatenate([self.material, mat])
            self.h = np.concatenate([self.h, h])
        return MPMState(
            x=torch.as_tensor(x_, device=self.device), v=None, C=None, F=None, J=None,
            cur_step=None, primitives=[], friction=None, mu=None, lamda=None,
            yield_stress=None,
        )

    def finalize(self):
        """Freeze the particle count and materials."""
        self.n_particles = len(self.material)
        self._material = torch.as_tensor(self.material, device=self.device)
        self._h = torch.as_tensor(self.h, device=self.device)
        self.transfer_mode = self._pick_transfer()

    def _pick_transfer(self):
        conf = self.conf
        if conf.transfer != "auto":
            return conf.transfer
        rx, ry, rz = conf.res
        # the largest dense intermediate is (P, plane, 3); keep it under ~32 MB
        plane = max(rx * ry, ry * rz, rx * rz)
        return "dense" if self.n_particles * plane * 3 * 4 <= 32 * 2**20 else "scatter"

    # ------------------------------------------------------------------ #
    # reset
    # ------------------------------------------------------------------ #

    def reset(self, state: MPMState):
        """Batched initial state from the particles and primitives of
        ``state``: at rest, F = I, J = 1, the conf's material parameters."""
        conf = self.conf
        self.finalize()
        P, B, dev = self.n_particles, self.batch_size, self.device
        E, nu = conf.E, conf.nu
        mu_0, lambda_0 = E / (2 * (1 + nu)), E * nu / ((1 + nu) * (1 - 2 * nu))
        f32 = dict(dtype=torch.float32, device=dev)

        def batch(t):
            return t[None].expand((B,) + tuple(t.shape)).contiguous()

        prims = tuple(
            PrimitiveState(**{f.name: batch(getattr(p, f.name)) for f in dataclasses.fields(p)})
            for p in state.primitives
        )
        return MPMState(
            x=batch(state.x),
            v=torch.zeros((B, P, 3), **f32),
            C=torch.zeros((B, P, 3, 3), **f32),
            F=batch(torch.eye(3, **f32).expand(P, 3, 3)),
            J=torch.ones((B, P), **f32),
            cur_step=torch.zeros((B,), dtype=torch.int32, device=dev),
            primitives=prims,
            friction=torch.full((B, 1), conf.ground_friction, **f32),
            mu=torch.full((B, 1), mu_0, **f32),
            lamda=torch.full((B, 1), lambda_0, **f32),
            yield_stress=torch.full((B, 1), conf.yield_stress, **f32),
        )

    # ------------------------------------------------------------------ #
    # transfers (plain)
    # ------------------------------------------------------------------ #

    def _weights_and_indices(self, x):
        """Quadratic B-spline stencil: per-particle 27 weights, flat grid
        indices and the node offsets from the particle in cells."""
        conf = self.conf
        base = torch.floor(x * conf.inv_dx - 0.5).to(torch.int32)  # (B, P, 3)
        fx = x * conf.inv_dx - base.to(x.dtype)
        w = torch.stack([0.5 * (1.5 - fx) ** 2, 0.75 - (fx - 1.0) ** 2, 0.5 * (fx - 0.5) ** 2],
                        dim=2)  # (B, P, 3 nodes, 3 dims)
        weight = (w[..., :, 0][..., :, None, None] * w[..., :, 1][..., None, :, None]
                  * w[..., :, 2][..., None, None, :]).reshape(x.shape[:2] + (27,))
        node = base[..., None, :] + self.offsets  # (B, P, 27, 3)
        res = self.res_t
        in_bounds = torch.all((node >= 0) & (node < res), dim=-1)
        weight = torch.where(in_bounds, weight, torch.zeros_like(weight))
        node = torch.minimum(torch.clamp(node, min=0), res - 1)
        flat = (node[..., 0] * conf.res[1] + node[..., 1]) * conf.res[2] + node[..., 2]
        dpos_units = self.offsets.to(x.dtype) - fx[..., None, :]  # (B, P, 27, 3)
        return weight, flat.long(), dpos_units

    def _axis_basis(self, xd, R):
        """Per-axis quadratic B-spline basis. xd: (B, P) coordinate * inv_dx.
        Returns w, w * t: (B, P, R), t = node - xd."""
        t = torch.arange(R, dtype=xd.dtype, device=xd.device) - xd[..., None]
        at = torch.abs(t)
        zero = torch.zeros_like(t)
        w = torch.where(at < 0.5, 0.75 - t * t,
                        torch.where(at < 1.5, 0.5 * (1.5 - at) ** 2, zero))
        return w, w * t

    def _bases(self, x):
        conf = self.conf
        return tuple(self._axis_basis(x[..., d] * conf.inv_dx, conf.res[d]) for d in range(3))

    def _p2g_dense(self, x, v, affine):
        """grid_v (B, *res, 3) and grid_m (B, *res) by three-axis tensor
        contraction."""
        conf = self.conf
        rx, ry, rz = conf.res
        B, P = x.shape[:2]
        (wx, wxd), (wy, wyd), (wz, wzd) = self._bases(x)

        def chain(a, b, c, val):
            # out[n, i, j, k, ch] = sum_p a[n,p,i] b[n,p,j] c[n,p,k] val[n,p,ch]
            byc = (b[..., :, None] * c[..., None, :]).reshape(B, P, ry * rz)
            outs = [(a * val[..., ch:ch + 1]).transpose(1, 2) @ byc for ch in range(val.shape[-1])]
            return torch.stack(outs, -1).reshape(B, rx, ry, rz, val.shape[-1])

        grid_v = chain(wx, wy, wz, conf.p_mass * v)
        grid_v = grid_v + conf.dx * chain(wxd, wy, wz, affine[..., :, 0])
        grid_v = grid_v + conf.dx * chain(wx, wyd, wz, affine[..., :, 1])
        grid_v = grid_v + conf.dx * chain(wx, wy, wzd, affine[..., :, 2])
        grid_m = chain(wx, wy, wz, torch.full((B, P, 1), conf.p_mass, dtype=x.dtype,
                                              device=x.device))[..., 0]
        return grid_v, grid_m

    def _g2p_dense(self, x, grid_v):
        """new_v (B, P, 3) and new_C (B, P, 3, 3) by the adjoint contractions."""
        conf = self.conf
        (wx, wxd), (wy, wyd), (wz, wzd) = self._bases(x)

        def chain(a, b, c):
            t = torch.einsum("npj,nijkc->npikc", b, grid_v)  # contract y
            t = torch.einsum("npk,npikc->npic", c, t)  # contract z
            return torch.einsum("npi,npic->npc", a, t)  # contract x

        new_v = chain(wx, wy, wz)
        C0 = chain(wxd, wy, wz)
        C1 = chain(wx, wyd, wz)
        C2 = chain(wx, wy, wzd)
        new_C = 4.0 * conf.inv_dx * torch.stack([C0, C1, C2], dim=-1)
        return new_v, new_C

    # ------------------------------------------------------------------ #
    # one substep (plain)
    # ------------------------------------------------------------------ #

    def _const(self, name, dtype):
        """The step's constant vector ``name`` (gravity, the ground's normal
        "up") in ``dtype`` on the device, made once per dtype: a tensor made
        from the host every substep would copy and wait for the stream."""
        key = (name, dtype)
        if key not in self._consts:
            value = self.conf.gravity if name == "gravity" else (0.0, 1.0, 0.0)
            self._consts[key] = torch.tensor(value, dtype=dtype, device=self.device)
        return self._consts[key]

    def _substep(self, f, state: MPMState):
        conf = self.conf
        res = conf.res
        n_cells = res[0] * res[1] * res[2]
        dt, dx, inv_dx = conf.dt, conf.dx, conf.inv_dx
        B, P = state.x.shape[:2]
        dtype, dev = state.x.dtype, state.x.device

        liquid = self._material == WATER
        plastic = self._material == PLASTIC_CLIP
        vm = self._material == VON_MISES
        eye = torch.eye(3, dtype=dtype, device=dev)

        # --- deformation gradient update + stress ---
        F = (eye + dt * state.C) @ state.F

        h = clip(self._h.to(dtype), 0.1, 5.0)
        mu = state.mu * h  # (B, P)
        la = state.lamda * h
        mu = torch.where(liquid, torch.zeros_like(mu), mu)
        la = torch.where(liquid, torch.ones_like(la), la)

        U, sig, Vh = svd3(F)

        # sigma-clip plasticity
        sig_clipped = clip(sig, 1 - 2.5e-2 * 10, 1 + 4.5e-3 * 100)
        sig = torch.where(plastic[:, None], sig_clipped, sig)
        J = sig.prod(-1)[..., None, None]
        F = torch.where(plastic[:, None, None], U @ (eye * sig[..., None]) @ Vh, F)

        # von-Mises plasticity, in log-sigma space
        sig_vm = torch.maximum(sig, sig.new_full((), 0.05))
        eps = torch.log(sig_vm)
        eps_hat = eps - eps.mean(-1, keepdim=True)
        eps_hat_norm = torch.sqrt(torch.sum(eps_hat**2, -1, keepdim=True) + 1e-12)
        ys = state.yield_stress[..., None]  # (B, 1, 1) or (B, P, 1)
        delta_gamma = eps_hat_norm - ys / (2.0 * mu[..., None] + 1e-12)
        yields = delta_gamma > 0
        delta_gamma_pos = clip(delta_gamma, 0.0, math.inf)
        eps_proj = eps - (delta_gamma_pos / eps_hat_norm) * eps_hat
        sig_proj = torch.where(yields, torch.exp(eps_proj), sig_vm)
        F_vm = U @ (eye * sig_proj[..., None]) @ Vh
        F = torch.where(vm[:, None, None], F_vm, F)

        R = U @ Vh
        stress = (2.0 * mu[..., None, None] * (F - R) @ F.transpose(-1, -2)
                  + eye * la[..., None, None] * J * (J - 1.0))
        stress = (-dt * conf.p_vol * 4.0) * stress / dx**2
        affine = stress + conf.p_mass * state.C
        state = state.replace(F=F)

        # --- P2G ---
        if self.transfer_mode == "dense":
            grid_v, grid_m = self._p2g_dense(state.x, state.v, affine)
        else:
            weight, flat, dpos_units = self._weights_and_indices(state.x)
            dpos = dpos_units * dx
            mom = conf.p_mass * state.v[..., None, :] + torch.einsum("npij,npoj->npoi", affine, dpos)
            vals = weight[..., None] * mom
            flat_b = (flat + n_cells * torch.arange(B, device=dev)[:, None, None]).reshape(-1)
            grid_v = torch.zeros((B * n_cells, 3), dtype=dtype, device=dev).index_add_(
                0, flat_b, vals.reshape(-1, 3))
            grid_m = torch.zeros((B * n_cells,), dtype=dtype, device=dev).index_add_(
                0, flat_b, (weight * conf.p_mass).reshape(-1))
            grid_v = grid_v.reshape((B,) + res + (3,))
            grid_m = grid_m.reshape((B,) + res)

        # --- primitive FK ---
        primitives = tuple(forward_kinematics(f, p) for p in state.primitives)
        state = state.replace(primitives=primitives)

        # --- grid ops ---
        # momentum -> velocity with a mass threshold: cells with a mass below
        # ~1e-5 of a particle's keep their momentum as it is
        mass_mask = grid_m > 1e-10
        safe_m = torch.where(mass_mask, grid_m, torch.ones_like(grid_m))
        grid_v = torch.where(mass_mask[..., None], grid_v / safe_m[..., None], grid_v)
        grid_v = grid_v + dt * self._const("gravity", dtype)

        # the nodes' indices and positions in float32 whatever the state's
        # dtype, as unidom_tpu's step computes them: a float64 step is then
        # JAX's float64 step, and a grazing contact feels the rounding
        # (tests/test_torch_mpm_big_grad.py)
        gidx = self.grid_idx_3d.to(torch.float32)
        grid_pos = (gidx * dx).reshape(-1, 3)
        for i, (collide, pos_control) in enumerate(self._colliders):
            control = pos_control if self.use_position_control else collide
            flat_v = control(f, grid_pos, grid_v.reshape(B, -1, 3), dt, primitives[i])
            grid_v = flat_v.reshape(grid_v.shape)

        # ground friction on the bottom 3 grid layers
        normal = self._const("up", dtype)
        lin = grid_v[..., 1] + 1e-30
        vit = grid_v - lin[..., None] * normal - gidx * 1e-30
        lit = torch.sqrt(torch.sum((vit + 1e-12) ** 2, dim=-1))
        friction = state.friction.reshape(B, 1, 1, 1)
        grid_v_fric = clip(1.0 + friction * lin / lit, 0.0, math.inf)[..., None] * (vit + gidx * 1e-30)
        grid_v_fric = torch.cat([grid_v_fric[..., :1], torch.zeros_like(grid_v_fric[..., 1:2]),
                                 grid_v_fric[..., 2:]], dim=-1)
        bottom = (self.grid_idx_3d[..., 1] < 3)
        fric_mask = bottom & (grid_v[..., 1] <= 0)
        grid_v = torch.where(fric_mask[..., None], grid_v_fric, grid_v)

        # walls: zero outgoing velocity within 3 cells of the box; the upper
        # bound is n_grid, not res, so a focus region smaller than the full
        # grid has its upper walls open
        idx3 = self.grid_idx_3d
        cond = ((idx3 < 3) & (grid_v < 0)) | ((idx3 > conf.n_grid - 3) & (grid_v > 0))
        grid_v = torch.where(cond, torch.zeros_like(grid_v), grid_v)

        # --- G2P ---
        if self.transfer_mode == "dense":
            new_v, new_C = self._g2p_dense(state.x, grid_v)
        else:
            gv = grid_v.reshape(B * n_cells, 3)[flat_b].reshape(B, P, 27, 3)
            new_v = torch.sum(weight[..., None] * gv, dim=2)
            new_C = 4.0 * inv_dx * torch.einsum("npo,npoi,npoj->npij", weight, gv, dpos_units)

        x = state.x + dt * new_v
        J_new = state.J * (1.0 + dt * torch.diagonal(new_C, dim1=-2, dim2=-1).sum(-1))
        return state.replace(x=x, v=new_v, C=new_C, J=J_new)

    # ------------------------------------------------------------------ #
    # macro step
    # ------------------------------------------------------------------ #

    def prepare(self, state: MPMState, action):
        """The macro step's head, before the substeps: NaN-scrub the state,
        clamp the action's cotangent, clip the action to [-1, 1] and spread
        it over the primitives' substep buffers."""
        conf = self.conf
        state = scrub_mpm_state(state)
        action = clip(clamp_grad_norm_tree([action])[0], -1.0, 1.0)
        prims = tuple(set_action(conf.steps, action[:, i * 6:(i + 1) * 6], p)
                      for i, p in enumerate(state.primitives))
        return state.replace(primitives=prims)

    def _run_substeps(self, state: MPMState):
        """``conf.steps`` plain substeps, then the buffers' row 0 <- row steps."""
        steps = self.conf.steps
        for f in range(steps):
            state = self._substep(f, state)
        prims = tuple(
            p.replace(position=torch.cat([p.position[:, steps:], p.position[:, 1:]], 1),
                      rotation=torch.cat([p.rotation[:, steps:], p.rotation[:, 1:]], 1))
            for p in state.primitives
        )
        return state.replace(primitives=prims)

    def _step_plain(self, state: MPMState, action):
        """One macro step in plain PyTorch: the kernel's plain version."""
        return self._run_substeps(self.prepare(state, action))

    def step_batch(self, state: MPMState, action):
        """One macro step for the batch under ``action`` (B, 6 n_primitive):
        plain on CPU, on CUDA the kernel that ``kernel_route`` picks."""
        if state.x.device.type == "cuda" and kernel_route(self) == "k3":
            return mpm_big_step(self, state, action)
        return mpm_step(self, state, action)
