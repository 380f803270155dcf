"""Rigid collider primitives of the MPM engine.

Counterpart of ``unidom_tpu/engine/primitives.py``: quaternion forward
kinematics over a per-macro-step substep buffer with ``steps + 1`` rows,
SDF collision with softness-weighted influence and Coulomb friction, and
position control. ``create_primitive`` builds one env's state, as the JAX
version does; the simulator's ``reset`` gives every tensor a leading batch
dim B, and everything else works on that batch.
"""

import math
from dataclasses import dataclass, replace

import torch

from unidom_torch.ops.gradops import clip
from unidom_torch.ops.quat import qinv, qmul, qrot, w2quat
from unidom_torch.ops.sdf import get_sdf, sdf_normal


@dataclass
class PrimitiveState:
    """Dynamic state of one rigid primitive; batched, each field (B, ...)."""

    size: torch.Tensor  # (3,) SDF size parameters
    friction: torch.Tensor  # () collider friction
    softness: torch.Tensor  # () contact softness
    color: torch.Tensor  # (3,) render color
    position: torch.Tensor  # (steps + 1, 3) substep position buffer
    rotation: torch.Tensor  # (steps + 1, 4) substep quaternion buffer
    v: torch.Tensor  # (steps, 3) linear velocity per substep
    w: torch.Tensor  # (steps, 3) angular velocity per substep
    action_buffer: torch.Tensor  # (6,) last macro action
    action_scale: torch.Tensor  # (6,)

    def replace(self, **changes):
        return replace(self, **changes)


def create_primitive(steps, friction, softness, color, size, init_pos, device="cuda"):
    """One env's PrimitiveState with ``steps + 1`` buffer rows, at rest."""
    f32 = dict(dtype=torch.float32, device=device)
    position = torch.zeros((steps + 1, 3), **f32)
    position[0] = torch.tensor(init_pos, **f32)
    rotation = torch.zeros((steps + 1, 4), **f32)
    rotation[:, 0] = 1.0
    return PrimitiveState(
        size=torch.tensor(size, **f32),
        friction=torch.tensor(friction, **f32),
        softness=torch.tensor(softness, **f32),
        color=torch.tensor(color, **f32),
        position=position,
        rotation=rotation,
        v=torch.zeros((steps, 3), **f32),
        w=torch.zeros((steps, 3), **f32),
        action_buffer=torch.zeros(6, **f32),
        action_scale=torch.ones(6, **f32),
    )


def set_action(n_substeps, action, state: PrimitiveState):
    """Spread a (B, 6) macro action uniformly over the substep v/w buffers."""
    B = action.shape[0]
    v = (action[:, :3] * state.action_scale[:, :3] / n_substeps)[:, None].expand(B, n_substeps, 3)
    w = (action[:, 3:] * state.action_scale[:, 3:] / n_substeps)[:, None].expand(B, n_substeps, 3)
    return state.replace(action_buffer=action, v=v, w=w)


def _set_row(buf, f, row):
    return torch.cat([buf[:, :f], row[:, None], buf[:, f + 1:]], dim=1)


def forward_kinematics(f, state: PrimitiveState):
    """Advance the substep buffers: position[f + 1], rotation[f + 1]; the
    whole position buffer is clipped to [-2, 2], as in the JAX version."""
    position = _set_row(state.position, f + 1, state.position[:, f] + state.v[:, f])
    position = clip(position, -2.0, 2.0)
    rotation = _set_row(state.rotation, f + 1, qmul(w2quat(state.w[:, f]), state.rotation[:, f]))
    return state.replace(position=position, rotation=rotation)


def _to_local(p, position, rotation):
    return qrot(qinv(rotation), p - position)


def make_collider(sdf_name):
    """(collide, position_control) over the SDF ``sdf_name``. Both take
    (f, grid_pos (..., n, 3), v_out (B, n, 3), dt, state) and return the new
    grid velocity (B, n, 3)."""
    sdf = get_sdf(sdf_name)
    normal = sdf_normal(sdf_name)

    def frame(state, f):
        return state.position[:, f, None, :], state.rotation[:, f, None, :]

    def sdf_world(f, grid_pos, state):
        position, rotation = frame(state, f)
        return sdf(state.size[:, None, :], _to_local(grid_pos, position, rotation))

    def normal_world(f, grid_pos, state):
        position, rotation = frame(state, f)
        local = _to_local(grid_pos, position, rotation)
        return qrot(rotation, normal(state.size[:, None, :], local))

    def collider_v(f, grid_pos, dt, state):
        position, rotation = frame(state, f)
        position1, rotation1 = frame(state, f + 1)
        relative = qrot(qinv(rotation), grid_pos - position)
        new_pos = qrot(rotation1, relative) + position1
        return (new_pos - grid_pos) / dt

    def collide(f, grid_pos, v_out, dt, state):
        """Softness-weighted rigid collision with Coulomb friction."""
        dist = sdf_world(f, grid_pos, state)
        influence = clip(torch.exp(-dist * state.softness[:, None]), -math.inf, 1.0)[..., None]
        friction = state.friction[:, None, None]

        D = normal_world(f, grid_pos, state)
        cv = collider_v(f, grid_pos, dt, state)
        input_v = v_out - cv

        normal_component = torch.sum(input_v * D, dim=-1, keepdim=True)
        grid_v_t = input_v - clip(normal_component, -math.inf, 0.0) * D

        grid_v_t_dot = torch.sum(grid_v_t * grid_v_t, dim=-1, keepdim=True)
        grid_v_t_norm = torch.sqrt(grid_v_t_dot + 1e-12)
        grid_v_t_friction = (grid_v_t / grid_v_t_norm
                             * clip(grid_v_t_norm + normal_component * friction, 1e-12, math.inf))

        flag = ((normal_component < 0).to(v_out.dtype)
                * (torch.sqrt(grid_v_t_dot) > 1e-12).to(v_out.dtype))
        grid_v_t = grid_v_t_friction * flag + grid_v_t * (1.0 - flag)
        return cv + input_v * (1.0 - influence) + grid_v_t * influence

    def position_control(f, grid_pos, v_out, dt, state):
        """Grid cells within 1.5 x size[0] of the surface take the
        primitive's velocity."""
        dist = sdf_world(f, grid_pos, state)
        control_mask = dist < state.size[:, 0:1] * 1.5
        return torch.where(control_mask[..., None], (state.v[:, f] / dt)[:, None, :], v_out)

    return collide, position_control
