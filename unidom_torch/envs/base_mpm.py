"""MPM task environment base: macro action -> simulator steps, L2 reward,
focus-region re-centering, auto-reset.

Counterpart of ``unidom_tpu/envs/base_mpm.py``. Before each macro step the
particle cloud and the primitives are shifted so that the cloud's centre
sits in the middle of the small simulation grid ``res`` (in x and z), and
shifted back afterwards; ``process_pre_step_actions`` moves the macro
action by the same shift where a task's action holds positions (shape_rope's
push). The env owns a ``torch.Generator`` for its random resets, as the
cloth env does; the JAX env's per-env keys are not ported. When an env is
done, ``auto_reset`` gets the initial state and the current one, as in JAX:
whip_rope and pour_water redraw around the initial state, shape_rope keeps
the current one.
"""

import math
import os
import sys

import numpy as np
import torch

from unidom_torch.engine.mpm import MPMConf, MPMSimulator, MPMState
from unidom_torch.engine.primitives import create_primitive
from unidom_torch.ops.gradops import tree_flatten
from unidom_torch.ops.metrics import l2_distance


def _select(done, new, old):
    """Per env, ``new``'s tensors where ``done`` else ``old``'s."""
    new_leaves, _ = tree_flatten(new)
    old_leaves, rebuild = tree_flatten(old)
    return rebuild([torch.where(done.view((-1,) + (1,) * (o.dim() - 1)), n, o)
                    for n, o in zip(new_leaves, old_leaves)])


def _shift(state: MPMState, shift_b):
    """``state`` with its particles and primitive buffers moved by
    ``shift_b`` (B, 1, 3)."""
    prims = tuple(p.replace(position=p.position + shift_b) for p in state.primitives)
    return state.replace(x=state.x + shift_b, primitives=prims)


class MPMEnv:
    """Batched MPM environment with particle observations, on ``device``
    (the GPU unless the caller asks for the CPU)."""

    action_squash = None  # the trainer feeds the policy's tanh sample as it is
    reset_mode = "auto_reset"  # the trainer randomises around init_state

    def __init__(self, conf: MPMConf, batch_size: int, max_steps: int, seed: int,
                 focus_computation: bool = False, use_position_control: bool = False,
                 device="cuda"):
        self.conf = conf
        self.device = torch.device(device)
        self.simulator = MPMSimulator(conf, batch_size, use_position_control, device)
        self.aux_reward = False
        self.max_steps = max_steps
        self.batch_size = batch_size
        self.action_size = 6
        self.focus_computation = focus_computation
        self.generator = torch.Generator().manual_seed(seed)

        self.init_state = None
        self.observation_size = 0
        self.goal = self._load_goal(conf.goal_path)

    def _load_goal(self, goal_path):
        if goal_path and os.path.exists(goal_path):
            return torch.as_tensor(np.load(goal_path), dtype=torch.float32, device=self.device)
        if goal_path:
            print(f"Warning: goal file {goal_path!r} does not exist!", file=sys.stderr)
        return torch.zeros((1, 3), device=self.device)

    # -------------------------------------------------------------- #
    # per-task hooks
    # -------------------------------------------------------------- #

    def get_primitive_actions(self, actions, state):
        """(B, 6) macro action -> ((B, n_sub, 6 n_prim) sub-actions, state)."""
        raise NotImplementedError

    def process_pre_step_actions(self, actions, shift):
        """The macro action (B, 6) in the shifted frame of ``pre_step``
        (``shift`` (B, 3)); unchanged unless the task's action holds
        positions."""
        return actions

    def auto_reset(self, init_state, generator=None, shift=None, state=None):
        """The state that a done env restarts from, given the initial state
        and the current one ``state``."""
        raise NotImplementedError

    def reward_func(self, state, goal):
        return math.e ** (-l2_distance(state.x, goal) * 10.0)

    # -------------------------------------------------------------- #
    # observations
    # -------------------------------------------------------------- #

    def get_obs(self, state: MPMState):
        """Particle positions, velocities and primitive 0's position buffer,
        flattened: (B, 6 P + 3 (steps + 1))."""
        B = state.x.shape[0]
        return torch.cat([state.x.reshape(B, -1), state.v.reshape(B, -1),
                          state.primitives[0].position.reshape(B, -1)], dim=-1)

    # -------------------------------------------------------------- #
    # step
    # -------------------------------------------------------------- #

    def pre_step(self, state: MPMState):
        """Centre the cloud in the focus grid in x and z. Returns (shifted
        state, shift (B, 1, 3))."""
        conf = self.conf
        target = torch.tensor(conf.res, dtype=state.x.dtype, device=state.x.device) * 0.5 / conf.n_grid
        shift = target - state.x.mean(1)
        shift = torch.stack([shift[:, 0], torch.zeros_like(shift[:, 1]), shift[:, 2]], dim=-1)
        shift_b = shift[:, None, :]
        return _shift(state, shift_b), shift_b

    def step_diff(self, actions, state: MPMState):
        """One macro step: returns (obs, reward, done, info)."""
        contact_distance = torch.sqrt(
            torch.sum((actions[:, None, :3] - state.x) ** 2, -1)).min(-1).values

        if self.focus_computation:
            state, shift_b = self.pre_step(state)
            actions = self.process_pre_step_actions(actions, shift_b[:, 0])
        sub_actions, state = self.get_primitive_actions(actions, state)
        state_list = []
        for t in range(sub_actions.shape[1]):
            state = self.simulator.step_batch(state, sub_actions[:, t])
            state_list.append(state)
        state = state.replace(cur_step=state.cur_step + 1)

        if self.focus_computation:
            state = _shift(state, -shift_b)
            state_list = [_shift(s, -shift_b) for s in state_list]

        done = state.cur_step >= self.max_steps

        # scrub before the reward
        state = state.replace(**{k: torch.nan_to_num(getattr(state, k))
                                 for k in ("x", "v", "C", "F", "J")})

        reward = self.reward_func(state, self.goal)
        if self.aux_reward:
            reward = reward + math.e ** (-contact_distance)

        # the restart takes no gradient, as JAX's stop_gradient
        leaves, rebuild = tree_flatten(self.auto_reset(self.init_state, state=state))
        new_state = rebuild([t.detach() for t in leaves])
        state = _select(done, new_state, state)

        obs = self.get_obs(state)
        obs_list = torch.stack([self.get_obs(s) for s in state_list])
        info = {"state": state, "state_list": state_list, "obs_list": obs_list}
        return obs, reward, done, info

    # -------------------------------------------------------------- #
    # scene construction helpers
    # -------------------------------------------------------------- #

    def create_primitive(self, state, friction, color, size, init_pos, softness=666.0,
                         sdf_name="box"):
        p_state = create_primitive(self.conf.steps, friction=friction, softness=softness,
                                   color=color, size=size, init_pos=init_pos, device=self.device)
        self.simulator.register_primitive_sdf(sdf_name)
        state.primitives.append(p_state)
        return state

    def initialize_after_adding_particle_primitives(self, state):
        self.init_state = self.simulator.reset(state)
        self.observation_size = self.simulator.n_particles * 6 + (self.conf.steps + 1) * 3
