"""Cloth task environments: pick-and-place macro actions and chamfer reward.

Counterpart of ``unidom_tpu/envs/base_cloth.py``. A 6-DoF macro action
(pick xyz, place xyz) expands into 40 gripper sub-actions (3 down, 10 up,
20 move, 7 release), each driving one robot step of the simulator; the
reward is ``e^(-10 * chamfer(x, goal)) * 0.99^t``, with an optional
contact-distance term. With ``param_obs`` (the para envs) the observation
ends in each env's stiffness, normalised to ``eval_min_max_stiff``.
"""

import math
import os
import sys

import numpy as np
import torch

from unidom_torch.engine.cloth import ClothConf, ClothSimulator, ClothState
from unidom_torch.ops.metrics import chamfer


class ClothEnv:
    """Batched cloth environment with particle observations, on ``device``
    (the GPU unless the caller asks for the CPU)."""

    action_squash = "sigmoid"  # the trainer squashes sampled actions with a sigmoid
    reset_mode = "reset"  # the trainer draws first states with ``reset``

    def __init__(self, conf: ClothConf, batch_size: int, max_steps: int,
                 aux_reward: bool = False, param_obs: bool = False,
                 eval_min_max_stiff=(10.0, 1800.0), device="cuda"):
        self.device = torch.device(device)
        self.simulator = ClothSimulator(conf, batch_size, self.create_cloth_mask(conf), device)
        self.conf = conf
        self.aux_reward = aux_reward
        self.param_obs = param_obs
        self.eval_min_max_stiff = tuple(eval_min_max_stiff)
        self.max_steps = max_steps
        self.batch_size = batch_size
        self.action_size = 6
        self.n_particles = self.simulator.n_particles
        self.observation_size = self.n_particles * 3 + 8 + (1 if param_obs else 0)
        self.goal = self._load_goal(conf.goal_path)
        self._init_state = self.simulator.reset()

    def create_cloth_mask(self, conf):
        raise NotImplementedError

    def _load_goal(self, goal_path):
        if goal_path and os.path.exists(goal_path):
            return torch.as_tensor(np.load(goal_path), dtype=torch.float32, device=self.device)
        if goal_path:
            print(f"Warning: goal file {goal_path!r} does not exist!", file=sys.stderr)
        return torch.zeros((1, 3), device=self.device)

    # -------------------------------------------------------------- #
    # observations
    # -------------------------------------------------------------- #

    def packed_x(self, state: ClothState):
        """(B, P, 3) particle view of the dense state."""
        return self.simulator.pack(state.x)

    def get_obs(self, state: ClothState):
        """Particle positions (mask cells in row-major bbox order, xyz
        innermost), then both gripper states: (B, 3P + 8); with
        ``param_obs``, then the stiffness normalised to
        ``eval_min_max_stiff``: (B, 3P + 9)."""
        B = state.x.shape[0]
        parts = [self.packed_x(state).reshape(B, -1), state.primitive0, state.primitive1]
        if self.param_obs:
            lo, hi = self.eval_min_max_stiff
            parts.append(((state.stiffness - lo) / (hi - lo))[:, None])
        return torch.cat(parts, dim=-1)

    # -------------------------------------------------------------- #
    # macro-action expansion
    # -------------------------------------------------------------- #

    @staticmethod
    def get_pnp_actions(actions, state: ClothState):
        """Expand (B, 6) pick/place into (40, B, 8) gripper sub-actions:
        3 down, 10 up, 20 move, 7 release; the second gripper idles."""
        B = actions.shape[0]
        pick = actions[:, :3].clone()
        place = actions[:, 3:].clone()
        pick[:, 1] = 0.0
        place[:, 1] = 0.0
        ones = actions.new_ones((B, 1))
        zeros = actions.new_zeros((B, 1))

        act_down = torch.cat([(pick - state.primitive0[:, :3]) / 3.0, ones], dim=1)
        act_up = actions.new_tensor([0.0, 0.06 / 10.0, 0.0, 0.0]).expand(B, 4)
        move = (place - pick) / 20.0
        move[:, 1] = 0.0
        act_move = torch.cat([move, zeros], dim=1)
        act_release = actions.new_tensor([0.0, 0.0, 0.0, 1.0]).expand(B, 4)

        sub = torch.cat(
            [
                act_down.expand(3, B, 4),
                act_up.expand(10, B, 4),
                act_move.expand(20, B, 4),
                act_release.expand(7, B, 4),
            ],
            dim=0,
        )
        return torch.cat([sub, torch.zeros_like(sub)], dim=-1)  # (40, B, 8)

    # -------------------------------------------------------------- #
    # step / reset
    # -------------------------------------------------------------- #

    def step_diff(self, actions, state: ClothState):
        """One macro step: returns (obs, reward, done, info)."""
        px = self.packed_x(state)
        old_chamfer_distance = chamfer(px, self.goal)
        contact_distance = torch.sqrt(
            torch.sum((actions[:, None, :3] - px) ** 2, -1)
        ).min(-1).values

        sub_actions = self.get_pnp_actions(actions, state)
        state_list = []
        for sub in sub_actions:
            state = self.simulator.step_batch(state, sub)
            state_list.append(state)
        state = state.replace(cur_step=state.cur_step + 1)
        obs = self.get_obs(state)
        if self.conf.use_substep_obs:
            obs_list = torch.stack([self.get_obs(s) for s in state_list])
        else:
            obs_list = obs

        done = state.cur_step >= self.max_steps
        chamfer_distance = chamfer(self.packed_x(state), self.goal)
        reward = math.e ** (-chamfer_distance * 10.0)
        if self.aux_reward:
            reward = reward + math.e ** (-contact_distance)
        reward = reward * 0.99 ** state.cur_step

        info = {
            "state": state,
            "obs_list": obs_list,
            "state_list": state_list,
            "real_reward": old_chamfer_distance - chamfer_distance + 0.1 * contact_distance,
        }
        return obs, reward, done, info

    def reset_from_shift(self, shift):
        """Initial state with the whole batch's cloth shifted by ``shift``
        (2,) in x and z; returns (obs, state)."""
        shift = torch.from_numpy(np.array(shift, dtype=np.float32)).to(self.device)
        init = self._init_state
        x = init.x.clone()
        x[..., 0] += shift[0]
        x[..., 2] += shift[1]
        state = init.replace(x=x)
        return self.get_obs(state), state

    def reset(self, generator: torch.Generator = None):
        """One N(0, 0.05^2) shift of shape (2,), shared by the whole batch,
        drawn from ``generator`` (a CPU generator; by default one seeded with
        ``conf.seed``)."""
        if generator is None:
            generator = torch.Generator().manual_seed(self.conf.seed)
        return self.reset_from_shift(torch.randn(2, generator=generator) * 0.05)

    def get_random_fold_action(self, state: ClothState, rng: np.random.RandomState,
                               indices=None):
        """Random pick/place pair: two particles of each env's current cloth,
        their indices (st, ed) drawn from numpy ``rng`` on the host, st first,
        as JAX draws them from numpy's global state. ``indices`` (st, ed),
        each (B,), replaces the draw."""
        x = self.packed_x(state)
        B, P, _ = x.shape
        if indices is None:
            indices = (rng.randint(0, P, size=(B,)), rng.randint(0, P, size=(B,)))
        st, ed = (torch.as_tensor(np.asarray(i), device=x.device) for i in indices)
        rows = torch.arange(B, device=x.device)
        return torch.cat([x[rows, st], x[rows, ed]], dim=-1)
