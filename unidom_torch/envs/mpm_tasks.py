"""Concrete MPM task environments.

Counterpart of ``unidom_tpu/envs/mpm_tasks.py`` for whip_rope: a
position-controlled box primitive whipping an elastic rope on a 64-grid
with a 32^3 focus region, 70 substeps per macro action and 70 macro steps
per episode, rewarded by the L2 distance to a recorded goal
(``unidom_tpu/assets/goals/whip_rope/goal.npy``), and ``grad_test``, its
gradient sanity check. ``ShapeRopeConf`` is the shape_rope simulator's
configuration; its env waits for a later slice.
"""

import dataclasses

import numpy as np
import torch

from unidom_torch.engine.mpm import ELASTIC, MPMConf
from unidom_torch.envs.base_mpm import MPMEnv
from unidom_torch.envs.cloth_tasks import goal_path
from unidom_torch.ops.gradops import scrub_grad, tree_flatten

WhipRopeConf = MPMConf(
    n_grid=64,
    dt=1e-4,
    steps=70,  # 0.007 s / 1e-4
    E=100.0,
    nu=0.1,
    ground_friction=0.1,
    res=(32, 32, 32),
    n_primitive=1,
    task="whip_rope",
    goal_path=goal_path("whip_rope"),
)

# grad_test's small whip_rope: a 32-grid with a 16^3 focus region, 8 substeps
GRAD_TEST_CONF = MPMConf(n_grid=32, dt=2e-4, steps=8, E=100.0, nu=0.1, res=(16, 16, 16),
                         task="grad_test", goal_path="")

ShapeRopeConf = MPMConf(
    n_grid=128,
    dt=0.5e-4,
    steps=133,  # 0.2 s / 30 actions / 0.5e-4
    E=100.0,
    nu=0.1,
    ground_friction=0.9,
    res=(64, 6, 64),
    n_primitive=1,
    primitive_action_steps=30,
    task="shape_rope",
    goal_path=goal_path("shape_rope"),
)


class WhipRopeEnv(MPMEnv):
    ROPE_WIDTH = (0.38, 0.006, 0.006)
    ROPE_INIT_POS = (0.5, 0.01, 0.5)

    def __init__(self, batch_size, seed=1, max_steps=70, conf=None, aux_reward=False,
                 device="cuda"):
        # aux_reward is taken and ignored, as in the JAX env
        conf = dataclasses.replace(conf or WhipRopeConf)
        super().__init__(conf, batch_size, max_steps, seed, focus_computation=True,
                         use_position_control=True, device=device)
        state = self.simulator.add_box(
            state=None, hardness=1.0, size=self.ROPE_WIDTH, init_pos=self.ROPE_INIT_POS,
            z_rotation_angle=np.pi / 2, material=ELASTIC, density=2.75,
        )
        state = self.create_primitive(
            state, friction=0.1, color=[0.5, 0.5, 0.5], size=[0.02, 0.02, 0.02],
            init_pos=[0.5, 0.01, 0.3], sdf_name="box",
        )
        self.initialize_after_adding_particle_primitives(state)

    def auto_reset(self, state, generator=None, shift=None):
        """``state`` (the initial state) with the rope and primitive 0's
        first buffer row moved in x and z by ``shift`` (B, 2), by default
        N(0, 0.02^2) per env from ``generator`` (the env's own unless one is
        given)."""
        B = state.x.shape[0]
        if shift is None:
            shift = torch.randn((B, 2), generator=generator or self.generator) * 0.02
        shift = torch.as_tensor(np.asarray(shift, dtype=np.float32)).to(state.x.device)
        shift3 = torch.stack([shift[:, 0], torch.zeros_like(shift[:, 0]), shift[:, 1]], -1)
        p0 = state.primitives[0]
        row0 = p0.position[:, :1] + shift3[:, None]
        p0 = p0.replace(position=torch.cat([row0, p0.position[:, 1:]], 1))
        return state.replace(x=state.x + shift3[:, None], primitives=(p0,) + state.primitives[1:])

    def get_primitive_actions(self, actions, state):
        actions = (actions + 1e-12) / 50.0  # the reference's NaN guard
        actions = torch.cat([actions[:, :3], torch.zeros_like(actions[:, 3:])], dim=1)
        return actions[:, None, :], state

    def reset(self, generator=None):
        """(obs, state): the initial state under ``auto_reset``'s shift."""
        state = self.auto_reset(self.init_state, generator)
        return self.get_obs(state), state


def grad_test(env=None, n_chained_steps=5, n_iters=3, device="cuda", verbose=True):
    """whip_rope's gradient sanity check (the JAX package's ``grad_test``,
    scripted actions): the gradient of the rope's summed positions after
    ``n_chained_steps`` chained ``step_diff`` calls with respect to the
    action, with ``scrub_grad`` on every float tensor of the state and on
    the action before each step; ``n_iters`` times, each from where the last
    ended. Asserts every gradient finite and not all of them zero, and
    returns them as numpy arrays (B, 6). On CUDA tensors every macro step's
    gradient goes through the MPM backward kernel."""
    env = env or WhipRopeEnv(batch_size=1, seed=1, max_steps=n_chained_steps + 1,
                             conf=GRAD_TEST_CONF, device=device)
    _, state = env.reset(torch.Generator().manual_seed(1))
    results = []
    for i in range(n_iters):
        actions = torch.tensor([[0.3, 0.0, 0.5, 0.0, 0.0, 0.0]], device=env.device)
        actions = actions.repeat(env.batch_size, 1).requires_grad_()
        a, s = actions, state
        for _ in range(n_chained_steps):
            leaves, rebuild = tree_flatten(s)
            s = rebuild([scrub_grad(t) for t in leaves])
            a = scrub_grad(a)
            _, _, _, info = env.step_diff(a, s)
            s = info["state"]
        (g,) = torch.autograd.grad(s.x.sum(), actions)
        leaves, rebuild = tree_flatten(s)
        state = rebuild([t.detach() for t in leaves])
        g = g.cpu().numpy()
        assert np.isfinite(g).all(), f"non-finite grad at iter {i}"
        results.append(g)
        if verbose:
            print(f"grad_test iter {i}: grad {g.round(6)}")
    assert any(np.abs(r).sum() > 0 for r in results), "all-zero gradients"
    return results
