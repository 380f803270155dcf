"""Concrete MPM task environments.

Counterpart of ``unidom_tpu/envs/mpm_tasks.py``:
- whip_rope: a position-controlled box primitive whipping an elastic rope on
  a 64-grid with a 32^3 focus region, 70 substeps per macro action and 70
  macro steps per episode, rewarded by the L2 distance to a recorded goal
  (``unidom_tpu/assets/goals/whip_rope/goal.npy``), and ``grad_test``, its
  gradient sanity check;
- shape_rope / shape_rope_hard: a box pushing a sigma-clip plastic rope on a
  128-grid with a (64, 6, 64) focus region, a (start, end) push capped at
  0.3 over 30 sub-steps per macro action; 2 random pushes at reset (8 more
  for "hard");
- pour_water: near-incompressible water between two bowl (``container``)
  primitives on an 80-grid, 100 macro steps; bowl 0 moves, bowl 1 stays;
- pour_soup: pour_water's bowls with water, two elastic tofu cubes and the
  vegetable point cloud (``unidom_tpu/assets/pour_soup_veg.npy``) on a
  128x64x128 grid, 120 macro steps;
- shape_elasto_plastic: shape_rope's pusher on a sigma-clip plastic slab of
  23,940 particles on a 96-grid with a 48x32x48 focus region, a push capped
  at 0.1 over 20 sub-steps, 6 macro steps.
The shape_rope family trains through ``host_reset``: each iteration's first
state is ``reset``'s, its random pushes run forward (``random_push``).
"""

import dataclasses

import numpy as np
import torch

from unidom_torch.engine.mpm import ELASTIC, PLASTIC_CLIP, WATER, MPMConf
from unidom_torch.envs.base_mpm import MPMEnv
from unidom_torch.envs.cloth_tasks import ASSET_DIR, goal_path
from unidom_torch.ops.gradops import clip, scrub_grad, tree_flatten

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

    def auto_reset(self, init_state, generator=None, shift=None, state=None):
        """``init_state`` with the rope and primitive 0's first buffer row
        moved in x and z by ``shift`` (B, 2), by default N(0, 0.02^2) per env
        from ``generator`` (the env's own unless one is given); the current
        ``state`` plays no part."""
        state = init_state
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


# ------------------------------------------------------------------ #
# shape_rope family
# ------------------------------------------------------------------ #


class ShapeRopeEnv(MPMEnv):
    """Push a plastic rope into a shape. A macro action is a push from
    ``start`` (actions[:3]) to ``end`` (actions[3:]), in world positions."""

    # the trainer treats shape_rope like a cloth env: sigmoid squash, host reset
    action_squash = "sigmoid"
    reset_mode = "host_reset"

    PUSH_SUBSTEPS = 30
    PUSH_CAP = 0.3
    ROPE_WIDTH = (0.25, 0.006, 0.006)
    ROPE_INIT_POS = (0.5, 0.01, 0.5)
    ROPE_MATERIAL = PLASTIC_CLIP
    ROPE_DENSITY = 3.0
    PRIM_SIZE = (0.015, 0.06, 0.015)
    PRIM_INIT = (0.5, 0.01, 0.45)
    DO_RESET_PUSHES = 2

    def __init__(self, batch_size, seed=1, max_steps=6, conf=None, aux_reward=False,
                 device="cuda"):
        conf = dataclasses.replace(conf or ShapeRopeConf)
        super().__init__(conf, batch_size, max_steps, seed, focus_computation=True, device=device)
        self.aux_reward = aux_reward
        # the reset pushes (JAX: numpy's global state, which this constructor
        # seeds; apg.train shares one stream between its two envs, as JAX's)
        self.rng = np.random.RandomState(seed)
        state = self.simulator.add_box(
            state=None, hardness=1.0, size=self.ROPE_WIDTH, init_pos=self.ROPE_INIT_POS,
            z_rotation_angle=0.0, material=self.ROPE_MATERIAL, density=self.ROPE_DENSITY,
        )
        state = self.create_primitive(
            state, friction=0.1, color=[0.5, 0.5, 0.5], size=self.PRIM_SIZE,
            init_pos=self.PRIM_INIT, sdf_name="box",
        )
        self.initialize_after_adding_particle_primitives(state)

    def auto_reset(self, init_state, generator=None, shift=None, state=None):
        """A done env keeps its current ``state``."""
        return init_state if state is None else state

    def process_pre_step_actions(self, actions, shift):
        """The push's start and end move with the focus shift."""
        return torch.cat([actions[:, :3] + shift, actions[:, 3:] + shift], dim=1)

    def get_primitive_actions(self, actions, state):
        """The push: primitive 0's first buffer row at ``start`` (y 0.01),
        then PUSH_SUBSTEPS equal moves towards ``end``, at most PUSH_CAP
        long, in x and z. Returns ((B, PUSH_SUBSTEPS, 6) sub-actions, state)."""
        B = actions.shape[0]
        y = torch.full_like(actions[:, :1], 0.01)
        start = torch.cat([actions[:, 0:1], y, actions[:, 2:3]], dim=1)
        end = torch.cat([actions[:, 3:4], y, actions[:, 5:6]], dim=1)
        norm = torch.sqrt(torch.sum((end - start) ** 2, dim=1, keepdim=True)) + 1e-8
        end = start + (end - start) / norm * clip(norm, 0.0, self.PUSH_CAP)
        p0 = state.primitives[0]
        p0 = p0.replace(position=torch.cat([start[:, None], p0.position[:, 1:]], 1))
        step = (end - start) / self.PUSH_SUBSTEPS
        step = torch.cat([step[:, :1], torch.zeros_like(step[:, 1:2]), step[:, 2:]], dim=1)
        sub = torch.cat([step, torch.zeros_like(step)], dim=1)[:, None]
        sub = sub.expand(B, self.PUSH_SUBSTEPS, 6)
        return sub, state.replace(primitives=(p0,) + tuple(state.primitives[1:]))

    def random_policy(self, state, n_actions, radius=0.05):
        """Pushes of length 2 ``radius`` through random particles of env 0,
        at random angles, from ``self.rng``."""
        pc = state.x[0].cpu().numpy()
        p_ids = self.rng.randint(0, pc.shape[0], n_actions)
        angles = self.rng.random_sample((n_actions,)) * np.pi * 2
        end = pc[p_ids].copy()
        end[:, 0] += np.cos(angles) * radius
        end[:, 2] += np.sin(angles) * radius
        start = pc[p_ids].copy()
        start[:, 0] -= np.cos(angles) * radius
        start[:, 2] -= np.sin(angles) * radius
        return np.concatenate([start, end], axis=-1)

    @torch.no_grad()
    def random_push(self, state, step=10):
        """``step`` random pushes from ``state``; the step counter restarts."""
        for _ in range(step):
            actions = self.random_policy(state, self.batch_size)
            actions[:, 1] = 0
            actions = torch.as_tensor(actions, dtype=torch.float32, device=self.device)
            _, _, _, info = self.step_diff(actions, state)
            state = info["state"]
        return state.replace(cur_step=torch.zeros_like(state.cur_step))

    def reset(self, generator=None):
        """(obs, state): the initial state after DO_RESET_PUSHES random pushes
        (``generator`` plays no part: the pushes draw from ``self.rng``)."""
        state = self.init_state
        if self.DO_RESET_PUSHES:
            state = self.random_push(state, step=self.DO_RESET_PUSHES)
        return self.get_obs(state), state


class ShapeRopeHardEnv(ShapeRopeEnv):
    """shape_rope with 8 more random pushes at reset."""

    HARD_RESET_PUSHES = 8

    def __init__(self, batch_size, seed=1, max_steps=20, conf=None, aux_reward=False,
                 device="cuda"):
        conf = conf or dataclasses.replace(ShapeRopeConf, task="shape_rope_hard",
                                           goal_path=goal_path("shape_rope_hard"))
        super().__init__(batch_size, seed, max_steps, conf, aux_reward, device=device)

    def reset(self, generator=None):
        _, state = super().reset(generator)
        state = self.random_push(state, step=self.HARD_RESET_PUSHES)
        return self.get_obs(state), state


# ------------------------------------------------------------------ #
# pour_water / pour_soup
# ------------------------------------------------------------------ #

PourWaterConf = MPMConf(
    n_grid=80,
    dt=3e-4,
    steps=23,  # 0.007 s / 3e-4
    E=5e-5,
    nu=0.4999,
    ground_friction=0.1,
    res=(26, 20, 26),  # n_grid // 3, n_grid // 4, n_grid // 3
    n_primitive=2,
    task="pour_water",
    goal_path=goal_path("pour_water"),
)


class PourWaterEnv(MPMEnv):
    """Pour from bowl 0 (moved by the policy) into bowl 1 (still)."""

    BOWL0 = dict(size=(0.09, 0.0, 0.008), init_pos=(0.5, 0.2, 0.5))
    BOWL1 = dict(size=(0.08, 0.0, 0.008), init_pos=(0.5, 0.06, 0.3))

    def __init__(self, batch_size, seed=1, max_steps=100, conf=None, aux_reward=False,
                 device="cuda"):
        conf = dataclasses.replace(conf or PourWaterConf)
        super().__init__(conf, batch_size, max_steps, seed, focus_computation=True, device=device)
        # the water's random fill is drawn from the env's seed, as JAX's from
        # its key_global
        state = self._add_contents(None, torch.Generator().manual_seed(seed))
        for bowl in (self.BOWL0, self.BOWL1):
            state = self.create_primitive(state, friction=0.1, color=[0.5, 0.5, 0.5],
                                          softness=666.0, sdf_name="container", **bowl)
        self.initialize_after_adding_particle_primitives(state)

    def _add_contents(self, state, generator):
        return self.simulator.add_box(
            state=state, hardness=1.0, size=[0.07, 0.07, 0.07], init_pos=[0.5, 0.2, 0.5],
            material=WATER, density=4.0, generator=generator,
        )

    def get_primitive_actions(self, actions, state):
        """One sub-action of 12: bowl 0's velocity /500 and rotation /500,
        bowl 1's zeros, everything + 1e-12 (the reference's NaN guard), y
        velocity 0."""
        sub = torch.cat([actions / 500.0, torch.zeros_like(actions)], dim=1) + 1e-12
        sub = torch.cat([sub[:, :1], torch.zeros_like(sub[:, 1:2]), sub[:, 2:]], dim=1)
        return sub[:, None, :], state

    def auto_reset(self, init_state, generator=None, shift=None, state=None):
        """``init_state`` with bowl 0's first buffer row (its place at
        construction) moved in x and z by ``shift`` (B, 2), by default
        N(0, 0.02^2) per env from ``generator`` (the env's own unless one is
        given); the current ``state`` plays no part."""
        B = init_state.x.shape[0]
        if shift is None:
            shift = torch.randn((B, 2), generator=generator or self.generator) * 0.02
        shift = torch.as_tensor(np.asarray(shift, dtype=np.float32)).to(init_state.x.device)
        shift3 = torch.stack([shift[:, 0], torch.zeros_like(shift[:, 0]), shift[:, 1]], -1)
        p0 = init_state.primitives[0]
        row0 = p0.position[:, :1] + shift3[:, None]
        p0 = p0.replace(position=torch.cat([row0, p0.position[:, 1:]], 1))
        return init_state.replace(primitives=(p0,) + tuple(init_state.primitives[1:]))

    def reset(self, generator=None):
        """(obs, state): the initial state under ``auto_reset``'s shift."""
        state = self.auto_reset(self.init_state, generator)
        return self.get_obs(state), state


PourSoupConf = MPMConf(
    n_grid=128,
    dt=4e-4,
    steps=25,  # 0.01 s / 4e-4
    E=100.0,
    nu=0.1,
    ground_friction=0.1,
    res=(128, 64, 128),
    n_primitive=2,
    task="pour_soup",
    goal_path=goal_path("pour_soup"),
)


def _veg_point_cloud(n=160, seed=7):
    """The reference's vegetable point cloud (4131 points), read from
    ``unidom_tpu/assets/pour_soup_veg.npy``; a procedural ellipsoid of ``n``
    points from numpy's ``seed`` only if the asset is missing."""
    asset = ASSET_DIR / "pour_soup_veg.npy"
    if asset.exists():
        return np.load(asset)
    rng = np.random.RandomState(seed)
    pts = rng.normal(size=(n, 3)) * np.array([0.015, 0.006, 0.015])
    return pts + np.array([0.55, 0.2, 0.5])


class PourSoupEnv(PourWaterEnv):
    """pour_water's bowls with soup: water, two elastic tofu cubes and the
    vegetable cloud, at hardness 0.3."""

    def __init__(self, batch_size, seed=1, max_steps=120, conf=None, aux_reward=False,
                 device="cuda"):
        super().__init__(batch_size, seed, max_steps, conf or PourSoupConf, aux_reward,
                         device=device)

    def _add_contents(self, state, generator):
        sim = self.simulator
        state = sim.add_box(state=state, hardness=1.0, size=[0.07, 0.07, 0.07],
                            init_pos=[0.5, 0.2, 0.5], material=WATER, density=4.0,
                            generator=generator)
        for init_pos in ([0.47, 0.2, 0.5], [0.5, 0.2, 0.55]):
            state = sim.add_box(state=state, hardness=0.3, size=[0.03, 0.03, 0.03],
                                init_pos=init_pos, material=ELASTIC, density=2.0)
        return sim.add_points(state, _veg_point_cloud(), hardness=0.3, material=ELASTIC)


# ------------------------------------------------------------------ #
# shape_elasto_plastic
# ------------------------------------------------------------------ #

ShapeElastoPlasticConf = MPMConf(
    n_grid=96,
    dt=2e-4,
    steps=16,
    E=2.0,
    nu=0.2,
    ground_friction=2.0,
    res=(48, 32, 48),
    n_primitive=1,
    task="shape_elasto_plastic",
    goal_path=goal_path("shape_elasto_plastic"),
)


class ShapeElastoPlasticEnv(ShapeRopeEnv):
    """Push a plastic slab into a shape; no pushes at reset."""

    PUSH_SUBSTEPS = 20
    PUSH_CAP = 0.1
    ROPE_WIDTH = (0.2, 0.06, 0.12)
    ROPE_INIT_POS = (0.5, 0.07, 0.5)
    ROPE_MATERIAL = PLASTIC_CLIP
    ROPE_DENSITY = 3.0
    DO_RESET_PUSHES = 0

    def __init__(self, batch_size, seed=1, max_steps=6, conf=None, aux_reward=False,
                 device="cuda"):
        super().__init__(batch_size, seed, max_steps, conf or ShapeElastoPlasticConf,
                         aux_reward, device=device)
