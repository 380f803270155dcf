"""PlasticineLab-style task family: declarative MPM scenes scored by a
target-driven loss.

Counterpart of ``unidom_tpu/envs/plb_tasks.py``: all ten of its scenes.
Each is one or more von-Mises plastic bodies (1,000-2,100 particles) on a
64^3 grid with 40 substeps per macro step, and one to three manipulators.
Seven scenes move spheres by a per-step velocity (3 dof each, ``v3``);
plb_writer moves a capsule pen the same way; plb_rollingpin rolls, yaws and
lowers a rolling pin (3 dof, ``rollingpin``); plb_chopsticks moves a pair
of capsules in 6 dof and opens or closes their gap (7 dof,
``chopsticks``). The reward is the decrease of the target loss since the
episode's start (``engine/losses.LossTracker``); the target is the initial
body moved by a per-variant offset (and flattened, for the rolling pin).
On the card the 64^3 grid (262,144 cells) is more than K2 holds, so every
scene steps through K3 (``engine/mpm.kernel_route``).

``reset`` rebuilds the scene from ``np.random.RandomState(seed)``, where the
seed is an int or a ``torch.Generator``'s initial seed: JAX's reset seeds
the same stream with ``PRNGKey(seed)``'s last word, ``seed``, so both
packages place the same particles.
"""

import dataclasses

import numpy as np
import torch

from unidom_torch.engine.losses import LossTracker, LossWeights, TargetLoss
from unidom_torch.engine.mpm import VON_MISES, MPMConf
from unidom_torch.envs.base_mpm import MPMEnv
from unidom_torch.ops.quat import qrot

PLB_BASE_CONF = MPMConf(
    n_grid=64,
    dt=0.5e-4,
    steps=40,  # plb: substeps = 2e-3 // dt
    E=5e3,
    nu=0.2,
    yield_stress=1762.2,
    ground_friction=0.5,
    res=(64, 64, 64),
    gravity=(0.0, -0.4, 0.0),
    task="plb",
    goal_path="",
)

PLB_SCENES = {
    "plb_move": dict(
        shapes=[dict(width=(0.5, 0.028, 0.028), init_pos=(0.5, 0.0125, 0.5), n=1000)],
        primitives=[dict(radius=0.025, init_pos=(0.745, 0.02, 0.5), scale=0.005)],
        target_shift=(0.0, 0.0, 0.12),
    ),
    "plb_rope": dict(
        shapes=[dict(width=(0.4, 0.01, 0.4), init_pos=(0.5, 0.04, 0.5), n=1500)],
        primitives=[dict(radius=0.025, init_pos=(0.5, 0.05, 0.5), scale=0.005)],
        target_shift=(0.1, 0.0, 0.0),
    ),
    "plb_table": dict(
        shapes=[dict(width=(0.4, 0.01, 0.4), init_pos=(0.5, 0.01, 0.5), n=1500)],
        primitives=[dict(radius=0.035, init_pos=(0.65, 0.025, 0.35), scale=0.005)],
        target_shift=(0.0, 0.0, 0.1),
    ),
    "plb_torus": dict(
        shapes=[dict(width=(0.028, 0.5, 0.028), init_pos=(0.5, 0.3, 0.5), n=1000)],
        primitives=[
            dict(radius=0.025, init_pos=(0.475, 0.05, 0.5), scale=1.0, friction=0.9),
            dict(radius=0.025, init_pos=(0.5, 0.55, 0.5), scale=1.0, friction=0.9),
        ],
        target_shift=(0.0, -0.2, 0.0),
    ),
    # ---- round-5 additions: the six remaining registered families ---- #
    "plb_writer": dict(
        # writer.yml (PlasticineLab/sim2sim/plb/envs/writer.yml): box
        # (0.3, 0.1, 0.3) @ (0.5, 0.05, 0.5), capsule pen h=0.06 r=0.03 @
        # (0.5, 0.13, 0.5), 3-dof action scale 0.01, friction 0
        shapes=[dict(width=(0.3, 0.1, 0.3), init_pos=(0.5, 0.05, 0.5), n=2000)],
        primitives=[dict(shape="capsule", size=(0.03, 0.03, 0.0),
                         init_pos=(0.5, 0.13, 0.5), scale=0.01, friction=0.0)],
        target_shift=(0.05, 0.0, 0.05),
    ),
    "plb_pinch": dict(
        # solver.py:245-270 Pinch expert: small +x pushes of a sphere into
        # the body's side, then release
        shapes=[dict(width=(0.2, 0.2, 0.2), init_pos=(0.5, 0.1, 0.5), n=2000)],
        primitives=[dict(radius=0.03, init_pos=(0.36, 0.12, 0.5), scale=0.01)],
        target_shift=(0.03, 0.0, 0.0),
    ),
    "plb_rollingpin": dict(
        # RollingPin (primitives.py:83-100): horizontal capsule, 3-dof
        # (roll dw, world-yaw dth, descend dy); flatten the slab
        shapes=[dict(width=(0.3, 0.12, 0.3), init_pos=(0.5, 0.06, 0.5), n=2000)],
        primitives=[dict(shape="rolling_pin", kind="rollingpin",
                         size=(0.03, 0.15, 0.0), init_pos=(0.5, 0.16, 0.5),
                         scale=(0.6, 0.06, 0.012), friction=0.9)],
        target_flatten=0.7,
        target_shift=(0.0, 0.0, 0.0),
    ),
    "plb_chopsticks": dict(
        # Chopsticks (primitives.py:102-174): two vertical capsules, 7-dof
        # (3 v, 3 w, gap); grasp the rope and carry it
        shapes=[dict(width=(0.06, 0.06, 0.3), init_pos=(0.5, 0.03, 0.5), n=1500)],
        primitives=[dict(shape="chopsticks", kind="chopsticks",
                         size=(0.015, 0.06, 0.06), init_pos=(0.5, 0.12, 0.5),
                         scale=(0.012, 0.012, 0.012, 0.06, 0.06, 0.06, 0.012),
                         friction=0.9)],
        target_shift=(0.08, 0.0, 0.04),
    ),
    "plb_triplemove": dict(
        # TripleMove: three bodies, three sphere manipulators (9 dof)
        shapes=[
            dict(width=(0.1, 0.08, 0.1), init_pos=(0.3, 0.04, 0.5), n=700),
            dict(width=(0.1, 0.08, 0.1), init_pos=(0.5, 0.04, 0.5), n=700),
            dict(width=(0.1, 0.08, 0.1), init_pos=(0.7, 0.04, 0.5), n=700),
        ],
        primitives=[
            dict(radius=0.03, init_pos=(0.3, 0.05, 0.34), scale=0.005),
            dict(radius=0.03, init_pos=(0.5, 0.05, 0.34), scale=0.005),
            dict(radius=0.03, init_pos=(0.7, 0.05, 0.34), scale=0.005),
        ],
        target_shift=(0.0, 0.0, 0.1),
    ),
    "plb_assembly": dict(
        # Assembly: place the soft ball on top of the pedestal (per-shape
        # target offsets)
        shapes=[
            dict(kind="sphere", radius=0.05, init_pos=(0.3, 0.06, 0.5), n=1200,
                 target_shift=(0.35, 0.1, 0.0)),
            dict(width=(0.12, 0.1, 0.12), init_pos=(0.65, 0.05, 0.5), n=800,
                 target_shift=(0.0, 0.0, 0.0)),
        ],
        primitives=[dict(radius=0.03, init_pos=(0.3, 0.17, 0.5), scale=0.01)],
        target_shift=(0.0, 0.0, 0.0),
    ),
}

# a primitive kind's macro-action dof: a velocity (spheres, the capsule pen),
# the rolling pin's roll, yaw and descent, the chopsticks' velocity, angular
# velocity and gap velocity
KIND_DIMS = {"v3": 3, "rollingpin": 3, "chopsticks": 7}


class PlbSceneEnv(MPMEnv):
    """A plb scene: shapes, manipulators and a target loss. A macro action
    is each primitive's ``KIND_DIMS[kind]`` dof, times the scene's scale,
    over ``conf.steps`` substeps; the reward is the target loss's decrease
    since the episode's start."""

    action_squash = None
    reset_mode = "host_reset"

    def __init__(self, scene_name, batch_size, seed=1, max_steps=50, conf=None, variant=1,
                 aux_reward=False, device="cuda"):
        # aux_reward is taken and ignored, as in the JAX env
        self.scene = PLB_SCENES[scene_name]
        self.variant = variant
        conf = conf or dataclasses.replace(PLB_BASE_CONF,
                                           n_primitive=len(self.scene["primitives"]),
                                           task=scene_name)
        super().__init__(conf, batch_size, max_steps, seed, focus_computation=False,
                         use_position_control=False, device=device)
        self.reset_seed = seed
        self.prim_kinds = [p.get("kind", "v3") for p in self.scene["primitives"]]
        self.action_size = sum(KIND_DIMS[k] for k in self.prim_kinds)
        self.target_loss = None  # built at reset
        self.tracker = None

    # ---------------- scene building ---------------- #

    @staticmethod
    def _sample_shape(spec, rng):
        if spec.get("kind") == "sphere":
            # a uniform ball
            u = rng.normal(size=(spec["n"], 3))
            u /= np.linalg.norm(u, axis=1, keepdims=True) + 1e-12
            r = spec["radius"] * rng.uniform(0, 1, (spec["n"], 1)) ** (1 / 3)
            pts = u * r + np.asarray(spec["init_pos"])
        else:
            w = np.asarray(spec["width"]) * 0.5
            pts = rng.uniform(-1, 1, (spec["n"], 3)) * w + np.asarray(spec["init_pos"])
        return pts.astype(np.float32)

    def _target_points(self, all_pts):
        """The target: each shape's particles moved by its shift (the
        scene's unless the shape has one), scaled by the variant, flattened
        toward its lowest point by the scene's ``target_flatten`` if it has
        one, clipped to [0.01, 0.99]."""
        vscale = 1.0 + 0.1 * (self.variant - 1)
        shifted = []
        for spec, pts in zip(self.scene["shapes"], all_pts):
            shift = np.asarray(spec.get("target_shift", self.scene["target_shift"]), np.float32)
            shifted.append(pts + shift * vscale)
        target = np.concatenate(shifted)
        flatten = self.scene.get("target_flatten")
        if flatten is not None:
            y0 = target[:, 1].min()
            target[:, 1] = y0 + (target[:, 1] - y0) * flatten
        return np.clip(target, 0.01, 0.99)

    def reset(self, generator=None):
        """(obs, state): the scene rebuilt from ``np.random.RandomState(seed)``,
        ``seed`` an int, a ``torch.Generator``'s initial seed, or by default
        the constructor's; the target loss and the episode's tracker anew."""
        if generator is None:
            seed = self.reset_seed
        elif isinstance(generator, torch.Generator):
            seed = generator.initial_seed()
        else:
            seed = int(generator)
        rng = np.random.RandomState(seed % 2**31)
        sim = self.simulator
        sim.sdf_names, sim._colliders = [], []

        state = None
        all_pts = []
        for spec in self.scene["shapes"]:
            pts = self._sample_shape(spec, rng)
            all_pts.append(pts)
            state = sim.add_points(state, pts, hardness=1.0, material=VON_MISES)
        for p in self.scene["primitives"]:
            size = list(p["size"]) if "size" in p else [p["radius"], 0.0, 0.0]
            state = self.create_primitive(
                state, friction=p.get("friction", 0.9), color=[0.7, 0.7, 0.7], size=size,
                init_pos=p["init_pos"], softness=666.0, sdf_name=p.get("shape", "sphere"))
        self.initialize_after_adding_particle_primitives(state)

        conf = self.conf
        target = torch.as_tensor(self._target_points(all_pts), device=self.device)
        self.target_loss = TargetLoss.from_particles(target, conf.res, conf.inv_dx,
                                                     weights=LossWeights())
        self.tracker = LossTracker.init(self.target_loss.losses(self.init_state.x))
        # the plb reward replaces the L2 goal reward
        self.goal = torch.zeros((1, 3), device=self.device)
        return self.get_obs(self.init_state), self.init_state

    # ---------------- actions / reward ---------------- #

    def get_primitive_actions(self, actions, state):
        """(B, action_size) macro actions -> ((B, 1, 6 n_prim) sub-actions,
        state): each primitive's (v, w) row from its dof times its scale.
        ``v3``: the velocity, no rotation. ``rollingpin`` (roll dw, yaw dth,
        descent dy): the pin rolls about its own axis, expressed as a world
        axis from its rotation at the macro step's start (row 0), so
        ``v = roll_dir dw 0.03`` with ``v[1] = dy`` and
        ``w = -y dth + qrot(q, x) dw``. ``chopsticks``: (v, w) and the gap
        velocity, which moves the half gap ``size[2]`` once per macro step,
        per env, to ``max(size[2] - gap / 2, 0.03)`` in the returned state."""
        rows = []
        prims = list(state.primitives)
        off = 0
        for i, (spec, kind) in enumerate(zip(self.scene["primitives"], self.prim_kinds)):
            n = KIND_DIMS[kind]
            scale = torch.tensor(np.broadcast_to(np.asarray(spec["scale"], np.float32), (n,)),
                                 dtype=actions.dtype, device=actions.device)
            a = actions[:, off:off + n] * scale
            off += n
            if kind == "v3":
                rows.append(torch.cat([a, torch.zeros_like(a)], dim=1))
            elif kind == "rollingpin":
                dw, dth, dy = a[:, 0:1], a[:, 1:2], a[:, 2:3]
                q = prims[i].rotation[:, 0]
                ex = a.new_tensor([1.0, 0.0, 0.0]).expand(a.shape[0], 3)
                ey = a.new_tensor([0.0, 1.0, 0.0]).expand(a.shape[0], 3)
                roll_dir = torch.linalg.cross(ey, qrot(q, -ex))
                v = roll_dir * dw * 0.03
                v = torch.cat([v[:, :1], dy, v[:, 2:]], dim=1)
                w = -ey * dth + qrot(q, ex) * dw
                rows.append(torch.cat([v, w], dim=1))
            else:
                pr = prims[i]
                half_gap = torch.maximum(pr.size[:, 2] - a[:, 6] * 0.5,
                                         torch.full_like(a[:, 6], 0.03))
                prims[i] = pr.replace(size=torch.cat([pr.size[:, :2], half_gap[:, None]], dim=1))
                rows.append(a[:, :6])
        return torch.cat(rows, dim=1)[:, None], state.replace(primitives=tuple(prims))

    def auto_reset(self, init_state, generator=None, shift=None, state=None):
        """A done env keeps its current ``state``."""
        return init_state if state is None else state

    def reward_func(self, state, goal):
        """The target loss's decrease since the episode's start."""
        return self.tracker.start_loss - self.target_loss.losses(state.x)["loss"]

    def loss_info(self, state):
        """The step's loss terms, reward and incremental IoU; advances the
        episode's tracker."""
        self.tracker, out = self.tracker.step(self.target_loss.losses(state.x))
        return out


def make_plb_env(scene_name):
    """The constructor of one scene, ``(batch_size, **kw)``."""

    class _Env(PlbSceneEnv):
        def __init__(self, batch_size, **kw):
            super().__init__(scene_name, batch_size, **kw)

    _Env.__name__ = f"PlbEnv_{scene_name}"
    return _Env
