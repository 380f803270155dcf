"""Concrete cloth task environments.

Counterpart of ``unidom_tpu/envs/cloth_tasks.py``:
- fold_cloth1 and fold_cloth3: a 16x32 rectangle of cloth on an 80-grid,
  folded onto a recorded goal cloud in 3 or 4 macro steps;
- fold_cloth1_para: fold_cloth1 with the stiffness in the observation;
- unfold_cloth1 and unfold_cloth3: the same cloth after 1 or 3 random
  folds at reset, on ground of friction 3, unfolded in 15 macro steps;
- fold_tshirt: a t-shirt of 3573 particles on a 180-grid, a 72x78 bbox,
  5 macro steps.
The goals and the t-shirt mask are read as ``.npy`` data from
``unidom_tpu/assets/``.
"""

from pathlib import Path

import numpy as np
import torch

from unidom_torch.engine.cloth import ClothConf
from unidom_torch.envs.base_cloth import ClothEnv

ASSET_DIR = Path(__file__).resolve().parents[2] / "unidom_tpu" / "assets"


def goal_path(task):
    return str(ASSET_DIR / "goals" / task / "goal.npy")


def _rect_mask(N, size):
    mask = np.zeros((N, N), dtype=np.float32)
    mask[size * 2 : size * 3, size * 2 : size * 4] = 1.0
    return mask


class FoldCloth1Env(ClothEnv):
    def __init__(self, batch_size, conf=None, aux_reward=False, seed=1, stiffness=900,
                 device="cuda"):
        conf = conf or ClothConf(task="fold_cloth1", goal_path=goal_path("fold_cloth1"), seed=seed)
        conf.stiffness = stiffness
        super().__init__(conf, batch_size, max_steps=3, aux_reward=aux_reward, device=device)

    def create_cloth_mask(self, conf):
        return _rect_mask(conf.N, conf.size)


class FoldCloth1ParaEnv(ClothEnv):
    """fold_cloth1 whose observation ends in the normalised stiffness (the
    GenORM parameter-aware capability)."""

    def __init__(self, batch_size, conf=None, aux_reward=False, seed=1, stiffness=900,
                 eval_min_max_stiff=(100.0, 2000.0), device="cuda"):
        conf = conf or ClothConf(task="fold_cloth1", goal_path=goal_path("fold_cloth1"), seed=seed)
        conf.stiffness = stiffness
        super().__init__(conf, batch_size, max_steps=3, aux_reward=aux_reward, param_obs=True,
                         eval_min_max_stiff=eval_min_max_stiff, device=device)

    def create_cloth_mask(self, conf):
        return _rect_mask(conf.N, conf.size)


class FoldCloth3Env(ClothEnv):
    def __init__(self, batch_size, conf=None, aux_reward=False, seed=1, device="cuda"):
        conf = conf or ClothConf(task="fold_cloth3", goal_path=goal_path("fold_cloth3"), seed=seed)
        super().__init__(conf, batch_size, max_steps=4, aux_reward=aux_reward, device=device)

    def create_cloth_mask(self, conf):
        return _rect_mask(conf.N, conf.size)


class _UnfoldClothEnv(ClothEnv):
    """Unfold a cloth that the reset folded: the flat cloth plus N(0, 1e-4^2)
    noise per particle, then N_FOLDS random pick-and-place folds through
    ``step_diff`` itself (forward only), the step count restarted. The
    folds' particle indices come from the env's numpy ``rng``, seeded with
    ``conf.seed`` as JAX seeds numpy's global state."""

    N_FOLDS = 3

    def __init__(self, batch_size, conf=None, aux_reward=False, seed=1, device="cuda"):
        task = f"unfold_cloth{self.N_FOLDS}"
        conf = conf or ClothConf(task=task, goal_path=goal_path(task), mu=3.0,
                                 use_substep_obs=False, seed=seed)
        super().__init__(conf, batch_size, max_steps=15, aux_reward=aux_reward, device=device)
        self.rng = np.random.RandomState(conf.seed)

    def create_cloth_mask(self, conf):
        return _rect_mask(conf.N, conf.size)

    @torch.no_grad()
    def random_fold(self, state, step, indices=None):
        """``step`` random folds from ``state``; ``indices``, one (st, ed)
        pair of (B,) particle indices per fold, replaces the draws."""
        for k in range(step):
            actions = self.get_random_fold_action(
                state, self.rng, None if indices is None else indices[k])
            _, _, _, info = self.step_diff(actions, state)
            state = info["state"]
        return state

    def reset_from_noise(self, noise, indices=None):
        """(obs, state): the flat cloth plus ``noise`` (B, H, W, 3), folded
        N_FOLDS times (``indices`` as in ``random_fold``), at step 0."""
        init = self._init_state
        noise = torch.tensor(np.asarray(noise, dtype=np.float32), device=self.device)
        state = self.random_fold(init.replace(x=init.x + noise), self.N_FOLDS, indices)
        state = state.replace(cur_step=torch.zeros_like(state.cur_step))
        return self.get_obs(state), state

    def reset(self, generator: torch.Generator = None):
        """The noise drawn from ``generator`` (a CPU generator; by default
        one seeded with ``conf.seed``), the folds from ``self.rng``."""
        if generator is None:
            generator = torch.Generator().manual_seed(self.conf.seed)
        return self.reset_from_noise(
            torch.randn(tuple(self._init_state.x.shape), generator=generator) * 0.0001)


class UnfoldCloth1Env(_UnfoldClothEnv):
    N_FOLDS = 1


class UnfoldCloth3Env(_UnfoldClothEnv):
    N_FOLDS = 3


def _tshirt_mask(N):
    """The reference's t-shirt mask at N = 180 (``tshirt_mask.npy``, 3573
    particles, the recorded goal cloud's row count); for another N a
    procedural silhouette of the same placement, as ``unidom_tpu`` draws it."""
    if N == 180:
        return np.load(ASSET_DIR / "tshirt_mask.npy").astype(np.float32)

    size = N // 2
    h_size = size // 2
    m = np.zeros((size, size), dtype=np.float32)

    body_w = int(size * 0.44)
    body_h = int(size * 0.62)
    bx0 = (size - body_w) // 2
    by0 = int(size * 0.22)
    m[by0 : by0 + body_h, bx0 : bx0 + body_w] = 1.0

    sleeve_h = int(size * 0.2)
    sleeve_w = int(size * 0.22)
    m[by0 : by0 + sleeve_h, bx0 - sleeve_w : bx0] = 1.0
    m[by0 : by0 + sleeve_h, bx0 + body_w : bx0 + body_w + sleeve_w] = 1.0

    neck_w = int(size * 0.12)
    nx0 = (size - neck_w) // 2
    m[by0 : by0 + int(size * 0.04), nx0 : nx0 + neck_w] = 0.0

    m = m.T[::-1]  # rotated 90 degrees clockwise
    mask = np.zeros((N, N), dtype=np.float32)
    c = N // 2
    mask[c - h_size : c + h_size, c - h_size : c + h_size] = m
    return mask


class FoldTshirtEnv(ClothEnv):
    def __init__(self, batch_size, conf=None, aux_reward=False, seed=1, device="cuda"):
        conf = conf or ClothConf(N=180, stiffness=5000.0, dt=0.5e-3, mu=0.9, task="fold_tshirt",
                                 goal_path=goal_path("fold_tshirt"), seed=seed)
        super().__init__(conf, batch_size, max_steps=5, aux_reward=aux_reward, device=device)

    def create_cloth_mask(self, conf):
        return _tshirt_mask(conf.N)
