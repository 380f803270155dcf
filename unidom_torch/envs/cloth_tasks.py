"""Concrete cloth task environments.

Counterpart of ``unidom_tpu/envs/cloth_tasks.py`` for fold_cloth1 and
fold_cloth3: a 16x32 rectangle of cloth on an 80-grid, folded onto a
recorded goal cloud in 3 or 4 macro steps. The goals are read as ``.npy``
data from ``unidom_tpu/assets/goals/``.
"""

from pathlib import Path

import numpy as np

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
                 device="cpu"):
        conf = conf or ClothConf(task="fold_cloth1", goal_path=goal_path("fold_cloth1"), seed=seed)
        conf.stiffness = stiffness
        super().__init__(conf, batch_size, max_steps=3, aux_reward=aux_reward, device=device)

    def create_cloth_mask(self, conf):
        return _rect_mask(conf.N, conf.size)


class FoldCloth3Env(ClothEnv):
    def __init__(self, batch_size, conf=None, aux_reward=False, seed=1, device="cpu"):
        conf = conf or ClothConf(task="fold_cloth3", goal_path=goal_path("fold_cloth3"), seed=seed)
        super().__init__(conf, batch_size, max_steps=4, aux_reward=aux_reward, device=device)

    def create_cloth_mask(self, conf):
        return _rect_mask(conf.N, conf.size)
