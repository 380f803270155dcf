"""Environment registry (name -> constructor), with the JAX package's
aliases (push_rope, push_rope_hard)."""

from unidom_torch.envs.cloth_tasks import FoldCloth1Env, FoldCloth3Env
from unidom_torch.envs.mpm_tasks import (
    PourSoupEnv,
    PourWaterEnv,
    ShapeElastoPlasticEnv,
    ShapeRopeEnv,
    ShapeRopeHardEnv,
    WhipRopeEnv,
)

env_functions = {
    "fold_cloth1": FoldCloth1Env,
    "fold_cloth3": FoldCloth3Env,
    "whip_rope": WhipRopeEnv,
    "shape_rope": ShapeRopeEnv,
    "push_rope": ShapeRopeEnv,
    "shape_rope_hard": ShapeRopeHardEnv,
    "push_rope_hard": ShapeRopeHardEnv,
    "pour_water": PourWaterEnv,
    "pour_soup": PourSoupEnv,
    "shape_elasto_plastic": ShapeElastoPlasticEnv,
}
