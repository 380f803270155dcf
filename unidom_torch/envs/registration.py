"""Environment registry (name -> constructor)."""

from unidom_torch.envs.cloth_tasks import FoldCloth1Env, FoldCloth3Env
from unidom_torch.envs.mpm_tasks import WhipRopeEnv

env_functions = {
    "fold_cloth1": FoldCloth1Env,
    "fold_cloth3": FoldCloth3Env,
    "whip_rope": WhipRopeEnv,
}
