"""Environment registry (name -> constructor)."""

from unidom_torch.envs.cloth_tasks import FoldCloth1Env, FoldCloth3Env

env_functions = {
    "fold_cloth1": FoldCloth1Env,
    "fold_cloth3": FoldCloth3Env,
}
