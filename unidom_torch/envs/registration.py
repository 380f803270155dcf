"""Environment registry (name -> constructor): every DaXBench env of the JAX
package, with its aliases (push_rope, push_rope_hard), and the ten plb
scenes (``envs/plb_tasks.py``)."""

from unidom_torch.envs.cloth_tasks import (
    FoldCloth1Env,
    FoldCloth1ParaEnv,
    FoldCloth3Env,
    FoldTshirtEnv,
    UnfoldCloth1Env,
    UnfoldCloth3Env,
)
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
    "fold_cloth1_para": FoldCloth1ParaEnv,
    "fold_cloth3": FoldCloth3Env,
    "fold_tshirt": FoldTshirtEnv,
    "unfold_cloth1": UnfoldCloth1Env,
    "unfold_cloth3": UnfoldCloth3Env,
    "whip_rope": WhipRopeEnv,
    "shape_rope": ShapeRopeEnv,
    "push_rope": ShapeRopeEnv,
    "shape_rope_hard": ShapeRopeHardEnv,
    "push_rope_hard": ShapeRopeHardEnv,
    "pour_water": PourWaterEnv,
    "pour_soup": PourSoupEnv,
    "shape_elasto_plastic": ShapeElastoPlasticEnv,
}


def _register_plb():
    from unidom_torch.envs.plb_tasks import PLB_SCENES, make_plb_env

    for name in PLB_SCENES:
        env_functions[name] = make_plb_env(name)


_register_plb()
