"""``step_diff``'s action gradient on shape_elasto_plastic for pushes that
graze the slab: ``unidom_tpu`` (``jax.grad`` of the XLA step) against the
port's plain step (autograd), each in float32 and in float64, from the same
reset state. Prints each push's gradient and the relative distances
between the four.

    JAX_PLATFORMS=cpu python scripts/grazing_push_f64.py --steps 16

The envs are cut to ``--push-substeps`` simulator calls per macro step
(2, as tests/test_torch_mpm_big_train.py cuts them) and ``--steps``
substeps per call (the env's own 16 by default).
"""

import argparse
import dataclasses
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from unidom_tpu.envs import mpm_tasks as jtasks  # noqa: E402
from unidom_torch.envs import mpm_tasks as ttasks  # noqa: E402
from unidom_torch.ops.gradops import tree_flatten  # noqa: E402
from unidom_torch.utils.convert import mpm_state_from_jax  # noqa: E402

# pushes (start x, y, z, end x, y, z) towards the slab (x 0.4-0.6, z 0.44-0.56)
PUSHES = {"grazing": [0.37, 0.0, 0.49, 0.39, 0.0, 0.49],
          "reaching": [0.37, 0.0, 0.49, 0.40, 0.0, 0.49]}


def action_grads(steps, push_substeps, actions, seed=1):
    """{(side, bits): (B, 6) action gradient of sum(reward) + 1e-2 sum(x)}
    for side jax / port and bits 32 / 64."""

    class JaxEnv(jtasks.ShapeElastoPlasticEnv):
        PUSH_SUBSTEPS = push_substeps

    class Env(ttasks.ShapeElastoPlasticEnv):
        PUSH_SUBSTEPS = push_substeps

    B = len(actions)
    actions = np.asarray(actions, np.float64)
    out = {}
    for bits in (32, 64):
        with jax.enable_x64(bits == 64):
            jenv = JaxEnv(batch_size=B, seed=seed, max_steps=2, conf=dataclasses.replace(
                jtasks.ShapeElastoPlasticConf, steps=steps))
            _, jstate = jenv.reset(jax.random.PRNGKey(seed))
            ftype = jnp.float64 if bits == 64 else jnp.float32
            jstate = jax.tree_util.tree_map(
                lambda a: a.astype(ftype) if jnp.issubdtype(a.dtype, jnp.floating) else a, jstate)

            def jloss(a):
                _, reward, _, info = jenv.step_diff(a, jstate)
                return jnp.sum(reward) + 1e-2 * jnp.sum(info["state"].x)

            t0 = time.perf_counter()
            g = jax.jit(jax.grad(jloss))(jnp.asarray(actions, ftype))
            out["jax", bits] = np.asarray(g, np.float64)
            assert g.dtype == ftype, g.dtype
            print(f"jax float{bits}: {time.perf_counter() - t0:.1f} s", flush=True)
        tenv = Env(B, seed=seed, device="cpu", max_steps=2, conf=dataclasses.replace(
            ttasks.ShapeElastoPlasticConf, steps=steps))
        dtype = torch.float64 if bits == 64 else torch.float32
        leaves, rebuild = tree_flatten(mpm_state_from_jax(jax.device_get(jstate), device="cpu"))
        state = rebuild([t.to(dtype) if t.is_floating_point() else t for t in leaves])
        if bits == 64:
            tenv.goal = tenv.goal.to(dtype)
        a = torch.from_numpy(actions).to(dtype).requires_grad_()
        t0 = time.perf_counter()
        _, reward, _, info = tenv.step_diff(a, state)
        (reward.sum() + 1e-2 * info["state"].x.sum()).backward()
        out["port", bits] = a.grad.double().numpy()
        print(f"port float{bits}: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--push-substeps", type=int, default=2)
    args = ap.parse_args()
    torch.set_num_threads(4)
    names = list(PUSHES)
    g = action_grads(args.steps, args.push_substeps, [PUSHES[n] for n in names])
    for i, n in enumerate(names):
        print(f"{n} push {PUSHES[n]}, {args.steps} substeps x {args.push_substeps} calls:")
        for key, v in g.items():
            print(f"  {key[0]} float{key[1]}: {np.array2string(v[i], precision=6)}")
        pairs = [(("port", 64), ("jax", 64)), (("port", 32), ("jax", 32)),
                 (("jax", 32), ("jax", 64)), (("port", 32), ("port", 64)),
                 (("port", 32), ("jax", 64))]
        print("  " + "; ".join(f"{a[0]}{a[1]} vs {b[0]}{b[1]} {rel(g[a][i], g[b][i]):.3e}"
                               for a, b in pairs))


if __name__ == "__main__":
    main()
