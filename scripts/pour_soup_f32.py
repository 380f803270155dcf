"""pour_soup's float32 physics under random actions: ``unidom_tpu``'s XLA step
against the port's plain step, both in float32, from the same reset state
and with the same actions (numpy, uniform in [-1, 1] as a policy's tanh
squashes them), macro step by macro step. For each macro step and side it
prints J's minimum over the finite values, the envs where a particle ends
outside the box the grid's walls bound (or not finite), in the simulator's
frame, as ``chip_smoke.py``'s ``big_outside`` tests it, and how far the
two sides' particles are apart.

    JAX_PLATFORMS=cpu timeout 1800 python scripts/pour_soup_f32.py --envs 2 --steps 40

Each side continues from its own output state, as a rollout does; once
they have drifted apart by rounding, they are two rollouts of the same
scene and actions. One macro step (25 substeps on the 128x64x128 grid) takes
tens of seconds on each side on the CPU.

    JAX_PLATFORMS=cpu python scripts/pour_soup_f32.py --replay build/pour_soup_escape.npz

replays instead one macro step from the input state and action that
``chip_smoke.py``'s pour_soup rollout saved at the first macro step where
a particle left the box on the card, through both sides in float32 and
in float64.
"""

import argparse
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
from unidom_torch.utils.convert import mpm_state_from_jax  # noqa: E402


def outside(conf, x_in, x_out):
    """(B,) whether a particle of x_out (world frame) lies outside [0, 1]^3
    or is not finite, in the simulator's frame of the macro step from x_in
    (the focus shift of its pre_step)."""
    target = np.asarray(conf.res, np.float64) * 0.5 / conf.n_grid
    shift = target - x_in.mean(1)
    shift[:, 1] = 0.0
    x = x_out + shift[:, None]
    inside = np.isfinite(x) & (x >= 0) & (x <= conf.n_grid * conf.dx)
    return ~inside.all(-1).all(-1)


def j_min(J):
    finite = J[np.isfinite(J)]
    return float(finite.min()) if finite.size else float("nan")


def replay(path):
    """One macro step from the saved input state and action, through
    unidom_tpu's XLA step and the port's plain step, in float32 and float64."""
    saved = dict(np.load(path))
    B = saved["x"].shape[0]
    action = saved.pop("action")
    for bits in (32, 64):
        with jax.enable_x64(bits == 64):
            jenv = jtasks.PourSoupEnv(batch_size=B, seed=1)
            _, jstate = jenv.reset(jax.random.PRNGKey(0))
            ftype = jnp.float64 if bits == 64 else jnp.float32

            def cast(a, like):
                a = jnp.asarray(a, like.dtype)
                return a.astype(ftype) if jnp.issubdtype(a.dtype, jnp.floating) else a

            prims = tuple(
                p._replace(**{f: cast(saved[f"primitives.{i}.{f}"], getattr(p, f))
                              for f in p._fields})
                for i, p in enumerate(jstate.primitives))
            jstate = jstate._replace(
                primitives=prims, **{f: cast(saved[f], getattr(jstate, f))
                                     for f in jstate._fields if f not in ("primitives", "key")})
            t0 = time.perf_counter()
            _, _, _, jinfo = jax.jit(jenv.step_diff)(jnp.asarray(action, ftype), jstate)
            jlast = jax.tree_util.tree_map(lambda a: np.asarray(a[-1]), jinfo["state_list"])
            t_jax = time.perf_counter() - t0
        tenv = ttasks.PourSoupEnv(B, seed=1, device="cpu")
        dtype = torch.float64 if bits == 64 else torch.float32
        tstate = mpm_state_from_jax(jax.device_get(jstate), device="cpu")
        if bits == 64:
            tenv.goal = tenv.goal.to(dtype)
        t0 = time.perf_counter()
        with torch.no_grad():
            _, _, _, tinfo = tenv.step_diff(torch.from_numpy(action).to(dtype), tstate)
        tlast = tinfo["state_list"][-1]
        t_port = time.perf_counter() - t0
        x_in = saved["x"].astype(np.float64)
        for side, x_out, J, secs in (("jax", np.asarray(jlast.x, np.float64), np.asarray(jlast.J),
                                      t_jax),
                                     ("port", tlast.x.double().numpy(), tlast.J.numpy(), t_port)):
            out = outside(tenv.conf, x_in, x_out)
            print(f"replay of {path} ({B} envs, saved env order): {side} float{bits}: envs "
                  f"outside {out.nonzero()[0].tolist()} of {B}, J min {j_min(J):.3e}; "
                  f"{secs:.1f} s", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--envs", type=int, default=2)
    ap.add_argument("--steps", type=int, default=40, help="macro steps")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--replay", type=Path, help="a state and action saved by chip_smoke.py")
    args = ap.parse_args()
    torch.set_num_threads(4)
    if args.replay:
        replay(args.replay)
        return
    B = args.envs
    jenv = jtasks.PourSoupEnv(batch_size=B, seed=1)
    _, jstate = jenv.reset(jax.random.PRNGKey(args.seed))
    tenv = ttasks.PourSoupEnv(B, seed=1, device="cpu")
    tstate = mpm_state_from_jax(jax.device_get(jstate), device="cpu")
    conf = tenv.conf
    rng = np.random.default_rng(args.seed)
    actions = rng.uniform(-1.0, 1.0, (args.steps, B, tenv.action_size)).astype(np.float32)
    jstep = jax.jit(jenv.step_diff)
    first = {"jax": None, "port": None}
    print(f"pour_soup, {B} envs, {tenv.simulator.n_particles} particles, res {conf.res}, "
          f"{conf.steps} substeps per macro step, float32 on both sides", flush=True)
    for t in range(args.steps):
        t0 = time.perf_counter()
        jx_in = np.asarray(jstate.x, np.float64)
        _, jrew, _, jinfo = jstep(jnp.asarray(actions[t]), jstate)
        jlast = jax.tree_util.tree_map(lambda a: np.asarray(a[-1]), jinfo["state_list"])
        t_jax = time.perf_counter() - t0
        t0 = time.perf_counter()
        tx_in = tstate.x.double().numpy()
        with torch.no_grad():
            _, trew, _, tinfo = tenv.step_diff(torch.from_numpy(actions[t]), tstate)
        tlast = tinfo["state_list"][-1]
        t_port = time.perf_counter() - t0
        rows = {"jax": (jx_in, np.asarray(jlast.x, np.float64), np.asarray(jlast.J)),
                "port": (tx_in, tlast.x.double().numpy(), tlast.J.numpy())}
        parts = []
        for side, (x_in, x_out, J) in rows.items():
            out = outside(conf, x_in, x_out).nonzero()[0].tolist()
            if out and first[side] is None:
                first[side] = (t, out)
            parts.append(f"{side}: J min {j_min(J):.3e}, envs outside {out}")
        apart = np.nanmax(np.abs(rows["jax"][1] - rows["port"][1]))
        print(f"macro step {t}: " + "; ".join(parts) + f"; max |x_jax - x_port| {apart:.3e}; "
              f"rewards jax {np.asarray(jrew).round(6).tolist()} port "
              f"{trew.numpy().round(6).tolist()}; {t_jax:.1f} s + {t_port:.1f} s", flush=True)
        jstate, tstate = jinfo["state"], tinfo["state"]
    print(f"first macro step with a particle outside: jax {first['jax']}, port {first['port']}",
          flush=True)


if __name__ == "__main__":
    main()
