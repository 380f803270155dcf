"""The spread, between repetitions, of ``chip_smoke.py``'s K3-bwd gates on
the PlasticineLab scenes ([plb-bwd-parity]): the VJP of one macro step of
plb_triplemove and plb_move (``chip_smoke.plb_inputs``: random v and C, a
yield stress per env drawn log-uniformly in ``--ys`` decades of the conf's,
the spheres put into the material) through K3-bwd at K = 7 and 1 and
through the float32 plain step, repeated, each against the float64 plain
VJP computed once. For every input it prints the float64 cotangent's median
per-env norm and, per side, each repetition's median over the envs of the
per-env error norm: the number the gate compares (kernel at most 2x the
float32 plain step's). Float atomics add in a varying order on the card,
in the kernel and in the plain step's ``index_add_``, so both sides vary
between repetitions.

With ``--k2`` it measures [plb-sphere-k2]'s gate instead: plb_move cut to
a 32^3 grid through K2-bwd at K = 7 and 1 on ``--kernel-envs`` envs (the
script's 256) with ``chip_smoke.plb_inputs``' own yield stress, the plain
VJPs on the first ``--envs``. ``--ref-reps`` computes the float64 VJP that
many times and prints each side's medians against each, and the float64
draws' own spread.

    python3 scripts/plb_bwd_gate_spread.py --envs 16 --reps 3   # on a machine with a GPU
    python3 scripts/plb_bwd_gate_spread.py --k2 --envs 16 --reps 3 --ref-reps 2
"""

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--envs", type=int, default=16)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--scenes", nargs="+", default=["plb_triplemove", "plb_move"])
    ap.add_argument("--ys", type=float, nargs=2, action="append",
                    help="decades (lo hi) of the yield stress factor; may repeat "
                         "(default: -4 -2 and -2 -1)")
    ap.add_argument("--k2", action="store_true", help="[plb-sphere-k2]'s gate through K2-bwd")
    ap.add_argument("--kernel-envs", type=int, default=256, help="the kernel's envs with --k2")
    ap.add_argument("--ref-reps", type=int, default=1, help="float64 VJPs")
    args = ap.parse_args()
    if args.k2:
        return k2_spread(args)
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke as cs
    from unidom_torch import make_env
    from unidom_torch.ops.cuda import mpm_big_kernel
    from unidom_torch.ops.cuda._build import build_library
    from unidom_torch.ops.cuda.mpm_big_kernel import mpm_big_step

    if not torch.cuda.is_available():
        sys.exit("this script needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    build_library(mpm_big_kernel.SOURCE)
    dev, B = torch.device("cuda"), args.envs
    for scene in args.scenes:
        for lo, hi in args.ys or [(-4, -2), (-2, -1)]:
            t0 = time.perf_counter()
            env = make_env(scene, batch_size=B, device=dev)
            s, a = cs.plb_inputs(env, dev)
            rng = np.random.default_rng(7)
            s = s.replace(yield_stress=env.init_state.yield_stress * torch.from_numpy(
                (10.0 ** rng.uniform(lo, hi, (B, 1))).astype(np.float32)).to(dev))
            sim = env.simulator
            cot = cs.mpm_vjp_cot(s)
            names = cs.mpm_vjp_names(len(sim.sdf_names))
            plain = cs.checkpointed(cs.plain_mpm_sim(sim))._step_plain
            g64 = cs.mpm_vjp(plain, cs.mpm_cast(s, torch.float64), a.double(),
                             [c.double() for c in cot])
            sides = {"f32": lambda: cs.mpm_vjp(plain, s, a, cot)}
            for K in (7, 1):
                sides[f"K{K}"] = lambda K=K: cs.mpm_vjp(
                    lambda s_, a_: mpm_big_step(sim, s_, a_, ckpt_stride=K), s, a, cot)
            draws = {k: [fn() for _ in range(args.reps)] for k, fn in sides.items()}
            print(f"== {scene} B={B} yield stress factor 1e{lo:g}..1e{hi:g}: "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            for i, n in enumerate(names):
                r = g64[i].double().reshape(B, -1)
                meds = {k: [(d[i].double().reshape(B, -1) - r).norm(dim=1).median().item()
                            for d in v] for k, v in draws.items()}
                print(f"{n:22s} |ref| med {r.norm(dim=1).median().item():.2e} " + " ".join(
                    f"{k} " + ",".join(f"{m:.2e}" for m in v) for k, v in meds.items()),
                    flush=True)
            del env, s, g64, draws
            torch.cuda.empty_cache()


def k2_spread(args):
    """[plb-sphere-k2]'s VJP gate, repeated: see the module's docstring."""
    import dataclasses

    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from unidom_torch.envs.plb_tasks import PLB_BASE_CONF, PlbSceneEnv
    from unidom_torch.ops.cuda import mpm_kernel
    from unidom_torch.ops.cuda._build import build_library
    from unidom_torch.ops.cuda.mpm_kernel import mpm_step

    if not torch.cuda.is_available():
        sys.exit("this script needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    build_library(mpm_kernel.SOURCE)
    dev, n, B = torch.device("cuda"), args.envs, args.kernel_envs
    t0 = time.perf_counter()
    conf = dataclasses.replace(PLB_BASE_CONF, n_grid=32, res=(32, 32, 32), n_primitive=1,
                               task="plb_move")
    env = PlbSceneEnv("plb_move", B, conf=conf, device=dev)
    s, a = cs.plb_inputs(env, dev)
    sim = env.simulator
    cot = cs.mpm_vjp_cot(s)
    hs, ha, hc = cs.mpm_slice_envs(s, n), a[:n], [c[:n] for c in cot]
    names = cs.mpm_vjp_names(1)
    plain = cs.checkpointed(cs.plain_mpm_sim(sim))._step_plain
    refs = [cs.mpm_vjp(plain, cs.mpm_cast(hs, torch.float64), ha.double(),
                       [c.double() for c in hc]) for _ in range(args.ref_reps)]
    sides = {"f32": lambda: cs.mpm_vjp(plain, hs, ha, hc)}
    for K in (7, 1):
        sides[f"K{K}"] = lambda K=K: [g[:n] for g in cs.mpm_vjp(
            lambda s_, a_: mpm_step(sim, s_, a_, ckpt_stride=K), s, a, cot)]
    draws = {k: [fn() for _ in range(args.reps)] for k, fn in sides.items()}
    print(f"== plb_move 32^3 through K2, kernel on {B} envs, plain on {n}: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for i, name in enumerate(names):
        r0 = refs[0][i].double().reshape(n, -1)
        spread = " ".join(f"{(r[i].double().reshape(n, -1) - r0).norm(dim=1).median().item():.2e}"
                          for r in refs[1:])
        for j, ref in enumerate(refs):
            r = ref[i].double().reshape(n, -1)
            meds = {k: [(d[i].double().reshape(n, -1) - r).norm(dim=1).median().item()
                        for d in v] for k, v in draws.items()}
            print(f"{name:20s} ref {j} |ref| med {r.norm(dim=1).median().item():.2e}"
                  + (f" (float64 draws differ by {spread})" if j == 0 and spread else "") + " "
                  + " ".join(f"{k} " + ",".join(f"{m:.2e}" for m in v) for k, v in meds.items()),
                  flush=True)


if __name__ == "__main__":
    main()
