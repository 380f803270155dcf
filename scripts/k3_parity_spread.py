"""The spread, between repetitions, of ``chip_smoke.py``'s K3-fwd gate on
shape_elasto_plastic ([big-parity shape_elasto_plastic]): one macro step of
16 envs through K3-fwd (the rollout: P2G in bin order, float sums) and
through the float32 plain step, repeated, each against the float64 plain
step computed once. Per repetition and field it prints both sides' RMS
error pooled over the first 4 envs (the gate's statistic before it was
held per env) and the median over the 16 envs of each env's RMS error (the
gate's statistic since), and the particles whose F is more than 1e-4 off
float64 (a return-map branch that rounding decided the other way). Float
atomics add in a varying order on the card, so the kernel's side varies
between repetitions; so may the plain step's (its scatter adds by atomics).

    python3 scripts/k3_parity_spread.py --reps 8        # on a machine with a GPU

``--root`` takes another checkout's ``chip_smoke.py`` and ``unidom_torch``
(for example the parent commit unpacked by ``git archive``), to compare two
trees in one call.
"""

import argparse
import sys
import time
from pathlib import Path


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--envs", type=int, default=16)
    ap.add_argument("--pooled-envs", type=int, default=4)
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parent.parent)
    args = ap.parse_args()
    sys.path.insert(0, str(args.root.resolve()))
    import torch

    import chip_smoke as cs
    from unidom_torch import make_env

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    env = make_env("shape_elasto_plastic", batch_size=args.envs, device=dev)
    sim = env.simulator
    state, action = cs.big_parity_inputs(env, dev)
    with torch.no_grad():
        ref = cs.mpm_fields(sim._step_plain(cs.mpm_cast(state, torch.float64), action.double()))

    def stats(out):
        row = {}
        for name, t in cs.mpm_fields(out).items():
            kk = t.double().reshape(t.shape[0], -1)
            rr = ref[name].double().reshape(kk.shape)
            n = args.pooled_envs
            pooled = (kk[:n] - rr[:n]).pow(2).mean().sqrt().item()
            per_env = (kk - rr).pow(2).mean(dim=1).sqrt().median().item()
            row[name] = (pooled, per_env)
        F = cs.mpm_fields(out)["F"].double().reshape(args.envs, sim.n_particles, 9)
        off = ((F - ref["F"].double().reshape(F.shape)).abs() > 1e-4).any(-1)
        row["flips"] = [int(c) for c in off.sum(1)]
        return row

    rows = {"kernel": [], "float32 plain": []}
    with torch.no_grad():
        for _ in range(args.reps):
            rows["kernel"].append(stats(sim.step_batch(state, action)))
            rows["float32 plain"].append(stats(sim._step_plain(state, action)))
    torch.cuda.synchronize()
    for side, reps in rows.items():
        for name in reps[0]:
            if name == "flips":
                print(f"{args.root} {side} particles with F more than 1e-4 off float64, per env "
                      "and repetition: " + " | ".join(" ".join(map(str, r[name])) for r in reps),
                      flush=True)
                continue
            print(f"{args.root} {side} {name}: pooled rms over {args.pooled_envs} envs "
                  + " ".join(f"{r[name][0]:.3e}" for r in reps)
                  + f"; median over {args.envs} envs of each env's rms "
                  + " ".join(f"{r[name][1]:.3e}" for r in reps), flush=True)
    print(f"{args.root} {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
