"""The spread, between repetitions, of ``chip_smoke.py``'s K2-bwd gate on
whip_rope ([mpm-bwd-parity]): the VJP of one whip_rope macro step at 1024
envs through K2-bwd (K = 1 and 9) and through the float32 plain step on the
first 32 envs, repeated, each against the float64 plain VJP computed once.
For x, v, F, mu and lamda it prints one line per side with each
repetition's median over the envs of the per-env error norm, the number
the gate compares (kernel at most 2x the float32 plain step's). Float
atomics add in a varying order on the card, so both sides vary between
repetitions and between processes.

    python3 scripts/k2_bwd_gate_spread.py --reps 8          # on a machine with a GPU

``--root`` takes another checkout's ``chip_smoke.py`` and ``unidom_torch``
(for example the parent commit unpacked by ``git archive``), to compare two
trees in one call: run parent, change, change, parent. ``--after-mpm-phases``
first runs ``chip_smoke.py``'s MPM phases 11-15, which precede the gate in a
whole run. ``--poison-reps N`` adds N repetitions in which every
``torch.empty`` of the K2 wrapper starts as NaN (ints 0x7f7f7f7f), and
``--poison-cache`` fills the memory the caching allocator holds free with
bytes 0xff (float NaN) before every repetition: a kernel that reads memory
it did not write then gives NaN or far-off cotangents.
"""

import argparse
import sys
import time
from pathlib import Path


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parent.parent)
    ap.add_argument("--after-mpm-phases", action="store_true")
    ap.add_argument("--poison-reps", type=int, default=0)
    ap.add_argument("--poison-cache", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(args.root.resolve()))
    import torch

    import chip_smoke as cs
    from unidom_torch import make_env
    from unidom_torch.ops.cuda import mpm_kernel as mk
    from unidom_torch.ops.cuda.mpm_kernel import mpm_step

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    if args.after_mpm_phases:
        cs.mpm_phases(dev)
        torch.cuda.empty_cache()
    env = make_env("whip_rope", batch_size=cs.B_MAIN, device=dev)
    sim = env.simulator
    state = cs.whip_rope_parity_state(env, dev)
    action = torch.tensor(cs.MPM_ACTION, device=dev).expand(cs.B_MAIN, 6).contiguous()
    with torch.no_grad():
        cot = cs.mpm_vjp_cot(mpm_step(sim, state, action))
    B = cs.B_MPM_GRAD
    head = [c[:B] for c in cot]
    hs = cs.mpm_slice_envs(state, B)
    psim = cs.plain_mpm_sim(sim)
    g64 = cs.mpm_vjp(psim._step_plain, cs.mpm_cast(hs, torch.float64), action[:B].double(),
                     [c.double() for c in head])

    def medians(grads):
        out = {}
        for name, k, r in zip(cs.MPM_VJP_INPUTS, grads, g64):
            if name in ("x", "v", "F", "mu", "lamda"):
                kk, rr = k[:B].double().reshape(B, -1), r.double().reshape(B, -1)
                out[name] = (kk - rr).norm(dim=1).median().item()
        return out

    class Poisoned:  # torch, but for empty and empty_like
        def __getattr__(self, name):
            return getattr(torch, name)

        @staticmethod
        def _fill(t):
            return t.fill_(float("nan") if t.is_floating_point() else 0x7F7F7F7F)

        def empty(self, *a, **k):
            return self._fill(torch.empty(*a, **k))

        def empty_like(self, *a, **k):
            return self._fill(torch.empty_like(*a, **k))

    def poison_cache():
        torch.cuda.synchronize()
        free = torch.cuda.mem_get_info()[0]
        big = torch.empty(int(free * 0.8), dtype=torch.uint8, device=dev).fill_(0xFF)
        small = [torch.empty(2**19, dtype=torch.uint8, device=dev).fill_(0xFF)
                 for _ in range(2000)]  # the allocator's pool of blocks below 1 MB
        torch.cuda.synchronize()
        del big, small

    def vjp(K):
        if args.poison_cache:
            poison_cache()
        g = cs.mpm_vjp(lambda s, a: mpm_step(sim, s, a, ckpt_stride=K), state, action, cot)
        if not all(torch.isfinite(t).all() for t in g):
            print(f"{args.root} K={K}: a cotangent is not finite", flush=True)
        return medians(g)

    rows = {"kernel K=1": [], "kernel K=9": [], "float32 plain": [],
            "kernel K=1 poisoned": [], "kernel K=9 poisoned": []}
    for _ in range(args.reps):
        for K in (1, 9):
            rows[f"kernel K={K}"].append(vjp(K))
        rows["float32 plain"].append(medians(cs.mpm_vjp(psim._step_plain, hs, action[:B], head)))
    mk.torch = Poisoned()
    for _ in range(args.poison_reps):
        for K in (1, 9):
            rows[f"kernel K={K} poisoned"].append(vjp(K))
    mk.torch = torch
    for side, reps in rows.items():
        for name in reps[0] if reps else ():
            print(f"{args.root} {side} {name}: " + " ".join(f"{r[name]:.3e}" for r in reps),
                  flush=True)
    print(f"{args.root} {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
