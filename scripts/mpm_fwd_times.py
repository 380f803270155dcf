"""Time the MPM forward kernels at their main widths from one checkout:
K3-fwd's rollout (P2G in bin order, float sums) on pour_soup at 32 envs and
K2-fwd on whip_rope at 1024 envs, each from ``chip_smoke.py``'s parity
inputs, ``--reps`` rounds of CUDA-event means over 10 launches. Prints one
JSON line with each kernel's per-round ms and their median.

    python3 scripts/mpm_fwd_times.py                      # this checkout
    python3 scripts/mpm_fwd_times.py --root build/parent  # another one

To compare two trees on one card, run both in one call, alternating
(parent, change, change, parent): each run builds its own kernels.
"""

import argparse
import json
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parent.parent)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke as cs
    from unidom_torch import make_env
    from unidom_torch.ops.cuda import mpm_big_kernel as mbk
    from unidom_torch.ops.cuda import mpm_kernel as mk
    from unidom_torch.ops.cuda._build import build_library

    if not torch.cuda.is_available():
        sys.exit("this script needs a CUDA GPU")
    with ThreadPoolExecutor(2) as pool:
        list(pool.map(build_library, (mk.SOURCE, mbk.SOURCE)))
    dev = torch.device("cuda")
    times = {}
    with torch.no_grad():
        env = make_env("pour_soup", batch_size=cs.B_SOUP, device=dev)
        sim = env.simulator
        ws, wa = cs.big_parity_inputs(env, dev)
        fields, frame, vw = mbk._big_inputs(sim, sim.prepare(ws, wa))
        times["K3-fwd pour_soup 32"] = [
            cs.cuda_ms(lambda: mbk._forward(sim, fields, frame, vw), reps=10)
            for _ in range(args.reps)]
        del env, sim, ws, wa, fields, frame, vw
        env = make_env("whip_rope", batch_size=cs.B_MAIN, device=dev)
        sim = env.simulator
        s = cs.whip_rope_parity_state(env, dev)
        a = torch.tensor(cs.MPM_ACTION, device=dev).expand(cs.B_MAIN, 6).contiguous()
        fields, frame, vw = mk._inputs(sim, sim.prepare(s, a))
        times["K2-fwd whip_rope 1024"] = [
            cs.cuda_ms(lambda: mk._forward(sim, fields, frame, vw), reps=10)
            for _ in range(args.reps)]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"root": str(root), "card": smi,
                      "median_ms": {k: statistics.median(v) for k, v in times.items()},
                      "ms": times}), flush=True)


if __name__ == "__main__":
    main()
