"""Run ``chip_smoke.py``'s PlasticineLab phases alone ([plb-sphere-k2],
[plb-parity], [plb-solve], [plb-rollout]; ``chip_smoke.plb_phases``) after
building the two MPM kernel sources, one ``nvcc`` each, at once: about 5
minutes of command instead of the whole script's 17.

    python3 scripts/plb_phases_only.py        # from the repository root, on a machine with a GPU
"""

import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from unidom_torch.ops.cuda import mpm_big_kernel, mpm_kernel  # noqa: E402
from unidom_torch.ops.cuda._build import build_library  # noqa: E402


def main():
    if not torch.cuda.is_available():
        sys.exit("this script needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        list(pool.map(build_library, (mpm_kernel.SOURCE, mpm_big_kernel.SOURCE)))
    print(f"[build] {time.perf_counter() - t0:.2f} s", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"{smi}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    paths, errs = cs.plb_phases(torch.device("cuda"), smi)
    print(f"[plb] launches by path {paths}; largest |kernel - plain| {errs}; "
          f"{time.perf_counter() - t0:.2f} s", flush=True)


if __name__ == "__main__":
    main()
