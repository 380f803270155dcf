"""Build a CUDA source of ``unidom_torch/csrc`` into a plain-C shared library
with nvcc, and load it with ctypes.

The library goes to ``build/unidom_torch_kernels/`` at the repository root,
named by a hash of the source, of every local header it includes
(``#include "..."``, found in ``csrc``) and of its flags, so the first use
after a change to any of them rebuilds it and later uses load it. Builds
write to a temporary name and rename, so concurrent processes never load a
half-written file. Nothing is built on import: only ``build_library`` calls
nvcc.
"""

import ctypes
import hashlib
import os
import re
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "unidom_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills, in the build log
)
# Flags of one source beyond NVCC_FLAGS. K3-fwd rounds every multiply and add
# apart, as its plain PyTorch version does. With fused multiply-adds, on
# shape_elasto_plastic's sigma-clip slab (F rebuilt from its SVD each
# substep) K3-fwd's velocities landed 1.8x further from the float64 plain
# step than the float32 one's; without, 0.97x (H100, chip_smoke.py's
# [big-parity]). K2 keeps the contraction: its paths pass their gates with
# it, and without it K2-bwd took 21% longer.
SOURCE_FLAGS = {"mpm_big_step.cu": ("-fmad=false",)}


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("CUDA toolkit not found (set CUDA_HOME): cannot build CUDA kernels")
    nvcc = Path(CUDA_HOME) / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return str(nvcc)


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _sources(source: str):
    """``csrc/<source>`` and the local headers it includes, directly or
    through another header, in the order first met."""
    seen, todo = [], [source]
    while todo:
        name = todo.pop(0)
        if name in seen:
            continue
        seen.append(name)
        todo += [m.decode() for m in _LOCAL_INCLUDE.findall((CSRC / name).read_bytes())]
    return seen


def _flags(source: str):
    return NVCC_FLAGS + SOURCE_FLAGS.get(source, ())


def library_path(source: str) -> Path:
    """Where the library built from ``csrc/<source>`` lives."""
    digest = hashlib.sha256()
    for name in _sources(source):
        digest.update(name.encode() + b"\0" + (CSRC / name).read_bytes())
    digest.update(" ".join(_flags(source)).encode())
    return BUILD_DIR / f"{Path(source).stem}-{digest.hexdigest()[:16]}.so"


def build_library(source: str) -> str:
    """Build ``csrc/<source>`` unless it is built already. Returns nvcc's
    log ("" when nothing was built); raises if nvcc is missing or fails."""
    out = library_path(source)
    if out.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [_nvcc(), *_flags(source), "-I", str(CSRC), "-o", tmp, str(CSRC / source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) on {source}:\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return proc.stdout + proc.stderr


def load_library(source: str) -> ctypes.CDLL:
    """Build ``csrc/<source>`` if needed and load it."""
    build_library(source)
    return ctypes.CDLL(str(library_path(source)))
