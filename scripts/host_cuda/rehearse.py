"""Rehearse the MPM kernels of ``unidom_torch/csrc`` on the CPU, without a GPU.

Builds ``mpm_step.cu`` (K2) and ``mpm_big_step.cu`` (K3) for the host with g++
under the stand-in CUDA runtime beside this file (every CUDA thread a
``std::thread``, clusters, warp shuffles and distributed shared memory
emulated), optionally with every ``float`` a ``double``, loads them through
copies of the wrappers (``ops/cuda/mpm_kernel.py`` and ``mpm_big_kernel.py``)
and holds the kernels against the plain step in the same precision: the
VJPs of one macro step against its autograd, on every input cotangent (``k2``,
with K2-seg launched alone against the plain forward's carries; ``k3`` at
K = 1, 2 and 3, with K3-seg's recorded grids against the gradient's P2G of
the same carries), and the forward alone, no gradient, on every output (``k2fwd``:
K2-fwd at clusters of 1, 2, 4 and 8; ``k3fwd``: K3-fwd's rollout, P2G in
bin order with float sums, twice on the scratch it keeps, which must be 0
again after each call). In float64 the kernels must
agree with the plain step to rounding (~1e-12 relative), which the card's
float32 gates cannot show.

    python scripts/host_cuda/rehearse.py --f64 --out /tmp/rehearse k2 k3 k2fwd k3fwd
    python scripts/host_cuda/rehearse.py --f64 --out /tmp/rehearse capsule cylinder torus \
        rolling_pin chopsticks

(the second: each SDF of ``TOOLS`` under K2-bwd, K2-fwd, K3-bwd with K3-seg's
record, and K3-fwd's rollout, on a von-Mises bar it reaches into).

Run it under ``timeout``: a barrier or shuffle that not every thread reaches
hangs the host build. It runs small configurations (a few substeps, one or
two envs); shape_elasto_plastic's 23,940 particles take minutes per macro
step here.
"""

import argparse
import ctypes
import dataclasses
import re
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
HERE = Path(__file__).resolve().parent
CSRC = ROOT / "unidom_torch" / "csrc"
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (its MPM helpers: configs, VJPs, cotangents)

F64_PRELUDE = """#define float double
#define sqrtf sqrt
#define fabsf fabs
#define expf exp
#define logf log
#define sinf sin
#define cosf cos
#define floorf floor
#define fminf fmin
#define fmaxf fmax
"""


def _rewrite(text, name, f64):
    """The source as the host stub takes it: __shared__ declarations as slots
    of the block's arena, kernel launches as calls, and in float64 the float
    literals without their suffix."""
    count = [0]

    def shared(m):
        count[0] += 1
        dims = m.group(3) or ""
        return (f"auto& {m.group(2)} = host_cuda::shared_slot<{m.group(1)}{dims}>("
                f"(const void*)\"{name}:{count[0]}\");")

    text = re.sub(r"extern __shared__ (\w+) (\w+)\[\];",
                  r"\1* \2 = host_cuda::dynamic_smem<\1>();", text)
    text = re.sub(r"__shared__ ([\w:]+) (\w+)(\[[^\]]+\])?;", shared, text)
    text = re.sub(r"(\w+(?:<\w+>)?)<<<(.*?)>>>\(", r"host_launch(\1, \2, ", text)
    if f64:
        text = re.sub(r"(?<![\w.])(\d[\d.]*(?:[eE][-+]?\d+)?)f\b", r"\1", text)
    return text


def build(source, out_dir, f64, smem_fill=0xCD):
    """Build csrc/<source> for the host, every byte of a block's shared
    memory ``smem_fill`` at launch; returns the library's path."""
    out_dir.mkdir(parents=True, exist_ok=True)
    for name in (source, "mpm_device.cuh"):
        text = _rewrite((CSRC / name).read_text(), name, f64)
        if name == source:
            text = ('#include "cuda_runtime.h"\n#include <cooperative_groups.h>\n'
                    + (F64_PRELUDE if f64 else "") + text)
        (out_dir / (name.replace(".cu", ".cpp") if name.endswith(".cu") else name)).write_text(text)
    lib = out_dir / f"{Path(source).stem}{'_f64' if f64 else ''}.so"
    cmd = ["g++", "-O2", "-std=c++20", "-pthread", "-shared", "-fPIC", "-w",
           f"-DHOST_CUDA_REAL={'double' if f64 else 'float'}", f"-DHOST_CUDA_SMEM_FILL={smem_fill}",
           "-I", str(out_dir), "-I", str(HERE),
           "-o", str(lib), str(out_dir / source.replace(".cu", ".cpp"))]
    subprocess.run(cmd, check=True)
    return lib


# what the poisoned wrappers' torch.empty tensors hold: floats POISON[0]
# (NaN shows in any arithmetic; a large finite value passes a comparison
# such as mass > 0 that NaN fails), ints a value far outside any index
POISON = [float("nan")]


def _poisoned(t):
    """``t`` filled with what an unset read would show."""
    return t.fill_(POISON[0] if t.is_floating_point() else 0x7F7F7F7F)


def wrappers(libs, f64, poison=False):
    """Copies of mpm_kernel.py and mpm_big_kernel.py that load the host
    libraries, take CPU tensors and, in float64, float64 tensors and C
    doubles; with ``poison``, whose ``torch.empty`` scratch and outputs
    start poisoned (``_poisoned``), as the card's reused memory may hold
    anything. Returns (mk, mbk)."""
    mods = {}
    for name, source in (("mpm_kernel", "mpm_step.cu"), ("mpm_big_kernel", "mpm_big_step.cu")):
        text = (ROOT / "unidom_torch" / "ops" / "cuda" / f"{name}.py").read_text()
        if poison:
            text = text.replace("torch.empty_like(", "_empty_like(").replace(
                "torch.empty(", "_empty(")
        if f64:
            # doubles take twice a float's shared memory, which the host has
            text = text.replace("torch.float32", "torch.float64").replace(
                "ctypes.c_float", "ctypes.c_double").replace("4 * floats", "8 * floats").replace(
                "SMEM_PER_BLOCK = 232_448", "SMEM_PER_BLOCK = 2 * 232_448")
        mod = types.ModuleType(f"unidom_torch.ops.cuda.{name}")
        mod.__file__ = str(ROOT / "unidom_torch" / "ops" / "cuda" / f"{name}.py")
        sys.modules[mod.__name__] = mod
        mod._empty = lambda *a, **k: _poisoned(torch.empty(*a, **k))
        mod._empty_like = lambda *a, **k: _poisoned(torch.empty_like(*a, **k))
        exec(compile(text, mod.__file__, "exec"), mod.__dict__)
        mod.load_library = lambda _src, path=libs[source]: ctypes.CDLL(str(path))
        mod._lib.cache_clear()
        mod._device_and_stream = lambda dev: (0, None)
        mods[name] = mod
    mods["mpm_big_kernel"]._device_and_stream = lambda dev: (0, None)
    return mods["mpm_kernel"], mods["mpm_big_kernel"]


def _as(sim, dtype):
    """Shallow copy of ``sim`` whose per-particle hardness is ``dtype``."""
    import copy

    out = copy.copy(sim)
    out._h = sim._h.to(dtype)
    return out


def compare(what, kernel, plain, names, of="input cotangent"):
    """Relative error norm of each input cotangent (or of what ``of``
    names); returns the largest."""
    worst = 0.0
    parts = []
    for n, k, p in zip(names, kernel, plain):
        ref = p.double().norm().item()
        err = (k.double() - p.double()).norm().item()
        rel = err / ref if ref > 0 else err
        worst = max(worst, rel)
        parts.append(f"{n} {rel:.1e}")
    print(f"[{what}] kernel vs the plain step, relative error per {of}: " + ", ".join(parts),
          flush=True)
    return worst


def _cut(sim, s, steps):
    """``sim`` and ``s`` cut to a macro step of ``steps`` substeps."""
    sim.conf = dataclasses.replace(sim.conf, steps=steps)
    for p in s.primitives:  # the per-substep v and w of the cut macro step
        p.v, p.w = p.v[:, :steps].contiguous(), p.w[:, :steps].contiguous()
        p.position = p.position[:, :steps + 1].contiguous()
        p.rotation = p.rotation[:, :steps + 1].contiguous()


def compare_fwd(what, kernel, plain):
    """Relative error norm of each output of a macro step; returns the
    largest."""
    names = ("x", "v", "C", "F", "J")
    pairs = [(n, getattr(kernel, n), getattr(plain, n)) for n in names]
    for i, (pk, pp) in enumerate(zip(kernel.primitives, plain.primitives)):
        pairs += [(f"position{i}", pk.position, pp.position),
                  (f"rotation{i}", pk.rotation, pp.rotation)]
    return compare(what, [k for _, k, _ in pairs], [p for _, _, p in pairs],
                   [n for n, _, _ in pairs], "outputs")


K2_CASES = [("shape_rope", False), ("bowl_water", False), ("plastic", True),
            ("von_mises", True), ("whip_rope", True), ("sphere", False), ("spheres3", False)]


def rehearse_k2(mk, dtype, steps, clusters, cases=K2_CASES):
    """K2-bwd (under autograd of K2-fwd) on ``cases`` (name, position
    control), two envs each, all cut to ``steps`` substeps, at K = 1 and
    K = 2: by default shape_rope at each cluster size, a bowl, position
    control, whip_rope and von Mises under one and three spheres; a name of
    TOOLS is that tool over the von-Mises bar."""
    from unidom_torch import make_env

    worst = 0.0
    for name, pc in cases:
        if name == "whip_rope":
            env = make_env("whip_rope", batch_size=2, device="cpu")
            sim, s = env.simulator, cs.whip_rope_parity_state(env, torch.device("cpu"))
            a = torch.tensor(cs.MPM_ACTION, dtype=torch.float32).expand(2, 6).contiguous()
        elif name in ("sphere", "spheres3"):
            sim, s, a = tool_config_sim([("sphere", (0.03, 0.0, 0.0), c) for c in
                                         SPHERE_CENTRES[1 if name == "sphere" else 3]], 2)
        elif name in TOOLS:
            sim, s, a = tool_config_sim([(name, *TOOLS[name])], 2)
        else:
            sim, s, a = cs.mpm_config_sim(name, 2, torch.device("cpu"), position_control=pc)
        _cut(sim, s, steps)
        s, a = cs.mpm_cast(s, dtype), a.to(dtype)
        ksim = _as(sim, dtype)
        cot = [c.to(dtype) for c in cs.mpm_vjp_cot(s)]
        names = cs.mpm_vjp_names(len(sim.sdf_names))
        plain = cs.mpm_vjp(sim._step_plain, s, a, cot)
        for cl in (clusters if name == "shape_rope" else (None,)):
            launch_config = mk.launch_config
            mk.launch_config = (lambda *args, cl=cl, **kw:
                                launch_config(*args[:5], cluster=cl))
            for K in (1, 2):
                t0 = time.perf_counter()
                k = cs.mpm_vjp(lambda s_, a_: mk.kernel_step(ksim, ksim.prepare(s_, a_), K),
                               s, a, cot)
                worst = max(worst, compare(
                    f"K2 {name} cluster {cl or 'rule'} K={K}, {time.perf_counter() - t0:.1f} s",
                    k, plain, names))
            if name == "shape_rope":  # K2-seg alone, launched as K2-bwd runs it
                worst = max(worst, rehearse_k2seg(mk, ksim, s, a, cl))
            mk.launch_config = launch_config
    return worst


def rehearse_k2seg(mk, sim, s, a, cluster):
    """K2-seg alone at K = 2 (launch_config as patched: ``cluster`` CTAs),
    every segment's carries against the plain forward's."""
    steps = sim.conf.steps
    with torch.no_grad():
        prepared = sim.prepare(s, a)
        carries, st = [], prepared
        for f in range(steps):
            carries.append(mk.pack_carry(st))
            st = sim._substep(f, st)
        _, hist = mk.launch(sim, prepared, 2)
        worst = 0.0
        for sg in range(-(-steps // 2)):
            seg = mk.mpm_step_seg(sim, prepared, hist, 2, sg)
            for j in range(seg.shape[1]):
                ref = carries[2 * sg + j]
                worst = max(worst, ((seg[:, j] - ref).norm() / ref.norm()).item())
    print(f"[K2-seg alone shape_rope cluster {cluster or 'rule'} K=2] every segment's carries "
          f"against the plain forward's: relative error {worst:.1e}", flush=True)
    return worst


# The plb scenes' SDF on a small grid: a von-Mises bar with one sphere at
# its side, or three (as plb_triplemove: two at its sides, one on top),
# each reaching 0.01 into it.
SPHERE_CENTRES = {1: [(0.25, 0.08, 0.2)],
                  3: [(0.17, 0.08, 0.2), (0.25, 0.13, 0.25), (0.33, 0.08, 0.3)]}


# The other SDFs' tools, each reaching into the same bar (its top at y =
# 0.11, x from 0.15 to 0.35, z from 0.22 to 0.28), centred on grid node 8
# (x = z = 0.25) with the sizes on the lattice of 1/32 where a kink sits:
# the capsule's and the rolling pin's clip at |p_axis| = size[1], the
# cylinder's rim, the axis of the cylinder and the torus, the chopsticks'
# midplane between two capsules that straddle the bar.
TOOLS = {
    "capsule": ((0.03, 1 / 32, 0.0), (0.25, 0.125, 0.25)),
    "cylinder": ((1 / 32, 1 / 32, 0.0), (0.25, 0.125, 0.25)),
    "torus": ((0.04, 0.015, 0.0), (0.25, 0.125, 0.25)),
    "rolling_pin": ((0.02, 3 / 32, 0.0), (0.25, 0.125, 0.25)),
    "chopsticks": ((0.015, 1 / 32, 1 / 16), (0.25, 0.09375, 0.25)),
}


def tool_scene(sim, make_primitive, tools, steps=8):
    """A von-Mises bar and the tools ``tools`` ((sdf name, size, centre)
    each) on a grid of at least 16^3 cells of 1/32; returns the state
    before the simulator's reset."""
    from unidom_torch.engine.mpm import VON_MISES

    state = sim.add_box(None, size=[0.2, 0.06, 0.06], init_pos=[0.25, 0.08, 0.25],
                        material=VON_MISES, density=1.5)
    for name, size, centre in tools:
        state.primitives.append(make_primitive(steps, friction=0.9, softness=666.0,
                                               color=[0.7] * 3, size=list(size),
                                               init_pos=list(centre)))
        sim.register_primitive_sdf(name)
    return state


def sphere_scene(sim, make_primitive, n_spheres=1, steps=8):
    """``tool_scene`` with ``n_spheres`` spheres of radius 0.03
    (SPHERE_CENTRES)."""
    return tool_scene(sim, make_primitive, [("sphere", (0.03, 0.0, 0.0), c)
                                            for c in SPHERE_CENTRES[n_spheres]], steps)


def tool_config_sim(tools, B):
    """(simulator, perturbed state, action) of ``tool_scene`` with ``tools``
    on tests/test_pallas_mpm.py's small grid (8 substeps), v and C perturbed
    as in ``chip_smoke.mpm_config_sim``, at a yield stress that the von-Mises
    return map reaches in one macro step; every tool moves and turns."""
    from unidom_torch.engine.mpm import MPMConf, MPMSimulator
    from unidom_torch.engine.primitives import create_primitive

    rng = np.random.default_rng(1)
    conf = MPMConf(n_grid=32, dt=2e-4, steps=8, E=100.0, nu=0.1, res=(16, 16, 16),
                   ground_friction=0.5, task="test")
    sim = MPMSimulator(conf, B, use_position_control=False, device="cpu")
    s = sim.reset(tool_scene(sim, lambda *a, **k: create_primitive(*a, **k, device="cpu"),
                             tools))
    a = np.tile(np.asarray([0.4, -0.2, 0.3, 0.05, 0.05, 0.05], np.float32), (B, len(tools)))
    s = s.replace(v=torch.from_numpy(0.2 * rng.standard_normal(s.v.shape, dtype=np.float32)),
                  C=torch.from_numpy(0.5 * rng.standard_normal(s.C.shape, dtype=np.float32)),
                  yield_stress=torch.full_like(s.yield_stress, 0.005))
    return sim, s, torch.from_numpy(a)


def tool_big_configs(names):
    """``big_configs``' entries for the tools ``names`` of TOOLS, each alone
    over the von-Mises bar."""
    kwargs = dict(n_grid=32, dt=2e-4, steps=4, E=100.0, nu=0.1, res=(16, 16, 16),
                  ground_friction=0.5, yield_stress=0.005)
    return {f"{n}_von_mises": (kwargs, lambda sim, mk, n=n: tool_scene(
        sim, mk, [(n, *TOOLS[n])], kwargs["steps"]), False) for n in names}


def big_configs():
    """tests/test_torch_mpm_big.py's configs and the plb scenes' SDF: a
    von-Mises bar under one sphere and under three (``sphere_scene``), at a
    yield stress its return map reaches."""
    sys.path.insert(0, str(ROOT / "tests"))
    from test_torch_mpm_big import CONFIGS

    kwargs = dict(n_grid=32, dt=2e-4, steps=4, E=100.0, nu=0.1, res=(16, 16, 16),
                  ground_friction=0.5, yield_stress=0.005)
    return {**CONFIGS, **{
        name: (kwargs, lambda sim, mk, n=n: sphere_scene(sim, mk, n, kwargs["steps"]), False)
        for name, n in (("sphere_von_mises", 1), ("spheres3_von_mises", 3))}}


def rehearse_k3(mbk, dtype, configs=None):
    """K3-bwd (under autograd of K3-fwd with checkpoints) on
    ``big_configs`` (4 substeps) at K = 1, 2 and 3
    (3: a segment of 3 and a short last one of 1); and, for each segment at
    K = 2 and 3, K3-seg's carries against the exact history's and its
    recorded grids (each touched cell's momentum and mass before the grid
    ops) against the gradient's P2G of the same carry (``p2g_sums``)."""
    from unidom_torch.engine.mpm import MPMConf, MPMSimulator
    from unidom_torch.engine.primitives import create_primitive

    worst = 0.0
    rng = np.random.default_rng(6)
    for name, (kwargs, scene, pc) in (configs or big_configs()).items():
        steps = kwargs["steps"]
        sim = MPMSimulator(MPMConf(**kwargs, task="t"), 1,
                           use_position_control=pc, device="cpu")
        s = sim.reset(scene(sim, lambda *a, **k: create_primitive(*a, **k, device="cpu")))
        s = s.replace(v=torch.from_numpy(0.2 * rng.standard_normal(s.v.shape)).float(),
                      C=torch.from_numpy(0.5 * rng.standard_normal(s.C.shape)).float())
        n_prim = len(s.primitives)
        a = np.zeros((1, 6 * n_prim), np.float32)
        a[:, :6] = [0.3, 0.0, 0.1, 0.0, 0.0, 0.05]
        s, a = cs.mpm_cast(s, dtype), torch.from_numpy(a).to(dtype)
        ksim = _as(sim, dtype)
        cot = [c.to(dtype) for c in cs.mpm_vjp_cot(s)]
        names = cs.mpm_vjp_names(n_prim)
        plain = cs.mpm_vjp(sim._step_plain, s, a, cot)
        for K in (1, 2, 3):
            t0 = time.perf_counter()
            k = cs.mpm_vjp(lambda s_, a_: mbk.kernel_step_big(ksim, ksim.prepare(s_, a_), K),
                           s, a, cot)
            worst = max(worst, compare(f"K3 {name} P={sim.n_particles} K={K}, "
                                       f"{time.perf_counter() - t0:.1f} s", k, plain, names))
        with torch.no_grad():
            prepared = ksim.prepare(s, a)
            _, exact = mbk.launch_big(ksim, prepared, 1)
            sums = [mbk.p2g_sums(ksim, prepared, exact, 1, t) for t in range(steps)]
            for K in (2, 3):
                _, hist = mbk.launch_big(ksim, prepared, K)
                carry_err = grid_err = 0.0
                same_cells = True
                for sg in range(-(-steps // K)):
                    seg, rec = mbk.mpm_big_step_seg(ksim, prepared, hist, K, sg, with_record=True)
                    L = seg.shape[1]
                    grids, marks = mbk.recorded_grids(ksim, rec, L)
                    for j in range(L):
                        t = sg * K + j
                        carry_err = max(carry_err, (seg[:, j] - exact[:, t]).abs().max().item())
                        gacc, mark = sums[t]
                        on = mark.bool()
                        same_cells &= bool(torch.equal(marks[j], on))
                        grid_err = max(grid_err, (grids[j][on].double() - gacc[on]).abs().max()
                                       .item() / gacc[on].abs().max().item())
                print(f"[K3-seg {name} K={K}] every segment's carries against the exact "
                      f"history's: max abs difference {carry_err:.3e}; the recorded grids "
                      f"against the gradient's P2G of the same carries: max abs difference "
                      f"{grid_err:.3e} of the largest value; the same touched cells: "
                      f"{same_cells}", flush=True)
                worst = max(worst, grid_err)
                if not same_cells:
                    raise SystemExit(f"K3-seg recorded other touched cells than P2G marks on {name}")
    return worst


def rehearse_k2fwd(mk, dtype, steps, clusters, tools=()):
    """K2-fwd, no gradient, on shape_rope cut to ``steps`` substeps at each
    cluster size (two envs), and on whip_rope (its 67 particles under
    position control, one env, 96 threads); or on each tool of ``tools``
    (names of TOOLS) over the von-Mises bar (two envs)."""
    from unidom_torch import make_env

    worst = 0.0
    if tools:
        configs = [(n, *tool_config_sim([(n, *TOOLS[n])], 2), (None,)) for n in tools]
    else:
        sim, s, a = cs.mpm_config_sim("shape_rope", 2, torch.device("cpu"))
        env = make_env("whip_rope", batch_size=1, device="cpu")
        ws = cs.whip_rope_parity_state(env, torch.device("cpu"))
        wa = torch.tensor([cs.MPM_ACTION], dtype=torch.float32)
        configs = [("shape_rope", sim, s, a, clusters),
                   ("whip_rope", env.simulator, ws, wa, (None,))]
    for name, sim_, s_, a_, cls in configs:
        _cut(sim_, s_, steps)
        s_, a_ = cs.mpm_cast(s_, dtype), a_.to(dtype)
        ksim = _as(sim_, dtype)
        with torch.no_grad():
            plain = sim_._step_plain(s_, a_)
            for cl in cls:
                cfg = mk.fwd_launch_config(s_.x.shape[0], sim_.n_particles,
                                           int(np.prod(sim_.conf.res)), steps,
                                           len(s_.primitives), cl)
                t0 = time.perf_counter()
                fields, frame, vw = mk._inputs(ksim, ksim.prepare(s_, a_))
                k = mk._rebuild(s_, mk._forward(ksim, fields, frame, vw, cluster=cl))
                worst = max(worst, compare_fwd(
                    f"K2-fwd {name} P={sim_.n_particles} cluster of {cfg.cluster}, "
                    f"{cfg.threads} threads, {cfg.per_cta} particles per CTA, "
                    f"{time.perf_counter() - t0:.1f} s", k, plain))
    return worst


def rehearse_k3fwd(mbk, dtype, configs=None):
    """K3-fwd's rollout, no gradient, on ``big_configs`` (a mixture of
    water, tofu and vegetables in two bowls, as pour_soup; a sigma-clip
    slab; position control; von Mises under one and three spheres), twice: the second call
    on the zeroed scratch the first kept, which must be 0 after each."""
    from unidom_torch.engine.mpm import MPMConf, MPMSimulator
    from unidom_torch.engine.primitives import create_primitive

    worst = 0.0
    rng = np.random.default_rng(6)
    for name, (kwargs, scene, pc) in (configs or big_configs()).items():
        sim = MPMSimulator(MPMConf(**kwargs, task="t"), 2, use_position_control=pc,
                           device="cpu")
        s = sim.reset(scene(sim, lambda *a, **k: create_primitive(*a, **k, device="cpu")))
        s = s.replace(v=torch.from_numpy(0.2 * rng.standard_normal(s.v.shape)).float(),
                      C=torch.from_numpy(0.5 * rng.standard_normal(s.C.shape)).float())
        n_prim = len(s.primitives)
        a = np.zeros((2, 6 * n_prim), np.float32)
        a[:, :6] = [[0.3, 0.0, 0.1, 0.0, 0.0, 0.05], [0.2, 0.0, -0.1, 0.05, 0.0, 0.0]]
        s, a = cs.mpm_cast(s, dtype), torch.from_numpy(a).to(dtype)
        ksim = _as(sim, dtype)
        with torch.no_grad():
            plain = sim._step_plain(s, a)
            for call in (1, 2):
                t0 = time.perf_counter()
                fields, frame, vw = mbk._big_inputs(ksim, ksim.prepare(s, a))
                k = mbk._rebuild(s, mbk._forward(ksim, fields, frame, vw))
                nonzero = [int(t.count_nonzero()) for t in
                           mbk.zeroed_parts(ksim, mbk._ROLLOUT_SCRATCH[ksim][1])]
                worst = max(worst, compare_fwd(
                    f"K3-fwd rollout {name} P={sim.n_particles}, call {call}, kept scratch "
                    f"entries not 0 after it {nonzero}, {time.perf_counter() - t0:.1f} s",
                    k, plain))
                if any(nonzero):
                    raise SystemExit(f"K3-fwd's rollout left its kept scratch not 0 on {name}")
    return worst


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", nargs="+", choices=("k2", "k3", "k2fwd", "k3fwd") + tuple(TOOLS),
                    help="kernels on their configs, or an SDF of TOOLS: K2-bwd, K2-fwd, "
                         "K3-bwd (K3-seg's record too) and K3-fwd's rollout under it")
    ap.add_argument("--f64", action="store_true", help="every float a double")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "host_cuda")
    ap.add_argument("--poison", type=float, nargs="?", const=float("nan"), default=None,
                    help="the wrappers' torch.empty floats start as this value (NaN if none is "
                         "given), their ints as 0x7f7f7f7f")
    ap.add_argument("--smem-fill", type=lambda s: int(s, 0), default=0xCD,
                    help="every byte of a block's shared memory at launch (0x7f: a large "
                         "positive float)")
    ap.add_argument("--steps", type=int, default=4, help="substeps of K2's cut macro step")
    ap.add_argument("--clusters", type=int, nargs="+", default=[1, 2, 8],
                    help="K2-bwd's cluster sizes on shape_rope")
    ap.add_argument("--fwd-clusters", type=int, nargs="+", default=[1, 2, 4, 8],
                    help="K2-fwd's cluster sizes on shape_rope")
    args = ap.parse_args()
    torch.set_num_threads(4)
    libs = {src: build(src, args.out, args.f64, args.smem_fill)
            for src in ("mpm_step.cu", "mpm_big_step.cu")}
    if args.poison is not None:
        POISON[0] = args.poison
    mk, mbk = wrappers(libs, args.f64, args.poison is not None)
    dtype = torch.float64 if args.f64 else torch.float32
    worst = 0.0
    if "k2" in args.what:
        worst = max(worst, rehearse_k2(mk, dtype, args.steps, args.clusters))
    if "k3" in args.what:
        worst = max(worst, rehearse_k3(mbk, dtype))
    if "k2fwd" in args.what:
        worst = max(worst, rehearse_k2fwd(mk, dtype, args.steps, args.fwd_clusters))
    if "k3fwd" in args.what:
        worst = max(worst, rehearse_k3fwd(mbk, dtype))
    tools = [n for n in args.what if n in TOOLS]
    if tools:
        configs = tool_big_configs(tools)
        worst = max(worst, rehearse_k2(mk, dtype, args.steps, args.clusters,
                                       [(n, False) for n in tools]),
                    rehearse_k2fwd(mk, dtype, args.steps, args.fwd_clusters, tools),
                    rehearse_k3(mbk, dtype, configs), rehearse_k3fwd(mbk, dtype, configs))
    print(f"largest relative error: {worst:.3e}")


if __name__ == "__main__":
    main()
