"""MPM macro step on the GPU: wrapper of the CUDA kernels of
``unidom_torch/csrc/mpm_step.cu``.

Replaces ``build_mpm_step_kernel`` of ``unidom_tpu/ops/pallas/mpm_kernel.py``:
K2-fwd (``fwd_call`` -> ``fwd_kernel``, one macro step of ``conf.steps``
substeps, writing the carry every K substeps when a gradient is wanted),
K2-seg (``seg_hist_call``, a segment's carries recomputed from its
checkpoint) and K2-bwd (``bwd_step_call`` with the reverse scan
``_core_bwd``, the macro step's adjoint; one launch walks every substep, with
K2-seg as a phase of each segment when K > 1).

``mpm_step`` runs the plain PyTorch macro step (``MPMSimulator._step_plain``,
differentiated by autograd) for CPU tensors. For CUDA tensors it runs the
macro step's head (``MPMSimulator.prepare``: scrub, action clamp and clip,
``set_action``, in torch) and the kernels, or raises: under ``no_grad`` (or
when nothing requires a gradient) K2-fwd without history; otherwise
``_MPMStepFn``, whose backward launches K2-bwd, under position control or
SDF collision. ``mpm_step.launches``,
``mpm_step.bwd_launches`` and ``mpm_step.seg_launches`` count launches of
K2-fwd and K2-bwd and the K2-seg phases that K2-bwd ran (plus launches of
``mpm_step_seg``).

``fwd_launch_config`` and ``launch_config`` size K2-fwd's and K2-bwd's
launches: a thread-block cluster per env, its size from the batch and the
card's SMs, the threads and shared memory of each CTA and the stride K. They
raise, naming the sizes, for a configuration whose CTA would exceed the
card's shared memory, before anything is built or launched.

The particle state crosses in the simulator's layout ((B, P, 3),
(B, P, 3, 3), (B, P)); the primitives are packed into two small tensors; the
history is (B, ceil(steps / K), 25, P), component-major as the kernels'
shared memory.
"""

import ctypes
import functools
import math
from dataclasses import dataclass

import torch

from unidom_torch.ops.cuda._build import load_library
from unidom_torch.ops.gradops import tree_flatten

SOURCE = "mpm_step.cu"

# What the kernels' design holds (see the source's header): particles whose
# state lives in one block's shared memory, SDFs it evaluates, primitives.
MAX_PARTICLES = 1024
MAX_CELLS = 196608  # the fused TPU kernel's own ceiling (cells x 32 bytes <= 6 MB)
MAX_PRIMITIVES = 4
# the SDFs the kernels evaluate (all of ops/sdf.py's), by the code the
# device switches on; four bits per primitive in the packed word
# (pack_sdf_kinds)
SDF_KINDS = {"box": 0, "container": 1, "sphere": 2, "capsule": 3, "cylinder": 4, "torus": 5,
             "rolling_pin": 6, "chopsticks": 7}
SDF_KIND_BITS = 4
PRIM_FRAME_COLS = 12  # position (3), rotation (4), size (3), friction, softness
N_COMP = 25  # x 3, v 3, C 9, F 9, J 1

# The checkpoint stride rule. K2-bwd needs each substep's input carry. K = 1
# keeps all of them: B * steps * 25 * P * 4 bytes per macro step, which
# autograd holds for every macro step of an episode until the loss's
# backward. For whip_rope at 1024 envs that is 480 MB per macro step and
# 33.6 GB over the 70 macro steps of an episode that learns. Above
# HISTORY_BUDGET per macro step the kernels keep a checkpoint every
# K = ceil(sqrt(steps)) substeps instead (whip_rope: 9, 8 checkpoints, 55 MB
# per macro step at 1024 envs, 3.8 GB over the episode) and K2-bwd recomputes
# each segment (one more forward per macro step). 64 MB keeps a 70-step
# episode's history under ~4.5 GB at any batch, and leaves the CPU-sized
# batches of the tests on K = 1.
HISTORY_BUDGET = 64 * 2**20

# K2-fwd's and K2-bwd's launches on an H100: a CTA may have SMEM_PER_BLOCK
# bytes of shared memory, static and dynamic; FWD_STATIC_SMEM and
# BWD_STATIC_SMEM bound the kernels' static parts (the primitives; backward
# also the CTA's sums of their cotangents and its frames' cotangents). A
# cluster has at most MAX_CLUSTER CTAs (the portable size). A K2-fwd CTA has
# at most FWD_MAX_THREADS threads (FWD_MAX_NT in the source: its launch
# bounds, which cap the registers at 65,536 / 640 = 102 per thread), one
# per particle of the CTA rounded up to a warp (whip_rope's 67 particles:
# 96 threads). A K2-bwd CTA has at most BWD_MAX_THREADS (BWD_MAX_NT: 204
# registers per thread) and at least MIN_THREADS (one wave of whip_rope's
# 1024 envs keeps the first design's 128 threads, 67 of them with a
# particle).
SMEM_PER_BLOCK = 232_448
N_SMS = 132
MAX_CLUSTER = 8
FWD_MAX_THREADS = 640
BWD_MAX_THREADS = 320
MIN_THREADS = 128
FWD_STATIC_SMEM = 512
BWD_STATIC_SMEM = 2048
MIN_PARTICLES_PER_CTA = 32

_PTR, _INT, _FLOAT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_FWD, _SEG, _BWD = 0, 1, 2


def pack_sdf_kinds(sdf_names):
    """The primitives' SDF codes in one int, primitive i's in bits
    [4 i, 4 i + 4), as the device decodes them (load_prims in
    csrc/mpm_device.cuh). Raises for an SDF the kernels do not evaluate."""
    bad = [n for n in sdf_names if n not in SDF_KINDS]
    if bad:
        raise NotImplementedError(
            f"the MPM kernels evaluate the SDFs {sorted(SDF_KINDS)}, not {bad}")
    if len(sdf_names) > MAX_PRIMITIVES:
        raise NotImplementedError(
            f"the MPM kernels take at most {MAX_PRIMITIVES} primitives, not {len(sdf_names)}")
    return sum(SDF_KINDS[n] << (SDF_KIND_BITS * i) for i, n in enumerate(sdf_names))


def checkpoint_stride(B, P, steps):
    """K = 1 when one macro step's exact history fits HISTORY_BUDGET, else
    ceil(sqrt(steps))."""
    if B * steps * N_COMP * P * 4 <= HISTORY_BUDGET:
        return 1
    return math.ceil(math.sqrt(steps))


def list_capacity(P, cells):
    """Slots of a touched-cell list for P particles: a cell enters once per
    substep, and at most 27 per particle do."""
    return min(27 * P, cells)


def smem_bytes(P, cells, steps, n_prim, bwd):
    """Dynamic shared memory of a K2 block holding P particles (smem_bytes
    in the source): the carry (and, backward, its cotangent), the primitive
    rows, the touched list (and, backward, three accumulators per particle
    in double, after 8 bytes of alignment slack)."""
    floats = (2 if bwd else 1) * N_COMP * P + (steps + 1) * n_prim * 7
    nbytes = 4 * floats + 4 * list_capacity(P, cells)
    return nbytes + 8 + 8 * 3 * P if bwd else nbytes


@dataclass(frozen=True)
class LaunchConfig:
    """K2-fwd's or K2-bwd's launch: ``cluster`` CTAs per env of ``threads``
    threads, each holding ``per_cta`` particles and a touched list of
    ``list_cap`` slots in ``smem`` bytes of dynamic shared memory; ``K`` the
    stride rule's checkpoint stride."""

    cluster: int
    threads: int
    per_cta: int
    list_cap: int
    smem: int
    K: int


def _launch(name, B, P, cells, steps, n_prim, cluster, bwd):
    """The cluster rule of fwd_launch_config and launch_config: the cluster
    doubles while B clusters of twice the size still fit the card's N_SMS
    SMs in one wave and each CTA keeps MIN_PARTICLES_PER_CTA particles, and
    further while a CTA's shared memory does not fit; ``cluster`` overrides
    it. Returns (cluster, particles per CTA)."""
    if min(B, P, cells, steps) < 1 or not 0 <= n_prim <= MAX_PRIMITIVES:
        raise ValueError(f"B={B}, P={P}, cells={cells}, steps={steps}, n_prim={n_prim}")
    if cluster is None:
        cs = 1
        while (cs < MAX_CLUSTER and 2 * cs * B <= N_SMS
               and P >= 2 * cs * MIN_PARTICLES_PER_CTA):
            cs *= 2
        while cs < MAX_CLUSTER and _cta_smem(P, cs, cells, steps, n_prim, bwd) > SMEM_PER_BLOCK:
            cs *= 2
    else:
        cs = int(cluster)
        if not 1 <= cs <= MAX_CLUSTER:
            raise ValueError(f"a cluster has 1 to {MAX_CLUSTER} CTAs, not {cs}")
    per_cta = -(-P // cs)
    need = _cta_smem(P, cs, cells, steps, n_prim, bwd)
    if need > SMEM_PER_BLOCK:
        raise ValueError(
            f"{name} on {P} particles, {cells} grid cells, {steps} substeps and {n_prim} "
            f"primitives needs {need} bytes of shared memory per CTA in a cluster of {cs} "
            f"({per_cta} particles each); a CTA may have {SMEM_PER_BLOCK}")
    return cs, per_cta


def fwd_launch_config(B, P, cells, steps, n_prim, cluster=None):
    """K2-fwd's launch for B envs of P particles on ``cells`` grid cells,
    ``steps`` substeps and ``n_prim`` primitives: the cluster as
    launch_config picks it (shape_rope at 64 envs: 2, at 16: 8; whip_rope at
    1024: 1), ``cluster`` overriding it; threads one per particle of a CTA,
    rounded up to a warp, at most FWD_MAX_THREADS. Raises ValueError, naming
    the sizes, when no cluster of at most MAX_CLUSTER CTAs holds the env."""
    cs, per_cta = _launch("K2-fwd", B, P, cells, steps, n_prim, cluster, False)
    threads = min(-(-per_cta // 32) * 32, FWD_MAX_THREADS)
    return LaunchConfig(cs, threads, per_cta, list_capacity(per_cta, cells),
                        smem_bytes(per_cta, cells, steps, n_prim, False),
                        checkpoint_stride(B, P, steps))


def launch_config(B, P, cells, steps, n_prim, cluster=None):
    """K2-bwd's launch for B envs of P particles on ``cells`` grid cells,
    ``steps`` substeps and ``n_prim`` primitives. The cluster doubles while
    B clusters of twice the size still fit the card's N_SMS SMs in one
    wave and each CTA keeps MIN_PARTICLES_PER_CTA particles (shape_rope at
    64 envs: 2; whip_rope at 1024: 1), and further while a CTA's shared
    memory does not fit; ``cluster`` overrides the rule. Threads: one per
    particle of a CTA, rounded up to a warp, within [MIN_THREADS,
    BWD_MAX_THREADS]. Raises ValueError, naming the sizes, when no cluster
    of at most MAX_CLUSTER CTAs holds the env."""
    cs, per_cta = _launch("K2-bwd", B, P, cells, steps, n_prim, cluster, True)
    threads = min(max(-(-per_cta // 32) * 32, MIN_THREADS), BWD_MAX_THREADS)
    return LaunchConfig(cs, threads, per_cta, list_capacity(per_cta, cells),
                        smem_bytes(per_cta, cells, steps, n_prim, True),
                        checkpoint_stride(B, P, steps))


def _cta_smem(P, cs, cells, steps, n_prim, bwd):
    return (smem_bytes(-(-P // cs), cells, steps, n_prim, bwd)
            + (BWD_STATIC_SMEM if bwd else FWD_STATIC_SMEM))


@functools.cache
def _lib():
    lib = load_library(SOURCE)
    lib.mpm_step_launch.argtypes = (
        [_PTR] * 5 + [_PTR, _INT, _INT] * 3 + [_PTR, _INT] + [_PTR] * 4 + [_PTR] * 9
        + [_PTR, _INT] + [_INT] * 10 + [_FLOAT] * 8 + [_INT, _PTR]
        + [_INT, _INT, _PTR, _PTR, _PTR, _PTR, _INT] + [_INT] * 3 + [_LL, _PTR]
    )
    lib.mpm_step_launch.restype = ctypes.c_int
    lib.mpm_step_smem_bytes.argtypes = [_INT] * 5
    lib.mpm_step_smem_bytes.restype = ctypes.c_size_t
    lib.mpm_step_kernel_info.argtypes = [_INT, _INT, _LL, _INT, _INT, _PTR]
    lib.mpm_step_kernel_info.restype = ctypes.c_int
    lib.unidom_cuda_error_string.argtypes = [ctypes.c_int]
    lib.unidom_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _kernel_info(bwd, cfg, device):
    out = (ctypes.c_int * 5)()
    err = _lib().mpm_step_kernel_info(int(bwd), cfg.threads, cfg.smem, cfg.cluster, device, out)
    if err != 0:
        raise RuntimeError(f"{'K2-bwd' if bwd else 'K2-fwd'} kernel info for {cfg}: "
                           f"{_lib().unidom_cuda_error_string(err).decode()} (error {err})")
    return dict(zip(("registers", "local_bytes", "static_smem", "blocks_per_sm",
                     "clusters"), out))


def fwd_kernel_info(cfg, device):
    """What the card makes of K2-fwd at ``cfg`` (a LaunchConfig): registers
    and local memory (bytes) per thread, static shared memory (bytes), blocks
    per SM (the occupancy API) and clusters of ``cfg.cluster`` the card holds
    at once."""
    return _kernel_info(False, cfg, device)


def bwd_kernel_info(cfg, device):
    """The same for K2-bwd."""
    return _kernel_info(True, cfg, device)


def _device_and_stream(dev):
    return dev.index if dev.index is not None else torch.cuda.current_device(), \
        torch.cuda.current_stream(dev).cuda_stream


def _check(name, t, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} has dtype {t.dtype}, the kernel takes float32")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def check_supported(sim):
    """Raise unless the kernel takes ``sim``'s configuration."""
    conf = sim.conf
    cells = conf.res[0] * conf.res[1] * conf.res[2]
    pack_sdf_kinds(sim.sdf_names)
    if sim.n_particles > MAX_PARTICLES or cells > MAX_CELLS:
        raise NotImplementedError(
            f"mpm_step's kernel holds at most {MAX_PARTICLES} particles and {MAX_CELLS} grid "
            f"cells, not {sim.n_particles} and {cells}: the big-grid kernel K3-fwd "
            "(unidom_torch/ops/cuda/mpm_big_kernel.py) takes such configurations forward")


def _material(name, t, B, P, device):
    """A material parameter of shape (B, 1) or (B, P), with the strides by
    which the kernel reads env b's particle p."""
    if t.device != device or t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32 on {device}, not {t.dtype} on {t.device}")
    if t.dim() != 2 or t.shape[0] != B or t.shape[1] not in (1, P):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected ({B}, 1) or ({B}, {P})")
    e = t.expand(B, P)
    return [t.data_ptr(), e.stride(0), e.stride(1)]


def pack_primitives(state):
    """(frame (B, n_prim, 12), vw (B, n_prim, steps, 6)) of the state's
    primitives: row 0 of position and rotation, size, friction and
    softness; the per-substep v and w."""
    frame = torch.stack([
        torch.cat([p.position[:, 0], p.rotation[:, 0], p.size, p.friction[:, None],
                   p.softness[:, None]], dim=1)
        for p in state.primitives], dim=1)
    vw = torch.stack([torch.cat([p.v, p.w], dim=-1) for p in state.primitives], dim=1)
    return frame.contiguous(), vw.contiguous()


def pack_carry(state):
    """The particle state as the kernels' history holds it: (B, 25, P)."""
    B, P = state.x.shape[:2]
    return torch.cat([state.x, state.v, state.C.reshape(B, P, 9), state.F.reshape(B, P, 9),
                      state.J[..., None]], -1).transpose(1, 2)


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def _pointer_array(tensors):
    """A C array of the tensors' data pointers (None when ``tensors`` is)."""
    if tensors is None:
        return None
    return ctypes.cast((ctypes.c_void_p * len(tensors))(*map(_ptr, tensors)), ctypes.c_void_p)


def _call(sim, fields, frame, vw, *, what, K=1, hist=None, outs=(None,) * 7, segment=0,
          seg_out=None, bwd_in=None, bwd_out=None, scratch=None, cfg=None, clocks=None):
    """One ``mpm_step_launch``: K2-fwd, K2-seg or K2-bwd (``what``; K2-fwd
    and K2-bwd launched as ``cfg`` says) on the forward's inputs ``fields``
    (x, v, C, F, J, mu, lamda, yield_stress, friction; x..J may be None but
    for K2-fwd); ``clocks`` (6 int64, zeros), when given, takes K2-fwd's
    phase split (StampedSync in the source)."""
    conf = sim.conf
    B, P, dev = frame.shape[0], sim.n_particles, frame.device
    n_prim, steps = frame.shape[1], conf.steps
    rx, ry, rz = conf.res
    cells = rx * ry * rz
    grid = torch.empty((B, cells, 4), dtype=torch.float32, device=dev)
    mark = torch.empty((B, cells), dtype=torch.int32, device=dev)
    sdf_kinds = pack_sdf_kinds(sim.sdf_names)
    gravity = [float(g) for g in conf.gravity]
    device, stream = _device_and_stream(dev)
    lib = _lib()
    err = lib.mpm_step_launch(
        *(_ptr(fields[n]) for n in ("x", "v", "C", "F", "J")),
        *_material("mu", fields["mu"], B, P, dev),
        *_material("lamda", fields["lamda"], B, P, dev),
        *_material("yield_stress", fields["yield_stress"], B, P, dev),
        fields["friction"].data_ptr(), fields["friction"].stride(0),
        sim._h.data_ptr(), sim._material.data_ptr(), frame.data_ptr(), vw.data_ptr(),
        *(_ptr(t) for t in outs), grid.data_ptr(), mark.data_ptr(),
        _ptr(hist), K,
        B, P, n_prim, steps, rx, ry, rz, conf.n_grid, int(sim.use_position_control), sdf_kinds,
        conf.dt, conf.dx, -conf.dt * conf.p_vol * 4.0, conf.dx**2, conf.p_mass, *gravity,
        device, stream,
        what, segment, _ptr(seg_out), _pointer_array(bwd_in), _pointer_array(bwd_out),
        _ptr(scratch), *((cfg.list_cap, cfg.cluster, cfg.threads, cfg.per_cta, cfg.smem)
                         if cfg else (0, 1, 0, 0, 0)), _ptr(clocks),
    )
    if err != 0:
        msg = lib.unidom_cuda_error_string(err).decode()
        name = ("K2-fwd", "K2-seg", "K2-bwd")[what]
        smem = cfg.smem if cfg else lib.mpm_step_smem_bytes(P, cells, steps, n_prim, 0)
        raise RuntimeError(
            f"mpm_step {name} launch failed: {msg} (error {err}; B={B}, P={P}, res={conf.res}, "
            f"K={K}, dynamic shared memory {smem} bytes" + (f", {cfg}" if cfg else "") + ")")


def _inputs(sim, state, check=check_supported):
    """Check ``state`` (the output of ``sim.prepare``) against what the
    kernel takes (``check(sim)`` for the configuration). Returns (fields,
    frame, vw)."""
    check(sim)
    x = state.x
    B, P, dev = x.shape[0], sim.n_particles, x.device
    n_prim, steps = len(state.primitives), sim.conf.steps
    if n_prim != len(sim.sdf_names):
        raise ValueError(f"the state has {n_prim} primitives, the simulator {len(sim.sdf_names)}")
    for name, shape in (("x", (B, P, 3)), ("v", (B, P, 3)), ("C", (B, P, 3, 3)),
                        ("F", (B, P, 3, 3)), ("J", (B, P))):
        _check(name, getattr(state, name), shape, dev)
    frame, vw = pack_primitives(state)
    _check("primitive frame", frame, (B, n_prim, PRIM_FRAME_COLS), dev)
    _check("primitive v and w", vw, (B, n_prim, steps, 6), dev)
    _check("friction", state.friction, (B, 1), dev)
    _check("hardness", sim._h, (P,), dev)
    if sim._material.dtype != torch.int32 or sim._material.device != dev:
        raise TypeError("the material codes must be int32 on the state's device")
    fields = {n: getattr(state, n) for n in ("x", "v", "C", "F", "J", "mu", "lamda",
                                             "yield_stress", "friction")}
    return fields, frame, vw


def _forward(sim, fields, frame, vw, K=1, hist=None, cluster=None, clocks=None):
    """K2-fwd, launched as fwd_launch_config says (``cluster`` overriding
    its cluster size; ``clocks`` as for _call). Returns (x, v, C, F, J,
    traj_pos, traj_rot)."""
    conf = sim.conf
    B, n_prim, steps = frame.shape[0], frame.shape[1], conf.steps
    dev = frame.device
    cfg = fwd_launch_config(B, sim.n_particles, conf.res[0] * conf.res[1] * conf.res[2], steps,
                            n_prim, cluster)
    outs = [torch.empty_like(fields[n]) for n in ("x", "v", "C", "F", "J")]
    traj_pos = torch.empty((B, n_prim, steps + 1, 3), dtype=torch.float32, device=dev)
    traj_rot = torch.empty((B, n_prim, steps + 1, 4), dtype=torch.float32, device=dev)
    _call(sim, fields, frame, vw, what=_FWD, K=K, hist=hist, outs=(*outs, traj_pos, traj_rot),
          cfg=cfg, clocks=clocks)
    mpm_step.launches += 1
    return (*outs, traj_pos, traj_rot)


def _rebuild(state, outs):
    x, v, C, F, J, traj_pos, traj_rot = outs
    prims = tuple(p.replace(position=traj_pos[:, i], rotation=traj_rot[:, i])
                  for i, p in enumerate(state.primitives))
    return state.replace(x=x, v=v, C=C, F=F, J=J, primitives=prims)


def _history(sim, B, K):
    steps, P = sim.conf.steps, sim.n_particles
    return torch.empty((B, math.ceil(steps / K), N_COMP, P), dtype=torch.float32,
                       device=sim._h.device)


def launch(sim, state, ckpt_stride=None):
    """K2-fwd on ``state``, the output of ``sim.prepare``: the ``conf.steps``
    substeps and the buffers' row 0 <- row steps. Returns the new state, or
    with ``ckpt_stride`` K, (the new state, the history of a checkpoint
    every K substeps). Raises on anything the kernel does not take."""
    fields, frame, vw = _inputs(sim, state)
    if ckpt_stride is None:
        return _rebuild(state, _forward(sim, fields, frame, vw))
    hist = _history(sim, frame.shape[0], ckpt_stride)
    return _rebuild(state, _forward(sim, fields, frame, vw, ckpt_stride, hist)), hist


def mpm_step_seg(sim, state, hist, ckpt_stride, segment):
    """K2-seg alone, launched as K2-bwd runs it as a phase (``launch_config``'s
    clusters, threads and shared memory, each CTA recording its grids, the
    segment's last carry's included): segment ``segment`` of the macro step
    from ``state`` (the output of ``sim.prepare``) recomputed from its
    checkpoint in ``hist`` (``launch(..., ckpt_stride)``'s). Returns its L
    input carries, (B, L, 25, P)."""
    fields, frame, vw = _inputs(sim, state)
    K, steps, res = ckpt_stride, sim.conf.steps, sim.conf.res
    B, P, dev = frame.shape[0], sim.n_particles, frame.device
    L = min(K, steps - segment * K)
    cfg = launch_config(B, P, res[0] * res[1] * res[2], steps, frame.shape[1])
    out = torch.empty((B, L, N_COMP, P), dtype=torch.float32, device=dev)
    # per CTA K records of a substep's grid, as K2-bwd's scratch holds them
    scratch = torch.empty((B * cfg.cluster * K * (5 * cfg.list_cap + 1),), dtype=torch.float32,
                          device=dev)
    _call(sim, fields, frame, vw, what=_SEG, K=K, hist=hist, segment=segment, seg_out=out,
          scratch=scratch, cfg=cfg)
    mpm_step.seg_launches += 1
    return out


class _MPMStepFn(torch.autograd.Function):
    """One macro step's substeps through K2-fwd, with K2-bwd as its backward.
    Inputs: the simulator, the checkpoint stride, x, v, C, F, J, mu, lamda,
    yield_stress, friction, the primitives' frame and per-substep v and w.
    Outputs: x, v, C, F, J and the (B, n_prim, steps + 1, 3 / 4) position
    and rotation rows."""

    @staticmethod
    def forward(ctx, sim, K, x, v, C, F, J, mu, lamda, ys, friction, frame, vw):
        fields = dict(x=x, v=v, C=C, F=F, J=J, mu=mu, lamda=lamda, yield_stress=ys,
                      friction=friction)
        hist = _history(sim, x.shape[0], K)
        outs = _forward(sim, fields, frame, vw, K, hist)
        ctx.sim, ctx.K = sim, K
        ctx.save_for_backward(hist, mu, lamda, ys, friction, frame, vw)
        return outs

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *cots):
        hist, mu, lamda, ys, friction, frame, vw = ctx.saved_tensors
        fields = dict(x=None, v=None, C=None, F=None, J=None, mu=mu, lamda=lamda,
                      yield_stress=ys, friction=friction)
        grads = _backward(ctx.sim, fields, frame, vw, hist, ctx.K,
                          [c.contiguous() for c in cots])
        return (None, None, *grads)


def _backward(sim, fields, frame, vw, hist, K, cots, cluster=None):
    """K2-bwd: the cotangents of x, v, C, F, J, mu, lamda, yield_stress,
    friction, frame and vw from those of the outputs ``cots``; ``cluster``
    overrides launch_config's cluster size."""
    B, P, dev = frame.shape[0], sim.n_particles, frame.device
    conf = sim.conf
    cells = conf.res[0] * conf.res[1] * conf.res[2]
    cfg = launch_config(B, P, cells, conf.steps, frame.shape[1], cluster)
    f32 = dict(dtype=torch.float32, device=dev)
    grads = [torch.empty((B, P, 3), **f32), torch.empty((B, P, 3), **f32),
             torch.empty((B, P, 3, 3), **f32), torch.empty((B, P, 3, 3), **f32),
             torch.empty((B, P), **f32)]
    grads += [torch.empty(fields[n].shape, **f32) for n in ("mu", "lamda", "yield_stress")]
    grads += [torch.empty((B, 1), **f32), torch.empty_like(frame), torch.empty_like(vw)]
    # the grid cotangent (a float4 per cell), and per CTA K records of a
    # substep's grid: list_cap cells' momentum and mass (float4) and index,
    # and their count
    scratch = torch.empty((B * (4 * cells + cfg.cluster * K * (5 * cfg.list_cap + 1)),), **f32)
    seg = torch.empty((B, K, N_COMP, P), **f32) if K > 1 else None
    _call(sim, fields, frame, vw, what=_BWD, K=K, hist=hist, seg_out=seg, bwd_in=cots,
          bwd_out=grads, scratch=scratch, cfg=cfg)
    mpm_step.bwd_launches += 1
    if K > 1:
        mpm_step.seg_launches += math.ceil(conf.steps / K)
    return grads


def kernel_step(sim, state, ckpt_stride=None):
    """The substeps of ``state`` (the output of ``sim.prepare``) through
    ``_MPMStepFn``: K2-fwd with a checkpoint every ``ckpt_stride`` substeps
    (by default ``checkpoint_stride``'s rule) and K2-bwd in the backward."""
    fields, frame, vw = _inputs(sim, state)
    B, P, steps = state.x.shape[0], sim.n_particles, sim.conf.steps
    res = sim.conf.res
    K = launch_config(B, P, res[0] * res[1] * res[2], steps, frame.shape[1]).K
    K = K if ckpt_stride is None else int(ckpt_stride)
    if not 1 <= K <= steps:
        raise ValueError(f"ckpt_stride must be in [1, {steps}], not {K}")
    outs = _MPMStepFn.apply(sim, K, *(fields[n] for n in ("x", "v", "C", "F", "J", "mu", "lamda",
                                                            "yield_stress", "friction")),
                            frame, vw)
    return _rebuild(state, outs)


def _requires_grad(state, action):
    return action.requires_grad or any(t.requires_grad for t in tree_flatten(state)[0])


def mpm_step(sim, state, action, ckpt_stride=None):
    """One macro step of ``sim`` for the batch ``state`` under ``action``
    (B, 6 n_primitive). CPU tensors take the plain PyTorch step (autograd
    differentiates it; ``ckpt_stride`` does not apply); CUDA tensors take
    the kernels, which raise on anything they do not take. ``ckpt_stride``
    overrides the checkpoint stride rule of a differentiable step."""
    dev = state.x.device
    if dev.type == "cpu":
        return sim._step_plain(state, action)
    if dev.type != "cuda":
        raise ValueError(f"mpm_step runs on CPU or CUDA tensors, not {dev}")
    n_act = 6 * len(sim.sdf_names)
    if tuple(action.shape) != (state.x.shape[0], n_act):
        raise ValueError(f"action has shape {tuple(action.shape)}, expected (B, {n_act})")
    if torch.is_grad_enabled() and _requires_grad(state, action):
        return kernel_step(sim, sim.prepare(state, action), ckpt_stride)
    return launch(sim, sim.prepare(state, action))


mpm_step.launches = 0
mpm_step.bwd_launches = 0
mpm_step.seg_launches = 0
