"""Cloth robot step on the GPU: wrapper of the CUDA kernels
``unidom_torch/csrc/cloth_robot_step.cu``.

Replaces ``build_cloth_robot_step_kernel`` of
``unidom_tpu/ops/pallas/cloth_kernel.py``: its forward (``fwd_kernel``) and
its backward (``bwd_kernel``). ``cloth_robot_step`` runs the plain PyTorch
step (``ClothSimulator._robot_step_plain``) for CPU tensors, which torch
autograd differentiates, and for CUDA tensors launches the forward kernel,
whose backward launches the backward kernel, or raises.
``cloth_robot_step.launches`` and ``cloth_robot_step.bwd_launches`` count
kernel launches.

``launch_config`` sizes a launch for a cloth of H x W bbox cells: threads
per env, particles per thread in registers and in device-memory scratch,
shared memory and history. It raises for a cloth whose block would exceed
the card's shared memory, before anything is built or launched.

``cloth_robot_step_vjp`` launches the backward kernel alone (CUDA only), and
``cloth_robot_step_vjp_plain`` is its plain version: torch autograd through
the plain substeps from the same inputs. State crosses in
the simulator's own layout, (B, H, W, 3) for x and v, so no repacking happens
around the launches.
"""

import ctypes
import functools
from dataclasses import dataclass

import torch

from unidom_torch.ops.cuda._build import load_library

SOURCE = "cloth_robot_step.cu"

SMEM_PER_BLOCK = 232_448  # shared memory one block may have on an H100
MAX_THREADS = 1024  # threads one block may have
# (threads, particles per thread held in registers) of the built kernels
# (K1_VARIANTS in the source). A cloth of at most MAIN_CELLS cells
# (fold_cloth1/3: 16 x 32) takes MAIN; a larger one LARGE, with the
# particles beyond LARGE's registers in device-memory scratch. Of 128 x 4,
# 256 x 2, 512 x 1 and 512 x 2 on fold_cloth3 on an H100, MAIN was the
# fastest backward and within 2% of the fastest forward (512 x 1, which
# puts 2 envs on an SM where MAIN puts 4; PERF.md, PR 7).
MAIN = (256, 2)
LARGE = (512, 2)
VARIANTS = (MAIN, LARGE)
MAIN_CELLS = 512
# The backward's values per particle (struct Own: the x and v cotangents,
# the input v, the force, the damped v, the prefetched v and force); the
# forward keeps v.
SCRATCH_FLOATS = {"fwd": 3, "bwd": 21}
HIST_PLANES = 9  # the backward's history per substep: x, v and force, planes of HWp

_PTR, _INT, _FLOAT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong


@dataclass(frozen=True)
class LaunchConfig:
    """One kernel's launch for a cloth of H x W bbox cells (``hw``; planes of
    ``hw_padded`` floats) and ``n_substeps``: ``threads`` per env, ``regs``
    particles per thread in registers, ``slots`` particles per thread in all,
    ``smem`` bytes of dynamic and ``static_smem`` of static shared memory,
    ``scratch`` floats of device memory per env for the slots beyond
    ``regs``, and for the backward ``hist_stride`` floats of history per env
    and substep."""

    kind: str
    hw: int
    hw_padded: int
    threads: int
    regs: int
    slots: int
    smem: int
    static_smem: int
    scratch: int
    hist_stride: int


def launch_config(H, W, n_substeps, kind, variant=None):
    """The launch of the forward (``kind="fwd"``) or backward (``"bwd"``)
    kernel on a cloth of H x W bbox cells; ``variant`` (threads, regs), one
    of VARIANTS, overrides the rule. Raises ValueError, naming the sizes, for
    a cloth whose block needs more than SMEM_PER_BLOCK bytes of shared memory."""
    if kind not in SCRATCH_FLOATS:
        raise ValueError(f"kind is 'fwd' or 'bwd', not {kind!r}")
    if n_substeps < 1 or H < 1 or W < 1:
        raise ValueError(f"cloth {H} x {W} with {n_substeps} substeps")
    hw = H * W
    hwp = -(-hw // 4) * 4
    threads, regs = variant or (MAIN if hw <= MAIN_CELLS else LARGE)
    if (threads, regs) not in VARIANTS:
        raise ValueError(f"variant {(threads, regs)} is not built; built: {VARIANTS}")
    slots = -(-hw // threads)
    scratch = max(slots - regs, 0) * SCRATCH_FLOATS[kind] * threads
    if kind == "fwd":
        smem, static = 6 * hwp * 4, 0  # x_old, x_new
        hist_stride = 0
    else:  # two x buffers, the neighbour terms, gripper states; reductions,
        # the gripper cotangents and actions, mbarriers
        smem = (9 * hwp + 8 * n_substeps) * 4
        static = (2 * 2 * 4 + 2 * 8) * (threads // 32) + 8 * 8 + 2 * 8 * 4 + 2 * 8
        hist_stride = HIST_PLANES * hwp
    if smem + static > SMEM_PER_BLOCK or threads > MAX_THREADS:
        raise ValueError(
            f"a cloth of {H} x {W} = {hw} bbox cells with {n_substeps} substeps needs "
            f"{smem + static} bytes of shared memory per block in the {kind} kernel "
            f"({threads} threads); a block may have {SMEM_PER_BLOCK}"
        )
    return LaunchConfig(kind, hw, hwp, threads, regs, slots, smem, static, scratch, hist_stride)


@functools.cache
def _lib():
    lib = load_library(SOURCE)
    lib.cloth_robot_step_fwd.argtypes = (
        [_PTR] * 14 + [_INT] * 7 + [_LL] + [_FLOAT] * 7 + [_INT, _PTR]
    )
    lib.cloth_robot_step_bwd.argtypes = (
        [_PTR] * 23 + [_INT] * 7 + [_LL] + [_FLOAT] * 8 + [_INT, _PTR]
    )
    lib.cloth_robot_step_kernel_info.argtypes = [_INT, _INT, _INT, _LL, _INT, _PTR]
    for fn in (lib.cloth_robot_step_fwd, lib.cloth_robot_step_bwd,
               lib.cloth_robot_step_kernel_info):
        fn.restype = ctypes.c_int
    lib.unidom_cuda_error_string.argtypes = [ctypes.c_int]
    lib.unidom_cuda_error_string.restype = ctypes.c_char_p
    return lib


def kernel_info(cfg, device):
    """What the card makes of ``cfg``'s kernel: registers per thread, local
    memory per thread in bytes (spills and stack), static shared memory and
    blocks per SM (from the occupancy API)."""
    out = (ctypes.c_int * 4)()
    err = _lib().cloth_robot_step_kernel_info(int(cfg.kind == "bwd"), cfg.threads, cfg.regs,
                                              cfg.smem, device, out)
    _raise_on(err, f"{cfg.kind} kernel info", cfg)
    return dict(zip(("registers", "local_bytes", "static_smem", "blocks_per_sm"), out))


def _device_and_stream(dev):
    return dev.index if dev.index is not None else torch.cuda.current_device(), \
        torch.cuda.current_stream(dev).cuda_stream


def _check(name, t, shape, device, dtype=torch.float32):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, the kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _state_shapes(B, H, W):
    """Names and shapes of the robot step's state: its outputs and, with the
    per-substep actions, stiffness and mu, its inputs."""
    return (("x", (B, H, W, 3)), ("v", (B, H, W, 3)),
            ("primitive0", (B, 4)), ("primitive1", (B, 4)))


def _check_inputs(sim, inputs):
    x = inputs[0]
    B, dev = x.shape[0], x.device
    if B < 1:
        raise ValueError("empty batch")
    shapes = _state_shapes(B, sim.H, sim.W) + (
        ("action0", (B, 4)), ("action1", (B, 4)), ("stiffness", (B,)), ("mu", (B,)),
    )
    for (name, shape), t in zip(shapes, inputs):
        _check(name, t, shape, dev)
    _check("link_code", sim.link_code, (sim.H * sim.W,), dev, torch.int32)


def _check_cotangents(sim, x, cotangents):
    """Raise unless the cotangents of the step's outputs (x, v, primitive0,
    primitive1) are what the backward kernel takes for the input ``x``."""
    for (name, shape), g in zip(_state_shapes(x.shape[0], sim.H, sim.W), cotangents):
        _check(f"cotangent of {name}", g, shape, x.device)


def _raise_on(err, what, cfg, B=None):
    if err != 0:
        msg = _lib().unidom_cuda_error_string(err).decode()
        raise RuntimeError(
            f"{what} failed: {msg} (error {err}; B={B}, {cfg.hw} bbox cells, "
            f"{cfg.threads} threads x {cfg.slots} particles ({cfg.regs} in registers), "
            f"dynamic shared memory {cfg.smem} bytes)"
        )


def _ptrs(*tensors):
    return [t.data_ptr() for t in tensors]


def _scratch(cfg, B, dev):
    """The kernel's device-memory scratch for the slots beyond its registers
    (none on a cloth that its registers hold)."""
    return torch.empty(max(B * cfg.scratch, 1), dtype=torch.float32, device=dev)


def _physics(sim):
    conf = sim.conf
    return (conf.dt, conf.gravity, sim.damping_factor, conf.small_num, conf.max_v)


def _launch_fwd(sim, inputs, variant=None):
    """The forward kernel on ``inputs`` (x, v, primitive0, primitive1,
    action0, action1, stiffness, mu): returns (x, v, primitive0, primitive1)
    after the robot step. The configuration is checked before the library
    is loaded."""
    _check_inputs(sim, inputs)
    x = inputs[0]
    B, H, W, dev = x.shape[0], sim.H, sim.W, x.device
    n_sub = sim.conf.n_substeps
    cfg = launch_config(H, W, n_sub, "fwd", variant)
    lib = _lib()
    outs = tuple(torch.empty_like(t) for t in inputs[:4])
    scratch = _scratch(cfg, B, dev)
    device, stream = _device_and_stream(dev)
    err = lib.cloth_robot_step_fwd(
        *_ptrs(*inputs, sim.link_code, *outs, scratch),
        B, H, W, n_sub, cfg.threads, cfg.regs, cfg.slots, cfg.smem,
        *_physics(sim), *sim.rest_lengths, device, stream,
    )
    _raise_on(err, "cloth_robot_step kernel launch", cfg, B)
    cloth_robot_step.launches += 1
    return outs


def _launch_bwd(sim, inputs, cotangents, variant=None):
    """The backward kernel: the 8 inputs' cotangents from the 4 outputs'."""
    _check_inputs(sim, inputs)
    x = inputs[0]
    _check_cotangents(sim, x, cotangents)
    B, H, W, dev = x.shape[0], sim.H, sim.W, x.device
    n_sub = sim.conf.n_substeps
    cfg = launch_config(H, W, n_sub, "bwd", variant)
    lib = _lib()
    outs = tuple(torch.empty_like(t) for t in inputs)
    hist = torch.empty(B * n_sub * cfg.hist_stride, dtype=torch.float32, device=dev)
    scratch = _scratch(cfg, B, dev)
    if hist.data_ptr() % 16 or cfg.hist_stride * 4 % 16:
        raise RuntimeError("the history's substeps are not 16-byte aligned for the bulk copy")
    device, stream = _device_and_stream(dev)
    err = lib.cloth_robot_step_bwd(
        *_ptrs(*inputs, sim.link_code, *cotangents, *outs, hist, scratch),
        B, H, W, n_sub, cfg.threads, cfg.regs, cfg.slots, cfg.smem,
        *_physics(sim), sim.particle_scale, *sim.rest_lengths, device, stream,
    )
    _raise_on(err, "cloth_robot_step backward kernel launch", cfg, B)
    cloth_robot_step.bwd_launches += 1
    return outs


class _ClothRobotStepFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sim, x, v, ps0, ps1, a0, a1, stiffness, mu):
        inputs = (x, v, ps0, ps1, a0, a1, stiffness, mu)
        outs = _launch_fwd(sim, inputs)
        ctx.sim = sim
        ctx.save_for_backward(*inputs)
        return outs

    @staticmethod
    def backward(ctx, *grads):
        inputs = ctx.saved_tensors
        cotangents = tuple(
            torch.zeros_like(t) if g is None else g.contiguous()
            for g, t in zip(grads, inputs[:4])
        )
        return (None, *cloth_robot_step_vjp(ctx.sim, inputs, cotangents))


def cloth_robot_step_vjp(sim, inputs, cotangents):
    """The backward kernel: cotangents of the robot step's 8 inputs (see
    ``cloth_robot_step_vjp_plain``) from those of its 4 outputs. CUDA float32
    tensors launch the kernel, with its history scratch allocated here;
    anything else raises (on the CPU, torch autograd differentiates the plain
    step instead)."""
    x = inputs[0]
    if x.device.type != "cuda":
        raise ValueError(f"cloth_robot_step_vjp runs on CUDA tensors only, not {x.device}")
    return _launch_bwd(sim, inputs, cotangents)


def cloth_robot_step(sim, state, action):
    """One robot step of ``sim`` for the batch ``state`` under ``action``
    (B, 8). CPU tensors take the plain PyTorch step; CUDA tensors take the
    kernel, which raises on anything it does not take."""
    dev = state.x.device
    if dev.type == "cpu":
        return sim._robot_step_plain(state, action)
    if dev.type != "cuda":
        raise ValueError(f"cloth_robot_step runs on CPU or CUDA tensors, not {dev}")
    if tuple(action.shape) != (state.x.shape[0], 8):
        raise ValueError(f"action has shape {tuple(action.shape)}, expected (B, 8)")
    a0, a1 = sim.prepare_actions(action)
    x, v, ps0, ps1 = _ClothRobotStepFn.apply(
        sim, state.x, state.v, state.primitive0, state.primitive1,
        a0, a1, state.stiffness, state.mu,
    )
    return state.replace(x=x, v=v, primitive0=ps0, primitive1=ps1, action0=a0, action1=a1)


cloth_robot_step.launches = 0
cloth_robot_step.bwd_launches = 0


def cloth_robot_step_vjp_plain(sim, inputs, cotangents):
    """The backward kernel's plain version. ``inputs`` are the kernel's
    (x, v, primitive0, primitive1, action0, action1, stiffness, mu), with the
    per-substep actions of ``sim.prepare_actions``; ``cotangents`` those of
    its outputs (x, v, primitive0, primitive1). Returns the 8 cotangents of
    the inputs, by torch autograd through ``sim``'s plain substeps in the
    inputs' dtype and on their device."""
    from unidom_torch.engine.cloth import ClothState

    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in inputs]
        x, v, ps0, ps1, a0, a1, stiffness, mu = leaves
        state = ClothState(
            x=x, v=v, primitive0=ps0, primitive1=ps1, action0=a0, action1=a1,
            cur_step=torch.zeros(x.shape[0], dtype=torch.int32, device=x.device),
            stiffness=stiffness, mu=mu,
        )
        out = sim._run_substeps(state)
        grads = torch.autograd.grad(
            (out.x, out.v, out.primitive0, out.primitive1), leaves, cotangents,
            allow_unused=True,
        )
    return tuple(torch.zeros_like(t) if g is None else g for g, t in zip(grads, leaves))
