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

``cloth_robot_step_vjp`` launches the backward kernel alone (CUDA only), and
``cloth_robot_step_vjp_plain`` is its plain version: torch autograd through
the plain substeps from the same inputs. State crosses in
the simulator's own layout, (B, H, W, 3) for x and v, so no repacking happens
around the launches.
"""

import ctypes
import functools

import torch

from unidom_torch.ops.cuda._build import load_library

SOURCE = "cloth_robot_step.cu"

_PTR, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.cache
def _lib():
    lib = load_library(SOURCE)
    lib.cloth_robot_step_fwd.argtypes = (
        [_PTR] * 14 + [_INT] * 4 + [_FLOAT] * 5 + [_INT, _PTR]
    )
    lib.cloth_robot_step_bwd.argtypes = (
        [_PTR] * 23 + [_INT] * 4 + [_FLOAT] * 6 + [_INT, _PTR]
    )
    for fn in (lib.cloth_robot_step_fwd, lib.cloth_robot_step_bwd):
        fn.restype = ctypes.c_int
    for fn in (lib.cloth_robot_step_smem_bytes, lib.cloth_robot_step_bwd_smem_bytes):
        fn.argtypes = [ctypes.c_int]
        fn.restype = ctypes.c_size_t
    lib.unidom_cuda_error_string.argtypes = [ctypes.c_int]
    lib.unidom_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(name, t, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} has dtype {t.dtype}, the kernel takes float32")
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
        ("link_rest", (8, sim.H * sim.W)), ("link_valid", (8, sim.H * sim.W)),
    )
    for (name, shape), t in zip(shapes, (*inputs, sim.link_rest, sim.link_valid)):
        _check(name, t, shape, dev)


def _check_cotangents(sim, x, cotangents):
    """Raise unless the cotangents of the step's outputs (x, v, primitive0,
    primitive1) are what the backward kernel takes for the input ``x``."""
    for (name, shape), g in zip(_state_shapes(x.shape[0], sim.H, sim.W), cotangents):
        _check(f"cotangent of {name}", g, shape, x.device)


def _raise_on(err, what, B, H, W, smem):
    if err != 0:
        msg = _lib().unidom_cuda_error_string(err).decode()
        raise RuntimeError(
            f"{what} kernel launch failed: {msg} (error {err}; "
            f"B={B}, H={H}, W={W}, dynamic shared memory {smem} bytes)"
        )


def _ptrs(*tensors):
    return [t.data_ptr() for t in tensors]


class _ClothRobotStepFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sim, x, v, ps0, ps1, a0, a1, stiffness, mu):
        inputs = (x, v, ps0, ps1, a0, a1, stiffness, mu)
        _check_inputs(sim, inputs)
        B, H, W = x.shape[0], sim.H, sim.W
        dev = x.device
        lib = _lib()
        outs = (torch.empty_like(x), torch.empty_like(v),
                torch.empty_like(ps0), torch.empty_like(ps1))
        conf = sim.conf
        with torch.cuda.device(dev):
            err = lib.cloth_robot_step_fwd(
                *_ptrs(*inputs, sim.link_rest, sim.link_valid, *outs),
                B, H, W, conf.n_substeps,
                conf.dt, conf.gravity, sim.damping_factor, conf.small_num, conf.max_v,
                dev.index, torch.cuda.current_stream(dev).cuda_stream,
            )
        _raise_on(err, "cloth_robot_step", B, H, W, lib.cloth_robot_step_smem_bytes(H * W))
        cloth_robot_step.launches += 1
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
    _check_inputs(sim, inputs)
    _check_cotangents(sim, x, cotangents)
    B, H, W = x.shape[0], sim.H, sim.W
    dev = x.device
    conf = sim.conf
    lib = _lib()
    outs = tuple(torch.empty_like(t) for t in inputs)
    hist = torch.empty(B * conf.n_substeps * (6 * H * W + 8), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.cloth_robot_step_bwd(
            *_ptrs(*inputs, sim.link_rest, sim.link_valid, *cotangents, *outs, hist),
            B, H, W, conf.n_substeps,
            conf.dt, conf.gravity, sim.damping_factor, conf.small_num, conf.max_v,
            sim.particle_scale,
            dev.index, torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(err, "cloth_robot_step backward", B, H, W,
              lib.cloth_robot_step_bwd_smem_bytes(H * W))
    cloth_robot_step.bwd_launches += 1
    return outs


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
