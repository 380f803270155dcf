"""Cloth robot step on the GPU: wrapper of the CUDA kernel
``unidom_torch/csrc/cloth_robot_step.cu``.

Replaces ``build_cloth_robot_step_kernel`` of
``unidom_tpu/ops/pallas/cloth_kernel.py`` (its forward, ``fwd_kernel``).
``cloth_robot_step`` runs the plain PyTorch step
(``ClothSimulator._robot_step_plain``) for CPU tensors, and for CUDA tensors
launches the kernel or raises. ``cloth_robot_step.launches`` counts kernel
launches.

The kernel is forward only: its backward raises rather than differentiate
the plain step. State crosses in the simulator's own layout, (B, H, W, 3)
for x and v, so no repacking happens around the launch.
"""

import ctypes
import functools

import torch

from unidom_torch.ops.cuda._build import load_library

SOURCE = "cloth_robot_step.cu"


@functools.cache
def _lib():
    lib = load_library(SOURCE)
    fn = lib.cloth_robot_step_fwd
    fn.argtypes = (
        [ctypes.c_void_p] * 14
        + [ctypes.c_int] * 4
        + [ctypes.c_float] * 5
        + [ctypes.c_int, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    lib.cloth_robot_step_smem_bytes.argtypes = [ctypes.c_int]
    lib.cloth_robot_step_smem_bytes.restype = ctypes.c_size_t
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


class _ClothRobotStepFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sim, x, v, ps0, ps1, a0, a1, stiffness, mu):
        B = x.shape[0]
        H, W = sim.H, sim.W
        dev = x.device
        for name, t, shape in (
            ("x", x, (B, H, W, 3)), ("v", v, (B, H, W, 3)),
            ("primitive0", ps0, (B, 4)), ("primitive1", ps1, (B, 4)),
            ("action0", a0, (B, 4)), ("action1", a1, (B, 4)),
            ("stiffness", stiffness, (B,)), ("mu", mu, (B,)),
            ("link_inv_rest", sim.link_inv_rest, (8, H * W)),
            ("link_valid", sim.link_valid, (8, H * W)),
        ):
            _check(name, t, shape, dev)
        if B < 1:
            raise ValueError("empty batch")

        lib = _lib()
        ox = torch.empty_like(x)
        ov = torch.empty_like(v)
        ops0 = torch.empty_like(ps0)
        ops1 = torch.empty_like(ps1)
        conf = sim.conf
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.cloth_robot_step_fwd(
                x.data_ptr(), v.data_ptr(), ps0.data_ptr(), ps1.data_ptr(),
                a0.data_ptr(), a1.data_ptr(), stiffness.data_ptr(), mu.data_ptr(),
                sim.link_inv_rest.data_ptr(), sim.link_valid.data_ptr(),
                ox.data_ptr(), ov.data_ptr(), ops0.data_ptr(), ops1.data_ptr(),
                B, H, W, conf.n_substeps,
                conf.dt, conf.gravity, sim.damping_factor, conf.small_num, conf.max_v,
                dev.index, stream,
            )
        if err != 0:
            msg = lib.unidom_cuda_error_string(err).decode()
            smem = lib.cloth_robot_step_smem_bytes(H * W)
            raise RuntimeError(
                f"cloth_robot_step kernel launch failed: {msg} (error {err}; "
                f"B={B}, H={H}, W={W}, dynamic shared memory {smem} bytes)"
            )
        cloth_robot_step.launches += 1
        return ox, ov, ops0, ops1

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "the CUDA cloth robot step has no backward kernel yet; "
            "differentiate the plain step on CPU tensors instead"
        )


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
