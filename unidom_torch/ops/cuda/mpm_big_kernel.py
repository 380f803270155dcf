"""MPM macro step on big grids on the GPU: wrapper of the CUDA kernel of
``unidom_torch/csrc/mpm_big_step.cu``.

Replaces the forward of ``build_mpm_big_step_kernel`` in
``unidom_tpu/ops/pallas/mpm_big_kernel.py``: K3-fwd (``fwd_call`` ->
``fwd_kernel``), one macro step of ``conf.steps`` substeps for the
configurations that K2 (``mpm_kernel.py``, one block per env) does not take,
such as pour_soup (7,694 particles, a 128x64x128 grid) and
shape_elasto_plastic (23,940 particles). Its segment recompute (K3-seg) and
backward (K3-bwd) come with big-grid training.

``mpm_big_step`` runs the plain PyTorch macro step
(``MPMSimulator._step_plain``) for CPU tensors. For CUDA tensors it runs the
macro step's head (``MPMSimulator.prepare``: scrub, action clamp and clip,
``set_action``, in torch) and K3-fwd, or raises: a gradient request raises
``NotImplementedError`` (K3-bwd is not ported), and nothing falls back to
autograd through the plain step. ``mpm_big_step.launches`` counts macro
steps through K3-fwd (the unit of the Pallas kernel),
``mpm_big_step.cuda_launches`` the CUDA launches inside them
(4 x steps + 2 each).

The particle state crosses in the simulator's layout ((B, P, 3),
(B, P, 3, 3), (B, P)); the kernel keeps it per env in device memory as
(B, 25, P), component-major, with a (B, cells) float4 grid and mark, a
touched-cell list per env and the primitives' frames, all scratch from
``torch.empty``.
"""

import ctypes
import functools

import torch

from unidom_torch.ops.cuda._build import load_library
from unidom_torch.ops.cuda.mpm_kernel import (
    MAX_PRIMITIVES,
    N_COMP,
    SDF_KINDS,
    _device_and_stream,
    _inputs,
    _material,
    _ptr,
    _rebuild,
    _requires_grad,
)

SOURCE = "mpm_big_step.cu"

THREADS = 256  # the kernel's threads per block (NT in the source)
ROW = 7  # a primitive's frame in the kernel's rows: position 3, rotation 4
INT_MAX = 2**31 - 1

_PTR, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.cache
def _lib():
    lib = load_library(SOURCE)
    lib.mpm_big_step_launch.argtypes = (
        [_PTR] * 5 + [_PTR, _INT, _INT] * 3 + [_PTR, _INT] + [_PTR] * 4 + [_PTR] * 9
        + [_PTR] * 4 + [_INT, _INT] + [_INT] * 10 + [_FLOAT] * 8 + [_INT, _PTR, _PTR]
    )
    lib.mpm_big_step_launch.restype = ctypes.c_int
    lib.unidom_cuda_error_string.argtypes = [ctypes.c_int]
    lib.unidom_cuda_error_string.restype = ctypes.c_char_p
    return lib


def list_capacity(sim):
    """Slots of an env's touched-cell list: a cell enters once per substep,
    and at most 27 per particle do."""
    rx, ry, rz = sim.conf.res
    return min(27 * sim.n_particles, rx * ry * rz)


def scratch_bytes(sim, B):
    """Device memory of one K3-fwd macro step at ``B`` envs: the outputs
    and the kernel's scratch (grid and marks, carry, touched lists, frames)."""
    conf = sim.conf
    rx, ry, rz = conf.res
    P, n_prim = sim.n_particles, len(sim.sdf_names)
    per_env = (rx * ry * rz * 20 + 4 * list_capacity(sim) + 4 + 2 * 4 * N_COMP * P
               + 4 * (conf.steps + 1) * n_prim * (ROW + 7))
    return B * per_env


def check_supported_big(sim, B=None):
    """Raise unless K3-fwd takes ``sim``'s configuration at ``B`` envs (by
    default the simulator's batch): the SDFs it evaluates, at most
    MAX_PRIMITIVES primitives, offsets within an env that fit 32 bits, and,
    on a GPU, the device memory."""
    conf = sim.conf
    B = sim.batch_size if B is None else B
    cells = conf.res[0] * conf.res[1] * conf.res[2]
    bad = [n for n in sim.sdf_names if n not in SDF_KINDS]
    if bad:
        raise NotImplementedError(
            f"mpm_big_step's kernel evaluates the SDFs {sorted(SDF_KINDS)}, not {bad}")
    if len(sim.sdf_names) > MAX_PRIMITIVES:
        raise NotImplementedError(
            f"mpm_big_step's kernel takes at most {MAX_PRIMITIVES} primitives, not "
            f"{len(sim.sdf_names)}")
    if cells > INT_MAX or N_COMP * sim.n_particles > INT_MAX or not 1 <= B <= 65535:
        raise NotImplementedError(
            f"mpm_big_step's kernel indexes an env's {cells} cells and {sim.n_particles} "
            f"particles in 32 bits and takes 1 to 65535 envs, not {B}")
    if sim.device.type == "cuda":
        total = torch.cuda.get_device_properties(sim.device).total_memory
        need = scratch_bytes(sim, B)
        if need > total:
            raise NotImplementedError(
                f"mpm_big_step at {B} envs needs {need / 2**30:.1f} GiB of device memory, more "
                f"than the card's {total / 2**30:.1f} GiB")


def launch_big(sim, state):
    """K3-fwd on ``state``, the output of ``sim.prepare``: the ``conf.steps``
    substeps and the buffers' row 0 <- row steps. Returns the new state.
    Raises on anything the kernel does not take."""
    B, P, dev = state.x.shape[0], sim.n_particles, state.x.device
    fields, frame, vw = _inputs(sim, state, lambda s: check_supported_big(s, B))
    conf = sim.conf
    n_prim, steps = frame.shape[1], conf.steps
    rx, ry, rz = conf.res
    cells, cap = rx * ry * rz, list_capacity(sim)
    f32 = dict(dtype=torch.float32, device=dev)
    outs = [torch.empty_like(fields[n]) for n in ("x", "v", "C", "F", "J")]
    traj_pos = torch.empty((B, n_prim, steps + 1, 3), **f32)
    traj_rot = torch.empty((B, n_prim, steps + 1, 4), **f32)
    grid = torch.empty((B, cells, 4), **f32)
    mark = torch.empty((B, cells), dtype=torch.int32, device=dev)
    carry = torch.empty((B, N_COMP, P), **f32)
    rows = torch.empty((B, steps + 1, n_prim, ROW), **f32)
    touched = torch.empty((B, cap), dtype=torch.int32, device=dev)
    n_touched = torch.empty((B,), dtype=torch.int32, device=dev)
    grid_blocks = -(-min(cap, P) // THREADS)
    sdf_kinds = sum(SDF_KINDS[n] << i for i, n in enumerate(sim.sdf_names))
    device, stream = _device_and_stream(dev)
    n_launches = ctypes.c_int(0)
    lib = _lib()
    err = lib.mpm_big_step_launch(
        *(fields[n].data_ptr() for n in ("x", "v", "C", "F", "J")),
        *_material("mu", fields["mu"], B, P, dev),
        *_material("lamda", fields["lamda"], B, P, dev),
        *_material("yield_stress", fields["yield_stress"], B, P, dev),
        fields["friction"].data_ptr(), fields["friction"].stride(0),
        sim._h.data_ptr(), sim._material.data_ptr(), frame.data_ptr(), vw.data_ptr(),
        *(_ptr(t) for t in outs), traj_pos.data_ptr(), traj_rot.data_ptr(),
        grid.data_ptr(), mark.data_ptr(), carry.data_ptr(), rows.data_ptr(),
        touched.data_ptr(), n_touched.data_ptr(), cap, grid_blocks,
        B, P, n_prim, steps, rx, ry, rz, conf.n_grid, int(sim.use_position_control), sdf_kinds,
        conf.dt, conf.dx, -conf.dt * conf.p_vol * 4.0, conf.dx**2, conf.p_mass,
        *(float(g) for g in conf.gravity), device, stream, ctypes.byref(n_launches),
    )
    mpm_big_step.cuda_launches += n_launches.value
    if err != 0:
        msg = lib.unidom_cuda_error_string(err).decode()
        raise RuntimeError(
            f"mpm_big_step K3-fwd launch failed: {msg} (error {err}; B={B}, P={P}, "
            f"res={conf.res}, after {n_launches.value} launches)")
    mpm_big_step.launches += 1
    return _rebuild(state, (*outs, traj_pos, traj_rot))


def check_no_grad(state, action):
    """Raise ``NotImplementedError`` when a gradient is requested through
    K3-fwd: its backward (K3-bwd) is not ported."""
    if torch.is_grad_enabled() and _requires_grad(state, action):
        raise NotImplementedError(
            "mpm_big_step has no backward kernel: K3-bwd (unidom_tpu/ops/pallas/"
            "mpm_big_kernel.py:1076) comes with big-grid training. Run the big-grid envs forward "
            "only, under torch.no_grad() or on tensors that need no gradient")


def mpm_big_step(sim, state, action):
    """One macro step of ``sim`` for the batch ``state`` under ``action``
    (B, 6 n_primitive). CPU tensors take the plain PyTorch step; CUDA
    tensors take K3-fwd, which raises on anything it does not take and on a
    gradient request."""
    dev = state.x.device
    if dev.type == "cpu":
        return sim._step_plain(state, action)
    if dev.type != "cuda":
        raise ValueError(f"mpm_big_step runs on CPU or CUDA tensors, not {dev}")
    n_act = 6 * len(sim.sdf_names)
    if tuple(action.shape) != (state.x.shape[0], n_act):
        raise ValueError(f"action has shape {tuple(action.shape)}, expected (B, {n_act})")
    check_no_grad(state, action)
    return launch_big(sim, sim.prepare(state, action))


mpm_big_step.launches = 0
mpm_big_step.cuda_launches = 0
