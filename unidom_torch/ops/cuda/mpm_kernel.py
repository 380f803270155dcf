"""MPM macro step on the GPU: wrapper of the CUDA kernel
``unidom_torch/csrc/mpm_step.cu``.

Replaces the forward of ``build_mpm_step_kernel`` of
``unidom_tpu/ops/pallas/mpm_kernel.py`` (``fwd_call`` -> ``fwd_kernel``).
``mpm_step`` runs the plain PyTorch macro step
(``MPMSimulator._step_plain``) for CPU tensors; for CUDA tensors it runs
the macro step's head (``MPMSimulator.prepare``: scrub, action clamp and
clip, ``set_action``) and launches the kernel for the ``conf.steps``
substeps, or raises. ``mpm_step.launches`` counts kernel launches.

The macro step's backward (the kernel's, and the plain step's SVD) is not
ported yet, so on CUDA tensors that require a gradient ``mpm_step`` raises
instead of silently differentiating something else; on CPU tensors the
plain step's SVD raises in the backward pass. The particle state crosses in
the simulator's layout ((B, P, 3), (B, P, 3, 3), (B, P)); the primitives
are packed into two small tensors.
"""

import ctypes
import functools

import torch

from unidom_torch.ops.cuda._build import load_library
from unidom_torch.ops.gradops import tree_flatten

SOURCE = "mpm_step.cu"

# What the kernel's design holds (see the source's header): particles whose
# state lives in one block's shared memory, SDFs it evaluates, primitives.
MAX_PARTICLES = 1024
MAX_CELLS = 196608  # the fused TPU kernel's own ceiling (cells x 32 bytes <= 6 MB)
MAX_PRIMITIVES = 4
SDF_KINDS = {"box": 0, "container": 1}
PRIM_FRAME_COLS = 12  # position (3), rotation (4), size (3), friction, softness

_PTR, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.cache
def _lib():
    lib = load_library(SOURCE)
    lib.mpm_step_fwd.argtypes = (
        [_PTR] * 5 + [_PTR, _INT, _INT] * 3 + [_PTR, _INT] + [_PTR] * 4 + [_PTR] * 9
        + [_INT] * 10 + [_FLOAT] * 8 + [_INT, _PTR]
    )
    lib.mpm_step_fwd.restype = ctypes.c_int
    lib.mpm_step_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.mpm_step_smem_bytes.restype = ctypes.c_size_t
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


def check_supported(sim):
    """Raise unless the kernel takes ``sim``'s configuration."""
    conf = sim.conf
    cells = conf.res[0] * conf.res[1] * conf.res[2]
    bad = [n for n in sim.sdf_names if n not in SDF_KINDS]
    if bad:
        raise NotImplementedError(
            f"mpm_step's kernel evaluates the SDFs {sorted(SDF_KINDS)}, not {bad}")
    if len(sim.sdf_names) > MAX_PRIMITIVES:
        raise NotImplementedError(
            f"mpm_step's kernel takes at most {MAX_PRIMITIVES} primitives, not {len(sim.sdf_names)}")
    if sim.n_particles > MAX_PARTICLES or cells > MAX_CELLS:
        raise NotImplementedError(
            f"mpm_step's kernel holds at most {MAX_PARTICLES} particles and {MAX_CELLS} grid "
            f"cells, not {sim.n_particles} and {cells}: the big-grid kernel (K3, "
            "unidom_tpu/ops/pallas/mpm_big_kernel.py) that covers such configurations is "
            "ported in a later slice")


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


def launch(sim, state):
    """Launch the kernel on ``state``, the output of ``sim.prepare``: the
    ``conf.steps`` substeps and the buffers' row 0 <- row steps. Returns the
    new state. Raises on anything the kernel does not take."""
    check_supported(sim)
    conf = sim.conf
    x = state.x
    B, P, dev = x.shape[0], sim.n_particles, x.device
    n_prim, steps = len(state.primitives), conf.steps
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

    rx, ry, rz = conf.res
    cells = rx * ry * rz
    outs = [torch.empty_like(getattr(state, n)) for n in ("x", "v", "C", "F", "J")]
    traj_pos = torch.empty((B, n_prim, steps + 1, 3), dtype=torch.float32, device=dev)
    traj_rot = torch.empty((B, n_prim, steps + 1, 4), dtype=torch.float32, device=dev)
    grid = torch.empty((B, cells, 4), dtype=torch.float32, device=dev)
    mark = torch.empty((B, cells), dtype=torch.int32, device=dev)
    sdf_kinds = sum(SDF_KINDS[n] << i for i, n in enumerate(sim.sdf_names))
    gravity = [float(g) for g in conf.gravity]

    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.mpm_step_fwd(
            *(state.x.data_ptr(), state.v.data_ptr(), state.C.data_ptr(), state.F.data_ptr(),
              state.J.data_ptr()),
            *_material("mu", state.mu, B, P, dev),
            *_material("lamda", state.lamda, B, P, dev),
            *_material("yield_stress", state.yield_stress, B, P, dev),
            state.friction.data_ptr(), state.friction.stride(0),
            sim._h.data_ptr(), sim._material.data_ptr(), frame.data_ptr(), vw.data_ptr(),
            *(t.data_ptr() for t in outs), traj_pos.data_ptr(), traj_rot.data_ptr(),
            grid.data_ptr(), mark.data_ptr(),
            B, P, n_prim, steps, rx, ry, rz, conf.n_grid, int(sim.use_position_control),
            sdf_kinds,
            conf.dt, conf.dx, -conf.dt * conf.p_vol * 4.0, conf.dx**2, conf.p_mass, *gravity,
            dev.index, torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        msg = lib.unidom_cuda_error_string(err).decode()
        raise RuntimeError(
            f"mpm_step kernel launch failed: {msg} (error {err}; B={B}, P={P}, res={conf.res}, "
            f"dynamic shared memory {lib.mpm_step_smem_bytes(P, cells)} bytes)")
    mpm_step.launches += 1
    x, v, C, F, J = outs
    prims = tuple(p.replace(position=traj_pos[:, i], rotation=traj_rot[:, i])
                  for i, p in enumerate(state.primitives))
    return state.replace(x=x, v=v, C=C, F=F, J=J, primitives=prims)


def _requires_grad(state, action):
    return action.requires_grad or any(t.requires_grad for t in tree_flatten(state)[0])


def mpm_step(sim, state, action):
    """One macro step of ``sim`` for the batch ``state`` under ``action``
    (B, 6 n_primitive). CPU tensors take the plain PyTorch step; CUDA tensors
    take the kernel, which raises on anything it does not take."""
    dev = state.x.device
    if dev.type == "cpu":
        return sim._step_plain(state, action)
    if dev.type != "cuda":
        raise ValueError(f"mpm_step runs on CPU or CUDA tensors, not {dev}")
    n_act = 6 * len(sim.sdf_names)
    if tuple(action.shape) != (state.x.shape[0], n_act):
        raise ValueError(f"action has shape {tuple(action.shape)}, expected (B, {n_act})")
    if torch.is_grad_enabled() and _requires_grad(state, action):
        raise NotImplementedError(
            "mpm_step's backward kernel (K2-bwd, unidom_tpu/ops/pallas/mpm_kernel.py:780) is "
            "ported with the whip_rope training slice; on CUDA tensors the macro step runs "
            "forward only, under torch.no_grad() or on tensors that need no gradient")
    return launch(sim, sim.prepare(state, action))


mpm_step.launches = 0
