"""MPM macro step on big grids on the GPU: wrapper of the CUDA kernels of
``unidom_torch/csrc/mpm_big_step.cu``.

Replaces ``build_mpm_big_step_kernel`` in
``unidom_tpu/ops/pallas/mpm_big_kernel.py``: K3-fwd (``fwd_call`` ->
``fwd_kernel``), one macro step of ``conf.steps`` substeps for the
configurations that K2 (``mpm_kernel.py``, one block per env) does not take,
such as pour_soup (7,694 particles, a 128x64x128 grid) and
shape_elasto_plastic (23,940 particles), writing the carry every K substeps
when a gradient is wanted; K3-seg (``seg_hist_call``, a segment's carries
recomputed from its checkpoint, each substep's grid recorded) and K3-bwd
(``bwd_step_call`` under the reverse scan ``_core_bwd``, the macro step's
adjoint, with K3-seg as a phase of each segment when K > 1: the reversed
substep then rebuilds its grid from K3-seg's record and runs no P2G).

``mpm_big_step`` runs the plain PyTorch macro step
(``MPMSimulator._step_plain``, differentiated by autograd) for CPU tensors.
For CUDA tensors it runs the macro step's head (``MPMSimulator.prepare``:
scrub, action clamp and clip, ``set_action``, in torch) and the kernels, or
raises: under ``no_grad`` (or when nothing requires a gradient) K3-fwd
without history; otherwise ``_MPMBigStepFn``, whose backward launches
K3-bwd. Nothing falls back to autograd through the plain step.
``mpm_big_step.launches`` counts macro steps through K3-fwd (the unit of the
Pallas kernel), ``mpm_big_step.bwd_launches`` those through K3-bwd,
``mpm_big_step.seg_launches`` the K3-seg phases that K3-bwd ran (plus calls
of ``mpm_big_step_seg``), ``mpm_big_step.cuda_launches`` the CUDA launches
inside all of them (4 x steps + 2 per K3-fwd macro step). The kernels sort
the particles by bin each substep and sum P2G's (and G2P's adjoint's)
shares over a bin before their atomics: in float in a rollout and in K3-seg,
in double in K3-fwd with checkpoints and K3-bwd's recompute at K = 1 (see
the source); ``p2g_sums`` runs that double P2G alone on a carry of the
history (``recorded_grids`` spreads K3-seg's record over the grid).

The particle state crosses in the simulator's layout ((B, P, 3),
(B, P, 3, 3), (B, P)); the kernels keep it per env in device memory as
(B, 25, P), component-major, with a (B, cells) float4 grid and mark, a
touched-cell list per env and the primitives' frames, all scratch from
``torch.empty``, but for what must start at 0: the sort's counters, and in a
rollout and K3-seg P2G's float sums and the marks, which they leave at 0 and
the simulator keeps for its next call; the history is (B, ceil(steps / K),
25, P), and K3-seg's record of a segment's grids K slots (``record_bytes``).
"""

import ctypes
import functools
import math
import weakref
from typing import NamedTuple

import torch

from unidom_torch.ops.cuda._build import load_library
from unidom_torch.ops.cuda.mpm_kernel import (
    MAX_PRIMITIVES,
    N_COMP,
    _device_and_stream,
    _inputs,
    _material,
    _pointer_array,
    _ptr,
    _rebuild,
    _requires_grad,
    checkpoint_stride,
    pack_sdf_kinds,
)

SOURCE = "mpm_big_step.cu"

THREADS = 256  # the kernel's threads per block (NT in the source)
ROW = 7  # a primitive's frame in the kernel's rows: position 3, rotation 4
INT_MAX = 2**31 - 1

_PTR, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FWD, _SEG, _BWD, _P2G = 0, 1, 2, 3
# K3's kernels as mpm_big_step_kernel_info numbers them
KERNELS = ("zero and count", "bins' scan", "P2G (gradient)", "grid ops (gradient)",
           "G2P (gradient)", "G2P adjoint", "grid ops adjoint", "particle adjoint",
           "P2G (rollout)", "grid ops (rollout)", "G2P (rollout)", "rebuild (K3-bwd)")


@functools.cache
def _lib():
    lib = load_library(SOURCE)
    lib.mpm_big_step_launch.argtypes = (
        [_PTR] * 5 + [_PTR, _INT, _INT] * 3 + [_PTR, _INT] + [_PTR] * 4 + [_PTR] * 10
        + [_PTR] * 5 + [_INT, _INT] + [_INT] * 10 + [_FLOAT] * 8 + [_INT, _PTR]
        + [_PTR, _INT, _INT, _INT, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _INT, _INT, _PTR, _PTR,
           _PTR]
    )
    lib.mpm_big_step_launch.restype = ctypes.c_int
    lib.mpm_big_step_kernel_info.argtypes = [_INT, _INT, _PTR]
    lib.mpm_big_step_kernel_info.restype = ctypes.c_int
    lib.unidom_cuda_error_string.argtypes = [ctypes.c_int]
    lib.unidom_cuda_error_string.restype = ctypes.c_char_p
    return lib


def kernel_info(which, device):
    """What the card makes of K3's kernel ``which`` (an index into KERNELS):
    registers and local memory (bytes) per thread, static shared memory
    (bytes), threads per block and blocks per SM (the occupancy API)."""
    out = (ctypes.c_int * 5)()
    err = _lib().mpm_big_step_kernel_info(which, device, out)
    if err != 0:
        raise RuntimeError(f"K3 kernel info for {KERNELS[which]}: "
                           f"{_lib().unidom_cuda_error_string(err).decode()} (error {err})")
    return dict(zip(("registers", "local_bytes", "static_smem", "threads", "blocks_per_sm"),
                    out))


def list_capacity(sim):
    """Slots of an env's touched-cell list: a cell enters once per substep,
    and at most 27 per particle do."""
    rx, ry, rz = sim.conf.res
    return min(27 * sim.n_particles, rx * ry * rz)


# K3-bwd's scratch per env beside K3-fwd's, laid out as the source reads it:
# the grid cotangent (4 floats per cell), the carry's
# cotangent (25 per particle) and the current frames' (7 per primitive of
# MAX_PRIMITIVES); in double, G2P's adjoint's sums (4 per cell), the Lame
# and yield cotangents (3 per particle) and the env's sums (N_EACC).
N_EACC = MAX_PRIMITIVES * 22 + 1 + 3


def bwd_scratch(sim):
    """(floats, doubles) of K3-bwd's scratch per env."""
    rx, ry, rz = sim.conf.res
    P = sim.n_particles
    return (4 * rx * ry * rz + N_COMP * P + MAX_PRIMITIVES * 7,
            4 * rx * ry * rz + 3 * P + N_EACC)


def record_bytes(sim, K):
    """Bytes per env of K3-seg's record of a segment's grids for K3-bwd:
    K slots, one per substep of a segment (with K = 1, the slot K3-bwd's
    recompute writes), each holding list_capacity touched cells (their
    index and their momentum and mass before the grid ops, 20 B), their
    count and the particles' bin order (4 B each). A slot is sized by the
    list's capacity, not by the substep's touched count, which only the
    card knows after P2G."""
    return K * (20 * list_capacity(sim) + 4 + 4 * sim.n_particles)


class Record(NamedTuple):
    """Views of a record (``_record``'s buffer), slot j of env b at [j, b]:
    each touched cell's momentum and mass before the grid ops (K, B, cap,
    4), the touched cells (K, B, cap), their count (K, B) and the particles
    in bin order (K, B, P)."""

    pre: torch.Tensor
    cells: torch.Tensor
    n: torch.Tensor
    perm: torch.Tensor


def _record(sim, B, K, dev, dtype=torch.float32):
    """The record's buffer of K slots for B envs, laid out as the source
    reads it (the float4s first, then the ints), and its views."""
    cap, P = list_capacity(sim), sim.n_particles
    buf = torch.empty((K * B * (5 * cap + 1 + P),), dtype=dtype, device=dev)
    n_pre = K * B * cap * 4
    ints = buf[n_pre:].view(torch.int32)
    n_cells = K * B * cap
    return buf, Record(buf[:n_pre].view(K, B, cap, 4), ints[:n_cells].view(K, B, cap),
                       ints[n_cells:n_cells + K * B].view(K, B),
                       ints[n_cells + K * B:n_cells + K * B * (1 + P)].view(K, B, P))


def recorded_grids(sim, rec, L):
    """Slots 0 .. L - 1 of ``rec`` (a Record) spread over the grid: (the
    momentum and mass before the grid ops, (L, B, cells, 4), 0 off the
    touched cells; the touched cells, (L, B, cells) bool)."""
    K, B, cap = rec.cells.shape
    cells = math.prod(sim.conf.res)
    grids = torch.zeros((L, B, cells, 4), dtype=rec.pre.dtype, device=rec.pre.device)
    marks = torch.zeros((L, B, cells), dtype=torch.bool, device=rec.pre.device)
    for j in range(L):
        for b in range(B):
            n = int(rec.n[j, b])
            idx = rec.cells[j, b, :n].long()
            grids[j, b, idx] = rec.pre[j, b, :n]
            marks[j, b, idx] = True
    return grids, marks


def bin_scratch(sim):
    """(ints per env of the sort by bin, bins, bin-list slots): each bin's
    counter (bins: the stencil's base node over (rx + 2) x (ry + 2) x
    (rz + 2), and one for the particles no node of whose stencil lies in the
    grid), the bin list's count and slots, and each particle's bin, rank in
    it and slot in bin order."""
    rx, ry, rz = sim.conf.res
    P = sim.n_particles
    n_keys = (rx + 2) * (ry + 2) * (rz + 2) + 1
    bin_cap = min(P, n_keys)
    return n_keys + 1 + bin_cap + 3 * P, n_keys, bin_cap


def kept_scratch_bytes(sim):
    """Bytes per env of the scratch a simulator keeps zeroed between calls
    (``_rollout_scratch``): P2G's float sums (16 B per cell), the marks (4 B
    per cell) and the sort's ints (``bin_scratch``)."""
    return 20 * math.prod(sim.conf.res) + 4 * bin_scratch(sim)[0]


def scratch_bytes(sim, B, ckpt_stride=None):
    """Device memory of one K3-fwd macro step at ``B`` envs: the outputs
    and the kernel's scratch (the float4 grid and marks, carry, touched
    lists, frames, the sort by bin), and a rollout's P2G sums in float (16 B
    per cell); with ``ckpt_stride`` K, instead what a gradient adds: P2G's
    sums in double (32 B per cell), the history of a
    checkpoint every K substeps, the output and input cotangents, K3-bwd's
    scratch, K3-seg's record of K substeps' grids (``record_bytes``) and, for
    K > 1, a segment of K carries and the scratch that K3-seg sums P2G in
    (``kept_scratch_bytes``): kept from one call to the next, it is still
    held while K3-fwd with checkpoints holds its own sums, marks and sort."""
    conf = sim.conf
    rx, ry, rz = conf.res
    P, n_prim = sim.n_particles, len(sim.sdf_names)
    per_env = (rx * ry * rz * 20 + 4 * list_capacity(sim) + 4 + 2 * 4 * N_COMP * P
               + 4 * (conf.steps + 1) * n_prim * (ROW + 7) + 4 * bin_scratch(sim)[0])
    if ckpt_stride is None:
        per_env += 16 * rx * ry * rz
    else:
        K = ckpt_stride
        floats, doubles = bwd_scratch(sim)
        per_env += (4 * math.ceil(conf.steps / K) * N_COMP * P + 2 * 4 * N_COMP * P
                    + 32 * rx * ry * rz + 4 * floats + 8 * doubles + 4
                    + record_bytes(sim, K)
                    + (4 * K * N_COMP * P + kept_scratch_bytes(sim) if K > 1 else 0))
    return B * per_env


def check_supported_big(sim, B=None, ckpt_stride=None):
    """Raise unless K3 takes ``sim``'s configuration at ``B`` envs (by
    default the simulator's batch): the SDFs it evaluates, at most
    MAX_PRIMITIVES primitives, offsets within an env that fit 32 bits, and,
    on a GPU, the device memory (with the backward's at stride
    ``ckpt_stride`` when one is given, K3-seg's record included), before
    anything is built or launched."""
    conf = sim.conf
    B = sim.batch_size if B is None else B
    cells = conf.res[0] * conf.res[1] * conf.res[2]
    pack_sdf_kinds(sim.sdf_names)
    if cells > INT_MAX or N_COMP * sim.n_particles > INT_MAX or not 1 <= B <= 65535:
        raise NotImplementedError(
            f"mpm_big_step's kernel indexes an env's {cells} cells and {sim.n_particles} "
            f"particles in 32 bits and takes 1 to 65535 envs, not {B}")
    if sim.device.type == "cuda":
        total = torch.cuda.get_device_properties(sim.device).total_memory
        need = scratch_bytes(sim, B, ckpt_stride)
        if need > total:
            raise NotImplementedError(
                f"mpm_big_step at {B} envs needs {need / 2**30:.1f} GiB of device memory, more "
                f"than the card's {total / 2**30:.1f} GiB")


# A rollout's scratch that must be 0 on entry (P2G's float sums, the marks
# and the sort's counters), per simulator: K3-fwd leaves it at 0 again on
# exit, so it is zeroed once and kept for the next rollout at the same batch
# size on the same device and stream (one set per simulator). K3-seg sums in
# float too and leaves it at 0: it shares the set.
_ROLLOUT_SCRATCH = weakref.WeakKeyDictionary()


def _rollout_scratch(sim, B, dev, key):
    """(fsum, mark, bin_ints) of a rollout of ``sim`` at ``B`` envs on
    ``dev``, kept under ``key`` (batch size, device and stream): the sums,
    the marks and the sort's counters (``zeroed_parts``) are 0."""
    kept = _ROLLOUT_SCRATCH.get(sim)
    if kept is not None and kept[0] == key:
        return kept[1]
    _ROLLOUT_SCRATCH.pop(sim, None)
    cells = math.prod(sim.conf.res)
    scratch = (torch.zeros((B, cells, 4), dtype=torch.float32, device=dev),
               torch.zeros((B, cells), dtype=torch.int32, device=dev),
               torch.zeros((B * bin_scratch(sim)[0],), dtype=torch.int32, device=dev))
    _ROLLOUT_SCRATCH[sim] = (key, scratch)
    return scratch


def zeroed_parts(sim, scratch):
    """What of a kept rollout ``scratch`` must be 0 between rollouts: the
    float sums, the marks and the sort's counters (the bins' and the bin
    lists' counts, the first B (n_keys + 1) of its ints)."""
    fsum, mark, bin_ints = scratch
    return fsum, mark, bin_ints[:fsum.shape[0] * (bin_scratch(sim)[1] + 1)]


def _call_big(sim, fields, frame, vw, *, what, K=1, hist=None, outs=(None,) * 7, segment=0,
              seg_out=None, bwd_in=None, bwd_out=None, gacc=None, mark=None, record=None):
    """One ``mpm_big_step_launch``: K3-fwd, K3-seg, K3-bwd or the
    gradient's P2G alone (``what``) on the forward's inputs ``fields`` (x,
    v, C, F, J, mu, lamda, yield_stress, friction; x..J may be None but for
    K3-fwd); with a history, ``gacc`` and ``mark``, when given, are the P2G
    sums' and marks' scratch. A rollout (no history) sums P2G in float in
    the simulator's kept scratch and takes neither, as K3-seg does (alone or
    in K3-bwd at K > 1). K3-seg and K3-bwd record K substeps' grids in
    ``record`` (``_record``'s buffer; a new one when None). Returns the CUDA
    launches."""
    # P2G summed in float in the simulator's kept scratch: a rollout, K3-seg
    float_sums = hist is None or what == _SEG or (what == _BWD and K > 1)
    if float_sums and (gacc is not None or mark is not None):
        raise ValueError("a K3-fwd rollout or K3-seg sums P2G in the simulator's kept float "
                         "scratch: it takes no gacc or mark")
    conf = sim.conf
    B, P, dev = frame.shape[0], sim.n_particles, frame.device
    n_prim, steps = frame.shape[1], conf.steps
    rx, ry, rz = conf.res
    cells, cap = rx * ry * rz, list_capacity(sim)
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    grid = torch.empty((B, cells, 4), **f32)
    # the sort by bin, whose counters start at 0, and P2G's sums: in double
    # with a gradient, in float in a rollout, whose sums and marks start at 0
    # too (see the source)
    per_env, n_keys, bin_cap = bin_scratch(sim)
    device, stream = _device_and_stream(dev)
    fsum = None
    if float_sums:
        fsum, mark, bin_ints = _rollout_scratch(sim, B, dev, (B, dev, stream))
    else:
        bin_ints = torch.zeros((B * per_env,), **i32)
        if gacc is None:
            gacc = torch.empty((B, cells, 4), dtype=torch.float64, device=dev)
        if mark is None:
            mark = torch.empty((B, cells), **i32)
    carry = torch.empty((B, N_COMP, P), **f32)
    rows = torch.empty((B, steps + 1, n_prim, ROW), **f32)
    touched = torch.empty((B, cap), dtype=torch.int32, device=dev)
    n_touched = torch.empty((B,), dtype=torch.int32, device=dev)
    bwd_floats = bwd_doubles = bwd_ints = None
    if what == _BWD:
        floats, doubles = bwd_scratch(sim)
        bwd_floats = torch.empty((B * floats,), **f32)
        bwd_doubles = torch.empty((B * doubles,), dtype=torch.float64, device=dev)
        bwd_ints = torch.empty((B,), **i32)
    if what in (_SEG, _BWD) and record is None:
        record = _record(sim, B, K, dev)[0]
    grid_blocks = -(-min(cap, P) // THREADS)
    sdf_kinds = pack_sdf_kinds(sim.sdf_names)
    n_launches = ctypes.c_int(0)
    lib = _lib()
    err = lib.mpm_big_step_launch(
        *(_ptr(fields[n]) for n in ("x", "v", "C", "F", "J")),
        *_material("mu", fields["mu"], B, P, dev),
        *_material("lamda", fields["lamda"], B, P, dev),
        *_material("yield_stress", fields["yield_stress"], B, P, dev),
        fields["friction"].data_ptr(), fields["friction"].stride(0),
        sim._h.data_ptr(), sim._material.data_ptr(), frame.data_ptr(), vw.data_ptr(),
        *(_ptr(t) for t in outs), grid.data_ptr(), _ptr(gacc), _ptr(fsum), mark.data_ptr(),
        carry.data_ptr(),
        rows.data_ptr(), touched.data_ptr(), n_touched.data_ptr(), cap, grid_blocks,
        B, P, n_prim, steps, rx, ry, rz, conf.n_grid, int(sim.use_position_control), sdf_kinds,
        conf.dt, conf.dx, -conf.dt * conf.p_vol * 4.0, conf.dx**2, conf.p_mass,
        *(float(g) for g in conf.gravity), device, stream,
        _ptr(hist), K, what, segment, _ptr(seg_out), _pointer_array(bwd_in),
        _pointer_array(bwd_out), _ptr(bwd_floats), _ptr(bwd_doubles), _ptr(bin_ints), n_keys,
        bin_cap, _ptr(bwd_ints), _ptr(record), ctypes.byref(n_launches),
    )
    mpm_big_step.cuda_launches += n_launches.value
    if err != 0:
        if float_sums:  # the kept scratch may no longer be 0
            _ROLLOUT_SCRATCH.pop(sim, None)
        msg = lib.unidom_cuda_error_string(err).decode()
        name = ("K3-fwd", "K3-seg", "K3-bwd", "K3's P2G")[what]
        raise RuntimeError(
            f"mpm_big_step {name} launch failed: {msg} (error {err}; B={B}, P={P}, "
            f"res={conf.res}, K={K}, after {n_launches.value} launches)")
    return n_launches.value


def _history(sim, B, K):
    return torch.empty((B, math.ceil(sim.conf.steps / K), N_COMP, sim.n_particles),
                       dtype=torch.float32, device=sim._h.device)


def _forward(sim, fields, frame, vw, K=1, hist=None, gacc=None, mark=None):
    """K3-fwd. Returns (x, v, C, F, J, traj_pos, traj_rot)."""
    B, n_prim, steps = frame.shape[0], frame.shape[1], sim.conf.steps
    f32 = dict(dtype=torch.float32, device=frame.device)
    outs = [torch.empty_like(fields[n]) for n in ("x", "v", "C", "F", "J")]
    traj_pos = torch.empty((B, n_prim, steps + 1, 3), **f32)
    traj_rot = torch.empty((B, n_prim, steps + 1, 4), **f32)
    _call_big(sim, fields, frame, vw, what=_FWD, K=K, hist=hist,
              outs=(*outs, traj_pos, traj_rot), gacc=gacc, mark=mark)
    mpm_big_step.launches += 1
    return (*outs, traj_pos, traj_rot)


def _big_inputs(sim, state, ckpt_stride=None):
    B = state.x.shape[0]
    return _inputs(sim, state, lambda s: check_supported_big(s, B, ckpt_stride))


def launch_big(sim, state, ckpt_stride=None, gacc=None, mark=None):
    """K3-fwd on ``state``, the output of ``sim.prepare``: the ``conf.steps``
    substeps and the buffers' row 0 <- row steps. Returns the new state, or
    with ``ckpt_stride`` K, (the new state, the history of a checkpoint
    every K substeps); ``gacc`` and ``mark`` then, when given, keep the last
    substep's P2G sums and marks. Raises on anything the kernel does not
    take."""
    fields, frame, vw = _big_inputs(sim, state, ckpt_stride)
    if ckpt_stride is None:
        return _rebuild(state, _forward(sim, fields, frame, vw))
    hist = _history(sim, frame.shape[0], ckpt_stride)
    outs = _forward(sim, fields, frame, vw, ckpt_stride, hist, gacc=gacc, mark=mark)
    return _rebuild(state, outs), hist


def mpm_big_step_seg(sim, state, hist, ckpt_stride, segment, with_record=False):
    """K3-seg alone: segment ``segment`` of the macro step from ``state``
    (the output of ``sim.prepare``) recomputed from its checkpoint in
    ``hist`` (``launch_big(..., ckpt_stride)``'s), each of its L carries'
    grid recorded as K3-bwd reads it. Returns its L input carries, (B, L,
    25, P), and with ``with_record`` also the record (a Record of K slots,
    the first L written)."""
    fields, frame, vw = _big_inputs(sim, state)
    K, steps = ckpt_stride, sim.conf.steps
    B, dev = frame.shape[0], frame.device
    L = min(K, steps - segment * K)
    out = torch.empty((B, L, N_COMP, sim.n_particles), dtype=torch.float32, device=dev)
    buf, rec = _record(sim, B, K, dev)
    _call_big(sim, fields, frame, vw, what=_SEG, K=K, hist=hist, segment=segment, seg_out=out,
              record=buf)
    mpm_big_step.seg_launches += 1
    return (out, rec) if with_record else out


def p2g_sums(sim, state, hist, ckpt_stride, slot):
    """The gradient's P2G in double alone (the path of K3-fwd with
    checkpoints and K3-bwd's recompute at K = 1) on carry ``slot`` of ``hist`` (``launch_big(...,
    ckpt_stride)``'s) from ``state``, the output of ``sim.prepare``. Returns
    (the sums of momentum and mass, (B, cells, 4) float64, and the marks of
    the touched cells, (B, cells) int32), 0 where no stencil reached."""
    fields, frame, vw = _big_inputs(sim, state)
    B, dev = frame.shape[0], frame.device
    rx, ry, rz = sim.conf.res
    gacc = torch.zeros((B, rx * ry * rz, 4), dtype=torch.float64, device=dev)
    mark = torch.zeros((B, rx * ry * rz), dtype=torch.int32, device=dev)
    _call_big(sim, fields, frame, vw, what=_P2G, K=ckpt_stride, hist=hist, segment=slot,
              gacc=gacc, mark=mark)
    return gacc, mark


class _MPMBigStepFn(torch.autograd.Function):
    """One big-grid macro step's substeps through K3-fwd, with K3-bwd as its
    backward. Inputs: the simulator, the checkpoint stride, x, v, C, F, J,
    mu, lamda, yield_stress, friction, the primitives' frame and per-substep
    v and w. Outputs: x, v, C, F, J and the (B, n_prim, steps + 1, 3 / 4)
    position and rotation rows."""

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


def _backward(sim, fields, frame, vw, hist, K, cots):
    """K3-bwd: the cotangents of x, v, C, F, J, mu, lamda, yield_stress,
    friction, frame and vw from those of the outputs ``cots``."""
    B, P, dev = frame.shape[0], sim.n_particles, frame.device
    f32 = dict(dtype=torch.float32, device=dev)
    grads = [torch.empty((B, P, 3), **f32), torch.empty((B, P, 3), **f32),
             torch.empty((B, P, 3, 3), **f32), torch.empty((B, P, 3, 3), **f32),
             torch.empty((B, P), **f32)]
    grads += [torch.empty(fields[n].shape, **f32) for n in ("mu", "lamda", "yield_stress")]
    grads += [torch.empty((B, 1), **f32), torch.empty_like(frame), torch.empty_like(vw)]
    seg = torch.empty((B, K, N_COMP, P), **f32) if K > 1 else None
    _call_big(sim, fields, frame, vw, what=_BWD, K=K, hist=hist, seg_out=seg, bwd_in=cots,
              bwd_out=grads)
    mpm_big_step.bwd_launches += 1
    if K > 1:
        mpm_big_step.seg_launches += math.ceil(sim.conf.steps / K)
    return grads


def kernel_step_big(sim, state, ckpt_stride=None):
    """The substeps of ``state`` (the output of ``sim.prepare``) through
    ``_MPMBigStepFn``: K3-fwd with a checkpoint every ``ckpt_stride``
    substeps (by default ``checkpoint_stride``'s rule) and K3-bwd in the
    backward."""
    B, P, steps = state.x.shape[0], sim.n_particles, sim.conf.steps
    K = checkpoint_stride(B, P, steps) if ckpt_stride is None else int(ckpt_stride)
    if not 1 <= K <= steps:
        raise ValueError(f"ckpt_stride must be in [1, {steps}], not {K}")
    fields, frame, vw = _big_inputs(sim, state, K)
    outs = _MPMBigStepFn.apply(sim, K, *(fields[n] for n in ("x", "v", "C", "F", "J", "mu",
                                                               "lamda", "yield_stress",
                                                               "friction")),
                               frame, vw)
    return _rebuild(state, outs)


def mpm_big_step(sim, state, action, ckpt_stride=None):
    """One macro step of ``sim`` for the batch ``state`` under ``action``
    (B, 6 n_primitive). CPU tensors take the plain PyTorch step (autograd
    differentiates it; ``ckpt_stride`` does not apply); CUDA tensors take
    the kernels, which raise on anything they do not take. ``ckpt_stride``
    overrides the checkpoint stride rule of a differentiable step."""
    dev = state.x.device
    if dev.type == "cpu":
        return sim._step_plain(state, action)
    if dev.type != "cuda":
        raise ValueError(f"mpm_big_step runs on CPU or CUDA tensors, not {dev}")
    n_act = 6 * len(sim.sdf_names)
    if tuple(action.shape) != (state.x.shape[0], n_act):
        raise ValueError(f"action has shape {tuple(action.shape)}, expected (B, {n_act})")
    if torch.is_grad_enabled() and _requires_grad(state, action):
        return kernel_step_big(sim, sim.prepare(state, action), ckpt_stride)
    return launch_big(sim, sim.prepare(state, action))


mpm_big_step.launches = 0
mpm_big_step.bwd_launches = 0
mpm_big_step.seg_launches = 0
mpm_big_step.cuda_launches = 0
