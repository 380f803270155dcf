"""Smoke run of unidom_torch on one CUDA GPU.

Builds the cloth robot-step kernels (forward and backward) from
``unidom_torch/csrc``, holds each against its plain PyTorch version on the
card, and drives the port's two paths at full width (fold_cloth3: 16x32
cloth, 50 substeps per robot step, 40 robot steps per macro step, 1024
envs) through them:
  - the policy rollout (``run_eval``, 4 macro steps, 160 forward launches),
    checked against the plain step, and the forward kernel's times;
  - APG training (``train`` and ``build_apg``/``minimize``, episode length 3,
    120 forward and 120 backward launches per update), with the policy
    gradient of one update held against the plain step's in float32 and
    float64 (on the tiny cloth of the CPU tests and at full width), the
    training env-steps/s and peak memory, and the backward kernel's times.
Both kernels are also held against the plain step on a cloth of more cells
than a block has threads, at the grid's corner (``BORDER_HW``), and on
fold_tshirt's 72 x 78 cloth (N = 180), whose rollout then runs through
K1-fwd (``[tshirt]``). ``[k1-design]`` prints what the card makes of each
K1 kernel (registers, local memory, shared memory, blocks per SM) and its
times per width, per variant and with the substeps halved. One rollout
and one update at 1024 envs run under ``torch.profiler``: device busy share
and device time by kernel.

It also builds the MPM macro-step kernel (K2-fwd) and drives the port's MPM
path: whip_rope (n_grid 64, a 32^3 focus grid, 67 particles, 70 substeps per
macro step) at 1024 envs:
  - one macro step from a perturbed state, the kernel against the float32
    and float64 plain steps, with a witness that the gate can fail;
  - one macro step of configurations whip_rope does not exercise: shape_rope
    (582 plastic particles, a 64x6x64 grid, 133 substeps, collision) and the
    small configs of tests/test_pallas_mpm.py (water, von Mises, a bowl);
  - the policy rollout (``run_eval``, 70 macro steps, 70 K2-fwd launches),
    three of its macro steps replayed through the plain steps; its times at
    1024 and 4096 envs beside the plain step and the bound; the rollout's
    env-steps/s and profile.
and the MPM training path through K2-fwd with checkpoints, K2-bwd (the
macro step's adjoint) and K2-seg (segment recompute, a phase of K2-bwd):
  - one macro step's VJP at 1024 envs at K = 1 and at the stride rule's
    K = 9, against the float32 and float64 plain VJPs, with a witness that
    the gate can fail; one K2-seg segment against the plain forward; K2-bwd
    on water, sigma-clip and von Mises under position control;
  - whip_rope APG training (``train`` and ``minimize``, ep_len 3, 1024 envs:
    3 K2-fwd, 3 K2-bwd and 24 K2-seg phases per update), one update's policy
    gradient against the plain step's, the ep_len-70 update with truncation
    10, K2-bwd's times and bound, and a profile of one update.
and it builds the big-grid macro-step kernel (K3-fwd) and drives the port's
big-grid path: pour_soup (n_grid 128, a 128x64x128 grid, 7,694 particles of
water, elastic tofu and vegetables, two bowls) at 32 envs and
shape_elasto_plastic (23,940 sigma-clip particles on a 48x32x48 grid) at 16:
  - one macro step of each, and of a config with more particles than K2
    holds on a grid K2 takes, against the float32 and float64 plain steps,
    with the mu = lamda = 0 witness;
  - the pour_soup rollout (``run_eval``, 120 macro steps, 120 K3-fwd calls),
    three of its macro steps replayed through the plain steps, its
    env-steps/s, peak memory and profile; the shape_elasto_plastic rollout
    (6 macro steps, 120 K3-fwd calls); pour_water's (K2) at 256 envs;
  - K3-fwd's times at pour_soup 8, 32 and 64 envs and shape_elasto_plastic
    16, beside the plain step and the bound.
and the big-grid and shape_rope training paths through K2-bwd under SDF
collision, K3-fwd with checkpoints, K3-seg and K3-bwd:
  - K2-bwd under collision: shape_rope (64 envs, 133 substeps) at K = 1 and
    12 and a bowl of water (256 envs), against the float32 and float64
    plain VJPs with witnesses; zero cotangents stay zero;
  - K3-bwd with K3-seg: pour_soup, shape_elasto_plastic and the P > 1024
    config at K = 1 and at the stride rule's K of the training width, every
    input cotangent held to the same gate; K3-seg alone on the three configs
    against the plain forward, and the grids it records for K3-bwd against
    the checkpointing forward's P2G;
  - one shape_elasto_plastic update (``minimize``, 16 envs, ep_len 3: 60
    K3-fwd, 60 K3-bwd and 240 K3-seg phases), its env-steps/s, peak memory
    and profile, and one update's policy gradient against the plain step's;
  - one shape_rope ``train`` iteration at 64 envs, its resets through
    ``host_reset`` (2 pushes of 30 K2-fwd calls, no K2-bwd);
  - K3-bwd's times at shape_elasto_plastic 16 and pour_soup 8 and 32 envs,
    K3-seg's, and K2-bwd's, K2-fwd's and K2-seg's (launched as K2-bwd's
    phase) under collision on shape_rope at 64 envs, beside the plain VJP
    and the bounds; a profile
    of one shape_rope ``train`` iteration.
``[k2-design]`` and ``[k3-design]`` print what the card makes of the MPM
kernels (registers, local memory, shared memory per CTA, CTAs per cluster,
blocks per SM); K2-fwd's and K2-bwd's times on shape_rope at 16, 64 and 256
envs (the other cluster sizes at 64) and whip_rope at 1024, with K2-fwd's
substep split into its phases, and each of those launches (clusters of 1,
2, 4 and 8) held to the float64 plain step; K3-fwd's rollout on pour_soup
at 32 envs and shape_elasto_plastic at 16 and its device time by launch, and
the scratch it keeps for the next rollout back at 0; K3-bwd's on shape_elasto_plastic at 8 and 16,
its device time by launch (no P2G or scan of its own at K > 1), and the
grids K3-seg records against the checkpointing forward's P2G.
``train_envs_phases`` trains every DaXBench env that no phase above trains,
each phase checking its launches against its ep_len, stride rule and
reset, and printing env-steps/s, peak memory and a [profile]:
  - [soup-train]: pour_soup updates at 8, 32 and 64 envs (3 K3-fwd with
    checkpoints, 3 K3-bwd and 15 K3-seg phases each), and one update's
    policy gradient at 4 envs against the float32 and float64 plain steps;
  - [water-train]: pour_water's ``train`` at 256 envs (2 iterations and an
    eval of 16 envs: 206 K2-fwd, 6 K2-bwd, 30 K2-seg phases), an update,
    and the policy-gradient gate at 8 envs;
  - [rope-hard-train]: shape_rope_hard's host reset (10 pushes, 300 K2-fwd)
    and an update at 64 envs under the box's collision;
  - [tshirt-train]: a fold_tshirt update at 64 envs through K1-bwd at 72 x 78;
  - [unfold-train]: ``train`` of unfold_cloth1 and unfold_cloth3 at 1024
    envs, their resets' folds (40 and 120 K1-fwd each) included;
  - [para-train]: ``train_para`` of fold_cloth1_para at 1024 envs with its
    10-point stiffness sweep of 64 envs: every launch's stiffness against
    the iteration's draw or the sweep point, the sweep's rewards not all
    equal, the cloth kernels' library loaded once.
The counters show that each path launches its own kernels and no other.

    python3 chip_smoke.py        # from the repository root, on a machine with a GPU

It prints one line per phase with its seconds, the card's name and power
limit, a JSON line of the kernels, and as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
It exits non-zero, without that line, when there is no CUDA device, when
the package is not beside it, or when any phase fails.
"""

import copy
import dataclasses
import functools
import json
import math
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent

B_MAIN = 1024  # fold_cloth3 at the width bench.py uses
B_WIDE = 4096
# One robot step, kernel vs plain on the same inputs. At full width the step
# is sensitive to rounding: grounded particles' velocities chatter under
# dynamic friction (which divides by sqrt(vx^2 + vz^2 + 1e-8)), so the plain
# step in float32 and in float64 already differ by about 1e-3 in v and 1e-6
# in x. The kernel is held to the plain step's own float32 error: against
# the plain step in float64, its RMS error may be at most PARITY_RATIO times
# the float32 plain step's, plus a floor.
PARITY_FLOOR = {"x": 1e-7, "v": 1e-6, "primitive0": 1e-7, "primitive1": 1e-7}
PARITY_RATIO = 2.0
# Rollout, kernel vs plain. Over a macro step (2000 substeps) the cloth is
# chaotic under the gripper: rounding decides whether a particle at the
# edge of the gripper's ball is held, and from the same state the float32
# and float64 plain steps differ in a macro step's reward by about 1e-3 on
# average over 1024 sampled envs and by up to 0.1 in single envs. So
# each macro step of a sampled rollout (1024 distinct episodes) is replayed
# from the kernel's state by the kernel, the float32 plain step and the
# float64 plain step, and the kernel's mean reward error against float64 may
# be at most PARITY_RATIO times the float32 plain step's, plus 1e-6. The
# free-running deterministic episode, kernel vs plain, is held only to
# TOL_REWARD_EPISODE, a bound on gross faults (the rewards are about 0.2):
# the JAX package's own Pallas kernel and XLA oracle differ by 2.8e-2 over a
# fold_cloth3 episode (tests/test_torch_slice.py).
TOL_REWARD_EPISODE = 0.1
# The backward kernel, one robot step with random cotangents, and the policy
# gradient of one update: held to the plain version in float64 per env. A
# gradient through the full-size step is rounding-chaotic in a few envs:
# where a particle sits at the gripper ball's edge or a grounded particle's
# friction chatters, one rounding flips a discrete event, and that env's
# cotangents move by 10-1000x the others' errors. Any float32 evaluation
# shows such envs, in different places: on an H100, at fold_cloth3's 128
# envs one env's stiffness cotangent is 1.9e-7 off in the kernel (the median
# env 1.3e-10, the float32 plain VJP's worst 9.3e-9), while on the border
# cloth below the float32 plain VJP has the outlier (2.8e-8, the kernel's
# worst 2.7e-9). So for each output the gate takes the median over envs
# of the error norm against float64: the kernel's may be at most
# PARITY_RATIO times the float32 plain version's, plus a floor of
# VJP_FLOOR_REL times the median env's norm; the RMS, the largest error and
# the per-env cosine are printed beside it. The plain VJP runs on the first
# B_VJP_PLAIN envs only: its autograd state at 1024 envs in float64 would
# not fit.
VJP_FLOOR_REL = 1e-6
B_VJP_PLAIN = 128
# whip_rope's K2-bwd gate ([mpm-bwd-parity]) takes each side's median over
# envs in PARITY_DRAWS draws (the VJP run again; float atomics add in
# another order each time, on both sides) and compares the medians of those
# medians: one draw's medians spread 2.0-4.5e-9 in lamda on either side
# (scripts/k2_bwd_gate_spread.py), so a single draw failed the 2x ratio in
# two of four whole runs on an H100.
PARITY_DRAWS = 5
# The policy gradient of one update (ep_len 1, 40 robot steps) through the
# kernels against the plain step in float32 and float64, per env, with the
# contact-distance aux reward off so that every bit of it passes through
# the simulator (an env whose gripper holds no cloth then has none):
#   - on the tiny cloth of the CPU tests (N=20, 10 substeps, gripper radius
#     0.08), where the gradient is well conditioned, held to the gate above
#     (B_GRAD envs);
#   - at full width (N=80, 50 substeps), B_GRAD_FULL envs for each noise
#     seed of FULL_SEEDS. There, over 2000 substeps of lifting and dragging
#     cloth, the float32 plain step's per-env policy gradient is itself 10%
#     to 970% off the float64 one (median 44% over the 9 of 32 envs holding
#     cloth, on an H100), so one env says little. Pooled over the seeds'
#     envs holding cloth (at least MIN_HOLDING), the kernel's median
#     relative error against float64 may be at most PARITY_RATIO times the
#     float32 plain step's, and must be below 1, what a zero gradient
#     scores. A zero, sign-flipped or 2x-scaled gradient is off by about 1
#     or more in every env and fails; a smaller scale error may pass, and
#     the backward kernel's scale is held at the main path's shapes by the
#     one-step gate above. The float64 plain step holds ~40 GB. One noise
#     seed (9 envs holding cloth on the H100) keeps the gate and takes ~145
#     s of the script's 1200; a second seed's 9 more envs would take as much.
B_GRAD = 8
B_GRAD_FULL = 32
FULL_SEEDS = (2,)
MIN_HOLDING = 9
TINY = dict(N=20, n_substeps=10, gripper_radius=0.08)
# Both kernels, one robot step, on a cloth in the corner of the 80x80 grid:
# 32 x 40 = 1280 bbox cells, more than a block can have threads (1024), and
# particles on the grid's border, where the global-grid clip keeps a
# shortened diagonal valid so that two links of a particle land on one
# neighbour. Held to the per-env gate above.
BORDER_HW = (32, 40)
B_BORDER = 128
MAX_BLOCK_THREADS = 1024
# fold_tshirt (N = 180: a 72 x 78 bbox of 5616 cells, 3573 particles,
# stiffness 5000, dt 0.5e-3, 50 substeps): both kernels, one robot step from
# perturbed states with both grippers on the shirt, held to the per-env gate
# above at B_TSHIRT envs; then a deterministic run_eval rollout at
# B_TSHIRT_ROLL envs (5 macro steps, 200 K1-fwd launches). Over 16 envs the
# median of the mu cotangent's error swings between draws for kernel and
# plain VJP alike (on an H100 the kernel's was once 2.04x the float32 plain
# VJP's, over the gate, and within it in other runs); the gate takes 64.
B_TSHIRT = 64
B_TSHIRT_ROLL = 64
# [k1-design]: each K1 kernel's registers, spills, shared memory and blocks
# per SM, every built variant's time at fold_cloth3's B_MAIN, and the chosen
# variant's times at DESIGN_B envs (one and two waves of one block per SM,
# the main width, the wide one) and with the substeps halved.
DESIGN_B = (132, 264, 1024, 4096)
N_SMS = 132
VJP_NAMES = ("x", "v", "primitive0", "primitive1", "action0", "action1", "stiffness", "mu")
# Training: fold_cloth3 as the reference README trains it.
EP_LEN = 3
TRAIN_IT = 2  # train() runs TRAIN_IT + 1 updates
MEMORY_LIMIT = 70e9  # bytes the 4096-env update may be predicted to take
# The bound, the least time the card could take: the larger of the bytes each kernel
# must move (each input read once, each output written once) over 3.35 TB/s
# and its float32 operations over 67 TFLOP/s (no tensor cores apply).
# Operations per particle and substep, counted from the source for a
# grounded particle outside the grippers' balls (the common case: the cloth
# lies on the ground, a gripper holds a few particles), a square root or a
# division counting as one:
#   forward: 8 links x 18 (difference, squared length, sqrt, division,
#   coefficient, 3 multiply-adds) + gravity 3 + friction 11 + damping 9 +
#   2 ball tests x 9 + advection 6 = 191;
#   backward: the forward once, 191, plus the adjoint alone (the operations
#   that take a cotangent or serve only the adjoint; what the kernel
#   recomputes of the forward is not counted): folding in the neighbour
#   terms and the cotangents' squared norms 15; normalize_grad, the clips
#   and advection 36; normalize_grad and gripper 1 24; normalize_grad,
#   gripper 0 and damping 18; dynamic friction 22; the 8 springs 8 x 32
#   (1/|d|, r.g, the r r^T term, the stiffness sum, the particle's and the
#   neighbour's terms) = 256; the new x cotangent 3: 191 + 374 = 565.
FLOP_FWD = 191
FLOP_BWD = 565
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = 67e12

# ---- the MPM path: whip_rope (n_grid 64, a 32^3 focus grid, 67 particles,
# 70 substeps per macro step, 70 macro steps per episode) at bench.py's
# MPM width, through K2-fwd.
# K2-fwd against the plain macro step on the same inputs, as K1-fwd: per
# field, the kernel's RMS error against the float64 plain step at most
# PARITY_RATIO times the float32 plain step's, plus a floor near float32's
# spacing at the field's size (x, F, J and the primitive's buffers ~1, v ~1,
# C ~10). The RMS and the median over envs of the per-env error norm are
# printed.
MPM_FLOOR = {"x": 1e-7, "v": 1e-6, "C": 1e-5, "F": 1e-7, "J": 1e-7, "position": 1e-7,
             "rotation": 1e-7}
# The gate must be able to fail: the float32 plain step with no elastic
# stress (mu = lamda = 0 in the state, inputs only) must miss float64 in v
# by at least WITNESS_MARGIN times the gate.
WITNESS_MARGIN = 10.0
# shape_elasto_plastic's forward gate is held per env: the median over its
# B_ELASTO envs of each env's RMS error (the same PARITY_RATIO, floors,
# float64 reference and witness). Its sigma-clip particles sit at
# return-map ties where float32 rounding decides the branch: the RMS pooled
# over 4 envs failed a run on one particle of one env (F 2.9e-3 off,
# kernel RMS 3.9e-6 against a gate of 1.0e-6, on an H100, twice). Such
# flips come and go with the atomics' order on both sides: the pooled F RMS
# swung from 9.8e-7 to 1.7e-6 between repetitions, the kernel's as the
# float32 plain step's, on the parent's tree as on this one, while the
# per-env median moved by under 1% (scripts/k3_parity_spread.py, H100).
B_ELASTO_PARITY = 16
# whip_rope's parity step: the test_pallas_mpm.py action, scaled as
# whip_rope's get_primitive_actions scales a macro action (1/50).
MPM_ACTION = (0.4 / 50, 0.2 / 50, -0.3 / 50, 0.05 / 50, 0.05 / 50, 0.05 / 50)
# The rollout's macro steps replayed by the kernel, the float32 and the
# float64 plain step (mean reward error gate as K1's sampled rollout).
MPM_REPLAYED = (0, 35, 69)
B_MPM_CONFIG = 256  # the small configs of tests/test_pallas_mpm.py
B_SHAPE_ROPE = 64
# Operations of K2-fwd, counted from unidom_torch/csrc/mpm_step.cu for an
# elastic particle (whip_rope's rope), each add, subtract, multiply,
# division, square root, exp or log counting as one, comparisons and selects
# as none, the stencil counted once per substep (the kernel recomputes it
# for the clearing and for G2P; that is not counted):
#   F update 63 (I + dt C: 18, the product 45); hardness and Lame 4;
#   the SVD 1414 (A^T A 45; 18 Jacobi rotations x 69: 15 for the angle, 54
#   for the rows, columns and V; sigma 6; A V 45; the scaled columns 9;
#   Gram-Schmidt with its fallbacks 67); det 2; stress and affine 223
#   (R 45, 2 mu (F - R) F^T 136, the diagonal 6, the scaling and p_mass C 36);
#   the stencil 51; P2G 27 nodes x 31 (weight 2, offsets 3, momentum 18,
#   weighted 3, mass 1, 4 atomic adds) = 837; G2P 27 x 29 = 783 and the
#   advection, C scaling and J 20: 3,397 per particle-substep.
#   A touched grid cell under position control: mass normalisation 3,
#   gravity 6, position 3, the box SDF in the primitive's frame 66 (inverse
#   quaternion 13, rotation 30, the SDF 20, the test 1, the velocity 3): 78;
#   plus ground friction 21 on the cells of the bottom 3 layers.
FLOP_MPM_PARTICLE = 3397
FLOP_MPM_G2P = 803  # G2P 783 and the advection, C scaling and J 20
FLOP_MPM_CELL = 78
FLOP_MPM_FRICTION = 21
# The MPM training path (whip_rope APG at 1024 envs) through K2-fwd, K2-bwd
# and K2-seg. K2-bwd, one macro step's VJP from whip_rope's parity state
# with output cotangents of MPM_COT_SCALE x N(0, 1) (small enough that the
# macro step's per-env clamp of the input cotangent stays off), is held per
# input to the median-over-envs gate of K1-bwd on the first B_MPM_GRAD envs,
# against the float32 and float64 plain VJPs (autograd of the plain step,
# scatter transfer: the dense one's autograd state would not fit), at the
# stride rule's K = MPM_STRIDE and at K = 1; the witness, the float32 plain
# VJP with mu = lamda = 0, must miss it by WITNESS_MARGIN. Under position
# control the primitive's size, friction and softness take no gradient, nor
# does the yield stress of a material that is not von Mises: those inputs
# must be 0 in the kernel as in float64. K2-seg, segment MPM_SEGMENT of a
# macro step, is held to K2-fwd's gate against the plain forward's carries.
B_MPM_GRAD = 32
MPM_STRIDE = 9
MPM_SEGMENT = 4
MPM_COT_SCALE = 1e-3
MPM_STATE_INPUTS = ("x", "v", "C", "F", "J", "mu", "lamda", "yield_stress", "friction")
MPM_PRIM_INPUTS = ("position", "rotation", "size", "friction", "softness")
MPM_VJP_INPUTS = MPM_STATE_INPUTS + tuple(f"primitive.{n}" for n in MPM_PRIM_INPUTS) + ("action",)
MPM_PC_ZERO = ("primitive.size", "primitive.friction", "primitive.softness")
# Operations of K2-bwd's work, counted from unidom_torch/csrc/mpm_step.cu as
# K2-fwd's above, for an elastic particle: the forward once (3,397), and the
# adjoint: G2P and advection 32 + 27 nodes x 81 (weight 2, its three
# derivatives 15, the C term 15, the node's cotangent 9, the x terms 40) =
# 2,219; P2G 27 x 115 (weight and derivatives 17, offsets 3, momentum 21,
# the dot 8, v 9, affine 27, x 30) = 3,105; stress 400 (R 45, dS and p_mass
# C 18, (F - R) F^T 45, mu 18, Jd 6, dS F 45, dS^T (F - R) 45, dF 36, dR 18,
# dU 45, dV 45, rest 40); Jd's singular values 6; the SVD's adjoint 780
# (U^T dU, V^T dV 90, the inverses 33, J and K 24, five terms 597, sums 36);
# F's update 160; the accumulators 4: 10,071 per particle-substep. A touched
# cell: the forward's 78 and 15 of adjoint (mass normalisation 12, position
# control 3); ground friction 21 + 25 on the bottom 3 layers.
FLOP_MPM_BWD_PARTICLE = 10071
FLOP_MPM_BWD_CELL = 93
FLOP_MPM_BWD_FRICTION = 46


def log(msg):
    print(msg, flush=True)


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, reps, warmup=2):
    """Mean milliseconds of fn() over reps launches, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profile_device(what, fn, top=6):
    """Run fn() once under torch.profiler (CPU and CUDA activities) and log
    its host seconds, the device's busy time (the union of its kernel and
    copy intervals) and the largest device times by kernel name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        us, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    busy_us, end = 0.0, -math.inf
    for s, t in sorted(spans):
        if t > end:
            busy_us += t - max(s, end)
            end = t
    if not spans:
        fail(f"the profiler saw no device work in {what}")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    log(f"[profile] {what}: {wall:.4f} s on the host clock with the profiler on; device busy "
        f"{busy_us / 1e6:.4f} s = {100 * busy_us / 1e6 / wall:.1f}%, "
        f"{sum(n for _, n in by_name.values())} device operations; largest: "
        + "; ".join(f"{name[:70]} {us / 1e3:.3f} ms x{n}" for name, (us, n) in ranked))


def perturbed_state(env, gen):
    """fold_cloth3 reset state, perturbed as ``perturb`` does."""
    import torch

    return perturb(env.reset(torch.Generator().manual_seed(0))[1], gen)


def perturb(s, gen):
    """``s`` with v, stiffness and mu perturbed per env, gripper 0 on the
    cloth's first particle and gripper 1 on its last, so that both grippers
    hold cloth and neither sits on its clip bound."""
    import torch

    B = s.x.shape[0]
    ps0, ps1 = s.primitive0.clone(), s.primitive1.clone()
    ps0[:, :3] = s.x[:, 0, 0]
    ps1[:, :3] = s.x[:, -1, -1]
    return s.replace(
        v=0.05 * torch.randn(s.v.shape, generator=gen, device=s.v.device),
        primitive0=ps0,
        primitive1=ps1,
        stiffness=s.stiffness * (1.0 + 0.2 * torch.rand(B, generator=gen, device=s.x.device)),
        mu=s.mu * (1.0 + torch.rand(B, generator=gen, device=s.x.device)),
    )


def plain_sim(sim, dtype):
    """Shallow copy of ``sim`` that runs the plain step in ``dtype``."""
    out = copy.copy(sim)
    out.rest_len = sim.rest_len.to(dtype)
    out.nbr_valid = sim.nbr_valid.to(dtype)
    out.step_batch = out._robot_step_plain
    return out


def plain_copy(env, dtype):
    """Shallow copy of ``env`` whose simulator runs the plain step in ``dtype``."""
    out = copy.copy(env)
    out.simulator = plain_sim(env.simulator, dtype)
    out.goal = env.goal.to(dtype)
    return out


def cast(state, dtype):
    fields = {f.name: getattr(state, f.name) for f in dataclasses.fields(state)}
    return state.replace(**{k: t.to(dtype) for k, t in fields.items() if t.is_floating_point()})


def errors(out, ref):
    """Max and RMS of |out - ref|, in float64."""
    d = (out.double() - ref.double()).abs()
    return d.max().item(), d.square().mean().sqrt().item()


def bound(bytes_moved, flops):
    """Least time in ms for the work, and what bounds it."""
    t_bytes, t_ops = bytes_moved / PEAK_BYTES_PER_S, flops / PEAK_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def vjp_inputs(sim, s):
    """The robot step's kernel inputs from the state ``s`` under
    ``robot_action``, and random cotangents of its outputs from a numpy seed."""
    import numpy as np
    import torch

    B = s.x.shape[0]
    a0, a1 = sim.prepare_actions(robot_action(B, s.x.device))
    inputs = (s.x, s.v, s.primitive0, s.primitive1, a0, a1, s.stiffness, s.mu)
    rng = np.random.default_rng(0)
    cot = tuple(torch.from_numpy(rng.standard_normal(tuple(t.shape)).astype(np.float32))
                .to(s.x.device) for t in inputs[:4])
    return inputs, cot


class Draws(list):
    """Repeated draws of one side of per_env_gate: each a list of outputs."""


def per_env_gate(what, names, kernel, plain, ref, zero=(), gates=None):
    """Fail unless, for every output, the median over envs (the leading
    axis) of the kernel's error norm against ``ref`` (float64) is at most
    PARITY_RATIO times the float32 plain version's, plus the floor. The
    outputs named in ``zero`` have an all-0 reference and must be 0 in the
    kernel too. ``gates``, when given, receives each output's gate. A side
    given as Draws takes the median over its draws of that median. Returns
    the largest |kernel - plain|."""
    import statistics

    import torch

    kernel_draws = kernel if isinstance(kernel, Draws) else Draws([kernel])
    plain_draws = plain if isinstance(plain, Draws) else Draws([plain])
    worst = 0.0
    for i, (name, r) in enumerate(zip(names, ref)):
        k, p = kernel_draws[0][i], plain_draws[0][i]
        if not all(torch.isfinite(d[i]).all() for d in kernel_draws):
            fail(f"{what} {name}: the kernel's output is not finite")
        kk, pp, rr = (t.double().reshape(t.shape[0], -1) for t in (k, p, r))
        if name in zero:
            if rr.abs().max() > 0 or any(d[i].abs().max() > 0 for d in kernel_draws):
                fail(f"{what} {name}: expected 0, kernel max {kk.abs().max().item():.3e}, "
                     f"reference max {rr.abs().max().item():.3e}")
            continue
        if not rr.abs().max() > 0:
            fail(f"{what} {name}: the reference is 0 in every env, the gate would hold nothing")
        kp = (kk - pp).abs().max().item()
        worst = max(worst, kp)
        e_k, e_p = (kk - rr).norm(dim=1), (pp - rr).norm(dim=1)

        def draw_medians(draws):
            return [(d[i].double().reshape(rr.shape) - rr).norm(dim=1).median().item()
                    for d in draws]

        meds_k, meds_p = draw_medians(kernel_draws), draw_medians(plain_draws)
        med_k, med_p = statistics.median(meds_k), statistics.median(meds_p)
        floor = VJP_FLOOR_REL * rr.norm(dim=1).median().item()
        if len(meds_k) > 1 or len(meds_p) > 1:
            log(f"[{what}] {name}: per-env error vs float64, median over envs in each draw: "
                f"kernel {' '.join(f'{m:.3e}' for m in meds_k)}; float32 plain "
                f"{' '.join(f'{m:.3e}' for m in meds_p)}")
        nonzero = rr.norm(dim=1) > 0
        cos = torch.nn.functional.cosine_similarity(kk[nonzero], rr[nonzero], dim=1)
        cos_txt = f"per-env cosine min {cos.min().item():.8f}; " if kk.shape[1] > 1 and len(cos) else ""
        log(f"[{what}] {name}: |ref| max {rr.abs().max().item():.3e}; per-env error vs float64, "
            f"median{' of the draws' if len(meds_k) > 1 else ''}: kernel {med_k:.3e}, float32 "
            f"plain {med_p:.3e} (gate {PARITY_RATIO:g} x "
            f"{med_p:.3e} + {floor:.3e}); max: kernel {e_k.max().item():.3e}, float32 plain "
            f"{e_p.max().item():.3e}; rms over entries: kernel {errors(kk, rr)[1]:.3e}, float32 "
            f"plain {errors(pp, rr)[1]:.3e}; {cos_txt}kernel vs plain max {kp:.3e}")
        if gates is not None:
            gates[name] = PARITY_RATIO * med_p + floor
        if med_k > PARITY_RATIO * med_p + floor:
            fail(f"{what} {name}: the kernel is further from float64 than the plain version")
    return worst


def per_env_policy_grads(env, policy, state, eps):
    """Per-env gradients of one update's loss (``-mean`` of one macro step's
    reward, ep_len 1) with respect to the policy's parameters: the trainer's
    step (obs -> policy -> NormalTanh sample with noise ``eps`` -> sigmoid ->
    ``step_diff``), its gradient with respect to the actions taken through
    the simulator, then one pass back through the policy per env. Returns
    the loss and, per parameter, a (B, *shape) tensor whose sum over envs is
    the update's gradient."""
    import torch

    from unidom_torch.models.distribution import NormalTanhDistribution

    params = list(policy.parameters())
    dist = NormalTanhDistribution(event_size=env.action_size)
    actions = torch.sigmoid(dist.sample_from_eps(policy(env.get_obs(state)), eps))
    _, reward, _, _ = env.step_diff(actions, state)
    loss = -reward.mean()
    (g_actions,) = torch.autograd.grad(loss, actions, retain_graph=True)
    per_env = [torch.autograd.grad(actions[e], params, g_actions[e], retain_graph=True)
               for e in range(actions.shape[0])]
    return loss.detach(), [torch.stack(g) for g in zip(*per_env)]


def policy_grads(env, seed):
    """One update's per-env policy gradients from ``env``'s reset, with the
    noise drawn from numpy ``seed``: through the kernels (checking K1-bwd's
    launches), the float32 and the float64 plain step. Returns the relative
    norm by which the kernel's per-env gradients, summed over envs, miss the
    trainer's own gradient (``minimize.debug["loss_grad"]``), and the three
    gradients as (B, n_params) float64 tensors."""
    import numpy as np
    import torch

    from unidom_torch.algorithms.apg import build_apg
    from unidom_torch.ops.cuda.cloth_kernel import cloth_robot_step

    B, dev = env.batch_size, env.device
    init_ts, minimize, reset_batch, _ = build_apg(env, 1, device=dev)
    ts = init_ts(0)
    s0 = reset_batch(torch.Generator().manual_seed(0))
    eps = torch.from_numpy(np.random.default_rng(seed).standard_normal((1, B, env.action_size))
                           .astype(np.float32)).to(dev)
    cloth_robot_step.bwd_launches = 0
    _, grad, _ = minimize.debug["loss_grad"](ts, s0, eps)
    torch.cuda.synchronize()
    if cloth_robot_step.bwd_launches != 40:
        fail(f"one B={B} update launched K1-bwd {cloth_robot_step.bwd_launches} times, not 40")

    def flat(per_env):
        return torch.cat([t.double().reshape(B, -1) for t in per_env], 1)

    _, per_k = per_env_policy_grads(env, ts.policy, s0, eps[0])
    whole = torch.cat([g.double().flatten() for g in grad])
    split = ((flat(per_k).sum(0) - whole).norm() / whole.norm()).item()
    _, per_p = per_env_policy_grads(plain_copy(env, torch.float32), ts.policy, s0, eps[0])
    _, per_64 = per_env_policy_grads(plain_copy(env, torch.float64),
                                     copy.deepcopy(ts.policy).double(),
                                     cast(s0, torch.float64), eps[0].double())
    return split, (flat(per_k), flat(per_p), flat(per_64))


def shared_neighbours(sim):
    """Particles of ``sim`` two of whose valid links land on one neighbour,
    with the neighbour clamped to the bbox as the kernels clamp it."""
    import numpy as np

    from unidom_torch.engine.cloth import LINKS

    H, W = sim.H, sim.W
    valid = sim.nbr_valid.cpu().numpy().transpose(2, 0, 1) > 0
    i, j = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    q = [np.clip(i + di, 0, H - 1) * W + np.clip(j + dj, 0, W - 1) for di, dj in LINKS]
    shared = np.zeros((H, W), bool)
    for a in range(8):
        for b in range(a + 1, 8):
            shared |= (q[a] == q[b]) & valid[a] & valid[b]
    return int(shared.sum())


def robot_action(B, device):
    import torch

    a = torch.zeros((B, 8), device=device)
    a[:, 0], a[:, 1], a[:, 3] = 0.8, 1.5, 0.0  # gripper 0 moves with suction engaged
    # gripper 1 moves with suction partly engaged: inside its ball v *= 0.25
    # and x += d * 0.75, so every term of its adjoint is non-zero
    a[:, 4:7], a[:, 7] = 0.1, 0.25
    return a


def tshirt_phase(dev, gen):
    """[tshirt]: both K1 kernels on fold_tshirt's cloth against the float32
    and float64 plain steps, then its rollout through K1-fwd. Returns the
    rollout's K1-fwd launches and the largest |kernel - plain| of each kernel."""
    import torch

    from unidom_torch import make_env
    from unidom_torch.algorithms.apg import run_eval
    from unidom_torch.models.mlp import PolicyMLP
    from unidom_torch.ops.cuda import cloth_kernel
    from unidom_torch.ops.cuda.cloth_kernel import cloth_robot_step, cloth_robot_step_vjp_plain

    t_phase = time.perf_counter()
    env = make_env("fold_tshirt", batch_size=B_TSHIRT, device=dev)
    sim = env.simulator
    s = perturb(env.reset(torch.Generator().manual_seed(0))[1], gen)
    px = sim.pack(s.x)  # both grippers on the shirt, not on a bbox corner
    ps0, ps1 = s.primitive0.clone(), s.primitive1.clone()
    ps0[:, :3], ps1[:, :3] = px[:, 0], px[:, -1]
    s = s.replace(primitive0=ps0, primitive1=ps1)
    action = robot_action(B_TSHIRT, dev)
    with torch.no_grad():
        outs = [(o.x, o.v, o.primitive0, o.primitive1) for o in (
            cloth_robot_step(sim, s, action), sim._robot_step_plain(s, action),
            plain_sim(sim, torch.float64)._robot_step_plain(cast(s, torch.float64),
                                                           action.double()))]
    fwd_err = per_env_gate("tshirt-fwd", VJP_NAMES[:4], *outs)
    t_in, t_cot = vjp_inputs(sim, s)
    bwd_err = per_env_gate(
        "tshirt-bwd", VJP_NAMES, cloth_kernel.cloth_robot_step_vjp(sim, t_in, t_cot),
        cloth_robot_step_vjp_plain(sim, t_in, t_cot),
        cloth_robot_step_vjp_plain(plain_sim(sim, torch.float64), [t.double() for t in t_in],
                                   [t.double() for t in t_cot]))
    cfgs = {k: cloth_kernel.launch_config(sim.H, sim.W, sim.conf.n_substeps, k)
            for k in ("fwd", "bwd")}
    log(f"[tshirt] {sim.H} x {sim.W} = {sim.H * sim.W} bbox cells, {sim.n_particles} particles, "
        f"B={B_TSHIRT}: both kernels within the gate; K1-fwd "
        f"{cfgs['fwd'].threads} threads x {cfgs['fwd'].slots} particles "
        f"({cfgs['fwd'].regs} in registers), {cfgs['fwd'].smem} B of shared memory; K1-bwd "
        f"{cfgs['bwd'].threads} x {cfgs['bwd'].slots} ({cfgs['bwd'].regs}), "
        f"{cfgs['bwd'].smem + cfgs['bwd'].static_smem} B; {time.perf_counter() - t_phase:.2f} s")
    del env, sim, s, outs, t_in, t_cot
    torch.cuda.empty_cache()

    t_phase = time.perf_counter()
    env = make_env("fold_tshirt", batch_size=B_TSHIRT_ROLL, device=dev)
    policy = PolicyMLP(env.observation_size, 2 * env.action_size,
                       generator=torch.Generator().manual_seed(0), device=dev)
    _, state0 = env.reset(torch.Generator().manual_seed(1))
    with torch.no_grad():
        run_eval(policy, None, env, state0, deterministic=True)  # warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cloth_robot_step.launches = 0
        cloth_robot_step.bwd_launches = 0
        t0 = time.perf_counter()
        final, _, rewards = run_eval(policy, None, env, state0, deterministic=True)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launches = (cloth_robot_step.launches, cloth_robot_step.bwd_launches)
    expected = env.max_steps * 40
    slack = env.conf.dt * env.conf.max_v + 1e-6
    lo, hi = final.x.min().item(), final.x.max().item()
    log(f"[tshirt] run_eval fold_tshirt B={B_TSHIRT_ROLL}, {env.max_steps} macro steps: K1-fwd "
        f"{launches[0]} launches (expected {expected}), K1-bwd {launches[1]}; "
        f"{env.max_steps * B_TSHIRT_ROLL / seconds:.2f} env-steps/s ({seconds:.3f} s); peak "
        f"memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB; rewards (env 0) "
        f"{[round(r, 6) for r in rewards[:, 0].tolist()]}; final x in [{lo:.5f}, {hi:.5f}]; "
        f"{time.perf_counter() - t_phase:.2f} s")
    if launches != (expected, 0):
        fail(f"the fold_tshirt rollout launched K1 {launches} times, expected ({expected}, 0)")
    if tuple(rewards.shape) != (env.max_steps, B_TSHIRT_ROLL) or not torch.isfinite(rewards).all():
        fail(f"fold_tshirt rewards of shape {tuple(rewards.shape)} are not all finite")
    if not (torch.isfinite(final.x).all() and lo >= -slack and hi <= 1.0 + slack):
        fail(f"fold_tshirt's final x leaves [0, 1] by more than {slack}")
    del env, policy, state0, final
    torch.cuda.empty_cache()
    return launches[0], fwd_err, bwd_err


def k1_design_phase(dev, gen):
    """[k1-design]: what the card makes of each K1 kernel (registers, local
    memory, shared memory, blocks per SM), every built variant's time at
    fold_cloth3's main width, and the chosen variant's times per width and
    with the substeps halved."""
    import torch

    from unidom_torch import make_env
    from unidom_torch.engine.cloth import ClothConf
    from unidom_torch.envs.cloth_tasks import goal_path
    from unidom_torch.ops.cuda import cloth_kernel

    t_phase = time.perf_counter()
    device = torch.cuda.current_device()

    def inputs(B, n_substeps=50):
        conf = ClothConf(task="fold_cloth3", goal_path=goal_path("fold_cloth3"),
                         n_substeps=n_substeps)
        env = make_env("fold_cloth3", batch_size=B, conf=conf, device=dev)
        w_in, w_cot = vjp_inputs(env.simulator, perturbed_state(env, gen))
        return env.simulator, w_in, w_cot

    def timed(kind, sim, w_in, w_cot, variant=None):
        if kind == "fwd":
            return cuda_ms(lambda: cloth_kernel._launch_fwd(sim, w_in, variant), reps=20)
        return cuda_ms(lambda: cloth_kernel._launch_bwd(sim, w_in, w_cot, variant), reps=5)

    sim, w_in, w_cot = inputs(B_MAIN)
    chosen = {}
    for kind in ("fwd", "bwd"):
        main_cfg = cloth_kernel.launch_config(sim.H, sim.W, sim.conf.n_substeps, kind)
        chosen[kind] = (main_cfg.threads, main_cfg.regs)
        for variant in cloth_kernel.VARIANTS:
            cfg = cloth_kernel.launch_config(sim.H, sim.W, sim.conf.n_substeps, kind, variant)
            info = cloth_kernel.kernel_info(cfg, device)
            ms = timed(kind, sim, w_in, w_cot, variant)
            waves = math.ceil(B_MAIN / (N_SMS * info["blocks_per_sm"]))
            log(f"[k1-design] K1-{kind} variant {variant}{' (chosen)' if variant == chosen[kind] else ''}"
                f" on fold_cloth3 ({sim.H} x {sim.W}): {info['registers']} registers, "
                f"{info['local_bytes']} B local memory per thread, {cfg.smem} B dynamic + "
                f"{info['static_smem']} B static shared memory "
                f"({cfg.smem / cfg.hw_padded:.0f} B per cell), {info['blocks_per_sm']} blocks "
                f"per SM; {ms:.4f} ms at B={B_MAIN} ({waves} waves, {ms / waves:.4f} ms per wave)")
    for kind in ("fwd", "bwd"):
        for hw, name in (((72, 78), "fold_tshirt"), (BORDER_HW, "the border cloth")):
            cfg = cloth_kernel.launch_config(*hw, 50, kind)
            info = cloth_kernel.kernel_info(cfg, device)
            log(f"[k1-design] K1-{kind} on {name} ({hw[0]} x {hw[1]}): variant "
                f"{(cfg.threads, cfg.regs)}, {cfg.slots} particles per thread, "
                f"{info['registers']} registers, {info['local_bytes']} B local memory, "
                f"{cfg.smem + cfg.static_smem} B shared memory, {info['blocks_per_sm']} blocks "
                f"per SM, {cfg.scratch * 4} B of scratch per env")
    del sim, w_in, w_cot
    times = {"fwd": {}, "bwd": {}}
    for B in DESIGN_B:
        sim, w_in, w_cot = inputs(B)
        for kind in ("fwd", "bwd"):
            times[kind][B] = timed(kind, sim, w_in, w_cot)
        del sim, w_in, w_cot
        torch.cuda.empty_cache()
    sim, w_in, w_cot = inputs(B_MAIN, 25)
    half = {kind: timed(kind, sim, w_in, w_cot) for kind in ("fwd", "bwd")}
    del sim, w_in, w_cot
    for kind in ("fwd", "bwd"):
        cfg = cloth_kernel.launch_config(16, 32, 50, kind)
        per_sm = cloth_kernel.kernel_info(cfg, device)["blocks_per_sm"]
        rows = "; ".join(
            f"B={B} {ms:.4f} ms ({math.ceil(B / (N_SMS * per_sm))} waves)"
            for B, ms in times[kind].items())
        full, halved = times[kind][B_MAIN], half[kind]
        log(f"[k1-design] K1-{kind} {chosen[kind]}: {rows}; at B={B_MAIN} with 25 substeps "
            f"{halved:.4f} ms: per substep {(full - halved) / 25:.5f} ms, the rest "
            f"{2 * halved - full:.4f} ms")
    log(f"[k1-design] {time.perf_counter() - t_phase:.2f} s")
    torch.cuda.empty_cache()
    return times


def mpm_cast(state, dtype):
    """An MPM state (a tree of dataclasses) with its float tensors in ``dtype``."""
    from unidom_torch.ops.gradops import tree_flatten

    leaves, rebuild = tree_flatten(state)
    return rebuild([t.to(dtype) if t.is_floating_point() else t for t in leaves])


def mpm_plain_env(env, dtype):
    """Shallow copy of the MPM ``env`` that runs the plain step in ``dtype``."""
    out = copy.copy(env)
    out.simulator = copy.copy(env.simulator)
    out.simulator.step_batch = out.simulator._step_plain
    out.goal = env.goal.to(dtype)
    out.init_state = mpm_cast(env.init_state, dtype)
    return out


def mpm_fields(state):
    """The macro step's outputs by name: x, v, C, F, J and the primitives'
    position and rotation buffers."""
    import torch

    out = {n: getattr(state, n) for n in ("x", "v", "C", "F", "J")}
    out["position"] = torch.stack([p.position for p in state.primitives], 1)
    out["rotation"] = torch.stack([p.rotation for p in state.primitives], 1)
    return out


def mpm_gate(what, kernel, plain, ref, floors=MPM_FLOOR, per_env=False):
    """Fail unless, for every field, the kernel's RMS error against ``ref``
    (float64) is at most PARITY_RATIO times the float32 plain step's plus the
    field's floor; with ``per_env``, the median over envs of each env's RMS
    error instead. Logs the RMS and the median over envs of the per-env
    error norm. Returns (the largest |kernel - plain|, the gate per field)."""
    import torch

    worst, gates = 0.0, {}
    k, p, r = mpm_fields(kernel), mpm_fields(plain), mpm_fields(ref)
    for name, floor in floors.items():
        kk, pp, rr = (t[name].double().reshape(t[name].shape[0], -1) for t in (k, p, r))
        if not torch.isfinite(kk).all():
            fail(f"{what} {name}: the kernel's output is not finite")
        kp = (kk - pp).abs().max().item()
        worst = max(worst, kp)
        rms_k, rms_p = errors(kk, rr)[1], errors(pp, rr)[1]
        med_k, med_p = (kk - rr).norm(dim=1).median().item(), (pp - rr).norm(dim=1).median().item()
        if per_env:
            stat_k, stat_p = env_rms(kk, rr), env_rms(pp, rr)
            log(f"[{what}] {name}: error vs the float64 plain step, rms: kernel {rms_k:.3e}, float32 "
                f"plain {rms_p:.3e}; the median over the {kk.shape[0]} envs of each env's rms: "
                f"kernel {stat_k:.3e}, float32 plain {stat_p:.3e} (gate {PARITY_RATIO:g} x "
                f"{stat_p:.3e} + {floor:g}); kernel vs plain max {kp:.3e}")
        else:
            stat_k, stat_p = rms_k, rms_p
            log(f"[{what}] {name}: error vs the float64 plain step, rms: kernel {rms_k:.3e}, float32 "
                f"plain {rms_p:.3e} (gate {PARITY_RATIO:g} x {rms_p:.3e} + {floor:g}); per-env "
                f"median: kernel {med_k:.3e}, float32 plain {med_p:.3e}; kernel vs plain max {kp:.3e}")
        gates[name] = PARITY_RATIO * stat_p + floor
        if stat_k > gates[name]:
            fail(f"{what} {name}: the kernel is further from float64 than the plain step")
    return worst, gates


def env_rms(t, ref):
    """The median over envs (the leading axis) of each env's RMS of t - ref."""
    return (t - ref).pow(2).mean(dim=1).sqrt().median().item()


def mpm_stencil_cells(sim, x):
    """Per env, the flat indices of the grid cells the particles' stencils
    touch at positions ``x`` (B, P, 3): a list of 1-D tensors."""
    import torch

    conf = sim.conf
    base = torch.floor(x * conf.inv_dx - 0.5).long()
    node = base[:, :, None, :] + sim.offsets.long()  # (B, P, 27, 3)
    res = torch.tensor(conf.res, device=x.device)
    ok = ((node >= 0) & (node < res)).all(-1)
    flat = (node[..., 0] * conf.res[1] + node[..., 1]) * conf.res[2] + node[..., 2]
    return [torch.unique(flat[b][ok[b]]) for b in range(x.shape[0])]


def mpm_work(sim, x_in, x_out):
    """(touched cells, of them in the bottom 3 layers) per substep, summed
    over envs: the mean of the macro step's first and last substeps."""
    conf = sim.conf
    counts = []
    for x in (x_in, x_out):
        cells = mpm_stencil_cells(sim, x)
        counts.append((sum(len(c) for c in cells),
                       sum(int(((c // conf.res[2]) % conf.res[1] < 3).sum()) for c in cells)))
    return tuple((a + b) / 2 for a, b in zip(*counts))


def mpm_bound(sim, state, out, cell_flops=FLOP_MPM_CELL):
    """Least time in ms of one K2-fwd (or K3-fwd) macro step from ``state``
    to ``out``, and what bounds it: the operations counted above for this
    run's touched cells (``cell_flops`` each), and the bytes of its inputs
    and outputs."""
    from unidom_torch.ops.cuda.mpm_kernel import pack_primitives

    conf = sim.conf
    B, P = state.x.shape[:2]
    cells, bottom = mpm_work(sim, state.x, out.x)
    flops = conf.steps * (FLOP_MPM_PARTICLE * B * P + cell_flops * cells
                          + FLOP_MPM_FRICTION * bottom)
    fields = mpm_fields(out)
    moved = (nbytes([getattr(state, n) for n in ("x", "v", "C", "F", "J", "mu", "lamda",
                                                 "yield_stress", "friction")])
             + nbytes(pack_primitives(state)) + nbytes([sim._h, sim._material])
             + nbytes(fields.values()))
    return bound(moved, flops), flops, moved, cells / B


def whip_rope_parity_state(env, dev, seed=0):
    """whip_rope's reset state in the simulator's frame (the focus shift
    applied), perturbed as tests/test_pallas_mpm.py does it: random v and C,
    and the primitive on the rope's end (the particle of least x)."""
    import numpy as np
    import torch

    B = env.batch_size
    _, s = env.reset(torch.Generator().manual_seed(seed))
    s, _ = env.pre_step(s)
    rng = np.random.default_rng(seed)
    end = s.x[torch.arange(B, device=dev), s.x[..., 0].argmin(1)]  # (B, 3)
    p0 = s.primitives[0]
    position = p0.position.clone()
    position[:, 0] = end
    return s.replace(
        v=torch.from_numpy(0.2 * rng.standard_normal(s.v.shape, dtype=np.float32)).to(dev),
        C=torch.from_numpy(0.5 * rng.standard_normal(s.C.shape, dtype=np.float32)).to(dev),
        primitives=(p0.replace(position=position),))


def cells_under_control(sim, state):
    """Per env, how many touched grid cells lie within 1.5 x size[0] of the
    primitive's surface at the first substep (position control takes them)."""
    import torch

    from unidom_torch.ops.gradops import clip
    from unidom_torch.ops.quat import qinv, qrot
    from unidom_torch.ops.sdf import sdf_box

    conf = sim.conf
    p = state.primitives[0]
    pos, rot = clip(p.position[:, 0], -2.0, 2.0), p.rotation[:, 0]
    counts = []
    for b, cells in enumerate(mpm_stencil_cells(sim, state.x)):
        ijk = torch.stack([cells // (conf.res[1] * conf.res[2]), (cells // conf.res[2]) % conf.res[1],
                           cells % conf.res[2]], -1).float() * conf.dx
        local = qrot(qinv(rot[b])[None], ijk - pos[b])
        counts.append(int((sdf_box(p.size[b], local) < p.size[b, 0] * 1.5).sum()))
    return torch.tensor(counts)


def mpm_config_sim(name, B, dev, position_control=False):
    """(simulator, perturbed state, action) of a configuration that whip_rope
    does not exercise: shape_rope's (a plastic rope pushed by a box under
    collision, in the focus grid), or tests/test_pallas_mpm.py's small ones
    (water, von Mises or sigma-clip plastic under the box, by collision or
    ``position_control``; water in a bowl)."""
    import numpy as np
    import torch

    from unidom_torch.engine.mpm import PLASTIC_CLIP, VON_MISES, WATER, MPMConf, MPMSimulator
    from unidom_torch.engine.primitives import create_primitive
    from unidom_torch.envs.mpm_tasks import ShapeRopeConf

    rng = np.random.default_rng(1)
    small = dict(n_grid=32, dt=2e-4, steps=8, E=100.0, nu=0.1, res=(16, 16, 16),
                 ground_friction=0.5, task="test")
    a = np.zeros((B, 6), np.float32)
    if name == "shape_rope":
        # ShapeRopeEnv.reset's rope and pusher, shifted into the focus grid as
        # pre_step shifts them, the pusher just short of the rope, pushing
        sim = MPMSimulator(ShapeRopeConf, B, use_position_control=False, device=dev)
        s = sim.add_box(None, size=(0.25, 0.006, 0.006), init_pos=(0.5, 0.01, 0.5),
                        material=PLASTIC_CLIP, density=3.0)
        s.primitives.append(create_primitive(ShapeRopeConf.steps, 0.1, 666.0, [0.5] * 3,
                                             (0.015, 0.06, 0.015), (0.25, 0.01, 0.225), device=dev))
        sim.register_primitive_sdf("box")
        s = sim.reset(s)
        s = s.replace(x=s.x + torch.tensor([-0.25, 0.0, -0.25], device=dev))
        a[:, 2] = 0.05
        ys = None
    elif name == "bowl_water":  # tests/test_pallas_mpm.py's container config
        conf = MPMConf(**{**small, "E": 5e-4, "nu": 0.3, "ground_friction": 0.1})
        sim = MPMSimulator(conf, B, use_position_control=False, device=dev)
        s = sim.add_box(None, size=(0.06, 0.04, 0.06), init_pos=(0.5, 0.2, 0.5),
                        material=WATER, density=1.5)
        s.primitives.append(create_primitive(8, 0.1, 666.0, [0.5] * 3, (0.09, 0.0, 0.008),
                                             (0.5, 0.17, 0.5), device=dev))
        sim.register_primitive_sdf("container")
        s = sim.reset(s)
        a[:, :3], a[:, 3:] = (0.4, 0.2, -0.3), 0.05
        ys = None
    else:  # "water", "von_mises" or "plastic": tests/test_pallas_mpm.py's small config
        sim = MPMSimulator(MPMConf(**small), B, use_position_control=position_control,
                           device=dev)
        material = {"water": WATER, "von_mises": VON_MISES, "plastic": PLASTIC_CLIP}[name]
        s = sim.add_box(None, size=(0.25, 0.06, 0.06), init_pos=(0.5, 0.08, 0.5),
                        material=material, density=1.5)
        s.primitives.append(create_primitive(8, 0.2, 666.0, [0.5] * 3, (0.03,) * 3,
                                             (0.5, 0.06, 0.46), device=dev))
        sim.register_primitive_sdf("box")
        s = sim.reset(s)
        a[:, :3], a[:, 3:] = (0.4, 0.2, -0.3), 0.05
        # a yield stress that the von-Mises return map reaches in one macro step
        ys = torch.full_like(s.yield_stress, 0.005 if position_control else 0.05)
    s = s.replace(
        v=torch.from_numpy(0.2 * rng.standard_normal(s.v.shape, dtype=np.float32)).to(dev),
        C=torch.from_numpy(0.5 * rng.standard_normal(s.C.shape, dtype=np.float32)).to(dev),
        yield_stress=s.yield_stress if ys is None else ys)
    return sim, s, torch.from_numpy(a).to(dev)


def mpm_phases(dev):
    """The MPM path: K2-fwd parity, other configurations, the whip_rope
    rollout at 1024 envs through K2-fwd, the gradient refusal, times and the
    bound. Returns the kernels-line entry of K2-fwd and the K1 launches seen
    in the whip_rope rollout."""
    import torch

    from unidom_torch import make_env
    from unidom_torch.algorithms.apg import run_eval
    from unidom_torch.models.mlp import PolicyMLP
    from unidom_torch.ops.cuda.cloth_kernel import cloth_robot_step
    from unidom_torch.ops.cuda.mpm_big_kernel import mpm_big_step
    from unidom_torch.ops.cuda.mpm_kernel import mpm_step

    # ---- 11. K2-fwd parity: one whip_rope macro step at 1024 envs
    t_phase = time.perf_counter()
    env = make_env("whip_rope", batch_size=B_MAIN, device=dev)
    sim = env.simulator
    state = whip_rope_parity_state(env, dev)
    action = torch.tensor(MPM_ACTION, device=dev).expand(B_MAIN, 6)
    with torch.no_grad():
        out_k = mpm_step(sim, state, action)
        torch.cuda.synchronize()
        out_p = sim._step_plain(state, action)
        out_64 = sim._step_plain(mpm_cast(state, torch.float64), action.double())
        parity_err, gates = mpm_gate("mpm-parity", out_k, out_p, out_64)
        witness = sim._step_plain(state.replace(mu=torch.zeros_like(state.mu),
                                                lamda=torch.zeros_like(state.lamda)), action)
    ratios = {}
    for name, t in mpm_fields(witness).items():
        ratios[name] = errors(t, mpm_fields(out_64)[name])[1] / gates[name]
    log("[mpm-parity] witness, the float32 plain step with mu = lamda = 0: rms error vs float64 "
        "over the gate " + ", ".join(f"{k} {v:.3e}x" for k, v in ratios.items())
        + f" (must be at least {WITNESS_MARGIN:g}x in v)")
    if not ratios["v"] >= WITNESS_MARGIN:
        fail("the witness without elastic stress passes the gate: the gate holds nothing")
    moved = (out_k.x - state.x).abs().max().item()
    controlled = cells_under_control(sim, state)
    log(f"[mpm-parity] B={B_MAIN}, P={sim.n_particles}, res {sim.conf.res}, {sim.conf.steps} "
        f"substeps; rope moved up to {moved:.3e}; grid cells under position control at the "
        f"first substep per env: min {int(controlled.min())}, median "
        f"{int(controlled.median())}; {time.perf_counter() - t_phase:.2f} s")
    if moved < 1e-4:
        fail("the parity step left the rope where it was")
    if int(controlled.min()) == 0:
        fail("no grid cell was under position control in some env")
    bound_1024, flops, moved_bytes, cells_per_env = mpm_bound(sim, state, out_k)
    del out_p, out_64, witness

    # ---- 12. K2-fwd on configurations whip_rope does not exercise
    t_phase = time.perf_counter()
    for name, B in (("shape_rope", B_SHAPE_ROPE), ("water", B_MPM_CONFIG),
                    ("von_mises", B_MPM_CONFIG), ("bowl_water", B_MPM_CONFIG)):
        csim, cs, ca = mpm_config_sim(name, B, dev)
        with torch.no_grad():
            ck = mpm_step(csim, cs, ca)
            cp = csim._step_plain(cs, ca)
            c64 = csim._step_plain(mpm_cast(cs, torch.float64), ca.double())
        err, _ = mpm_gate(f"mpm-config {name}", ck, cp, c64)
        parity_err = max(parity_err, err)
        log(f"[mpm-config] {name}: B={B}, P={csim.n_particles}, res {csim.conf.res}, "
            f"{csim.conf.steps} substeps, SDF {csim.sdf_names}, materials "
            f"{sorted(set(csim.material.tolist()))}, "
            f"{'position control' if csim.use_position_control else 'collision'}; particles "
            f"moved up to {(ck.x - cs.x).abs().max().item():.3e}")
        if name == "shape_rope" and csim.n_particles != 582:
            fail(f"shape_rope has {csim.n_particles} particles, not 582")
    log(f"[mpm-config] {time.perf_counter() - t_phase:.2f} s")
    torch.cuda.empty_cache()

    # ---- 13. the main path: the whip_rope policy rollout at 1024 envs
    t_phase = time.perf_counter()
    policy = PolicyMLP(env.observation_size, 2 * env.action_size,
                       generator=torch.Generator().manual_seed(0), device=dev)
    _, state0 = env.reset(torch.Generator().manual_seed(1))
    mpm_step.launches = 0
    mpm_big_step.launches = 0
    cloth_robot_step.launches = 0
    cloth_robot_step.bwd_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, acts, rewards = run_eval(policy, None, env, state0,
                                generator=torch.Generator(device=dev).manual_seed(2))
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    launches, k3 = mpm_step.launches, mpm_big_step.launches
    k1 = {"fwd": cloth_robot_step.launches, "bwd": cloth_robot_step.bwd_launches}
    log(f"[mpm-slice] run_eval whip_rope B={B_MAIN}: {launches} K2-fwd launches (expected "
        f"{env.max_steps}), K1 launches {k1} and K3-fwd {k3} (expected 0); first rollout "
        f"{t_first:.3f} s")
    if launches != env.max_steps:
        fail(f"{launches} K2-fwd launches in the whip_rope rollout, expected {env.max_steps}")
    if k1 != {"fwd": 0, "bwd": 0} or k3 != 0:
        fail(f"the whip_rope rollout launched the cloth kernels {k1} and K3-fwd {k3} times")
    if tuple(rewards.shape) != (env.max_steps, B_MAIN) or not torch.isfinite(rewards).all():
        fail(f"rewards of shape {tuple(rewards.shape)} are not all finite")

    # replay the sampled rollout through the kernel, and three of its macro
    # steps through the float32 and float64 plain steps from the kernel's state
    env32, env64 = mpm_plain_env(env, torch.float32), mpm_plain_env(env, torch.float64)
    s, lo, hi = state0, math.inf, -math.inf
    with torch.no_grad():
        for t in range(env.max_steps):
            _, r_k, _, info = env.step_diff(acts[t], s)
            # the step's particles before any auto-reset, in the simulator's
            # frame: inside the box [0, n_grid dx]^3 that the walls bound
            target = torch.tensor(env.conf.res, device=dev) * 0.5 / env.conf.n_grid
            shift = target - s.x.mean(1)
            shift[:, 1] = 0.0
            x_sim = info["state_list"][-1].x + shift[:, None]
            if not torch.isfinite(x_sim).all():
                fail(f"macro step {t}: non-finite particles")
            lo, hi = min(lo, x_sim.min().item()), max(hi, x_sim.max().item())
            if t == env.max_steps - 1:
                prim_moved = (info["state_list"][-1].primitives[0].position[:, -1]
                              - state0.primitives[0].position[:, 0]).norm(dim=1)
            if t in MPM_REPLAYED:
                _, r_p, _, _ = env32.step_diff(acts[t], s)
                _, r_64, _, _ = env64.step_diff(acts[t].double(), mpm_cast(s, torch.float64))
                e_k, e_p = (r_k.double() - r_64).abs(), (r_p.double() - r_64).abs()
                log(f"[mpm-slice] sampled macro step {t} from the kernel's state, reward error "
                    f"vs the float64 plain step: kernel mean {e_k.mean():.3e} max {e_k.max():.3e}, "
                    f"float32 plain mean {e_p.mean():.3e} max {e_p.max():.3e}; rewards mean "
                    f"{r_64.mean():.6f}")
                if e_k.mean() > PARITY_RATIO * e_p.mean() + 1e-6:
                    fail(f"macro step {t}: the kernel's rewards are further from float64 than "
                         "the plain step's")
            s = info["state"]
    extent = env.conf.n_grid * env.conf.dx
    log(f"[mpm-slice] replayed episode: particles in the simulator's frame within [{lo:.5f}, "
        f"{hi:.5f}] (the walls' box is [0, {extent:g}]); primitive moved by median "
        f"{prim_moved.median().item():.4f}, max {prim_moved.max().item():.4f}; rewards per "
        f"step (env 0) {[round(r, 5) for r in rewards[:, 0].tolist()[:10]]} ...")
    if lo < 0.0 or hi > extent:
        fail("particles left the box that the grid's walls allow")
    if not prim_moved.max().item() > 1e-3:
        fail("the primitive did not move")
    del env32, env64
    log(f"[mpm-slice] {time.perf_counter() - t_phase:.2f} s")

    # ---- 15. times, and the bound
    t_phase = time.perf_counter()
    times = {}
    for B in (B_MAIN, B_WIDE):
        wenv = env if B == B_MAIN else make_env("whip_rope", batch_size=B, device=dev)
        ws = state if B == B_MAIN else whip_rope_parity_state(wenv, dev)
        wa = torch.tensor(MPM_ACTION, device=dev).expand(B, 6)
        rounds = []
        with torch.no_grad():
            for order in (("plain", "kernel"), ("kernel", "plain")):
                r = {}
                for which in order:
                    if which == "kernel":
                        r[which] = cuda_ms(lambda: mpm_step(wenv.simulator, ws, wa), reps=20)
                    elif B == B_MAIN:
                        r[which] = cuda_ms(lambda: sim._step_plain(ws, wa), reps=1, warmup=1)
                rounds.append(r)
        times[B] = {k: sum(r[k] for r in rounds) / len(rounds) for k in rounds[0]}
        plain_txt = (f"plain {times[B]['plain']:.4f} ms, speedup "
                     f"{times[B]['plain'] / times[B]['kernel']:.1f}x; " if B == B_MAIN else "")
        log(f"[time] one whip_rope macro step, B={B}: K2-fwd {times[B]['kernel']:.4f} ms, "
            f"{plain_txt}(rounds {rounds})")
        del wenv, ws
    log(f"[time] K2-fwd bound at B={B_MAIN}: {bound_1024[0]:.4f} ms ({bound_1024[1]}): "
        f"{FLOP_MPM_PARTICLE} operations per particle-substep, {FLOP_MPM_CELL} per touched "
        f"cell (+{FLOP_MPM_FRICTION} on the bottom 3 layers), {cells_per_env:.1f} touched cells "
        f"per env and substep in this run: {flops / 1e9:.3f} GFLOP; {moved_bytes / 1e6:.2f} MB "
        f"in and out; K2-fwd at {100 * bound_1024[0] / times[B_MAIN]['kernel']:.2f}% of it")
    t_roll = []
    with torch.no_grad():
        for _ in range(4):  # a warm rollout, then best of 3
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_eval(policy, None, env, state0, deterministic=True)
            torch.cuda.synchronize()
            t_roll.append(time.perf_counter() - t0)
    env_steps = env.max_steps * B_MAIN
    log(f"[time] whip_rope rollout B={B_MAIN} ({env.max_steps} macro steps): "
        f"{env_steps / min(t_roll[1:]):.1f} env-steps/s through K2-fwd (best of "
        f"{[round(t, 4) for t in t_roll[1:]]} s after a warm {t_roll[0]:.4f} s)")
    profile_device(f"run_eval whip_rope B={B_MAIN}",
                   lambda: run_eval(policy, None, env, state0, deterministic=True))
    log(f"[time] phase 15 in {time.perf_counter() - t_phase:.2f} s")
    entry = {
        "name": "mpm_step_fwd",
        "route": "cuda",
        "source": "unidom_torch/csrc/mpm_step.cu",
        "replaces": "unidom_tpu/ops/pallas/mpm_kernel.py:761",
        "launches": launches,
        "launches_by_path": {"whip_rope_run_eval": launches},
        "max_abs_err": parity_err,
        "ms": times[B_MAIN]["kernel"],
        "plain_ms": times[B_MAIN]["plain"],
        "bound_ms": bound_1024[0],
        "bound_by": bound_1024[1],
        "library_ms": None,
    }
    return entry, k1, k3


def mpm_slice_envs(state, stop, start=0):
    """Envs ``start`` to ``stop`` (by default the first ``stop``) of an MPM
    state."""
    from unidom_torch.ops.gradops import tree_flatten

    leaves, rebuild = tree_flatten(state)
    return rebuild([t[start:stop].contiguous() for t in leaves])


def mpm_vjp_names(n_prim):
    """The inputs ``mpm_vjp`` differentiates, by name: MPM_VJP_INPUTS for one
    primitive, each primitive's fields numbered for more."""
    if n_prim == 1:
        return MPM_VJP_INPUTS
    return MPM_STATE_INPUTS + tuple(f"primitive{i}.{n}" for i in range(n_prim)
                                    for n in MPM_PRIM_INPUTS) + ("action",)


def mpm_outputs(out):
    """A macro step's differentiated outputs: x, v, C, F, J and each
    primitive's position and rotation buffers."""
    return (out.x, out.v, out.C, out.F, out.J) + tuple(
        t for p in out.primitives for t in (p.position, p.rotation))


def mpm_vjp(step, state, action, cot):
    """Cotangents of ``mpm_vjp_names`` for one macro step ``step(state,
    action)`` under the output cotangents ``cot`` (``mpm_outputs``'s)."""
    import torch

    ins = [getattr(state, n).detach().clone().requires_grad_() for n in MPM_STATE_INPUTS]
    for p in state.primitives:
        ins += [getattr(p, n).detach().clone().requires_grad_() for n in MPM_PRIM_INPUTS]
    ins.append(action.detach().clone().requires_grad_())
    n, k = len(MPM_STATE_INPUTS), len(MPM_PRIM_INPUTS)
    prims = tuple(p.replace(**dict(zip(MPM_PRIM_INPUTS, ins[n + i * k:n + (i + 1) * k])))
                  for i, p in enumerate(state.primitives))
    s = state.replace(**dict(zip(MPM_STATE_INPUTS, ins[:n])), primitives=prims)
    with torch.enable_grad():
        outs = mpm_outputs(step(s, ins[-1]))
        grads = torch.autograd.grad(outs, ins, [c.to(outs[0].dtype) for c in cot], allow_unused=True)
    return [torch.zeros_like(t) if g is None else g.detach() for g, t in zip(grads, ins)]


def mpm_vjp_cot(out, seed=0):
    """Random output cotangents from a numpy seed, small enough that the
    macro step's per-env clamp of the input cotangent stays off."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    return [torch.from_numpy(MPM_COT_SCALE * rng.standard_normal(tuple(t.shape)).astype(np.float32))
            .to(t.device) for t in mpm_outputs(out)]


def plain_mpm_sim(sim, transfer="scatter"):
    """Shallow copy of ``sim`` whose plain step uses ``transfer``."""
    out = copy.copy(sim)
    out.transfer_mode = transfer
    return out


def mpm_action_checks(what, grads):
    """Fail unless the action's translation cotangent (position control's
    whole gradient) is non-zero in every env."""
    a = grads[MPM_VJP_INPUTS.index("action")][:, :3]
    zero = int((a.abs().amax(1) == 0).sum())
    if zero:
        fail(f"{what}: the action's cotangent is 0 in {zero} envs")


def mpm_policy_grads(env, seed, checkpoint=False):
    """One update's per-env policy gradients (ep_len 1) from ``env``'s reset,
    noise from numpy ``seed``, through the kernels, the float32 and the
    float64 plain step (scatter transfer; with ``checkpoint``, each substep
    of the plain steps recomputed in the backward pass instead of kept, as
    ``checkpointed``: pour_soup's float64 substep holds ~1.9 GB per env);
    (B, n_params) float64 each."""
    import numpy as np
    import torch

    from unidom_torch.algorithms.apg import build_apg
    from unidom_torch.models.distribution import NormalTanhDistribution

    B, dev = env.batch_size, env.device
    init_ts, _, reset_batch, _ = build_apg(env, 1, device=dev)
    ts = init_ts(0)
    s0 = reset_batch(torch.Generator().manual_seed(0))
    eps = torch.from_numpy(np.random.default_rng(seed).standard_normal((B, env.action_size))
                           .astype(np.float32)).to(dev)
    dist = NormalTanhDistribution(event_size=env.action_size)

    def per_env(e, policy, state, eps):
        params = list(policy.parameters())
        actions = dist.sample_from_eps(policy(e.get_obs(state)), eps)
        if e.action_squash == "sigmoid":
            actions = torch.sigmoid(actions)
        _, reward, _, _ = e.step_diff(actions, state)
        (g_actions,) = torch.autograd.grad(-reward.mean(), actions, retain_graph=True)
        rows = [torch.autograd.grad(actions[i], params, g_actions[i], retain_graph=True)
                for i in range(B)]
        return torch.cat([torch.stack(g).double().reshape(B, -1) for g in zip(*rows)], 1)

    env32, env64 = mpm_plain_env(env, torch.float32), mpm_plain_env(env, torch.float64)
    for e in (env32, env64):
        e.simulator.transfer_mode = "scatter"
        if checkpoint:
            e.simulator = checkpointed(e.simulator)
            e.simulator.step_batch = e.simulator._step_plain
    return (per_env(env, ts.policy, s0, eps), per_env(env32, ts.policy, s0, eps),
            per_env(env64, copy.deepcopy(ts.policy).double(), mpm_cast(s0, torch.float64),
                    eps.double()))


def mpm_bwd_bound(sim, B, K, cells, bottom, cell_flops=FLOP_MPM_BWD_CELL):
    """Least time in ms of one K2-bwd (or K3-bwd) macro step at B envs with
    stride K, and what bounds it: the forward once and the adjoint
    (operations counted above, for this run's touched cells, ``cell_flops``
    each), and the bytes of the history, the cotangents in and out and the
    inputs."""
    conf = sim.conf
    P, steps, n_prim = sim.n_particles, conf.steps, len(sim.sdf_names)
    flops = steps * (FLOP_MPM_BWD_PARTICLE * B * P + cell_flops * cells
                     + FLOP_MPM_BWD_FRICTION * bottom)
    hist = B * math.ceil(steps / K) * 25 * P * 4
    cot = 2 * B * P * 25 * 4 + 2 * B * n_prim * (steps + 1) * 7 * 4  # in and out
    inputs = B * (3 + 1) * 4 + B * n_prim * (12 + 6 * steps) * 4 * 2  # and their cotangents
    return bound(hist + cot + inputs, flops), flops, hist + cot + inputs


def mpm_grad_phases(dev):
    """The MPM training path: K2-bwd parity at K = 1 and K = 9 with its
    witness, K2-seg against the plain forward, K2-bwd on the other
    materials, whip_rope ``train``/``minimize`` at 1024 envs (the main
    path), the ep_len-70 update with truncation, times, bounds and profile.
    Returns the kernels-line entries of K2-bwd and K2-seg and K2-fwd's
    training launches."""
    import torch

    from unidom_torch import make_env
    from unidom_torch.algorithms.apg import build_apg, train
    from unidom_torch.envs.mpm_tasks import grad_test
    from unidom_torch.ops.cuda import mpm_kernel as mk
    from unidom_torch.ops.cuda.cloth_kernel import cloth_robot_step
    from unidom_torch.ops.cuda.mpm_big_kernel import mpm_big_step
    from unidom_torch.ops.cuda.mpm_kernel import mpm_step

    # ---- 16. K2-bwd parity: one whip_rope macro step's VJP at 1024 envs
    t_phase = time.perf_counter()
    env = make_env("whip_rope", batch_size=B_MAIN, device=dev)
    sim = env.simulator
    state = whip_rope_parity_state(env, dev)
    action = torch.tensor(MPM_ACTION, device=dev).expand(B_MAIN, 6).contiguous()
    with torch.no_grad():
        cot = mpm_vjp_cot(mpm_step(sim, state, action))
    rule_k = mk.checkpoint_stride(B_MAIN, sim.n_particles, sim.conf.steps)
    log(f"[mpm-bwd-parity] checkpoint stride rule at B={B_MAIN}: K = {rule_k} (exact history "
        f"{B_MAIN * sim.conf.steps * 25 * sim.n_particles * 4 / 2**20:.1f} MiB per macro step, "
        f"budget {mk.HISTORY_BUDGET / 2**20:g} MiB)")
    if rule_k != MPM_STRIDE:
        fail(f"the stride rule gives K = {rule_k} at B={B_MAIN}, not {MPM_STRIDE}")
    grads_k = {}
    for K in (1, MPM_STRIDE):
        mpm_step.bwd_launches = mpm_step.seg_launches = 0
        grads_k[K] = mpm_vjp(lambda s, a: mpm_step(sim, s, a, ckpt_stride=K), state, action, cot)
        torch.cuda.synchronize()
        log(f"[mpm-bwd-parity] K={K}: {mpm_step.bwd_launches} K2-bwd launches, "
            f"{mpm_step.seg_launches} K2-seg phases")
        if mpm_step.bwd_launches != 1 or mpm_step.seg_launches != (
                0 if K == 1 else math.ceil(sim.conf.steps / K)):
            fail(f"K={K}: unexpected launch counts")
        mpm_action_checks(f"mpm-bwd-parity K={K}", grads_k[K])
    head = lambda ts: [t[:B_MPM_GRAD] for t in ts]  # noqa: E731
    hs = mpm_slice_envs(state, B_MPM_GRAD)
    psim = plain_mpm_sim(sim)
    # PARITY_DRAWS draws of each side (the first kernel draw is grads_k's)
    draws_k = {K: Draws([head(grads_k[K])] + [
        head(mpm_vjp(lambda s, a: mpm_step(sim, s, a, ckpt_stride=K), state, action, cot))
        for _ in range(PARITY_DRAWS - 1)]) for K in (1, MPM_STRIDE)}
    g32 = Draws(mpm_vjp(psim._step_plain, hs, action[:B_MPM_GRAD], head(cot))
                for _ in range(PARITY_DRAWS))
    g64 = mpm_vjp(psim._step_plain, mpm_cast(hs, torch.float64), action[:B_MPM_GRAD].double(),
                  [c.double() for c in head(cot)])
    bwd_err, gates = 0.0, {}
    for K in (1, MPM_STRIDE):
        bwd_err = max(bwd_err, per_env_gate(
            f"mpm-bwd-parity K={K}", MPM_VJP_INPUTS, draws_k[K], g32, g64,
            zero=MPM_PC_ZERO + ("yield_stress",), gates=gates))
    log("[mpm-bwd-parity] K=1 vs K=" + str(MPM_STRIDE) + ", max abs difference over the "
        f"{B_MAIN} envs: " + ", ".join(
            f"{n} {(a - b).abs().max().item():.3e}"
            for n, a, b in zip(MPM_VJP_INPUTS, grads_k[1], grads_k[MPM_STRIDE])))
    wit = mpm_vjp(psim._step_plain, hs.replace(mu=torch.zeros_like(hs.mu),
                                                 lamda=torch.zeros_like(hs.lamda)),
                  action[:B_MPM_GRAD], head(cot))
    ratios = {}
    for name, w, r in zip(MPM_VJP_INPUTS, wit, g64):
        if name in gates:
            e = (w.double() - r).reshape(B_MPM_GRAD, -1)
            ratios[name] = e.norm(dim=1).median().item() / gates[name]
    log("[mpm-bwd-parity] witness, the float32 plain VJP with mu = lamda = 0: median error vs "
        "float64 over the gate " + ", ".join(f"{k} {v:.3e}x" for k, v in ratios.items())
        + f" (the largest must be at least {WITNESS_MARGIN:g}x)")
    if not max(ratios.values()) >= WITNESS_MARGIN:
        fail("the witness without elastic stress passes the K2-bwd gate: the gate holds nothing")
    del grads_k, draws_k, g32, g64, wit
    log(f"[mpm-bwd-parity] {time.perf_counter() - t_phase:.2f} s")

    # ---- 17. K2-seg: one segment's carries against the plain forward's
    t_phase = time.perf_counter()
    with torch.no_grad():
        prepared = sim.prepare(state, action)
        _, hist = mk.launch(sim, prepared, MPM_STRIDE)
        mpm_step.seg_launches = 0
        seg = mk.mpm_step_seg(sim, prepared, hist, MPM_STRIDE, MPM_SEGMENT)
        torch.cuda.synchronize()
        if mpm_step.seg_launches != 1:
            fail("mpm_step_seg did not count its launch")
        t0 = MPM_SEGMENT * MPM_STRIDE
        refs = {}
        for dtype in (torch.float32, torch.float64):
            s = mpm_cast(prepared, dtype)
            carries = []
            for f in range(t0 + seg.shape[1] - 1):
                if f >= t0:
                    carries.append(mk.pack_carry(s))
                s = sim._substep(f, s)
            carries.append(mk.pack_carry(s))
            refs[dtype] = torch.stack(carries, 1)
        seg_err = 0.0
        for name, lo, hi in (("x", 0, 3), ("v", 3, 6), ("C", 6, 15), ("F", 15, 24), ("J", 24, 25)):
            k, p, r = (t[:, :, lo:hi].double() for t in (seg, refs[torch.float32],
                                                          refs[torch.float64]))
            rms_k, rms_p = errors(k, r)[1], errors(p, r)[1]
            seg_err = max(seg_err, (k - p).abs().max().item())
            log(f"[mpm-seg] {name}: rms error vs float64 over the segment's {seg.shape[1]} "
                f"carries: K2-seg {rms_k:.3e}, float32 plain {rms_p:.3e} (gate "
                f"{PARITY_RATIO:g} x {rms_p:.3e} + {MPM_FLOOR[name]:g})")
            if not torch.isfinite(k).all() or rms_k > PARITY_RATIO * rms_p + MPM_FLOOR[name]:
                fail(f"K2-seg {name}: further from float64 than the plain forward")
        seg_ms = cuda_ms(lambda: mk.mpm_step_seg(sim, prepared, hist, MPM_STRIDE, MPM_SEGMENT),
                         reps=10)
        def plain_segment():
            s = prepared
            for f in range(t0, t0 + MPM_STRIDE - 1):
                s = sim._substep(f, s)
            return s

        seg_plain_ms = cuda_ms(plain_segment, reps=1, warmup=1)
        seg_cells, seg_bottom = mpm_work(sim, prepared.x, prepared.x)
        seg_flops, seg_rec = seg_work(sim, B_MAIN, seg.shape[1], seg_cells, seg_bottom, perm=False)
        seg_bound = bound(nbytes([hist[:, 0], seg]) + nbytes(mk.pack_primitives(prepared))
                          + seg_rec, seg_flops)
    log(f"[mpm-seg] segment {MPM_SEGMENT} (substeps {t0}-{t0 + seg.shape[1] - 1}) at B={B_MAIN}: "
        f"K2-seg (launched as K2-bwd's phase) {seg_ms:.4f} ms per launch, the plain forward of "
        f"its {MPM_STRIDE - 1} substeps "
        f"{seg_plain_ms:.2f} ms; bound {seg_bound[0]:.4f} ms ({seg_bound[1]}); "
        f"{time.perf_counter() - t_phase:.2f} s")
    del seg, refs, hist, prepared

    # ---- 18. K2-bwd on the materials whip_rope does not have, position control
    t_phase = time.perf_counter()
    for name in ("water", "plastic", "von_mises"):
        csim, cs, ca = mpm_config_sim(name, B_MPM_CONFIG, dev, position_control=True)
        with torch.no_grad():
            ccot = mpm_vjp_cot(mpm_step(csim, cs, ca), seed=1)
        mpm_step.bwd_launches = 0
        gk = mpm_vjp(lambda s, a: mpm_step(csim, s, a), cs, ca, ccot)
        if mpm_step.bwd_launches != 1:
            fail(f"{name}: {mpm_step.bwd_launches} K2-bwd launches, not 1")
        hcs, hca, hcot = mpm_slice_envs(cs, B_MPM_GRAD), ca[:B_MPM_GRAD], head(ccot)
        zero = MPM_PC_ZERO + (("mu", "lamda") if name == "water" else ()) + (
            () if name == "von_mises" else ("yield_stress",))
        err = per_env_gate(
            f"mpm-bwd-materials {name}", MPM_VJP_INPUTS, head(gk),
            mpm_vjp(csim._step_plain, hcs, hca, hcot),
            mpm_vjp(csim._step_plain, mpm_cast(hcs, torch.float64), hca.double(),
                    [c.double() for c in hcot]), zero=zero)
        mpm_action_checks(f"mpm-bwd-materials {name}", gk)
        bwd_err = max(bwd_err, err)
        log(f"[mpm-bwd-materials] {name}: B={B_MPM_CONFIG}, P={csim.n_particles}, materials "
            f"{sorted(set(csim.material.tolist()))}, K = "
            f"{mk.checkpoint_stride(B_MPM_CONFIG, csim.n_particles, csim.conf.steps)}")
    mpm_step.bwd_launches = 0
    grads = grad_test(n_chained_steps=2, n_iters=2, device="cuda", verbose=False)
    log(f"[mpm-bwd-materials] grad_test on the card: {mpm_step.bwd_launches} K2-bwd launches, "
        f"gradients {[g.round(6).tolist() for g in grads]}")
    if mpm_step.bwd_launches != 4:
        fail(f"grad_test launched K2-bwd {mpm_step.bwd_launches} times, not 4")
    log(f"[mpm-bwd-materials] {time.perf_counter() - t_phase:.2f} s")
    torch.cuda.empty_cache()

    # ---- 19. the main path: whip_rope APG training at 1024 envs
    t_phase = time.perf_counter()
    logdir = ROOT / "build" / "chip_smoke_train_whip_rope"
    shutil.rmtree(logdir, ignore_errors=True)
    n_seg = math.ceil(sim.conf.steps / MPM_STRIDE)
    eval_its = len(range(0, TRAIN_IT + 1, TRAIN_IT))
    mem_before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    mpm_step.launches = mpm_step.bwd_launches = mpm_step.seg_launches = 0
    cloth_robot_step.launches = cloth_robot_step.bwd_launches = 0
    mpm_big_step.launches = 0
    ts, history = train("whip_rope", EP_LEN, B_MAIN, max_it=TRAIN_IT, eval_freq=TRAIN_IT,
                        num_eval_envs=20, logdir=str(logdir), device="cuda")
    torch.cuda.synchronize()
    train_launches = {"fwd": mpm_step.launches, "bwd": mpm_step.bwd_launches,
                      "seg": mpm_step.seg_launches}
    k1 = (cloth_robot_step.launches, cloth_robot_step.bwd_launches)
    updates = TRAIN_IT + 1
    expect = {"fwd": updates * EP_LEN + eval_its * 2 * env.max_steps, "bwd": updates * EP_LEN,
              "seg": updates * EP_LEN * n_seg}
    log(f"[mpm-train] train(whip_rope, ep_len {EP_LEN}, {B_MAIN} envs, {updates} updates, "
        f"{eval_its} evals of 20 envs): launches {train_launches} (expected {expect}), K1 {k1}; "
        f"peak memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB "
        f"({mem_before / 1e9:.3f} GB held before)")
    if train_launches != expect or k1 != (0, 0) or mpm_big_step.launches != 0:
        fail(f"whip_rope training launched K2 {train_launches}, K1 {k1} and K3-fwd "
             f"{mpm_big_step.launches} times")
    for rec in history:
        log(f"[mpm-train] {json.dumps(rec)}")
        if not all(math.isfinite(rec[k]) for k in ("train_reward", "grad_norm", "sps")):
            fail(f"iteration {rec['it']}: non-finite metrics")
        if rec["grad_norm"] <= 0:
            fail(f"iteration {rec['it']}: zero gradient")
    first = torch.load(logdir / "apg_whip_rope_0.pt", map_location=dev, weights_only=True)
    moved = max((p - first["policy"][k]).abs().max().item()
                for k, p in ts.policy.state_dict().items())
    log(f"[mpm-train] parameters moved up to {moved:.3e}; {time.perf_counter() - t_phase:.2f} s")
    if not moved > 0:
        fail("whip_rope training left the parameters where they were")
    del ts, history

    init_ts, minimize, reset_batch, _ = build_apg(env, EP_LEN, device=dev)
    ts = init_ts(0)
    first_state = reset_batch(torch.Generator().manual_seed(0))
    params0 = [p.detach().clone() for p in ts.policy.parameters()]
    seconds = []
    for rep in range(2):
        mpm_step.launches = mpm_step.bwd_launches = mpm_step.seg_launches = 0
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ts, m = minimize(ts, first_state)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        per_update = (mpm_step.launches, mpm_step.bwd_launches, mpm_step.seg_launches)
        if per_update != (EP_LEN, EP_LEN, EP_LEN * n_seg):
            fail(f"one whip_rope minimize launched K2 (fwd, bwd, seg) {per_update} times")
        m = {k: v.item() for k, v in m.items()}
        if not all(math.isfinite(v) for v in m.values()) or m["grad_norm"] <= 0:
            fail(f"whip_rope minimize: metrics {m}")
    peak_train = torch.cuda.max_memory_allocated()
    moved = max((p - q).abs().max().item() for p, q in zip(ts.policy.parameters(), params0))
    if not moved > 0:
        fail("whip_rope minimize left the parameters where they were")
    train_sps = EP_LEN * B_MAIN / seconds[1]
    log(f"[mpm-train] minimize B={B_MAIN}: K2 (fwd, bwd, seg phases) {per_update} per update; "
        f"metrics {m}; parameters moved up to {moved:.3e}; {[round(t, 4) for t in seconds]} s "
        f"per update, {train_sps:.1f} env-steps/s (second update); peak memory "
        f"{peak_train / 1e9:.3f} GB")
    profile_device(f"minimize whip_rope B={B_MAIN}", lambda: minimize(ts, first_state))
    del ts, first_state, params0
    torch.cuda.empty_cache()

    # one update's policy gradient through the kernels against the plain step
    t_phase = time.perf_counter()
    genv = make_env("whip_rope", batch_size=B_MPM_GRAD, device=dev)
    k, p, r = mpm_policy_grads(genv, 0)
    grad_err = per_env_gate(f"mpm-policy-grad B={B_MPM_GRAD}", ["policy"], [k], [p], [r])
    if (r.norm(dim=1) == 0).any():
        fail("a float64 per-env policy gradient is 0")
    log(f"[mpm-policy-grad] {time.perf_counter() - t_phase:.2f} s")
    del genv, k, p, r

    # ---- 20. the configuration that learns: ep_len 70, truncation 10
    t_phase = time.perf_counter()
    init_ts, minimize, reset_batch, _ = build_apg(env, env.max_steps, truncation_length=10,
                                                  device=dev)
    ts = init_ts(0)
    first_state = reset_batch(torch.Generator().manual_seed(0))
    mpm_step.launches = mpm_step.bwd_launches = mpm_step.seg_launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ts, m = minimize(ts, first_state)
    torch.cuda.synchronize()
    long_s = time.perf_counter() - t0
    m = {k: v.item() for k, v in m.items()}
    counts = (mpm_step.launches, mpm_step.bwd_launches, mpm_step.seg_launches)
    log(f"[mpm-train-long] minimize whip_rope ep_len {env.max_steps}, truncation 10, "
        f"B={B_MAIN}, stride K = {rule_k}: {long_s:.3f} s, "
        f"{env.max_steps * B_MAIN / long_s:.1f} env-steps/s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB; K2 (fwd, bwd, seg phases) {counts}; "
        f"metrics {m}")
    if counts != (env.max_steps, env.max_steps, env.max_steps * n_seg):
        fail(f"the ep_len-{env.max_steps} update launched K2 {counts} times")
    if not all(math.isfinite(v) for v in m.values()) or m["grad_norm"] <= 0:
        fail(f"the ep_len-{env.max_steps} update: metrics {m}")
    del ts, first_state
    torch.cuda.empty_cache()
    log(f"[mpm-train-long] {time.perf_counter() - t_phase:.2f} s")

    # ---- 21. K2-bwd times and bounds
    t_phase = time.perf_counter()
    bwd_times, bwd_bounds = {}, {}
    for B in (B_MAIN, B_WIDE):
        wenv = env if B == B_MAIN else make_env("whip_rope", batch_size=B, device=dev)
        wsim = wenv.simulator
        ws = wsim.prepare(whip_rope_parity_state(wenv, dev), action[:1].expand(B, 6))
        K = mk.checkpoint_stride(B, wsim.n_particles, wsim.conf.steps)
        with torch.no_grad():
            fields, frame, vw = mk._inputs(wsim, ws)
            wout, hist = mk.launch(wsim, ws, K)
            wcot = [c.contiguous() for c in mpm_vjp_cot(wout)]
            wcot[5], wcot[6] = (torch.stack([t], 1).contiguous() for t in wcot[5:])
            bwd_times[B] = cuda_ms(lambda: mk._backward(wsim, fields, frame, vw, hist, K, wcot),
                                   reps=5)
            if B == B_MAIN:  # the exact history: no K2-seg phases
                _, hist1 = mk.launch(wsim, ws, 1)
                exact_ms = cuda_ms(lambda: mk._backward(wsim, fields, frame, vw, hist1, 1, wcot),
                                   reps=5)
                log(f"[time] K2-bwd at K = 1, one whip_rope macro step, B={B}: {exact_ms:.4f} ms")
                del hist1
        cells, bottom = mpm_work(wsim, ws.x, wout.x)
        bwd_bounds[B] = mpm_bwd_bound(wsim, B, K, cells, bottom)
        log(f"[time] K2-bwd (K = {K}, with its {math.ceil(wsim.conf.steps / K) if K > 1 else 0} "
            f"K2-seg phases), one whip_rope macro step, B={B}: {bwd_times[B]:.4f} ms; bound "
            f"{bwd_bounds[B][0][0]:.4f} ms ({bwd_bounds[B][0][1]}: {FLOP_MPM_BWD_PARTICLE} "
            f"operations per particle-substep, {cells / B:.1f} touched cells per env and "
            f"substep, {bwd_bounds[B][1] / 1e9:.3f} GFLOP, {bwd_bounds[B][2] / 1e6:.2f} MB); "
            f"K2-bwd at {100 * bwd_bounds[B][0][0] / bwd_times[B]:.2f}% of it")
        del wenv, wsim, ws, wout, hist, wcot, fields, frame, vw
        torch.cuda.empty_cache()
    with torch.enable_grad():
        plain_ms = cuda_ms(lambda: mpm_vjp(psim._step_plain, hs, action[:B_MPM_GRAD], head(cot)),
                           reps=1, warmup=1)
    log(f"[time] the plain VJP (forward and backward, scatter transfer) at B={B_MPM_GRAD}: "
        f"{plain_ms:.2f} ms; phase 21 in {time.perf_counter() - t_phase:.2f} s")

    bwd_entry = {
        "name": "mpm_step_bwd",
        "route": "cuda",
        "source": "unidom_torch/csrc/mpm_step.cu",
        "replaces": "unidom_tpu/ops/pallas/mpm_kernel.py:780",
        "launches": train_launches["bwd"],
        "launches_by_path": {"whip_rope_train": train_launches["bwd"]},
        "max_abs_err": max(bwd_err, grad_err),
        "ms": bwd_times[B_MAIN],
        "plain_ms": plain_ms,
        "bound_ms": bwd_bounds[B_MAIN][0][0],
        "bound_by": bwd_bounds[B_MAIN][0][1],
        "library_ms": None,
    }
    seg_entry = {
        "name": "mpm_step_seg",
        "route": "cuda",
        "source": "unidom_torch/csrc/mpm_step.cu",
        "replaces": "unidom_tpu/ops/pallas/mpm_kernel.py:834",
        "launches": train_launches["seg"],
        "launches_by_path": {"whip_rope_train": train_launches["seg"]},
        "max_abs_err": seg_err,
        "ms": seg_ms,
        "plain_ms": seg_plain_ms,
        "bound_ms": seg_bound[0],
        "bound_by": seg_bound[1],
        "library_ms": None,
    }
    return bwd_entry, seg_entry, train_launches["fwd"]


# ---- the big-grid MPM path through K3-fwd: pour_soup (n_grid 128, a
# 128x64x128 grid, 7,694 particles of water and elastic tofu and vegetables,
# two bowls under collision, 25 substeps per macro step, 120 macro steps) and
# shape_elasto_plastic (n_grid 96, a 48x32x48 grid, 23,940 sigma-clip
# particles pushed by a box, 16 substeps per simulator call, 20 calls per
# macro step, 6 macro steps).
B_SOUP = 32  # pour_soup's rollout width
B_SOUP_PLAIN = 8  # the envs that the plain steps replay
B_ELASTO = 16  # shape_elasto_plastic at the reference's width
B_ELASTO_PLAIN = 4
B_BIG_CONFIG = 64  # a config with more particles than K2 holds on a grid it takes
B_WATER = 256
WATER_STEPS = 5  # pour_water's rollout, cut: a check that it stays on K2
SOUP_TIME_B = (8, 32, 64)
# The rollout's macro steps replayed through the plain steps: before ~90,
# where the random policy's episode starts to break the float32 physics in
# some envs (water at J = 0 through the walls), chaotically, in the plain
# step as in the kernel.
SOUP_REPLAYED = (0, 40, 80)
# the escaping envs' input and action (scripts/pour_soup_f32.py --replay)
SOUP_ESCAPE = ROOT / "build" / "pour_soup_escape.npz"
# bowl 0's macro action in the parity step (moving and tilting; bowl 1 stays)
SOUP_ACTION = (0.5, 0.2, -0.3, 0.0, 0.0, 0.4)
# a push from beside the slab into its side, 0.06 long, in world positions
ELASTO_PUSH = (0.38, 0.0, 0.5, 0.44, 0.0, 0.5)
# Operations of a touched cell under collision, counted from
# unidom_torch/csrc/mpm_device.cuh's grid_op as FLOP_MPM_CELL above: mass
# normalisation, gravity and position 12; per primitive the inverse
# quaternion 13, the offset 3, two rotations 60 and a third for the normal
# 30, the SDF with its gradient (box 28, container 35), influence 2, the
# normal's norm 10, the collider's velocity 12, the normal component 5, the
# tangent 6, its norm 8, friction 2 and the blend 21: 200 for a box, 207 for
# a bowl. K3-fwd's particle work is K2-fwd's (FLOP_MPM_PARTICLE).
FLOP_MPM_GRID = 12
FLOP_MPM_COLLIDE = {"box": 200, "container": 207}


def big_cell_flops(sim):
    """Operations of one touched cell's grid ops for ``sim`` (friction on the
    bottom layers aside)."""
    if sim.use_position_control:
        return FLOP_MPM_CELL
    return FLOP_MPM_GRID + sum(FLOP_MPM_COLLIDE[n] for n in sim.sdf_names)


def big_parity_inputs(env, dev, seed=0):
    """A big-grid env's reset state in the simulator's frame (the focus shift
    applied) with random v and C per particle from a numpy seed, and the
    first sub-action of a macro action: pour_soup's bowl 0 moving and tilting
    (per env about SOUP_ACTION), shape_elasto_plastic's ELASTO_PUSH."""
    import numpy as np
    import torch

    B = env.batch_size
    rng = np.random.default_rng(seed)
    _, s = env.reset(torch.Generator().manual_seed(seed))
    s, shift = env.pre_step(s)
    s = s.replace(
        v=torch.from_numpy(0.2 * rng.standard_normal(s.v.shape, dtype=np.float32)).to(dev),
        C=torch.from_numpy(0.5 * rng.standard_normal(s.C.shape, dtype=np.float32)).to(dev))
    if env.simulator.sdf_names[0] == "container":
        macro = np.clip(np.asarray(SOUP_ACTION, np.float32)
                        + 0.2 * rng.standard_normal((B, 6), dtype=np.float32), -1, 1)
    else:
        macro = np.tile(np.asarray(ELASTO_PUSH, np.float32), (B, 1))
    macro = env.process_pre_step_actions(torch.from_numpy(macro).to(dev), shift[:, 0])
    sub, s = env.get_primitive_actions(macro, s)
    return s, sub[:, 0].contiguous()


def big_plain_env(env, dtype, stop, start=0):
    """Shallow copy of the big-grid ``env`` on its envs ``start`` to
    ``stop`` that runs the plain step in ``dtype``."""
    out = mpm_plain_env(env, dtype)
    out.init_state = mpm_slice_envs(out.init_state, stop, start)
    out.batch_size = stop - start
    return out


def big_outside(env, s, info):
    """Per env, whether a particle of the macro step from ``s`` (``info``,
    its ``step_diff`` info) ended outside the box that the grid's walls
    bound, or not finite, in the simulator's frame."""
    import torch

    conf = env.conf
    target = torch.tensor(conf.res, dtype=s.x.dtype, device=s.x.device) * 0.5 / conf.n_grid
    shift = target - s.x.mean(1)
    shift[:, 1] = 0.0
    x = info["state_list"][-1].x + shift[:, None]
    return ~((x >= 0) & (x <= conf.n_grid * conf.dx)).all(-1).all(-1)


def save_mpm_state(path, state, action, envs):
    """The envs ``envs`` of an MPM state and their action as numpy arrays in
    ``path`` (``.npz``; a primitive's field under ``primitives.<i>.<name>``),
    for ``scripts/pour_soup_f32.py --replay``."""
    import numpy as np

    idx = list(envs)
    arrays = {"action": action[idx].cpu().numpy()}
    for f in dataclasses.fields(state):
        if f.name != "primitives":
            arrays[f.name] = getattr(state, f.name)[idx].cpu().numpy()
    for i, p in enumerate(state.primitives):
        for f in dataclasses.fields(p):
            arrays[f"primitives.{i}.{f.name}"] = getattr(p, f.name)[idx].cpu().numpy()
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **arrays)


def big_parity(what, sim, state, action, n_plain, per_env=False):
    """One macro step through ``sim.step_batch`` (K3-fwd on the card), held
    on its first ``n_plain`` envs against the float32 and float64 plain steps
    by ``mpm_gate`` (``per_env`` as there), with the mu = lamda = 0 witness
    held to the same statistic. Returns (the largest |kernel - plain|, the
    kernel's output)."""
    import torch

    from unidom_torch.ops.cuda.mpm_big_kernel import mpm_big_step
    from unidom_torch.ops.cuda.mpm_kernel import mpm_step

    k2, k3 = mpm_step.launches, mpm_big_step.launches
    with torch.no_grad():
        out_k = sim.step_batch(state, action)
        torch.cuda.synchronize()
        if (mpm_big_step.launches - k3, mpm_step.launches - k2) != (1, 0):
            fail(f"{what}: the step launched K3-fwd {mpm_big_step.launches - k3} and K2-fwd "
                 f"{mpm_step.launches - k2} times, not once and never")
        if not all(torch.isfinite(t).all() for t in mpm_fields(out_k).values()):
            fail(f"{what}: the kernel's output is not finite")
        head, a_head = mpm_slice_envs(state, n_plain), action[:n_plain]
        out_p = sim._step_plain(head, a_head)
        out_64 = sim._step_plain(mpm_cast(head, torch.float64), a_head.double())
        err, gates = mpm_gate(what, mpm_slice_envs(out_k, n_plain), out_p, out_64,
                              per_env=per_env)
        witness = sim._step_plain(head.replace(mu=torch.zeros_like(head.mu),
                                               lamda=torch.zeros_like(head.lamda)), a_head)
    refs = mpm_fields(out_64)

    def stat(t, name):
        t, r = (u.double().reshape(u.shape[0], -1) for u in (t, refs[name]))
        return env_rms(t, r) if per_env else errors(t, r)[1]

    ratios = {name: stat(t, name) / gates[name] for name, t in mpm_fields(witness).items()}
    log(f"[{what}] witness, the float32 plain step with mu = lamda = 0: rms error vs float64 "
        "over the gate " + ", ".join(f"{k} {v:.3e}x" for k, v in ratios.items())
        + f" (must be at least {WITNESS_MARGIN:g}x in v)")
    if not ratios["v"] >= WITNESS_MARGIN:
        fail(f"{what}: the witness without elastic stress passes the gate")
    moved = (out_k.x - state.x).abs().max().item()
    log(f"[{what}] B={state.x.shape[0]} (plain on {n_plain}), P={sim.n_particles}, res "
        f"{sim.conf.res}, {sim.conf.steps} substeps, SDFs {sim.sdf_names}, materials "
        f"{sorted(set(sim.material.tolist()))}; particles moved up to {moved:.3e}")
    if moved < 1e-4:
        fail(f"{what}: the step left the particles where they were")
    return err, out_k


def big_config_sim(B, dev):
    """(simulator, perturbed state, action) with more particles than K2
    holds (an elastic bar at 4 particles per cell width, 64 per cell) on a
    grid that K2 takes: tests/test_pallas_mpm.py's small config otherwise."""
    import numpy as np
    import torch

    from unidom_torch.engine.mpm import ELASTIC, MPMConf, MPMSimulator
    from unidom_torch.engine.primitives import create_primitive

    conf = MPMConf(n_grid=32, dt=2e-4, steps=8, E=100.0, nu=0.1, res=(16, 16, 16),
                   ground_friction=0.5, task="test")
    sim = MPMSimulator(conf, B, use_position_control=False, device=dev)
    s = sim.add_box(None, size=(0.25, 0.06, 0.06), init_pos=(0.5, 0.08, 0.5), material=ELASTIC,
                    density=4.0)
    s.primitives.append(create_primitive(8, 0.2, 666.0, [0.5] * 3, (0.03,) * 3,
                                         (0.5, 0.06, 0.46), device=dev))
    sim.register_primitive_sdf("box")
    s = sim.reset(s)
    rng = np.random.default_rng(2)
    s = s.replace(
        v=torch.from_numpy(0.2 * rng.standard_normal(s.v.shape, dtype=np.float32)).to(dev),
        C=torch.from_numpy(0.5 * rng.standard_normal(s.C.shape, dtype=np.float32)).to(dev))
    a = torch.tensor([[0.4, 0.2, -0.3, 0.05, 0.05, 0.05]], device=dev).expand(B, 6).contiguous()
    return sim, s, a


def big_phases(dev):
    """The big-grid path: K3-fwd parity on pour_soup, shape_elasto_plastic
    and a config that K2 refuses, with witnesses; the pour_soup and
    shape_elasto_plastic rollouts through K3-fwd (the main path) and
    pour_water's through K2; K3-fwd's times at pour_soup B = 8, 32, 64 and
    shape_elasto_plastic B = 16 beside the plain step and the bound.
    Returns the kernels-line entry of K3-fwd and the K2-fwd launches of
    pour_water's rollout."""
    import torch

    from unidom_torch import make_env
    from unidom_torch.algorithms.apg import run_eval
    from unidom_torch.engine.mpm import kernel_route
    from unidom_torch.models.mlp import PolicyMLP
    from unidom_torch.ops.cuda.cloth_kernel import cloth_robot_step
    from unidom_torch.ops.cuda.mpm_big_kernel import mpm_big_step
    from unidom_torch.ops.cuda.mpm_kernel import MAX_CELLS, MAX_PARTICLES, mpm_step

    def counts():
        return {"K3-fwd": mpm_big_step.launches, "K3 CUDA launches": mpm_big_step.cuda_launches,
                "K2-fwd": mpm_step.launches, "K2-bwd": mpm_step.bwd_launches,
                "K1-fwd": cloth_robot_step.launches, "K1-bwd": cloth_robot_step.bwd_launches}

    def zero():
        mpm_big_step.launches = mpm_big_step.cuda_launches = 0
        mpm_step.launches = mpm_step.bwd_launches = mpm_step.seg_launches = 0
        cloth_robot_step.launches = cloth_robot_step.bwd_launches = 0

    # ---- 22. K3-fwd parity: pour_soup, shape_elasto_plastic, and P > 1024
    t_phase = time.perf_counter()
    soup = make_env("pour_soup", batch_size=B_SOUP, device=dev)
    elasto = make_env("shape_elasto_plastic", batch_size=B_ELASTO, device=dev)
    csim, cstate, caction = big_config_sim(B_BIG_CONFIG, dev)
    cells = math.prod(csim.conf.res)
    routes = {n: kernel_route(e.simulator) for n, e in (("pour_soup", soup),
                                                        ("shape_elasto_plastic", elasto))}
    routes["P > 1024"] = kernel_route(csim)
    log(f"[big-parity] routes {routes}; the P > 1024 config: P={csim.n_particles} (K2 holds "
        f"{MAX_PARTICLES}), {cells} cells (K2 takes {MAX_CELLS})")
    if set(routes.values()) != {"k3"} or not (csim.n_particles > MAX_PARTICLES
                                              and cells <= MAX_CELLS):
        fail("the big-grid configurations are not routed to K3-fwd as they should be")
    zero()
    big_err = 0.0
    soup_in = big_parity_inputs(soup, dev)
    err, soup_out = big_parity("big-parity pour_soup", soup.simulator, *soup_in, B_SOUP_PLAIN)
    big_err = max(big_err, err)
    bowl1 = (soup_out.primitives[1].position[:, -1] - soup_in[0].primitives[1].position[:, 0])
    bowl0 = (soup_out.primitives[0].position[:, -1] - soup_in[0].primitives[0].position[:, 0])
    log(f"[big-parity pour_soup] bowl 0 moved by up to {bowl0.norm(dim=1).max().item():.3e}, "
        f"bowl 1 by {bowl1.norm(dim=1).max().item():.3e}")
    if not bowl0.norm(dim=1).min().item() > 1e-5 or bowl1.abs().max().item() > 1e-6:
        fail("pour_soup's parity step: bowl 0 must move and bowl 1 stay")
    elasto_in = big_parity_inputs(elasto, dev)
    err, _ = big_parity("big-parity shape_elasto_plastic", elasto.simulator, *elasto_in,
                        B_ELASTO_PARITY, per_env=True)
    big_err = max(big_err, err)
    err, _ = big_parity("big-parity P > 1024", csim, cstate, caction, B_BIG_CONFIG)
    big_err = max(big_err, err)
    c = counts()
    log(f"[big-parity] launches {c}; {time.perf_counter() - t_phase:.2f} s")
    if (c["K3-fwd"], c["K2-fwd"]) != (3, 0):
        fail(f"the big-grid parity steps launched {c}")
    del soup_out, csim, cstate, caction
    torch.cuda.empty_cache()

    # ---- 23. the main path: pour_soup's policy rollout at 32 envs
    t_phase = time.perf_counter()
    sim = soup.simulator
    steps = sim.conf.steps
    policy = PolicyMLP(soup.observation_size, 2 * soup.action_size,
                       generator=torch.Generator().manual_seed(0), device=dev)
    _, state0 = soup.reset(torch.Generator().manual_seed(1))
    zero()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, acts, rewards = run_eval(policy, None, soup, state0,
                                generator=torch.Generator(device=dev).manual_seed(2))
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    soup_counts = counts()
    expect = {"K3-fwd": soup.max_steps, "K3 CUDA launches": soup.max_steps * (4 * steps + 2),
              "K2-fwd": 0, "K2-bwd": 0, "K1-fwd": 0, "K1-bwd": 0}
    log(f"[big-rollout] run_eval pour_soup B={B_SOUP}: launches {soup_counts} (expected "
        f"{expect}); first rollout {t_first:.3f} s")
    if soup_counts != expect:
        fail(f"the pour_soup rollout launched {soup_counts}")
    if tuple(rewards.shape) != (soup.max_steps, B_SOUP) or not torch.isfinite(rewards).all():
        fail(f"pour_soup rewards of shape {tuple(rewards.shape)} are not all finite")
    # The episode replayed through K3-fwd, SOUP_REPLAYED through the plain
    # steps from the kernel's state. At the first macro step where the
    # kernel's run leaves the walls' box, all its envs are replayed from the
    # same input through the plain steps, and where each leaves is logged,
    # not gated (see SOUP_REPLAYED).
    env32 = big_plain_env(soup, torch.float32, B_SOUP_PLAIN)
    env64 = big_plain_env(soup, torch.float64, B_SOUP_PLAIN)
    s, escaped, first = state0, torch.zeros(B_SOUP, dtype=torch.bool, device=dev), None
    with torch.no_grad():
        for t in range(soup.max_steps):
            _, r_k, _, info = soup.step_diff(acts[t], s)
            out = big_outside(soup, s, info)
            if out.any() and first is None:
                first = (t, out.nonzero().flatten().tolist())
                seen = {}
                for name, dtype in (("float32", torch.float32), ("float64", torch.float64)):
                    s_d = mpm_cast(s, dtype)
                    _, _, _, pinfo = big_plain_env(soup, dtype, B_SOUP).step_diff(
                        acts[t].to(dtype), s_d)
                    seen[name] = big_outside(soup, s_d, pinfo).nonzero().flatten().tolist()
                    del s_d, pinfo
                save_mpm_state(SOUP_ESCAPE, s, acts[t], first[1])
                log(f"[big-rollout] pour_soup macro step {t}: the first where particles leave "
                    f"the walls' box (or are not finite) in the kernel's run, in envs "
                    f"{first[1]}; replayed from the same input, in the float32 plain step's "
                    f"envs {seen['float32']}, the float64 one's {seen['float64']}; their input "
                    f"and action saved to {SOUP_ESCAPE.relative_to(ROOT)}")
            escaped |= out
            if t in SOUP_REPLAYED:
                head, a_head = mpm_slice_envs(s, B_SOUP_PLAIN), acts[t][:B_SOUP_PLAIN]
                _, r_p, _, _ = env32.step_diff(a_head, head)
                _, r_64, _, _ = env64.step_diff(a_head.double(), mpm_cast(head, torch.float64))
                e_k = (r_k[:B_SOUP_PLAIN].double() - r_64).abs()
                e_p = (r_p.double() - r_64).abs()
                log(f"[big-rollout] pour_soup macro step {t} from the kernel's state, reward "
                    f"error vs the float64 plain step: kernel mean {e_k.mean():.3e} max "
                    f"{e_k.max():.3e}, float32 plain mean {e_p.mean():.3e} max "
                    f"{e_p.max():.3e}; rewards mean {r_64.mean():.6f}")
                if e_k.mean() > PARITY_RATIO * e_p.mean() + 1e-6:
                    fail(f"pour_soup macro step {t}: the kernel's rewards are further from "
                         "float64 than the plain step's")
            if t == soup.max_steps - 2:
                last = info["state_list"][-1]
                bowl = (last.primitives[0].position[:, -1]
                        - state0.primitives[0].position[:, 0]).norm(dim=1)
                J = last.J[torch.isfinite(last.J)]
            s = info["state"]
    log(f"[big-rollout] pour_soup episode: {int(escaped.sum())} of {B_SOUP} envs left the walls' "
        f"box at some step (first at {first}); before the last step J in [{J.min().item():.3e}, "
        f"{J.max().item():.3e}] over its finite values; bowl 0 moved by median "
        f"{bowl.median().item():.4f}; rewards (env 0) "
        f"{[round(r, 5) for r in rewards[::20, 0].tolist()]} every 20 steps")
    if not bowl.max().item() > 1e-3:
        fail("pour_soup's bowl did not move")
    del env32, env64
    t_roll = []
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        for _ in range(4):  # a warm rollout, then best of 3
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_eval(policy, None, soup, state0, deterministic=True)
            torch.cuda.synchronize()
            t_roll.append(time.perf_counter() - t0)
    soup_peak = torch.cuda.max_memory_allocated()
    soup_sps = soup.max_steps * B_SOUP / min(t_roll[1:])
    log(f"[big-rollout] pour_soup rollout B={B_SOUP} ({soup.max_steps} macro steps): "
        f"{soup_sps:.1f} env-steps/s through K3-fwd (best of "
        f"{[round(t, 4) for t in t_roll[1:]]} s after a warm {t_roll[0]:.4f} s); peak memory "
        f"{soup_peak / 1e9:.3f} GB")
    profile_device(f"run_eval pour_soup B={B_SOUP}",
                   lambda: run_eval(policy, None, soup, state0, deterministic=True), top=8)
    del policy
    log(f"[big-rollout] pour_soup {time.perf_counter() - t_phase:.2f} s")

    # ---- 24. shape_elasto_plastic's rollout at 16 envs, and pour_water's on K2
    t_phase = time.perf_counter()
    esim = elasto.simulator
    policy = PolicyMLP(elasto.observation_size, 2 * elasto.action_size,
                       generator=torch.Generator().manual_seed(0), device=dev)
    _, e0 = elasto.reset(torch.Generator().manual_seed(1))
    zero()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, eacts, erewards = run_eval(policy, None, elasto, e0,
                                  generator=torch.Generator(device=dev).manual_seed(2))
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    elasto_counts = counts()
    calls = elasto.max_steps * elasto.PUSH_SUBSTEPS
    expect = {"K3-fwd": calls, "K3 CUDA launches": calls * (4 * esim.conf.steps + 2),
              "K2-fwd": 0, "K2-bwd": 0, "K1-fwd": 0, "K1-bwd": 0}
    log(f"[big-rollout] run_eval shape_elasto_plastic B={B_ELASTO}: launches {elasto_counts} "
        f"(expected {expect}); first rollout {t_first:.3f} s")
    if elasto_counts != expect:
        fail(f"the shape_elasto_plastic rollout launched {elasto_counts}")
    if not torch.isfinite(erewards).all():
        fail("shape_elasto_plastic's rewards are not all finite")
    with torch.no_grad():
        _, r_k, _, _ = elasto.step_diff(eacts[0], e0)
        head, a_head = mpm_slice_envs(e0, B_ELASTO_PLAIN), eacts[0][:B_ELASTO_PLAIN]
        _, r_p, _, _ = big_plain_env(elasto, torch.float32, B_ELASTO_PLAIN).step_diff(a_head, head)
        _, r_64, _, _ = big_plain_env(elasto, torch.float64, B_ELASTO_PLAIN).step_diff(
            a_head.double(), mpm_cast(head, torch.float64))
    e_k, e_p = (r_k[:B_ELASTO_PLAIN].double() - r_64).abs(), (r_p.double() - r_64).abs()
    log(f"[big-rollout] shape_elasto_plastic macro step 0 ({elasto.PUSH_SUBSTEPS} simulator "
        f"calls), reward error vs the float64 plain step: kernel mean {e_k.mean():.3e}, float32 "
        f"plain mean {e_p.mean():.3e}; rewards mean {r_64.mean():.6f}")
    if e_k.mean() > PARITY_RATIO * e_p.mean() + 1e-6:
        fail("shape_elasto_plastic: the kernel's rewards are further from float64 than the "
             "plain step's")
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_eval(policy, None, elasto, e0, deterministic=True)
        torch.cuda.synchronize()
        t_elasto = time.perf_counter() - t0
    log(f"[big-rollout] shape_elasto_plastic rollout B={B_ELASTO} ({elasto.max_steps} macro "
        f"steps, {calls} K3-fwd calls): {elasto.max_steps * B_ELASTO / t_elasto:.2f} env-steps/s "
        f"({t_elasto:.4f} s after the counted rollout)")
    del policy
    water = make_env("pour_water", batch_size=B_WATER, max_steps=WATER_STEPS, device=dev)
    wpolicy = PolicyMLP(water.observation_size, 2 * water.action_size,
                        generator=torch.Generator().manual_seed(0), device=dev)
    _, w0 = water.reset(torch.Generator().manual_seed(1))
    zero()
    _, _, wrewards = run_eval(wpolicy, None, water, w0, deterministic=True)
    torch.cuda.synchronize()
    water_counts = counts()
    log(f"[big-rollout] run_eval pour_water B={B_WATER}, {WATER_STEPS} macro steps, route "
        f"{kernel_route(water.simulator)}: launches {water_counts}")
    if (water_counts["K2-fwd"], water_counts["K3-fwd"]) != (WATER_STEPS, 0):
        fail(f"pour_water's rollout launched {water_counts}, not K2-fwd alone")
    if not torch.isfinite(wrewards).all():
        fail("pour_water's rewards are not all finite")
    del water, wpolicy, w0
    log(f"[big-rollout] {time.perf_counter() - t_phase:.2f} s")
    torch.cuda.empty_cache()

    # ---- 25. K3-fwd times beside the plain step and the bound
    t_phase = time.perf_counter()
    times, bounds = {}, {}
    cases = [("pour_soup", B) for B in SOUP_TIME_B] + [("shape_elasto_plastic", B_ELASTO)]
    for name, B in cases:
        env = {("pour_soup", B_SOUP): soup, ("shape_elasto_plastic", B_ELASTO): elasto}.get(
            (name, B)) or make_env(name, batch_size=B, device=dev)
        wsim = env.simulator
        ws, wa = big_parity_inputs(env, dev)
        rounds = []
        with torch.no_grad():
            out = mpm_big_step(wsim, ws, wa)
            for order in (("plain", "kernel"), ("kernel", "plain")):
                r = {}
                for which in order:
                    if which == "kernel":
                        r[which] = cuda_ms(lambda: mpm_big_step(wsim, ws, wa), reps=10)
                    else:
                        r[which] = cuda_ms(lambda: wsim._step_plain(ws, wa), reps=1, warmup=1)
                rounds.append(r)
        key = f"{name} B={B}"
        times[key] = {k: sum(r[k] for r in rounds) / len(rounds) for k in rounds[0]}
        bounds[key] = mpm_bound(wsim, ws, out, big_cell_flops(wsim))
        (b_ms, b_by), flops, moved, cells_env = bounds[key]
        log(f"[big-time] one {name} simulator call, B={B}: K3-fwd {times[key]['kernel']:.4f} ms, "
            f"plain {times[key]['plain']:.4f} ms, speedup "
            f"{times[key]['plain'] / times[key]['kernel']:.1f}x (rounds {rounds}); bound "
            f"{b_ms:.4f} ms ({b_by}: {FLOP_MPM_PARTICLE} operations per particle-substep, "
            f"{big_cell_flops(wsim)} per touched cell, {cells_env:.1f} touched cells per env "
            f"and substep, {flops / 1e9:.3f} GFLOP; {moved / 1e6:.2f} MB in and out); K3-fwd at "
            f"{100 * b_ms / times[key]['kernel']:.2f}% of it")
        del env, wsim, ws, wa, out
        torch.cuda.empty_cache()
    log(f"[big-time] {time.perf_counter() - t_phase:.2f} s")
    main_key = f"pour_soup B={B_SOUP}"
    entry = {
        "name": "mpm_big_step_fwd",
        "route": "cuda",
        "source": "unidom_torch/csrc/mpm_big_step.cu",
        "replaces": "unidom_tpu/ops/pallas/mpm_big_kernel.py:1042",
        "launches": soup_counts["K3-fwd"],
        "launches_by_path": {"pour_soup_run_eval": soup_counts["K3-fwd"],
                             "shape_elasto_plastic_run_eval": elasto_counts["K3-fwd"],
                             "pour_water_run_eval": water_counts["K3-fwd"]},
        "max_abs_err": big_err,
        "ms": times[main_key]["kernel"],
        "plain_ms": times[main_key]["plain"],
        "bound_ms": bounds[main_key][0][0],
        "bound_by": bounds[main_key][0][1],
        "library_ms": None,
    }
    return entry, water_counts["K2-fwd"]


# ---- big-grid training (phases 26-31): K2-bwd under SDF collision (the
# shape_rope family), K3-fwd with checkpoints, K3-seg and K3-bwd (the big
# grids). Their VJPs are held to the K2-bwd gate above (per_env_gate: per
# input cotangent, the median over envs of the kernel's error norm against
# the float64 plain VJP at most PARITY_RATIO times the float32 plain VJP's,
# plus VJP_FLOOR_REL of the median env's norm), on the plain VJPs' envs.
B_ROPE_PLAIN = 16  # shape_rope's plain VJPs, float32 and float64: ~52 GB at 16 envs
ROPE_STRIDE = 12  # the stride rule's K for shape_rope at 64 envs (133 substeps)
ROPE_SEGMENT = 5  # the segment K2-seg alone recomputes there
B_BOWL_PLAIN = 32
B_SOUP_GRAD = 4
SOUP_STRIDE = 5  # the rule's K for pour_soup at 32 envs (25 substeps)
# The plain VJPs here recompute each substep in the backward pass
# (``checkpointed``): pour_soup's float64 one would otherwise keep every
# substep's full-grid intermediates (25 substeps on 1M cells per env). Its
# peak at one env sizes how many of the B_SOUP_GRAD envs the plain VJPs
# hold, within PLAIN_BUDGET bytes.
PLAIN_BUDGET = 60e9
# shape_elasto_plastic's VJP on 16 envs: over 4, the median of the per-env
# errors of the primitive's cotangents (a sum over ~30k cells of terms that
# cancel) moved 2x from run to run, the float32 plain VJP's as the
# kernel's, on the H100 (the float64 builds of the kernels are exact)
B_ELASTO_GRAD = 16
ELASTO_STRIDE = 4  # the rule's K for shape_elasto_plastic at 16 envs (16 substeps)
BIG_CONFIG_STRIDE = 3  # a stride above 1 on the P > 1024 config (8 substeps)
B_BIG_GRAD_PLAIN = 16
ELASTO_SEGMENT = 2
B_POLICY_GRAD = 2  # shape_elasto_plastic's policy gradient: ep_len 1, 20 calls
B_ROPE_TRAIN = 64
ROPE_EVAL_ENVS = 8
SOUP_BWD_TIME_B = (8, 32)
# Operations of collide's adjoint per touched cell and primitive, counted
# from unidom_torch/csrc/mpm_device.cuh's collide_bwd as FLOP_MPM_CELL above
# (its recompute of the forward not counted): the blend 15, friction 28,
# the tangent and its norm 24, the normal component 20, the collider's
# velocity 3, three quaternion rotations' adjoints 306, the normal's 20, the
# influence 6, the SDF's value and gradient (box 60, container 75), the
# inverse quaternion's 35, the offset 3: 520 for a box, 535 for a bowl. A
# touched cell under collision: the forward's FLOP_MPM_GRID and collide's,
# the mass normalisation's adjoint 12, and collide's adjoint per primitive.
FLOP_MPM_COLLIDE_BWD = {"box": 520, "container": 535}


def bwd_cell_flops(sim):
    """Operations of one touched cell's grid ops and their adjoint for
    ``sim`` (friction on the bottom layers aside)."""
    if sim.use_position_control:
        return FLOP_MPM_BWD_CELL
    return FLOP_MPM_GRID + 12 + sum(FLOP_MPM_COLLIDE[n] + FLOP_MPM_COLLIDE_BWD[n]
                                    for n in sim.sdf_names)


def seg_work(sim, B, L, cells, bottom, perm=True):
    """(operations, record bytes) of K3-seg (K2-seg without ``perm``) on a
    segment of L carries of B envs, ``cells`` touched cells per substep over
    the envs (``bottom`` of them on the bottom layers): L P2Gs and grid ops
    (each particle's chain but its G2P, each touched cell's grid ops), L - 1
    G2Ps, and the record written per carry (each touched cell's index and
    momentum and mass, 20 B; K3's each particle's slot in bin order, 4 B)."""
    P = sim.n_particles
    flops = (L * ((FLOP_MPM_PARTICLE - FLOP_MPM_G2P) * B * P + big_cell_flops(sim) * cells
                  + FLOP_MPM_FRICTION * bottom) + (L - 1) * FLOP_MPM_G2P * B * P)
    return flops, L * (20 * cells + (4 * B * P if perm else 0))


def record_check(what, sim, prepared, exact, rec, seg, t0):
    """Hold K3-seg's record of a segment (``rec``, its carries ``seg``
    from substep t0) against the checkpointing forward's P2G: the
    gradient's P2G in double (``p2g_sums``) of each of K3-seg's own
    carries (slot 0 the checkpoint itself), spliced into ``exact`` (a K = 1
    history of the same forward, of which the carries' difference is
    printed). Every slot must have the same touched cells and each recorded
    value (K3-seg sums in float32) within RECORD_REL of the env's largest
    value of its component."""
    import torch

    from unidom_torch.ops.cuda import mpm_big_kernel as mbk

    L = seg.shape[1]
    grids, marks = mbk.recorded_grids(sim, rec, L)
    own = exact.clone()
    own[:, t0:t0 + L] = seg
    for j in range(L):
        gacc, mark = mbk.p2g_sums(sim, prepared, own, 1, t0 + j)
        on = mark.bool()
        other = int((on ^ marks[j]).sum())
        # each env's largest |value| of each component, over its cells
        scale = gacc.abs().amax(dim=1, keepdim=True).clamp_min(1e-30)
        rel = ((grids[j].double() - gacc).abs() / scale)[on & marks[j]]
        over = int((rel > RECORD_REL).sum())
        carry = (seg[:, j] - exact[:, t0 + j]).abs().max().item()
        log(f"[{what}] record slot {j} (substep {t0 + j}): {int(marks[j].sum())} touched cells "
            f"over the envs, {other} touched by one side only; the recorded momentum and mass "
            f"against the double-sum P2G of K3-seg's carry, relative to the env's largest value "
            f"of each: largest {rel.max().item():.3e}, rms {rel.pow(2).mean().sqrt().item():.3e}, "
            f"{over} of {rel.numel()} beyond {RECORD_REL:.3e}; the carry's largest difference "
            f"from the forward's {carry:.3e}")
        if other or over:
            fail(f"{what}: K3-seg's record of substep {t0 + j} is not the P2G of its carry")
        if not torch.isfinite(grids[j]).all():
            fail(f"{what}: K3-seg's record is not finite")
    del own


def checkpointed(sim):
    """Shallow copy of ``sim`` whose plain step recomputes each substep in
    the backward pass instead of keeping its intermediates
    (torch.utils.checkpoint): the same function and gradient, with one
    substep's autograd memory at a time."""
    import torch.utils.checkpoint

    out = copy.copy(sim)
    substep = type(sim)._substep
    out._substep = lambda f, s: torch.utils.checkpoint.checkpoint(substep, out, f, s,
                                                                  use_reentrant=False)
    return out


def grad_gate(what, sim, state, action, steps, n_plain, zero, witness):
    """One macro step's VJP through each kernel step of ``steps`` (K ->
    step(state, action)) on all envs of ``state``, held on its first
    ``n_plain`` envs to per_env_gate against the float32 and float64 plain
    VJPs (scatter transfer, ``checkpointed``), the inputs in ``zero`` (and
    any whose float64 cotangent is 0) 0 on both; the float32 plain VJP of
    ``witness(state, sim)`` (a (state, plain step) pair) must miss the gate
    by WITNESS_MARGIN. Returns (the largest |kernel - plain|, the kernels'
    cotangents by K)."""
    import torch

    psim = plain_mpm_sim(sim)
    cot = mpm_vjp_cot(state)  # the outputs have the inputs' shapes
    names = mpm_vjp_names(len(sim.sdf_names))
    hs, ha, hc = mpm_slice_envs(state, n_plain), action[:n_plain], [c[:n_plain] for c in cot]
    plain = checkpointed(psim)._step_plain
    g32 = mpm_vjp(plain, hs, ha, hc)
    g64 = mpm_vjp(plain, mpm_cast(hs, torch.float64), ha.double(), [c.double() for c in hc])
    # an input that the scene leaves untouched (a ground the material never
    # reaches) has a 0 cotangent in float64: it must be 0 in the kernel too
    found = [n for n, r in zip(names, g64) if n not in zero and not r.abs().max() > 0]
    if found:
        log(f"[{what}] the float64 cotangent is 0 in every env, so must the kernel's be: {found}")
    err, grads, gates = 0.0, {}, {}
    for K, step in steps.items():
        grads[K] = mpm_vjp(step, state, action, cot)
        torch.cuda.synchronize()
        err = max(err, per_env_gate(f"{what} K={K}", names, [g[:n_plain] for g in grads[K]], g32,
                                    g64, zero=tuple(zero) + tuple(found), gates=gates))
    ws, wstep = witness(hs, psim)
    wit = mpm_vjp(wstep, ws, ha, hc)
    ratios = {n: (w.double() - r).reshape(n_plain, -1).norm(dim=1).median().item() / gates[n]
              for n, w, r in zip(names, wit, g64) if n in gates}
    log(f"[{what}] witness: median error vs float64 over the gate "
        + ", ".join(f"{k} {v:.3e}x" for k, v in ratios.items())
        + f" (the largest must be at least {WITNESS_MARGIN:g}x)")
    if not max(ratios.values()) >= WITNESS_MARGIN:
        fail(f"{what}: the witness passes the gate: the gate holds nothing")
    return err, grads


def no_stiffness(s, psim):
    """The witness: the float32 plain step with mu = lamda = 0."""
    import torch

    return (s.replace(mu=torch.zeros_like(s.mu), lamda=torch.zeros_like(s.lamda)),
            checkpointed(psim)._step_plain)


def counts():
    """Every kernel's launch count since ``zero``."""
    from unidom_torch.ops.cuda.cloth_kernel import cloth_robot_step
    from unidom_torch.ops.cuda.mpm_big_kernel import mpm_big_step
    from unidom_torch.ops.cuda.mpm_kernel import mpm_step

    return {"K3-fwd": mpm_big_step.launches, "K3-bwd": mpm_big_step.bwd_launches,
            "K3-seg": mpm_big_step.seg_launches, "K2-fwd": mpm_step.launches,
            "K2-bwd": mpm_step.bwd_launches, "K2-seg": mpm_step.seg_launches,
            "K1-fwd": cloth_robot_step.launches, "K1-bwd": cloth_robot_step.bwd_launches}


def zero():
    """Set every kernel's launch counts to 0."""
    from unidom_torch.ops.cuda.cloth_kernel import cloth_robot_step
    from unidom_torch.ops.cuda.mpm_big_kernel import mpm_big_step
    from unidom_torch.ops.cuda.mpm_kernel import mpm_step

    mpm_big_step.launches = mpm_big_step.bwd_launches = mpm_big_step.seg_launches = 0
    mpm_big_step.cuda_launches = 0
    mpm_step.launches = mpm_step.bwd_launches = mpm_step.seg_launches = 0
    cloth_robot_step.launches = cloth_robot_step.bwd_launches = 0


def big_grad_phases(dev):
    """The big-grid training path and the shape_rope family's: K2-bwd under
    collision on shape_rope and a bowl, K3-bwd and K3-seg on pour_soup,
    shape_elasto_plastic and the P > 1024 config, K3-seg alone, one
    shape_elasto_plastic minimize at 16 envs (the main path) with its policy
    gradient, one shape_rope train iteration at 64 envs through host_reset,
    and K3-bwd's, K3-seg's and K2-bwd's times beside their bounds. Returns
    the kernels-line entries of K3-seg and K3-bwd and K2-bwd's launches in
    the shape_rope iteration."""
    import torch

    from unidom_torch import make_env
    from unidom_torch.algorithms.apg import build_apg, train
    from unidom_torch.ops.cuda import mpm_big_kernel as mbk
    from unidom_torch.ops.cuda import mpm_kernel as mk
    from unidom_torch.ops.cuda.mpm_big_kernel import mpm_big_step
    from unidom_torch.ops.cuda.mpm_kernel import mpm_step

    # ---- 26. K2-bwd under collision: shape_rope at 64 envs, a bowl at 256
    t_phase = time.perf_counter()
    sim, s, a = mpm_config_sim("shape_rope", B_SHAPE_ROPE, dev)
    rule_k = mk.checkpoint_stride(B_SHAPE_ROPE, sim.n_particles, sim.conf.steps)
    log(f"[mpm-collide-bwd] shape_rope B={B_SHAPE_ROPE}, P={sim.n_particles}, {sim.conf.steps} "
        f"substeps, res {sim.conf.res}: stride rule K = {rule_k}")
    if rule_k != ROPE_STRIDE:
        fail(f"the stride rule gives shape_rope K = {rule_k}, not {ROPE_STRIDE}")
    zero()
    collide_err, rope_grads = grad_gate(
        "mpm-collide-bwd shape_rope", sim, s, a,
        {K: functools.partial(lambda s_, a_, K: mpm_step(sim, s_, a_, ckpt_stride=K), K=K)
         for K in (1, ROPE_STRIDE)}, B_ROPE_PLAIN, ("yield_stress",), no_stiffness)
    c = counts()
    if (c["K2-bwd"], c["K2-seg"], c["K3-bwd"]) != (2, math.ceil(sim.conf.steps / ROPE_STRIDE), 0):
        fail(f"shape_rope's VJPs at K = 1 and {ROPE_STRIDE} launched {c}")
    names = mpm_vjp_names(1)
    log(f"[mpm-collide-bwd] shape_rope K=1 vs K={ROPE_STRIDE}, max abs difference over the "
        f"{B_SHAPE_ROPE} envs: " + ", ".join(
            f"{n} {(x - y).abs().max().item():.3e}"
            for n, x, y in zip(names, rope_grads[1], rope_grads[ROPE_STRIDE])))
    zcot = [torch.zeros_like(c) for c in mpm_vjp_cot(s)]
    zgrads = mpm_vjp(lambda s_, a_: mpm_step(sim, s_, a_), s, a, zcot)
    nonzero = [n for n, g in zip(names, zgrads) if g.abs().max() > 0]
    log(f"[mpm-collide-bwd] zero output cotangents: input cotangents not 0 in {nonzero}")
    if nonzero:
        fail(f"K2-bwd turned zero cotangents into non-zero ones in {nonzero}")
    del rope_grads, zgrads
    torch.cuda.empty_cache()
    bsim, bs, ba = mpm_config_sim("bowl_water", B_MPM_CONFIG, dev)

    def position_control(s_, psim):
        """The witness for water, whose mu and lamda play no part: the bowl
        as position control instead of collision."""
        out = copy.copy(psim)
        out.use_position_control = True
        return s_, checkpointed(out)._step_plain

    err, _ = grad_gate("mpm-collide-bwd bowl_water", bsim, bs, ba,
                       {"rule": lambda s_, a_: mpm_step(bsim, s_, a_)}, B_BOWL_PLAIN,
                       ("mu", "lamda", "yield_stress", "friction"), position_control)
    collide_err = max(collide_err, err)
    log(f"[mpm-collide-bwd] bowl_water B={B_MPM_CONFIG}, P={bsim.n_particles}; "
        f"{time.perf_counter() - t_phase:.2f} s")
    del sim, s, a, bsim, bs, ba
    torch.cuda.empty_cache()

    # ---- 27. K3-bwd and K3-seg: pour_soup, shape_elasto_plastic, P > 1024
    t_phase = time.perf_counter()
    big_err = 0.0
    soup = make_env("pour_soup", batch_size=B_SOUP_GRAD, device=dev)
    ss, sa = big_parity_inputs(soup, dev)
    ssim = soup.simulator
    scot = mpm_vjp_cot(ss)
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    mpm_vjp(checkpointed(plain_mpm_sim(ssim))._step_plain,
            mpm_cast(mpm_slice_envs(ss, 1), torch.float64), sa[:1].double(),
            [c[:1].double() for c in scot])
    torch.cuda.synchronize()
    peak64 = torch.cuda.max_memory_allocated() - before
    n_soup = max(1, min(B_SOUP_GRAD, int(PLAIN_BUDGET // peak64)))
    log(f"[big-bwd-parity] pour_soup's float64 plain VJP at one env: {peak64 / 1e9:.2f} GB "
        f"above its inputs, {time.perf_counter() - t0:.2f} s: the plain VJPs hold {n_soup} of the "
        f"{B_SOUP_GRAD} envs")
    del scot
    torch.cuda.empty_cache()
    cases = [("pour_soup", ssim, ss, sa, n_soup, SOUP_STRIDE, ("yield_stress",))]
    elasto = make_env("shape_elasto_plastic", batch_size=B_ELASTO_GRAD, device=dev)
    es, ea = big_parity_inputs(elasto, dev)
    cases.append(("shape_elasto_plastic", elasto.simulator, es, ea, B_ELASTO_GRAD, ELASTO_STRIDE,
                  ("yield_stress", "friction")))
    csim, cs_, ca = big_config_sim(B_BIG_CONFIG, dev)
    cases.append(("P > 1024", csim, cs_, ca, B_BIG_GRAD_PLAIN, BIG_CONFIG_STRIDE,
                  ("yield_stress",)))
    for name, bsim, bs, ba, n_plain, stride, zeros in cases:
        zero()
        err, grads = grad_gate(
            f"big-bwd-parity {name}", bsim, bs, ba,
            {K: functools.partial(lambda s_, a_, K: mpm_big_step(bsim, s_, a_, ckpt_stride=K),
                                  K=K) for K in (1, stride)}, n_plain, zeros, no_stiffness)
        big_err = max(big_err, err)
        c = counts()
        if (c["K3-fwd"], c["K3-bwd"], c["K3-seg"], c["K2-bwd"]) != (
                2, 2, math.ceil(bsim.conf.steps / stride), 0):
            fail(f"{name}'s VJPs at K = 1 and {stride} launched {c}")
        names = mpm_vjp_names(len(bsim.sdf_names))
        log(f"[big-bwd-parity] {name} B={bs.x.shape[0]} (plain on {n_plain}), P={bsim.n_particles}, "
            f"res {bsim.conf.res}, SDFs {bsim.sdf_names}: K=1 vs K={stride}, max abs difference: "
            + ", ".join(f"{n} {(x - y).abs().max().item():.3e}"
                        for n, x, y in zip(names, grads[1], grads[stride])))
        del grads
        torch.cuda.empty_cache()
    log(f"[big-bwd-parity] {time.perf_counter() - t_phase:.2f} s")

    # ---- 28. K3-seg alone on the three configs at their strides: a
    # segment's carries against the plain forward's, and the grids it
    # records for K3-bwd against the checkpointing forward's P2G
    t_phase = time.perf_counter()
    big_seg_err = 0.0
    for name, bsim, bs, ba, _, stride, _ in cases:
        segment = min(ELASTO_SEGMENT, math.ceil(bsim.conf.steps / stride) - 1)
        with torch.no_grad():
            prepared = bsim.prepare(bs, ba)
            _, hist = mbk.launch_big(bsim, prepared, stride)
            mpm_big_step.seg_launches = 0
            seg, rec = mbk.mpm_big_step_seg(bsim, prepared, hist, stride, segment,
                                            with_record=True)
            torch.cuda.synchronize()
            if mpm_big_step.seg_launches != 1:
                fail("mpm_big_step_seg did not count its launch")
            t0, L = segment * stride, seg.shape[1]
            refs = {}
            for dtype in (torch.float32, torch.float64):
                st = mpm_cast(prepared, dtype)
                carries = []
                for f in range(t0 + L - 1):
                    if f >= t0:
                        carries.append(mk.pack_carry(st))
                    st = bsim._substep(f, st)
                carries.append(mk.pack_carry(st))
                refs[dtype] = torch.stack(carries, 1)
            for field, lo, hi in (("x", 0, 3), ("v", 3, 6), ("C", 6, 15), ("F", 15, 24),
                                  ("J", 24, 25)):
                k, p, r = (t[:, :, lo:hi].double() for t in (seg, refs[torch.float32],
                                                              refs[torch.float64]))
                rms_k, rms_p = errors(k, r)[1], errors(p, r)[1]
                big_seg_err = max(big_seg_err, (k - p).abs().max().item())
                log(f"[big-seg {name}] {field}: rms error vs float64 over the segment's {L} "
                    f"carries: K3-seg {rms_k:.3e}, float32 plain {rms_p:.3e} (gate "
                    f"{PARITY_RATIO:g} x {rms_p:.3e} + {MPM_FLOOR[field]:g})")
                if not torch.isfinite(k).all() or rms_k > PARITY_RATIO * rms_p + MPM_FLOOR[field]:
                    fail(f"K3-seg {name} {field}: further from float64 than the plain forward")
            del refs
            _, exact = mbk.launch_big(bsim, prepared, 1)  # every substep's carry
            record_check(f"big-seg {name}", bsim, prepared, exact, rec, seg, t0)
        log(f"[big-seg {name}] B={bs.x.shape[0]}, segment {segment} (substeps {t0}-{t0 + L - 1}) "
            f"of a K={stride} history")
        del seg, rec, hist, exact, prepared
        torch.cuda.empty_cache()
    log(f"[big-seg] {time.perf_counter() - t_phase:.2f} s")
    del soup, ss, sa, csim, cs_, ca, cases, elasto, es, ea
    torch.cuda.empty_cache()

    # ---- 29. the main path: one shape_elasto_plastic minimize at 16 envs
    t_phase = time.perf_counter()
    env = make_env("shape_elasto_plastic", batch_size=B_ELASTO, device=dev)
    calls = EP_LEN * env.PUSH_SUBSTEPS
    init_ts, minimize, reset_batch, _ = build_apg(env, EP_LEN, device=dev)
    ts = init_ts(0)
    first_state = reset_batch(torch.Generator().manual_seed(0))
    params0 = [p.detach().clone() for p in ts.policy.parameters()]
    mem_before = torch.cuda.memory_allocated()
    zero()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ts, m = minimize(ts, first_state)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    elasto_counts = counts()
    peak = torch.cuda.max_memory_allocated()
    n_seg = math.ceil(env.conf.steps / ELASTO_STRIDE)
    expect = {"K3-fwd": calls, "K3-bwd": calls, "K3-seg": calls * n_seg, "K2-fwd": 0,
              "K2-bwd": 0, "K2-seg": 0, "K1-fwd": 0, "K1-bwd": 0}
    m = {k: v.item() for k, v in m.items()}
    moved = max((p - q).abs().max().item() for p, q in zip(ts.policy.parameters(), params0))
    log(f"[big-train] minimize shape_elasto_plastic ep_len {EP_LEN}, B={B_ELASTO} ({calls} "
        f"simulator calls of {env.conf.steps} substeps, stride K = {ELASTO_STRIDE}): launches "
        f"{elasto_counts} (expected {expect}); {train_s:.3f} s, "
        f"{EP_LEN * B_ELASTO / train_s:.2f} env-steps/s; peak memory {peak / 1e9:.3f} GB "
        f"({mem_before / 1e9:.3f} GB held before); metrics {m}; parameters moved up to "
        f"{moved:.3e}")
    if elasto_counts != expect:
        fail(f"the shape_elasto_plastic update launched {elasto_counts}")
    if not all(math.isfinite(v) for v in m.values()) or not m["grad_norm"] > 0:
        fail(f"the shape_elasto_plastic update: metrics {m}")
    if not moved > 0:
        fail("the shape_elasto_plastic update left the parameters where they were")
    profile_device(f"minimize shape_elasto_plastic B={B_ELASTO}", lambda: minimize(ts, first_state),
                   top=8)
    del ts, first_state, params0, env, init_ts, minimize, reset_batch
    torch.cuda.empty_cache()
    # one update's policy gradient through the kernels against the plain step
    genv = make_env("shape_elasto_plastic", batch_size=B_POLICY_GRAD, device=dev)
    k, p, r = mpm_policy_grads(genv, 0, checkpoint=True)
    policy_err = per_env_gate(f"big-policy-grad B={B_POLICY_GRAD}", ["policy"], [k], [p], [r])
    if (r.norm(dim=1) == 0).any():
        fail("a float64 per-env policy gradient of shape_elasto_plastic is 0")
    log(f"[big-train] {time.perf_counter() - t_phase:.2f} s")
    del genv, k, p, r
    torch.cuda.empty_cache()

    # ---- 30. one shape_rope train iteration at 64 envs through host_reset
    t_phase = time.perf_counter()
    rope = make_env("shape_rope", batch_size=B_ROPE_TRAIN, device=dev)
    pushes = rope.DO_RESET_PUSHES * rope.PUSH_SUBSTEPS
    rope_steps, calls = rope.conf.steps, EP_LEN * rope.PUSH_SUBSTEPS
    eval_steps = 2 * rope.max_steps * rope.PUSH_SUBSTEPS  # the sampled and the deterministic eval
    zero()
    with torch.enable_grad():
        _, _, rope_reset, _ = build_apg(rope, EP_LEN, device=dev)
        r0 = rope_reset()
    reset_counts = counts()
    log(f"[rope-train] reset_batch (host_reset) at B={B_ROPE_TRAIN}: launches {reset_counts}; "
        f"the state requires no gradient: {not r0.x.requires_grad}")
    if (reset_counts["K2-fwd"], reset_counts["K2-bwd"]) != (pushes, 0) or r0.x.requires_grad:
        fail(f"host_reset launched {reset_counts}")
    del rope, r0
    logdir = ROOT / "build" / "chip_smoke_train_shape_rope"
    shutil.rmtree(logdir, ignore_errors=True)
    zero()
    torch.cuda.reset_peak_memory_stats()
    ts, history = train("shape_rope", EP_LEN, B_ROPE_TRAIN, max_it=0, eval_freq=1,
                        num_eval_envs=ROPE_EVAL_ENVS, logdir=str(logdir), device="cuda")
    torch.cuda.synchronize()
    rope_counts = counts()
    rope_peak = torch.cuda.max_memory_allocated()
    expect = {"K3-fwd": 0, "K3-bwd": 0, "K3-seg": 0,
              "K2-fwd": 3 * pushes + eval_steps + calls, "K2-bwd": calls,
              "K2-seg": calls * math.ceil(rope_steps / ROPE_STRIDE), "K1-fwd": 0, "K1-bwd": 0}
    rec = history[0]
    first = torch.load(logdir / "apg_shape_rope_0.pt", map_location=dev, weights_only=True)
    moved = max((q - first["policy"][key]).abs().max().item()
                for key, q in ts.policy.state_dict().items())
    log(f"[rope-train] train(shape_rope, ep_len {EP_LEN}, {B_ROPE_TRAIN} envs, one iteration, "
        f"an eval of {ROPE_EVAL_ENVS} envs): launches {rope_counts} (expected {expect}: three "
        f"host resets of {pushes} calls, the evals' {eval_steps}, the update's {calls}); "
        f"{json.dumps(rec)}; {rec['sps']:.2f} training env-steps/s; peak memory "
        f"{rope_peak / 1e9:.3f} GB; parameters moved up to {moved:.3e}; "
        f"{time.perf_counter() - t_phase:.2f} s")
    if rope_counts != expect:
        fail(f"the shape_rope iteration launched {rope_counts}")
    if not all(math.isfinite(rec[key]) for key in ("train_reward", "grad_norm", "sps")) or \
            not rec["grad_norm"] > 0:
        fail(f"the shape_rope iteration: {rec}")
    if not moved > 0:
        fail("the shape_rope iteration left the parameters where they were")
    del ts, history
    torch.cuda.empty_cache()
    shutil.rmtree(logdir, ignore_errors=True)
    profile_device(f"train shape_rope B={B_ROPE_TRAIN}, one iteration",
                   lambda: train("shape_rope", EP_LEN, B_ROPE_TRAIN, max_it=0, eval_freq=1,
                                 num_eval_envs=ROPE_EVAL_ENVS, logdir=str(logdir),
                                 device="cuda"), top=8)
    torch.cuda.empty_cache()

    # ---- 31. K3-bwd, K3-seg and K2-bwd (collision) times beside their bounds
    t_phase = time.perf_counter()
    bwd_times, bwd_bounds, plain_ms = {}, {}, None
    cases = [("shape_elasto_plastic", B_ELASTO)] + [("pour_soup", B) for B in SOUP_BWD_TIME_B]
    for name, B in cases:
        wenv = make_env(name, batch_size=B, device=dev)
        wsim = wenv.simulator
        ws, wa = big_parity_inputs(wenv, dev)
        K = mk.checkpoint_stride(B, wsim.n_particles, wsim.conf.steps)
        with torch.no_grad():
            prepared = wsim.prepare(ws, wa)
            fields, frame, vw = mbk._big_inputs(wsim, prepared, K)
            wout, hist = mbk.launch_big(wsim, prepared, K)
            wcot = mpm_vjp_cot(wout)
            wcot = [c.contiguous() for c in wcot[:5]] + [
                torch.stack(wcot[5::2], 1).contiguous(), torch.stack(wcot[6::2], 1).contiguous()]
            key = f"{name} B={B}"
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            bwd_times[key] = cuda_ms(lambda: mbk._backward(wsim, fields, frame, vw, hist, K, wcot),
                                     reps=5)
            bwd_peak = torch.cuda.max_memory_allocated()
            if K > 1:
                exact = mbk.launch_big(wsim, prepared, 1)[1]
                exact_ms = cuda_ms(lambda: mbk._backward(wsim, fields, frame, vw, exact, 1, wcot),
                                   reps=5)
                del exact
            cells, bottom = mpm_work(wsim, ws.x, wout.x)
            bwd_bounds[key] = mpm_bwd_bound(wsim, B, K, cells, bottom, bwd_cell_flops(wsim))
            (b_ms, b_by), flops, moved = bwd_bounds[key]
            log(f"[big-bwd-time] K3-bwd (K = {K}, with its "
                f"{math.ceil(wsim.conf.steps / K) if K > 1 else 0} K3-seg phases), one {name} "
                f"simulator call, B={B}: {bwd_times[key]:.4f} ms"
                + (f" ({exact_ms:.4f} ms at K = 1)" if K > 1 else "")
                + f"; bound {b_ms:.4f} ms ({b_by}: {FLOP_MPM_BWD_PARTICLE} operations per "
                f"particle-substep, {bwd_cell_flops(wsim)} per touched cell, {cells / B:.1f} "
                f"touched cells per env and substep, {flops / 1e9:.3f} GFLOP, {moved / 1e6:.2f} "
                f"MB); K3-bwd at {100 * b_ms / bwd_times[key]:.2f}% of it; peak memory "
                f"{bwd_peak / 1e9:.3f} GB ({held / 1e9:.3f} GB held before; K3-seg's record "
                f"{B * mbk.record_bytes(wsim, K) / 1e9:.3f} GB of it)")
            if name == "shape_elasto_plastic":
                seg_ms = cuda_ms(lambda: mbk.mpm_big_step_seg(wsim, prepared, hist, K,
                                                              ELASTO_SEGMENT), reps=10)
                L = min(K, wsim.conf.steps - ELASTO_SEGMENT * K)
                seg_flops, seg_bytes = seg_work(wsim, B, L, cells, bottom)
                seg_bound = bound(nbytes([hist[:, 0]]) * (1 + L) + nbytes([frame, vw])
                                  + seg_bytes, seg_flops)
                log(f"[big-bwd-time] K3-seg, segment {ELASTO_SEGMENT} ({L} carries, each one's "
                    f"P2G and grid ops recorded, {L - 1} G2Ps) of one {name} call at B={B}: "
                    f"{seg_ms:.4f} ms; bound {seg_bound[0]:.4f} ms ({seg_bound[1]}: "
                    f"{seg_flops / 1e9:.3f} GFLOP, the record {seg_bytes / 1e6:.2f} MB)")
                hs, ha = mpm_slice_envs(ws, B_ELASTO_GRAD), wa[:B_ELASTO_GRAD]
                hc = [c[:B_ELASTO_GRAD] for c in mpm_vjp_cot(wout)]
                psim = plain_mpm_sim(wsim)

                def plain_segment():
                    st = prepared
                    for f in range(ELASTO_SEGMENT * K, ELASTO_SEGMENT * K + L - 1):
                        st = wsim._substep(f, st)
                    return st

                seg_plain_ms = cuda_ms(plain_segment, reps=1, warmup=1)
                with torch.enable_grad():
                    plain_ms = cuda_ms(lambda: mpm_vjp(psim._step_plain, hs, ha, hc), reps=1,
                                       warmup=1)
                log(f"[big-bwd-time] the plain VJP (forward and backward, scatter transfer) of "
                    f"one {name} call at B={B_ELASTO_GRAD}: {plain_ms:.2f} ms; the plain forward "
                    f"of the segment's {L - 1} substeps at B={B}: {seg_plain_ms:.2f} ms")
        del wenv, wsim, ws, wa, prepared, fields, frame, vw, wout, hist, wcot
        torch.cuda.empty_cache()
    rsim, rs, ra = mpm_config_sim("shape_rope", B_SHAPE_ROPE, dev)
    with torch.no_grad():
        prepared = rsim.prepare(rs, ra)
        fields, frame, vw = mk._inputs(rsim, prepared)
        rout, rhist = mk.launch(rsim, prepared, ROPE_STRIDE)
        rcot = [c.contiguous() for c in mpm_vjp_cot(rout)]
        rcot[5], rcot[6] = (torch.stack([t], 1).contiguous() for t in rcot[5:])
        rope_bwd_ms = cuda_ms(lambda: mk._backward(rsim, fields, frame, vw, rhist, ROPE_STRIDE,
                                                   rcot), reps=5)
        cells, bottom = mpm_work(rsim, rs.x, rout.x)
        rb = mpm_bwd_bound(rsim, B_SHAPE_ROPE, ROPE_STRIDE, cells, bottom, bwd_cell_flops(rsim))
        # K2-fwd (no history) and the standalone K2-seg at the same width
        rope_fwd_ms = cuda_ms(lambda: mk.launch(rsim, prepared), reps=5)
        fb = mpm_bound(rsim, prepared, rout, big_cell_flops(rsim))
        rope_seg_ms = cuda_ms(lambda: mk.mpm_step_seg(rsim, prepared, rhist, ROPE_STRIDE,
                                                      ROPE_SEGMENT), reps=5)
        L = min(ROPE_STRIDE, rsim.conf.steps - ROPE_SEGMENT * ROPE_STRIDE)
        seg_flops, seg_rec = seg_work(rsim, B_SHAPE_ROPE, L, cells, bottom, perm=False)
        sb = bound(nbytes([rhist[:, 0]]) * (1 + L) + nbytes([frame, vw]) + seg_rec, seg_flops)
    log(f"[big-bwd-time] K2-bwd under collision (K = {ROPE_STRIDE}, with its "
        f"{math.ceil(rsim.conf.steps / ROPE_STRIDE)} K2-seg phases), one shape_rope call, "
        f"B={B_SHAPE_ROPE}: {rope_bwd_ms:.4f} ms; bound {rb[0][0]:.4f} ms ({rb[0][1]}: "
        f"{bwd_cell_flops(rsim)} operations per touched cell, {cells / B_SHAPE_ROPE:.1f} touched "
        f"cells per env and substep); K2-bwd at {100 * rb[0][0] / rope_bwd_ms:.2f}% of it; phase "
        f"31 in {time.perf_counter() - t_phase:.2f} s")
    log(f"[big-bwd-time] K2-fwd under collision (no history), one shape_rope call, "
        f"B={B_SHAPE_ROPE}: {rope_fwd_ms:.4f} ms; bound {fb[0][0]:.4f} ms ({fb[0][1]}: "
        f"{big_cell_flops(rsim)} operations per touched cell, {fb[3]:.1f} touched cells per env "
        f"and substep, {fb[1] / 1e9:.3f} GFLOP, {fb[2] / 1e6:.2f} MB); K2-fwd at "
        f"{100 * fb[0][0] / rope_fwd_ms:.2f}% of it")
    log(f"[big-bwd-time] K2-seg alone (launched as K2-bwd's phase), segment {ROPE_SEGMENT} "
        f"({L} carries) of one shape_rope call at B={B_SHAPE_ROPE}: {rope_seg_ms:.4f} ms; bound "
        f"{sb[0]:.4f} ms ({sb[1]})")
    del rsim, rs, ra, prepared, fields, frame, vw, rout, rhist, rcot
    torch.cuda.empty_cache()

    main_key = f"shape_elasto_plastic B={B_ELASTO}"
    seg_entry = {
        "name": "mpm_big_step_seg",
        "route": "cuda",
        "source": "unidom_torch/csrc/mpm_big_step.cu",
        "replaces": "unidom_tpu/ops/pallas/mpm_big_kernel.py:1055",
        "launches": elasto_counts["K3-seg"],
        "launches_by_path": {"shape_elasto_plastic_minimize": elasto_counts["K3-seg"]},
        "max_abs_err": big_seg_err,
        "ms": seg_ms,
        "plain_ms": seg_plain_ms,
        "bound_ms": seg_bound[0],
        "bound_by": seg_bound[1],
        "library_ms": None,
    }
    bwd_entry = {
        "name": "mpm_big_step_bwd",
        "route": "cuda",
        "source": "unidom_torch/csrc/mpm_big_step.cu",
        "replaces": "unidom_tpu/ops/pallas/mpm_big_kernel.py:1076",
        "launches": elasto_counts["K3-bwd"],
        "launches_by_path": {"shape_elasto_plastic_minimize": elasto_counts["K3-bwd"]},
        "max_abs_err": max(big_err, policy_err),
        "ms": bwd_times[main_key],
        "plain_ms": plain_ms,
        "bound_ms": bwd_bounds[main_key][0][0],
        "bound_by": bwd_bounds[main_key][0][1],
        "library_ms": None,
    }
    return seg_entry, bwd_entry, rope_counts["K2-bwd"], collide_err


# ---- [k2-design] and [k3-design]: what the card makes of the MPM backward
# kernels (registers, local memory, shared memory, CTAs per cluster, blocks
# per SM) and their times per width; the grids K3-seg records for K3-bwd
# against the checkpointing forward's P2G (record_check).
K2_DESIGN_B = (16, 64, 256)  # shape_rope envs
K2_DESIGN_CLUSTERS = (1, 2, 4)  # the variants timed at shape_rope's 64 envs
K3_DESIGN_B = (8, 16)  # shape_elasto_plastic envs
# K3-seg's record of each of its carries against the forward's P2G of that
# carry in double: K3-seg sums a cell's ~340 shares (shape_elasto_plastic)
# in float32 in a varying order, so each recorded value may miss the exact
# sum by a few float32 spacings of the shares' size; it must lie within
# RECORD_REL (2^-16, 1.5e-5) of its env's largest value of the same
# component. A share lost or put on another cell moves a value by ~1/340 of
# a cell's, ~3e-3 of the largest.
RECORD_REL = 2.0**-16


def k2_bwd_inputs(sim, s, a, K):
    """(fields, frame, vw, history at stride K, output cotangents) of one
    K2-bwd call from state ``s`` under action ``a`` (one primitive)."""
    import torch

    from unidom_torch.ops.cuda import mpm_kernel as mk

    with torch.no_grad():
        prepared = sim.prepare(s, a)
        fields, frame, vw = mk._inputs(sim, prepared)
        out, hist = mk.launch(sim, prepared, K)
        cot = [c.contiguous() for c in mpm_vjp_cot(out)]
        cot[5], cot[6] = (torch.stack([t], 1).contiguous() for t in cot[5:])
    return fields, frame, vw, hist, cot


def k2_design_phase(dev):
    """[k2-design]: K2-fwd's launch as fwd_launch_config picks it and
    K2-bwd's as launch_config picks it, on shape_rope at K2_DESIGN_B envs
    and whip_rope at 1024 (and the other cluster sizes at shape_rope's 64):
    registers, local memory, shared memory per CTA, CTAs per cluster, CTAs
    per SM, clusters resident, and ms per call; each K2-fwd launch's outputs
    held to the float64 plain step by mpm_gate; K2-fwd's substep split into
    its phases (stencils zeroed, P2G, grid ops, G2P) by clock64() stamps of
    the launch's first CTA, from a launch of the stamped instantiation
    (the timed one is the main path's)."""
    import torch

    from unidom_torch import make_env
    from unidom_torch.ops.cuda import mpm_kernel as mk

    t_phase = time.perf_counter()
    device = torch.cuda.current_device()

    refs = {}  # the plain steps (float32, float64) per configuration and B

    def timed_fwd(name, B, sim, s, a, cluster=None):
        conf = sim.conf
        cfg = mk.fwd_launch_config(B, sim.n_particles, math.prod(conf.res), conf.steps,
                                   len(sim.sdf_names), cluster)
        info = mk.fwd_kernel_info(cfg, device)
        with torch.no_grad():
            prepared = sim.prepare(s, a)
            fields, frame, vw = mk._inputs(sim, prepared)
            ms = cuda_ms(lambda: mk._forward(sim, fields, frame, vw, cluster=cluster), reps=5,
                         warmup=1)
            if (name, B) not in refs:
                refs[(name, B)] = (sim._step_plain(s, a),
                                   sim._step_plain(mpm_cast(s, torch.float64), a.double()))
            out = mk._rebuild(prepared, mk._forward(sim, fields, frame, vw, cluster=cluster))
            mpm_gate(f"k2-design K2-fwd {name} B={B} cluster of {cfg.cluster}", out,
                     *refs[(name, B)])
            del out
            clocks = torch.zeros(6, dtype=torch.int64, device=dev)
            mk._forward(sim, fields, frame, vw, cluster=cluster, clocks=clocks)
            clocks = clocks.tolist()
        if clocks[5] != 4 * conf.steps:
            fail(f"K2-fwd's stamped launch counted {clocks[5]} phases, not 4 x {conf.steps}")
        total = sum(clocks[:4])
        waves = math.ceil(B * cfg.cluster / (N_SMS * max(info["blocks_per_sm"], 1)))
        log(f"[k2-design] K2-fwd {name} B={B}, cluster of {cfg.cluster}"
            f"{' (chosen)' if cluster is None else ''}: {cfg.threads} threads and "
            f"{cfg.per_cta} particles per CTA, {info['registers']} registers, "
            f"{info['local_bytes']} B local memory per thread, {cfg.smem} B dynamic + "
            f"{info['static_smem']} B static shared memory per CTA, {info['blocks_per_sm']} CTAs "
            f"per SM, {info['clusters']} clusters resident; {ms:.4f} ms ({waves} waves); a "
            f"substep's phases in the first CTA: " + ", ".join(
                f"{n} {100 * c / total:.1f}% ({ms * c / total / conf.steps * 1e3:.2f} us)"
                for n, c in zip(("stencils zeroed", "P2G", "grid ops", "G2P"), clocks[:4])))
        del fields, frame, vw, prepared
        return ms

    fwd_times = {}
    for B in K2_DESIGN_B:
        sim, s, a = mpm_config_sim("shape_rope", B, dev)
        fwd_times[B] = timed_fwd("shape_rope", B, sim, s, a)
        if B == B_SHAPE_ROPE:
            chosen = mk.fwd_launch_config(B, sim.n_particles, math.prod(sim.conf.res),
                                          sim.conf.steps, 1).cluster
            for cl in K2_DESIGN_CLUSTERS:
                if cl != chosen:
                    timed_fwd("shape_rope", B, sim, s, a, cl)
        del sim, s, a
        refs.clear()
    env = make_env("whip_rope", batch_size=B_MAIN, device=dev)
    s = whip_rope_parity_state(env, dev)
    a = torch.tensor(MPM_ACTION, device=dev).expand(B_MAIN, 6).contiguous()
    fwd_times["whip_rope"] = timed_fwd("whip_rope", B_MAIN, env.simulator, s, a)
    del env, s, a
    refs.clear()
    torch.cuda.empty_cache()

    def timed(name, B, sim, s, a, cluster=None):
        conf = sim.conf
        cfg = mk.launch_config(B, sim.n_particles, conf.res[0] * conf.res[1] * conf.res[2],
                               conf.steps, len(sim.sdf_names), cluster)
        info = mk.bwd_kernel_info(cfg, device)
        fields, frame, vw, hist, cot = k2_bwd_inputs(sim, s, a, cfg.K)
        ms = cuda_ms(lambda: mk._backward(sim, fields, frame, vw, hist, cfg.K, cot, cluster),
                     reps=3, warmup=1)
        waves = math.ceil(B * cfg.cluster / (N_SMS * max(info["blocks_per_sm"], 1)))
        log(f"[k2-design] K2-bwd {name} B={B}, K = {cfg.K}, cluster of {cfg.cluster}"
            f"{' (chosen)' if cluster is None else ''}: {cfg.threads} threads and "
            f"{cfg.per_cta} particles per CTA, {info['registers']} registers, "
            f"{info['local_bytes']} B local memory per thread, {cfg.smem} B dynamic + "
            f"{info['static_smem']} B static shared memory per CTA, {info['blocks_per_sm']} CTAs "
            f"per SM, {info['clusters']} clusters resident; {ms:.4f} ms ({waves} waves)")
        del fields, frame, vw, hist, cot
        torch.cuda.empty_cache()
        return ms

    times = {}
    for B in K2_DESIGN_B:
        sim, s, a = mpm_config_sim("shape_rope", B, dev)
        times[B] = timed("shape_rope", B, sim, s, a)
        if B == B_SHAPE_ROPE:
            chosen = mk.launch_config(B, sim.n_particles, math.prod(sim.conf.res),
                                      sim.conf.steps, 1).cluster
            for cl in K2_DESIGN_CLUSTERS:
                if cl != chosen:
                    timed("shape_rope", B, sim, s, a, cl)
        del sim, s, a
    env = make_env("whip_rope", batch_size=B_MAIN, device=dev)
    s = whip_rope_parity_state(env, dev)
    a = torch.tensor(MPM_ACTION, device=dev).expand(B_MAIN, 6).contiguous()
    times["whip_rope"] = timed("whip_rope", B_MAIN, env.simulator, s, a)
    del env, s, a
    torch.cuda.empty_cache()
    log(f"[k2-design] {time.perf_counter() - t_phase:.2f} s")
    return fwd_times, times


def device_ms_by_kernel(fn):
    """fn() once under torch.profiler: {kernel name: (device ms, launches)}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    return by_name


# K3-bwd's launches by kernel name (the profiler's names hold them)
K3_BWD_LAUNCHES = (("zero and count", "big_zero_kernel"), ("bins' scan", "big_bin_kernel"),
                   ("P2G", "p2g"), ("grid ops", "big_grid_kernel"), ("G2P", "big_g2p_kernel"),
                   ("rebuild", "big_rebuild_kernel"), ("G2P adjoint", "big_g2p_bwd_kernel"),
                   ("grid ops adjoint", "big_grid_bwd_kernel"),
                   ("particle adjoint", "big_particle_bwd_kernel"))
# K3-fwd's rollout launches by kernel name (the profiler's names hold them)
K3_ROLLOUT_LAUNCHES = (("pack", "big_pack_kernel"), ("bins' scan", "big_bin_kernel"),
                       ("P2G", "big_p2g_sorted_kernel"), ("grid ops", "big_grid_kernel"),
                       ("G2P", "big_g2p_kernel"), ("unpack", "big_unpack_kernel"))


def k3_design_phase(dev):
    """[k3-design]: each K3 kernel's registers, local memory, shared memory
    and blocks per SM; the rollout's K3-fwd (P2G in bin order, float sums)
    at pour_soup's B_SOUP envs and shape_elasto_plastic's B_ELASTO: ms per
    call and each launch's device ms per substep, and the zeroed scratch the
    simulator keeps for its next rollout checked to be 0 again; K3-bwd's ms per shape_elasto_plastic call
    at K3_DESIGN_B envs; at B_ELASTO, K3-bwd's device ms by launch (with K >
    1 no P2G or scan beyond K3-seg's) and the grids K3-seg records on the
    last segment against the checkpointing forward's P2G (record_check).
    Returns K3-fwd's rollout ms by (env, B) and K3-bwd's by B."""
    import torch

    from unidom_torch import make_env
    from unidom_torch.ops.cuda import mpm_big_kernel as mbk
    from unidom_torch.ops.cuda import mpm_kernel as mk

    t_phase = time.perf_counter()
    device = torch.cuda.current_device()
    for i, name in enumerate(mbk.KERNELS):
        info = mbk.kernel_info(i, device)
        log(f"[k3-design] K3 {name}: {info['threads']} threads per block, {info['registers']} "
            f"registers, {info['local_bytes']} B local memory per thread, {info['static_smem']} B "
            f"static shared memory, 1 CTA per cluster, {info['blocks_per_sm']} blocks per SM")
    rollout = {}
    for name, B in (("pour_soup", B_SOUP), ("shape_elasto_plastic", B_ELASTO)):
        env = make_env(name, batch_size=B, device=dev)
        sim = env.simulator
        ws, wa = big_parity_inputs(env, dev)
        steps = sim.conf.steps
        with torch.no_grad():
            fields, frame, vw = mbk._big_inputs(sim, sim.prepare(ws, wa))
            ms = cuda_ms(lambda: mbk._forward(sim, fields, frame, vw), reps=10, warmup=1)
            by_kernel = device_ms_by_kernel(lambda: mbk._forward(sim, fields, frame, vw))
            torch.cuda.synchronize()
            kept = mbk.zeroed_parts(sim, mbk._ROLLOUT_SCRATCH[sim][1])
            nonzero = [int(t.count_nonzero()) for t in kept]
        log(f"[k3-design] K3-fwd rollout {name} B={B}: the scratch kept for the next rollout "
            f"(float sums, marks, the sort's counters) after 12 calls: {nonzero} entries not 0")
        if any(nonzero):
            fail(f"K3-fwd's rollout left its kept scratch not 0 on {name}")
        rollout[(name, B)] = ms
        split, named = [], 0.0
        for label, kernel in K3_ROLLOUT_LAUNCHES:
            k_ms = sum(m for n, (m, _) in by_kernel.items() if kernel in n)
            k_n = sum(c for n, (_, c) in by_kernel.items() if kernel in n)
            named += k_ms
            split.append(f"{label} {k_ms / max(k_n, 1):.4f} ms x{k_n}")
        other = sum(m for m, _ in by_kernel.values()) - named
        split.append(f"other device work {other:.4f} ms")
        log(f"[k3-design] K3-fwd rollout {name} B={B}, {steps} substeps: {ms:.4f} ms per call; "
            f"one call's device ms per launch by launch (the launches the profiler saw): "
            + "; ".join(split))
        del env, sim, ws, wa, fields, frame, vw, kept
        torch.cuda.empty_cache()
    times = {}
    for B in K3_DESIGN_B:
        env = make_env("shape_elasto_plastic", batch_size=B, device=dev)
        sim = env.simulator
        ws, wa = big_parity_inputs(env, dev)
        K = mk.checkpoint_stride(B, sim.n_particles, sim.conf.steps)
        with torch.no_grad():
            prepared = sim.prepare(ws, wa)
            fields, frame, vw = mbk._big_inputs(sim, prepared, K)
            out, hist = mbk.launch_big(sim, prepared, K)
            cot = mpm_vjp_cot(out)
            cot = [c.contiguous() for c in cot[:5]] + [
                torch.stack(cot[5::2], 1).contiguous(), torch.stack(cot[6::2], 1).contiguous()]
            times[B] = cuda_ms(lambda: mbk._backward(sim, fields, frame, vw, hist, K, cot),
                               reps=3, warmup=1)
            fwd_ms = cuda_ms(lambda: mbk.launch_big(sim, prepared, K), reps=3, warmup=1)
            log(f"[k3-design] shape_elasto_plastic B={B}, K = {K}: K3-bwd {times[B]:.4f} ms per "
                f"call; K3-fwd with its checkpoints (P2G in bin order, double sums) "
                f"{fwd_ms:.4f} ms per call")
            if B == B_ELASTO:
                # K3-bwd's launches by kernel: with K > 1 the P2Gs and scans
                # are K3-seg's alone, one per substep
                by_kernel = device_ms_by_kernel(
                    lambda: mbk._backward(sim, fields, frame, vw, hist, K, cot))
                split = []
                for label, kernel in K3_BWD_LAUNCHES:
                    k_ms = sum(m for n, (m, _) in by_kernel.items() if kernel in n)
                    k_n = sum(c for n, (_, c) in by_kernel.items() if kernel in n)
                    split.append(f"{label} {k_ms:.4f} ms x{k_n}")
                other = sum(m for n, (m, _) in by_kernel.items()
                            if not any(k in n for _, k in K3_BWD_LAUNCHES))
                p2g = sum(c for n, (_, c) in by_kernel.items() if "p2g" in n)
                scans = sum(c for n, (_, c) in by_kernel.items() if "big_bin_kernel" in n)
                log(f"[k3-design] K3-bwd at B={B}, K = {K}, one call's device ms by launch (the "
                    f"launches the profiler saw): " + "; ".join(split)
                    + f"; other device work {other:.4f} ms; P2G launches {p2g} and scans "
                    f"{scans}, K3-seg's {sim.conf.steps} (one per substep) and K3-bwd's own "
                    f"{max(p2g, scans) - sim.conf.steps}")
                if K > 1 and (p2g > sim.conf.steps or scans > sim.conf.steps):
                    fail(f"K3-bwd at K = {K} ran {p2g} P2Gs and {scans} scans: more than "
                         f"K3-seg's {sim.conf.steps}")
                # the grids K3-seg recorded for K3-bwd against the
                # checkpointing forward's, on the last segment
                last = math.ceil(sim.conf.steps / K) - 1
                seg, rec = mbk.mpm_big_step_seg(sim, prepared, hist, K, last, with_record=True)
                _, exact = mbk.launch_big(sim, prepared, 1)
                record_check(f"k3-design B={B} K={K}", sim, prepared, exact, rec, seg, last * K)
                del seg, rec, exact
            del out, hist, cot
        del env, sim, ws, wa, prepared, fields, frame, vw
        torch.cuda.empty_cache()
    log(f"[k3-design] {time.perf_counter() - t_phase:.2f} s")
    return rollout, times


# The DaXBench paths that train on the card only here (train_envs_phases):
# pour_soup at runs/r5/bench_pour_soup.json's 8 envs and ep_len 3 (its
# configuration, not its speed), then wider; pour_water at B_WATER; the
# cloth envs at the main path's 1024 (fold_tshirt at its rollout's 64).
SOUP_TRAIN_B = (8, 32, 64)
B_SOUP_POLICY = 4
B_WATER_POLICY = 8
WATER_EVAL_ENVS = 16
B_ROPE_HARD = 64
B_TSHIRT_TRAIN = 64
B_UNFOLD = 1024
UNFOLD_EVAL_ENVS = 20
B_PARA = 1024
PARA_EVAL_ENVS = 64
PARA_POINTS = 10
ROBOT_STEPS = 40  # robot steps per cloth macro step


def expected(**launches):
    """A ``counts`` dict: the launches given (K1_fwd=... for "K1-fwd"), 0 elsewhere."""
    out = {k: 0 for k in ("K3-fwd", "K3-bwd", "K3-seg", "K2-fwd", "K2-bwd", "K2-seg",
                          "K1-fwd", "K1-bwd")}
    out.update({k.replace("_", "-"): v for k, v in launches.items()})
    return out


def segments(env, B):
    """K2-seg or K3-seg phases per backward call of ``env`` at B envs: one
    per segment of the stride rule's K, none at K = 1."""
    from unidom_torch.ops.cuda import mpm_kernel as mk

    sim = env.simulator
    K = mk.checkpoint_stride(B, sim.n_particles, sim.conf.steps)
    return math.ceil(sim.conf.steps / K) if K > 1 else 0


def check_history(tag, history):
    """Fail unless every record of ``train`` or ``train_para`` has finite
    metrics and a gradient."""
    for rec in history:
        if not all(math.isfinite(rec[k]) for k in ("train_reward", "grad_norm", "sps")) or \
                not rec["grad_norm"] > 0:
            fail(f"{tag}: iteration {rec['it']}: {rec}")


def minimize_phase(tag, env, expect, reset_expect=None):
    """The first state from ``build_apg``'s ``reset_batch`` (its launches
    against ``reset_expect``, none by default), then two updates of ``env``
    at ep_len EP_LEN: each one's launches against ``expect``, finite
    metrics, a gradient, moved parameters; the second's env-steps/s, the
    peak memory and a [profile] of a third. Returns (the reset's launches,
    one update's, env-steps/s)."""
    import torch

    from unidom_torch.algorithms.apg import build_apg

    init_ts, minimize, reset_batch, _ = build_apg(env, EP_LEN, device=env.device)
    ts = init_ts(0)
    zero()
    first = reset_batch(torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    reset_counts = counts()
    if reset_counts != (reset_expect or expected()):
        fail(f"{tag}: the reset launched {reset_counts}, expected {reset_expect or expected()}")
    params0 = [p.detach().clone() for p in ts.policy.parameters()]
    mem_before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    seconds = []
    for _ in range(2):
        zero()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ts, m = minimize(ts, first)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        update = counts()
        m = {k: v.item() for k, v in m.items()}
        if update != expect:
            fail(f"{tag}: one update launched {update}, expected {expect}")
        if not all(math.isfinite(v) for v in m.values()) or not m["grad_norm"] > 0:
            fail(f"{tag}: metrics {m}")
    peak = torch.cuda.max_memory_allocated()
    moved = max((p - q).abs().max().item() for p, q in zip(ts.policy.parameters(), params0))
    if not moved > 0:
        fail(f"{tag}: the updates left the parameters where they were")
    sps = EP_LEN * env.batch_size / seconds[1]
    log(f"[{tag}] reset launches {reset_counts}; per update {update}; metrics {m}; "
        f"{[round(t, 4) for t in seconds]} s per update, {sps:.2f} env-steps/s (second update); "
        f"peak memory {peak / 1e9:.3f} GB ({mem_before / 1e9:.3f} GB held before); parameters "
        f"moved up to {moved:.3e}")
    profile_device(f"minimize {tag}", lambda: minimize(ts, first), top=8)
    return reset_counts, update, sps


def train_phase(tag, name, B, expect, n_eval, **kwargs):
    """``train`` of ``name`` at B envs, ep_len EP_LEN, 2 iterations (one eval
    of ``n_eval`` envs, sampled and deterministic, at the first): the whole
    call's launches against ``expect``, finite metrics and a gradient every
    iteration, env-steps/s and the peak memory. Returns the launches and
    the history."""
    import torch

    from unidom_torch.algorithms.apg import train

    logdir = ROOT / "build" / f"chip_smoke_train_{name}"
    shutil.rmtree(logdir, ignore_errors=True)
    zero()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, history = train(name, EP_LEN, B, max_it=1, eval_freq=2, num_eval_envs=n_eval,
                       logdir=str(logdir), device="cuda", **kwargs)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    got = counts()
    check_history(tag, history)
    log(f"[{tag}] train({name}, ep_len {EP_LEN}, {B} envs, 2 iterations, an eval of {n_eval} "
        f"envs): launches {got} (expected {expect}); "
        + "; ".join(json.dumps(rec) for rec in history)
        + f"; {history[1]['sps']:.2f} training env-steps/s (second update); peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB; {seconds:.2f} s")
    if got != expect:
        fail(f"{tag}: train({name}) launched {got}")
    shutil.rmtree(logdir, ignore_errors=True)
    return got, history


def train_envs_phases(dev):
    """Training on the card of every DaXBench env that no phase above
    trains, through the kernels that exist: pour_soup (K3), pour_water and
    shape_rope_hard (K2 under the bowls' and the box's collision),
    fold_tshirt (K1 at 72 x 78), unfold_cloth1 and unfold_cloth3 (their
    folding resets through K1-fwd) and fold_cloth1_para's parameter-aware
    trainer (a stiffness per env and iteration, and the eval's sweep). Each
    phase checks its launches against what its ep_len, stride rule and reset
    work out to, its loss and gradient norm finite, and prints its
    env-steps/s, peak memory and a [profile]. Returns each path's launches
    by kernel and the largest |kernel - plain| of pour_soup's and of
    pour_water's policy gradients."""
    import torch

    from unidom_torch import make_env
    from unidom_torch.algorithms import apg_para
    from unidom_torch.ops.cuda import cloth_kernel
    from unidom_torch.ops.cuda import mpm_big_kernel as mbk
    from unidom_torch.ops.cuda import mpm_kernel as mk
    from unidom_torch.ops.cuda._build import library_path
    from unidom_torch.ops.metrics import chamfer

    paths = {}  # path -> launch counts

    # ---- [soup-train]: pour_soup updates through K3 with checkpoints, K3-seg, K3-bwd
    t_phase = time.perf_counter()
    for B in SOUP_TRAIN_B:
        env = make_env("pour_soup", batch_size=B, aux_reward=True, device=dev)
        sim = env.simulator
        K = mk.checkpoint_stride(B, sim.n_particles, sim.conf.steps)
        try:
            mbk.check_supported_big(sim, B, K)
        except NotImplementedError as refusal:
            log(f"[soup-train] B={B}: check_supported_big refuses the update: {refusal}")
            continue
        log(f"[soup-train] pour_soup B={B}: {EP_LEN} simulator calls of {sim.conf.steps} "
            f"substeps per update, stride K = {K}, K3 scratch "
            f"{mbk.scratch_bytes(sim, B, K) / 1e9:.2f} GB")
        _, paths[f"pour_soup_minimize_B{B}"], _ = minimize_phase(
            f"soup-train B={B}", env, expected(K3_fwd=EP_LEN, K3_bwd=EP_LEN,
                                               K3_seg=EP_LEN * segments(env, B)))
        del env, sim
        torch.cuda.empty_cache()
    genv = make_env("pour_soup", batch_size=B_SOUP_POLICY, device=dev)
    k, p, r = mpm_policy_grads(genv, 0, checkpoint=True)
    soup_err = per_env_gate(f"soup-policy-grad B={B_SOUP_POLICY}", ["policy"], [k], [p], [r])
    if (r.norm(dim=1) == 0).any():
        fail("a float64 per-env policy gradient of pour_soup is 0")
    del genv, k, p, r
    torch.cuda.empty_cache()
    log(f"[soup-train] {time.perf_counter() - t_phase:.2f} s")

    # ---- [water-train]: pour_water's train through K2 under the bowls' collision
    t_phase = time.perf_counter()
    env = make_env("pour_water", batch_size=B_WATER, device=dev)
    per_call = segments(env, B_WATER)
    evals = 2 * env.max_steps
    del env
    paths["pour_water_train"], _ = train_phase(
        "water-train", "pour_water", B_WATER,
        expected(K2_fwd=evals + 2 * EP_LEN, K2_bwd=2 * EP_LEN, K2_seg=2 * EP_LEN * per_call),
        WATER_EVAL_ENVS)
    env = make_env("pour_water", batch_size=B_WATER, aux_reward=True, device=dev)
    minimize_phase(f"water-train B={B_WATER}", env,
                   expected(K2_fwd=EP_LEN, K2_bwd=EP_LEN, K2_seg=EP_LEN * per_call))
    del env
    genv = make_env("pour_water", batch_size=B_WATER_POLICY, device=dev)
    k, p, r = mpm_policy_grads(genv, 0, checkpoint=True)
    water_err = per_env_gate(f"water-policy-grad B={B_WATER_POLICY}", ["policy"], [k], [p], [r])
    if (r.norm(dim=1) == 0).any():
        fail("a float64 per-env policy gradient of pour_water is 0")
    del genv, k, p, r
    torch.cuda.empty_cache()
    log(f"[water-train] {time.perf_counter() - t_phase:.2f} s")

    # ---- [rope-hard-train]: shape_rope_hard's host reset (its pushes through
    # K2-fwd) and one update through K2 under the box's collision
    t_phase = time.perf_counter()
    env = make_env("shape_rope_hard", batch_size=B_ROPE_HARD, aux_reward=True, device=dev)
    pushes = (env.DO_RESET_PUSHES + env.HARD_RESET_PUSHES) * env.PUSH_SUBSTEPS
    calls = EP_LEN * env.PUSH_SUBSTEPS
    reset_counts, paths["shape_rope_hard_minimize"], _ = minimize_phase(
        f"rope-hard-train B={B_ROPE_HARD}", env,
        expected(K2_fwd=calls, K2_bwd=calls, K2_seg=calls * segments(env, B_ROPE_HARD)),
        reset_expect=expected(K2_fwd=pushes))
    paths["shape_rope_hard_reset"] = reset_counts
    del env
    torch.cuda.empty_cache()
    log(f"[rope-hard-train] the reset's {pushes} K2-fwd calls: 10 pushes of "
        f"{pushes // 10} sub-steps; {time.perf_counter() - t_phase:.2f} s")

    # ---- [tshirt-train]: one fold_tshirt update through K1-bwd at 72 x 78
    t_phase = time.perf_counter()
    env = make_env("fold_tshirt", batch_size=B_TSHIRT_TRAIN, aux_reward=True, device=dev)
    _, s0 = env.reset(torch.Generator().manual_seed(0))
    x = env.packed_x(s0).requires_grad_()
    (g,) = torch.autograd.grad(chamfer(x, env.goal).sum(), x)
    nan_envs = int((~torch.isfinite(g)).flatten(1).any(1).sum())
    log(f"[tshirt-train] the chamfer reward's gradient at the reset is non-finite in {nan_envs} "
        f"of {B_TSHIRT_TRAIN} envs (float32 d^2 <= 0 beside a goal point; the first "
        "normalize_grad zeroes such an env's simulator gradient, as JAX's does)")
    per_update = EP_LEN * ROBOT_STEPS
    _, paths["fold_tshirt_minimize"], _ = minimize_phase(
        f"tshirt-train B={B_TSHIRT_TRAIN}", env, expected(K1_fwd=per_update, K1_bwd=per_update))
    del env, s0, x, g
    torch.cuda.empty_cache()
    log(f"[tshirt-train] {time.perf_counter() - t_phase:.2f} s")

    # ---- [unfold-train]: unfold_cloth1 and unfold_cloth3, their resets'
    # folds through K1-fwd
    t_phase = time.perf_counter()
    for n in (1, 3):
        name = f"unfold_cloth{n}"
        folds = n * ROBOT_STEPS
        evals = 2 * 15 * ROBOT_STEPS  # the sampled and the deterministic eval, 15 macro steps
        # the eval env's reset, each iteration's, the eval, and two updates
        paths[f"{name}_train"], _ = train_phase(
            "unfold-train", name, B_UNFOLD,
            expected(K1_fwd=folds + 2 * folds + evals + 2 * per_update, K1_bwd=2 * per_update),
            UNFOLD_EVAL_ENVS)
        torch.cuda.empty_cache()
    env = make_env("unfold_cloth3", batch_size=B_UNFOLD, aux_reward=True, device=dev)
    minimize_phase(f"unfold-train unfold_cloth3 B={B_UNFOLD}", env,
                   expected(K1_fwd=per_update, K1_bwd=per_update),
                   reset_expect=expected(K1_fwd=3 * ROBOT_STEPS))
    del env
    torch.cuda.empty_cache()
    log(f"[unfold-train] {time.perf_counter() - t_phase:.2f} s")

    # ---- [para-train]: train_para of fold_cloth1_para, a stiffness per env
    # and iteration, the eval's sweep; each launch's stiffness recorded
    t_phase = time.perf_counter()
    logdir = ROOT / "build" / "chip_smoke_train_para"
    shutil.rmtree(logdir, ignore_errors=True)
    lib = library_path(cloth_kernel.SOURCE)
    loads, built = cloth_kernel._lib.cache_info().misses, lib.stat().st_mtime_ns
    draws, seen = [], []
    launch_fwd, launch_bwd, randomize = (cloth_kernel._launch_fwd, cloth_kernel._launch_bwd,
                                         apg_para.randomize_stiffness)

    def record_fwd(sim, inputs, variant=None):
        seen.append(("fwd", inputs[6].clone()))
        return launch_fwd(sim, inputs, variant)

    def record_bwd(sim, inputs, cotangents, variant=None):
        seen.append(("bwd", inputs[6].clone()))
        return launch_bwd(sim, inputs, cotangents, variant)

    def record_draw(*args, **kwargs):
        state = randomize(*args, **kwargs)
        draws.append(state.stiffness.clone())
        return state

    cloth_kernel._launch_fwd, cloth_kernel._launch_bwd = record_fwd, record_bwd
    apg_para.randomize_stiffness = record_draw
    zero()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        _, history = apg_para.train_para(
            "fold_cloth1_para", EP_LEN, B_PARA, max_it=1, eval_freq=2,
            num_eval_envs=PARA_EVAL_ENVS, n_eval_points=PARA_POINTS, logdir=str(logdir),
            device="cuda")
    finally:
        cloth_kernel._launch_fwd, cloth_kernel._launch_bwd = launch_fwd, launch_bwd
        apg_para.randomize_stiffness = randomize
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    got = counts()
    sweep_launches = PARA_POINTS * 3 * ROBOT_STEPS
    expect = expected(K1_fwd=sweep_launches + 2 * per_update, K1_bwd=2 * per_update)
    check_history("para-train", history)
    sweep = history[0]["eval_sweep"]
    log(f"[para-train] train_para(fold_cloth1_para, ep_len {EP_LEN}, {B_PARA} envs, 2 "
        f"iterations, a {PARA_POINTS}-point sweep of {PARA_EVAL_ENVS} envs): launches {got} "
        f"(expected {expect}); " + "; ".join(json.dumps(rec) for rec in history)
        + f"; {history[1]['sps']:.2f} training env-steps/s (second update); peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB; {seconds:.2f} s")
    if got != expect:
        fail(f"train_para launched {got}")
    if len(set(sweep.values())) == 1:
        fail(f"the eval sweep's rewards are all equal: {sweep}")
    # what K1 received: each update's draw in every launch, each sweep point
    # in every eval env, in order
    if len(draws) != 2 or len(seen) != got["K1-fwd"] + got["K1-bwd"]:
        fail(f"recorded {len(draws)} draws and {len(seen)} launches")
    fwd = [t for kind, t in seen if kind == "fwd"]
    bwd = [t for kind, t in seen if kind == "bwd"]
    points = torch.tensor(list(sweep), dtype=torch.float32)
    for i, t in enumerate(fwd[:sweep_launches]):
        if not (t == points[i // (3 * ROBOT_STEPS)].to(t.device)).all():
            fail(f"the sweep's launch {i} ran at stiffness {t.unique().tolist()}")
    updates = fwd[sweep_launches:]
    for it in range(2):
        for t in (updates[it * per_update:(it + 1) * per_update]
                  + bwd[it * per_update:(it + 1) * per_update]):
            if not torch.equal(t, draws[it]):
                fail(f"iteration {it}: K1 received a stiffness other than the draw")
    if torch.equal(draws[0], draws[1]) or len(draws[0].unique()) < B_PARA // 2:
        fail("the stiffness draws do not vary per env and iteration")
    misses, mtime = cloth_kernel._lib.cache_info().misses, lib.stat().st_mtime_ns
    log(f"[para-train] K1 received each iteration's draw (per env, in [{draws[0].min():.1f}, "
        f"{draws[0].max():.1f}]) in all of its {per_update} K1-fwd and K1-bwd launches, and "
        f"each sweep point in all {PARA_EVAL_ENVS} envs of its {3 * ROBOT_STEPS}; the kernel "
        f"library {lib.name}: loaded {misses} time(s) in this process ({loads} before the "
        f"phase), file unchanged: {mtime == built}; sweep {sweep}")
    if misses != loads or mtime != built:
        fail("the stiffness draws or the sweep rebuilt or reloaded the cloth kernels")
    shutil.rmtree(logdir, ignore_errors=True)
    paths["fold_cloth1_para_train"] = got
    env = make_env("fold_cloth1_para", batch_size=B_PARA, aux_reward=True, device=dev)
    minimize_phase(f"para-train B={B_PARA}", env, expected(K1_fwd=per_update, K1_bwd=per_update))
    del env
    torch.cuda.empty_cache()
    log(f"[para-train] {time.perf_counter() - t_phase:.2f} s")
    return paths, soup_err, water_err


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA GPU")
    if not (ROOT / "unidom_torch" / "__init__.py").is_file():
        fail(f"unidom_torch is not beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT))
    import unidom_torch

    if Path(unidom_torch.__file__).resolve().parent != ROOT / "unidom_torch":
        fail(f"imported unidom_torch from {unidom_torch.__file__}, not from {ROOT}")

    import numpy as np

    from unidom_torch import make_env
    from unidom_torch.algorithms.apg import build_apg, run_eval, train
    from unidom_torch.engine.cloth import ClothConf, ClothSimulator
    from unidom_torch.envs.cloth_tasks import goal_path
    from unidom_torch.models.mlp import PolicyMLP
    from unidom_torch.ops.cuda import cloth_kernel, mpm_big_kernel, mpm_kernel
    from unidom_torch.ops.cuda._build import build_library, library_path
    from unidom_torch.ops.cuda.cloth_kernel import cloth_robot_step, cloth_robot_step_vjp_plain
    from unidom_torch.ops.cuda.mpm_kernel import mpm_step

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    log(f"[device] {kind} x{count}; nvidia-smi: {smi}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    # ---- 2. build: one nvcc per source, all started together
    t0 = time.perf_counter()
    sources = (cloth_kernel.SOURCE, mpm_kernel.SOURCE, mpm_big_kernel.SOURCE)
    with ThreadPoolExecutor(len(sources)) as pool:
        build_logs = list(pool.map(build_library, sources))
    log(f"[build] {', '.join(f'{s} -> {library_path(s).name}' for s in sources)} in "
        f"{time.perf_counter() - t0:.2f} s")
    for source, build_log in zip(sources, build_logs):
        for line in build_log.splitlines():
            if any(w in line for w in ("entry function", "registers", "spill", "smem")):
                log(f"[build] {source} ptxas: {line.strip()}")

    # ---- the MPM paths (phases 11-15, see mpm_phases; 16-21, mpm_grad_phases)
    mpm_entry, whip_k1, whip_k3 = mpm_phases(dev)
    torch.cuda.empty_cache()
    bwd_entry, seg_entry, whip_train_fwd = mpm_grad_phases(dev)
    mpm_entry["launches"] = whip_train_fwd
    mpm_entry["launches_by_path"]["whip_rope_train"] = whip_train_fwd
    torch.cuda.empty_cache()
    # ---- the big-grid MPM path (phases 22-25, see big_phases)
    big_entry, water_k2 = big_phases(dev)
    big_entry["launches_by_path"]["whip_rope_run_eval"] = whip_k3
    mpm_entry["launches_by_path"]["pour_water_run_eval"] = water_k2
    torch.cuda.empty_cache()
    # ---- big-grid and shape_rope training (phases 26-31, see big_grad_phases)
    big_seg_entry, big_bwd_entry, rope_k2_bwd, collide_err = big_grad_phases(dev)
    bwd_entry["launches_by_path"]["shape_rope_train"] = rope_k2_bwd
    bwd_entry["max_abs_err"] = max(bwd_entry["max_abs_err"], collide_err)
    torch.cuda.empty_cache()
    # ---- the MPM backward kernels' design (see k2_design_phase, k3_design_phase)
    k2_design_phase(dev)
    k3_design_phase(dev)
    # ---- the other DaXBench envs' training (see train_envs_phases)
    train_paths, soup_err, water_err = train_envs_phases(dev)

    def by_path(kernel):
        return {path: c[kernel] for path, c in train_paths.items() if c[kernel]}

    for entry, kernel in ((mpm_entry, "K2-fwd"), (bwd_entry, "K2-bwd"), (seg_entry, "K2-seg"),
                          (big_entry, "K3-fwd"), (big_seg_entry, "K3-seg"),
                          (big_bwd_entry, "K3-bwd")):
        entry["launches_by_path"].update(by_path(kernel))
    bwd_entry["max_abs_err"] = max(bwd_entry["max_abs_err"], water_err)
    big_bwd_entry["max_abs_err"] = max(big_bwd_entry["max_abs_err"], soup_err)
    torch.cuda.empty_cache()

    t_phase = time.perf_counter()
    with torch.no_grad():
        # ---- 3. kernel parity, one robot step at the main path's shapes
        env = make_env("fold_cloth3", batch_size=B_MAIN, device=dev)
        sim = env.simulator
        gen = torch.Generator(device=dev).manual_seed(0)
        state = perturbed_state(env, gen)
        action = robot_action(B_MAIN, dev)
        out_k = cloth_robot_step(sim, state, action)
        torch.cuda.synchronize()
        out_p = sim._robot_step_plain(state, action)
        env64 = plain_copy(env, torch.float64)
        out_64 = env64.simulator.step_batch(cast(state, torch.float64), action.double())
        errs = {}
        for name, floor in PARITY_FLOOR.items():
            k, p, r = getattr(out_k, name), getattr(out_p, name), getattr(out_64, name)
            if not torch.isfinite(k).all():
                fail(f"kernel {name} is not finite")
            errs[name] = errors(k, p)[0]
            max_k, rms_k = errors(k, r)
            max_p, rms_p = errors(p, r)
            log(f"[parity] {name}: kernel vs plain max abs {errs[name]:.3e}; vs the float64 "
                f"plain step: kernel max {max_k:.3e} rms {rms_k:.3e}, float32 plain max "
                f"{max_p:.3e} rms {rms_p:.3e} "
                f"(gate rms {PARITY_RATIO:g} x {rms_p:.3e} + {floor:g})")
            if rms_k > PARITY_RATIO * rms_p + floor:
                fail(f"{name}: the kernel is further from the float64 step than the plain step")
        moved = (out_k.x - state.x).abs().max().item()
        log(f"[parity] B={B_MAIN}, H x W = {sim.H} x {sim.W}, {sim.conf.n_substeps} substeps; "
            f"cloth moved up to {moved:.3e}")
        if moved < 1e-4:
            fail("the parity step left the cloth where it was")

        # ---- 4. the main path: fold_cloth3 policy rollout through the kernel
        policy = PolicyMLP(env.observation_size, 2 * env.action_size,
                           generator=torch.Generator().manual_seed(0), device=dev)
        _, state0 = env.reset(torch.Generator().manual_seed(1))
        cloth_robot_step.launches = 0
        cloth_robot_step.bwd_launches = 0
        mpm_step.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        final, actions, rewards = run_eval(policy, None, env, state0, deterministic=True)
        torch.cuda.synchronize()
        t_first = time.perf_counter() - t0
        launches, eval_bwd_launches = cloth_robot_step.launches, cloth_robot_step.bwd_launches
        expected = env.max_steps * 40
        log(f"[slice] run_eval fold_cloth3 B={B_MAIN}: {launches} K1-fwd launches "
            f"(expected {expected}), {eval_bwd_launches} K1-bwd (expected 0), "
            f"{mpm_step.launches} K2-fwd (expected 0), first rollout {t_first:.3f} s")
        if launches != expected:
            fail(f"{launches} kernel launches in the rollout, expected {expected}")
        if eval_bwd_launches != 0:
            fail(f"the rollout launched the backward kernel {eval_bwd_launches} times")
        if mpm_step.launches != 0:
            fail(f"the cloth rollout launched the MPM kernel {mpm_step.launches} times")
        if tuple(rewards.shape) != (env.max_steps, B_MAIN) or not torch.isfinite(rewards).all():
            fail(f"rewards of shape {tuple(rewards.shape)} are not all finite")
        conf = env.conf
        lo, hi = final.x.min().item(), final.x.max().item()
        # x = clip(x, 0, 1) + dt * clip(v, -max_v, max_v) at the end of a
        # substep, rounded in float32
        slack = conf.dt * conf.max_v + 1e-6
        checksum = sum(p.double().sum().item() for p in policy.parameters())
        log(f"[slice] policy weight sum {checksum:.6f}; rewards per step (env 0): "
            f"{[round(r, 6) for r in rewards[:, 0].tolist()]}; "
            f"final x in [{lo:.5f}, {hi:.5f}]; cur_step {int(final.cur_step[0])}")
        if not (torch.isfinite(final.x).all() and lo >= -slack and hi <= 1.0 + slack):
            fail(f"final x leaves [0, 1] by more than dt * max_v (+ rounding) = {slack}")
        if not bool((final.cur_step == env.max_steps).all()):
            fail("cur_step is not max_steps after the episode")

        # kernel vs plain: each macro step of a sampled rollout replayed from
        # the kernel's state, then the free-running deterministic episode
        plain_env = plain_copy(env, torch.float32)
        _, sacts, srews = run_eval(policy, None, env, state0,
                                   generator=torch.Generator(device=dev).manual_seed(2))
        s = state0
        for t in range(env.max_steps):
            _, r_k, _, info_k = env.step_diff(sacts[t], s)
            if not torch.equal(r_k, srews[t]):
                fail(f"replayed macro step {t} does not reproduce the sampled rollout's reward")
            _, r_p, _, _ = plain_env.step_diff(sacts[t], s)
            _, r_64, _, _ = env64.step_diff(sacts[t].double(), cast(s, torch.float64))
            e_k, e_p = (r_k.double() - r_64).abs(), (r_p.double() - r_64).abs()
            log(f"[slice] sampled macro step {t} from the kernel's state, reward error vs the "
                f"float64 plain step: kernel mean {e_k.mean():.3e} max {e_k.max():.3e}, float32 "
                f"plain mean {e_p.mean():.3e} max {e_p.max():.3e}; kernel vs plain max "
                f"{(r_k - r_p).abs().max():.3e}")
            if e_k.mean() > PARITY_RATIO * e_p.mean() + 1e-6:
                fail(f"macro step {t}: the kernel's rewards are further from float64 "
                     "than the plain step's")
            s = info_k["state"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, rewards_p = run_eval(policy, None, plain_env, state0, deterministic=True)
        torch.cuda.synchronize()
        t_plain_rollout = time.perf_counter() - t0
        ep_diff = (rewards - rewards_p).abs().max().item()
        log(f"[slice] free-running deterministic episode, kernel vs plain: max reward diff "
            f"{ep_diff:.3e} (gate {TOL_REWARD_EPISODE:g}); plain rewards (env 0) "
            f"{[round(r, 6) for r in rewards_p[:, 0].tolist()]}")
        if ep_diff > TOL_REWARD_EPISODE:
            fail("kernel and plain episodes differ beyond the stated bound")

        # ---- 5. times
        times = {}
        for B in (B_MAIN, B_WIDE):
            wenv = env if B == B_MAIN else make_env("fold_cloth3", batch_size=B, device=dev)
            wsim = wenv.simulator
            ws = perturbed_state(wenv, gen)
            wa = robot_action(B, dev)
            rounds = []
            for order in (("plain", "kernel"), ("kernel", "plain")):
                r = {}
                for which in order:
                    if which == "kernel":
                        r[which] = cuda_ms(lambda: cloth_robot_step(wsim, ws, wa), reps=50)
                    else:
                        r[which] = cuda_ms(lambda: wsim._robot_step_plain(ws, wa), reps=5, warmup=1)
                rounds.append(r)
            times[B] = {k: sum(r[k] for r in rounds) / len(rounds) for k in ("kernel", "plain")}
            log(f"[time] one robot step, B={B}: kernel {times[B]['kernel']:.4f} ms, "
                f"plain {times[B]['plain']:.4f} ms (rounds {rounds}); "
                f"speedup {times[B]['plain'] / times[B]['kernel']:.1f}x")
        t_roll = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_eval(policy, None, env, state0, deterministic=True)
            torch.cuda.synchronize()
            t_roll.append(time.perf_counter() - t0)
        t_best = min(t_roll)
        env_steps = env.max_steps * B_MAIN
        log(f"[time] rollout B={B_MAIN} ({env.max_steps} macro steps): "
            f"{env_steps / t_best:.1f} env-steps/s through the kernel "
            f"(best of {[round(t, 4) for t in t_roll]} s); plain step "
            f"{env_steps / t_plain_rollout:.1f} env-steps/s ({t_plain_rollout:.3f} s)")
        profile_device(f"run_eval B={B_MAIN}",
                       lambda: run_eval(policy, None, env, state0, deterministic=True))

    errs_all = max(errs.values())
    if not math.isfinite(errs_all):
        fail("non-finite kernel error")
    log(f"[time] phases 3-5 in {time.perf_counter() - t_phase:.2f} s")
    del out_k, out_p, out_64, env64, plain_env, state, state0, final
    torch.cuda.empty_cache()

    # ---- 6. K1-bwd parity, one robot step at the main path's shapes
    t_phase = time.perf_counter()
    inputs, cot = vjp_inputs(sim, perturbed_state(env, gen))
    grads_k = cloth_kernel.cloth_robot_step_vjp(sim, inputs, cot)
    torch.cuda.synchronize()
    head = [t[:B_VJP_PLAIN] for t in inputs]
    head_cot = [t[:B_VJP_PLAIN] for t in cot]
    grads_p = cloth_robot_step_vjp_plain(sim, head, head_cot)
    sim64 = plain_sim(sim, torch.float64)
    grads_64 = cloth_robot_step_vjp_plain(sim64, [t.double() for t in head],
                                          [t.double() for t in head_cot])
    for name, g in zip(VJP_NAMES, grads_k):
        if not torch.isfinite(g).all():
            fail(f"K1-bwd {name} is not finite over the {B_MAIN} envs")
    bwd_err = per_env_gate("bwd-parity", VJP_NAMES, [g[:B_VJP_PLAIN] for g in grads_k],
                              grads_p, grads_64)
    log(f"[bwd-parity] kernel on {B_MAIN} envs, held on the first {B_VJP_PLAIN}: "
        f"{time.perf_counter() - t_phase:.2f} s")
    del grads_k, grads_p, grads_64, sim64

    # ---- 6b. both kernels on the border cloth (see BORDER_HW)
    t_phase = time.perf_counter()
    mask = np.zeros((80, 80), np.float32)
    mask[:BORDER_HW[0], :BORDER_HW[1]] = 1.0
    bsim = ClothSimulator(ClothConf(), B_BORDER, mask, device=dev)
    shared = shared_neighbours(bsim)
    if bsim.H * bsim.W <= MAX_BLOCK_THREADS or not shared:
        fail(f"the border cloth ({bsim.H} x {bsim.W}, {shared} particles with a shared "
             "neighbour) does not test what it should")
    bstate = perturb(bsim.reset(), gen)
    baction = robot_action(B_BORDER, dev)
    with torch.no_grad():
        outs = [(o.x, o.v, o.primitive0, o.primitive1) for o in (
            cloth_robot_step(bsim, bstate, baction), bsim._robot_step_plain(bstate, baction),
            plain_sim(bsim, torch.float64)._robot_step_plain(cast(bstate, torch.float64),
                                                             baction.double()))]
    per_env_gate("border-fwd", VJP_NAMES[:4], *outs)
    b_in, b_cot = vjp_inputs(bsim, bstate)
    per_env_gate(
        "border-bwd", VJP_NAMES, cloth_kernel.cloth_robot_step_vjp(bsim, b_in, b_cot),
        cloth_robot_step_vjp_plain(bsim, b_in, b_cot),
        cloth_robot_step_vjp_plain(plain_sim(bsim, torch.float64), [t.double() for t in b_in],
                                   [t.double() for t in b_cot]))
    log(f"[border] {bsim.H} x {bsim.W} = {bsim.H * bsim.W} bbox cells at the grid's corner, "
        f"{shared} particles with two links to one neighbour, B={B_BORDER}: both kernels "
        f"within the gate; {time.perf_counter() - t_phase:.2f} s")
    del bsim, bstate, b_in, b_cot, outs
    torch.cuda.empty_cache()

    # ---- 6c. fold_tshirt through both kernels, and its rollout
    tshirt_launches, tshirt_fwd_err, tshirt_bwd_err = tshirt_phase(dev, gen)
    # ---- 6d. the K1 kernels' design: registers, occupancy, time per wave
    k1_design_phase(dev, gen)

    # ---- 7. the main path: APG training of fold_cloth3 through both kernels
    t_phase = time.perf_counter()
    logdir = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(logdir, ignore_errors=True)
    eval_its = len(range(0, TRAIN_IT + 1, TRAIN_IT))
    expect_bwd = (TRAIN_IT + 1) * EP_LEN * 40
    expect_fwd = expect_bwd + eval_its * 2 * env.max_steps * 40  # sampled and mode evals
    mem_before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cloth_robot_step.launches = 0
    cloth_robot_step.bwd_launches = 0
    mpm_step.launches = 0
    ts, history = train("fold_cloth3", EP_LEN, B_MAIN, max_it=TRAIN_IT, eval_freq=TRAIN_IT,
                        num_eval_envs=20, logdir=str(logdir), device="cuda")
    torch.cuda.synchronize()
    train_launches = {"fwd": cloth_robot_step.launches, "bwd": cloth_robot_step.bwd_launches}
    peak = torch.cuda.max_memory_allocated()
    log(f"[train] train(fold_cloth3, ep_len {EP_LEN}, {B_MAIN} envs, {TRAIN_IT + 1} updates, "
        f"{eval_its} evals of 20 envs): K1-fwd {train_launches['fwd']} launches (expected "
        f"{expect_fwd}), K1-bwd {train_launches['bwd']} (expected {expect_bwd}); peak memory "
        f"{peak / 1e9:.3f} GB ({(peak - mem_before) / 1e9:.3f} GB above the "
        f"{mem_before / 1e9:.3f} GB held before)")
    if train_launches != {"fwd": expect_fwd, "bwd": expect_bwd}:
        fail(f"training launched the kernels {train_launches} times")
    if mpm_step.launches != 0:
        fail(f"fold_cloth3 training launched the MPM kernel {mpm_step.launches} times")
    for rec in history:
        log(f"[train] {json.dumps(rec)}")
        if not all(math.isfinite(rec[k]) for k in ("train_reward", "grad_norm", "sps")):
            fail(f"iteration {rec['it']}: non-finite metrics")
        if rec["grad_norm"] <= 0:
            fail(f"iteration {rec['it']}: zero gradient")
    first = torch.load(logdir / "apg_fold_cloth3_0.pt", map_location=dev, weights_only=True)
    moved = max((p - first["policy"][k]).abs().max().item()
                for k, p in ts.policy.state_dict().items())
    train_sps = max(rec["sps"] for rec in history[1:])
    log(f"[train] parameters moved up to {moved:.3e}; {train_sps:.1f} training env-steps/s "
        f"at {B_MAIN} envs (best of iterations 1-{TRAIN_IT}); {time.perf_counter() - t_phase:.2f} s")
    if not moved > 0:
        fail("training left the parameters where they were")
    del ts, history
    torch.cuda.empty_cache()

    # ---- 8. one minimize per batch width: launches, metrics and env-steps/s
    t_phase = time.perf_counter()
    minimize_sps = {}
    for B in (B_MAIN, B_WIDE):
        if B == B_WIDE and 4 * (peak - mem_before) > MEMORY_LIMIT:
            log(f"[minimize] B={B} skipped: 4x the {B_MAIN}-env update's "
                f"{(peak - mem_before) / 1e9:.2f} GB exceeds {MEMORY_LIMIT / 1e9:g} GB")
            continue
        tenv = make_env("fold_cloth3", batch_size=B, aux_reward=True, device=dev)
        init_ts, minimize, reset_batch, _ = build_apg(tenv, EP_LEN, device=dev)
        ts = init_ts(0)
        first_state = reset_batch(torch.Generator().manual_seed(0))
        params0 = [p.detach().clone() for p in ts.policy.parameters()]
        seconds = []
        for rep in range(2):
            cloth_robot_step.launches = 0
            cloth_robot_step.bwd_launches = 0
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ts, m = minimize(ts, first_state)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            counts = (cloth_robot_step.launches, cloth_robot_step.bwd_launches)
            if counts != (EP_LEN * 40, EP_LEN * 40):
                fail(f"one minimize at B={B} launched the kernels {counts} times")
            m = {k: v.item() for k, v in m.items()}
            if not all(math.isfinite(v) for v in m.values()) or m["grad_norm"] <= 0:
                fail(f"minimize at B={B}: metrics {m}")
        moved = max((p - q).abs().max().item() for p, q in zip(ts.policy.parameters(), params0))
        if not moved > 0:
            fail(f"minimize at B={B} left the parameters where they were")
        minimize_sps[B] = EP_LEN * B / seconds[1]
        log(f"[minimize] B={B}: K1-fwd/K1-bwd launches {counts} per update; metrics {m}; "
            f"parameters moved up to {moved:.3e}; {[round(t, 4) for t in seconds]} s per "
            f"update, {minimize_sps[B]:.1f} env-steps/s (second update); peak memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
        if B == B_MAIN:
            profile_device(f"minimize B={B}", lambda: minimize(ts, first_state))
        del tenv, ts, first_state, params0
        torch.cuda.empty_cache()
    log(f"[minimize] {time.perf_counter() - t_phase:.2f} s")

    # ---- 9. the policy gradient of one update through the kernels, against
    # the plain step in float32 and float64: tiny cloth, then full width
    t_phase = time.perf_counter()
    tiny = ClothConf(task="fold_cloth3", goal_path=goal_path("fold_cloth3"), **TINY)
    _, (k, p, r) = policy_grads(make_env("fold_cloth3", batch_size=B_GRAD, conf=tiny,
                                         aux_reward=False, device=dev), 1)
    grad_err = per_env_gate(f"policy-grad tiny B={B_GRAD}", ["policy"], [k], [p], [r])
    full_env = make_env("fold_cloth3", batch_size=B_GRAD_FULL, aux_reward=False, device=dev)
    rel_k, rel_p, cos_k, cos_p = [], [], [], []
    for seed in FULL_SEEDS:
        split, (k, p, r) = policy_grads(full_env, seed)
        active = r.norm(dim=1) > 0
        rel_k.append(((k - r).norm(dim=1) / r.norm(dim=1))[active])
        rel_p.append(((p - r).norm(dim=1) / r.norm(dim=1))[active])
        cos_k.append(torch.nn.functional.cosine_similarity(k[active], r[active], dim=1))
        cos_p.append(torch.nn.functional.cosine_similarity(p[active], r[active], dim=1))
        log(f"[policy-grad] full width B={B_GRAD_FULL}, noise seed {seed}: {int(active.sum())} "
            f"envs hold cloth; per-env gradient split vs the trainer's: relative norm "
            f"{split:.3e}; relative error vs float64, kernel "
            f"{' '.join(f'{e:.2e}' for e in rel_k[-1].tolist())}, float32 plain "
            f"{' '.join(f'{e:.2e}' for e in rel_p[-1].tolist())}; kernel vs plain max "
            f"{(k - p).abs().max().item():.3e}")
        if not split < 1e-4:
            fail("the per-env gradients do not sum to the trainer's gradient")
        del k, p, r
        torch.cuda.empty_cache()
    rel_k, rel_p, cos_k, cos_p = (torch.cat(t) for t in (rel_k, rel_p, cos_k, cos_p))
    med_k, med_p = rel_k.median().item(), rel_p.median().item()
    log(f"[policy-grad] full width, {len(rel_k)} envs holding cloth over seeds {FULL_SEEDS}: "
        f"median relative error vs float64, kernel {med_k:.3e}, float32 plain {med_p:.3e} "
        f"(gate {PARITY_RATIO:g} x {med_p:.3e}, and below 1); median per-env cosine, kernel "
        f"{cos_k.median().item():.6f}, float32 plain {cos_p.median().item():.6f}; "
        f"{time.perf_counter() - t_phase:.2f} s")
    if len(rel_k) < MIN_HOLDING:
        fail(f"fewer than {MIN_HOLDING} envs hold cloth: the full-width gradient gate would "
             "hold too little")
    if med_k > PARITY_RATIO * med_p or not med_k < 1.0:
        fail("full-width policy gradient: the kernel is further from float64 than the plain step")

    # ---- 10. K1-bwd times, and the bounds of both kernels
    t_phase = time.perf_counter()
    bwd_times, bounds = {}, {}
    for B in (B_MAIN, B_WIDE):
        wenv = env if B == B_MAIN else make_env("fold_cloth3", batch_size=B, device=dev)
        wsim = wenv.simulator
        w_in, w_cot = vjp_inputs(wsim, perturbed_state(wenv, gen))
        w_out = cloth_kernel.cloth_robot_step_vjp(wsim, w_in, w_cot)
        links = (wsim.link_code,)
        cells = B * wsim.H * wsim.W * wsim.conf.n_substeps
        bounds[B] = {
            "fwd": bound(nbytes(w_in) + nbytes(links) + nbytes(w_in[:4]), FLOP_FWD * cells),
            "bwd": bound(nbytes(w_in) + nbytes(links) + nbytes(w_cot) + nbytes(w_out),
                         FLOP_BWD * cells),
        }
        plain_fits = B == B_MAIN
        if not plain_fits:
            plain_note = (f"plain VJP not run: ~{4 * plain_vjp_bytes / 1e9:.0f} GB of autograd "
                          f"state (4x its peak at B={B_MAIN})")
        rounds = []
        for order in (("plain", "kernel"), ("kernel", "plain")):
            r = {}
            for which in order:
                if which == "kernel":
                    r[which] = cuda_ms(
                        lambda: cloth_kernel.cloth_robot_step_vjp(wsim, w_in, w_cot), reps=10)
                elif plain_fits:
                    torch.cuda.reset_peak_memory_stats()
                    before = torch.cuda.memory_allocated()
                    r[which] = cuda_ms(lambda: cloth_robot_step_vjp_plain(wsim, w_in, w_cot),
                                       reps=2, warmup=1)
                    plain_vjp_bytes = torch.cuda.max_memory_allocated() - before
                    plain_note = (f"plain VJP peak {plain_vjp_bytes / 1e9:.2f} GB above the "
                                  "inputs")
            rounds.append(r)
        bwd_times[B] = {k: sum(r[k] for r in rounds) / len(rounds) for k in rounds[0]}
        plain_txt = (f"plain {bwd_times[B]['plain']:.4f} ms, speedup "
                     f"{bwd_times[B]['plain'] / bwd_times[B]['kernel']:.1f}x; "
                     if plain_fits else "")
        log(f"[time] one robot step's VJP, B={B}: K1-bwd {bwd_times[B]['kernel']:.4f} ms, "
            f"{plain_txt}{plain_note} (rounds {rounds}); bound K1-fwd "
            f"{bounds[B]['fwd'][0]:.4f} ms ({bounds[B]['fwd'][1]}), K1-bwd "
            f"{bounds[B]['bwd'][0]:.4f} ms ({bounds[B]['bwd'][1]})")
        del wenv, wsim, w_in, w_cot, w_out
        torch.cuda.empty_cache()
    log(f"[time] phase 10 in {time.perf_counter() - t_phase:.2f} s")

    log(smi)
    log(json.dumps({"kernels": [{
        "name": "cloth_robot_step_fwd",
        "route": "cuda",
        "source": "unidom_torch/csrc/cloth_robot_step.cu",
        "replaces": "unidom_tpu/ops/pallas/cloth_kernel.py:331",
        "launches": train_launches["fwd"],
        "launches_by_path": {"run_eval": launches, "train": train_launches["fwd"],
                             "whip_rope_run_eval": whip_k1["fwd"],
                             "fold_tshirt_run_eval": tshirt_launches, **by_path("K1-fwd")},
        "max_abs_err": max(errs_all, tshirt_fwd_err),
        "ms": times[B_MAIN]["kernel"],
        "plain_ms": times[B_MAIN]["plain"],
        "bound_ms": bounds[B_MAIN]["fwd"][0],
        "bound_by": bounds[B_MAIN]["fwd"][1],
        "library_ms": None,
    }, {
        "name": "cloth_robot_step_bwd",
        "route": "cuda",
        "source": "unidom_torch/csrc/cloth_robot_step.cu",
        "replaces": "unidom_tpu/ops/pallas/cloth_kernel.py:354",
        "launches": train_launches["bwd"],
        "launches_by_path": {"run_eval": eval_bwd_launches, "train": train_launches["bwd"],
                             "whip_rope_run_eval": whip_k1["bwd"], **by_path("K1-bwd")},
        "max_abs_err": max(bwd_err, grad_err, tshirt_bwd_err),
        "ms": bwd_times[B_MAIN]["kernel"],
        "plain_ms": bwd_times[B_MAIN]["plain"],
        "bound_ms": bounds[B_MAIN]["bwd"][0],
        "bound_by": bounds[B_MAIN]["bwd"][1],
        "library_ms": None,
    }, mpm_entry, bwd_entry, seg_entry, big_entry, big_seg_entry, big_bwd_entry]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))


if __name__ == "__main__":
    main()
