"""Smoke run of unidom_torch on one CUDA GPU.

Builds the cloth robot-step kernel from ``unidom_torch/csrc``, holds it
against the plain PyTorch step on the card, drives the fold_cloth3 policy
rollout (``run_eval``) at full width through it (1024 envs, 16x32 cloth,
50 substeps per robot step, 4 macro steps of 40 robot steps), checks the
rollout against the plain step, and times kernel and plain versions.

    python3 chip_smoke.py        # from the repository root, on a machine with a GPU

It prints one line per phase, the card's name and power limit, a JSON line
of the kernels, and as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
It exits non-zero, without that line, when there is no CUDA device, when
the package is not beside it, or when any phase fails.
"""

import copy
import dataclasses
import json
import math
import subprocess
import sys
import time
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


def perturbed_state(env, gen):
    """fold_cloth3 reset state with v, stiffness and mu perturbed per env,
    gripper 0 on the cloth's first particle."""
    import torch

    _, s = env.reset(torch.Generator().manual_seed(0))
    B = s.x.shape[0]
    ps0 = s.primitive0.clone()
    ps0[:, :3] = s.x[:, 0, 0]
    return s.replace(
        v=0.05 * torch.randn(s.v.shape, generator=gen, device=s.v.device),
        primitive0=ps0,
        stiffness=s.stiffness * (1.0 + 0.2 * torch.rand(B, generator=gen, device=s.x.device)),
        mu=s.mu * (1.0 + torch.rand(B, generator=gen, device=s.x.device)),
    )


def plain_copy(env, dtype):
    """Shallow copy of ``env`` whose simulator runs the plain step in ``dtype``."""
    sim = copy.copy(env.simulator)
    sim.rest_len = sim.rest_len.to(dtype)
    sim.nbr_valid = sim.nbr_valid.to(dtype)
    sim.step_batch = sim._robot_step_plain
    out = copy.copy(env)
    out.simulator = sim
    out.goal = env.goal.to(dtype)
    return out


def cast(state, dtype):
    fields = {f.name: getattr(state, f.name) for f in dataclasses.fields(state)}
    return state.replace(**{k: t.to(dtype) for k, t in fields.items() if t.is_floating_point()})


def errors(out, ref):
    """Max and RMS of |out - ref|, in float64."""
    d = (out.double() - ref.double()).abs()
    return d.max().item(), d.square().mean().sqrt().item()


def robot_action(B, device):
    import torch

    a = torch.zeros((B, 8), device=device)
    a[:, 0], a[:, 1], a[:, 3] = 0.8, 1.5, 0.0  # gripper 0 moves with suction engaged
    a[:, 4:7] = 0.1  # gripper 1 moves, suction 0 as well
    return a


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

    from unidom_torch import make_env
    from unidom_torch.algorithms.apg import run_eval
    from unidom_torch.models.mlp import PolicyMLP
    from unidom_torch.ops.cuda import cloth_kernel
    from unidom_torch.ops.cuda._build import build_library, library_path
    from unidom_torch.ops.cuda.cloth_kernel import cloth_robot_step

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

    # ---- 2. build
    t0 = time.perf_counter()
    build_log = build_library(cloth_kernel.SOURCE)
    log(f"[build] {cloth_kernel.SOURCE} -> {library_path(cloth_kernel.SOURCE).name} "
        f"in {time.perf_counter() - t0:.2f} s")
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"[build] ptxas: {line.strip()}")

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
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        final, actions, rewards = run_eval(policy, None, env, state0, deterministic=True)
        torch.cuda.synchronize()
        t_first = time.perf_counter() - t0
        launches = cloth_robot_step.launches
        expected = env.max_steps * 40
        log(f"[slice] run_eval fold_cloth3 B={B_MAIN}: {launches} kernel launches "
            f"(expected {expected}), first rollout {t_first:.3f} s")
        if launches != expected:
            fail(f"{launches} kernel launches in the rollout, expected {expected}")
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

    errs_all = max(errs.values())
    if not math.isfinite(errs_all):
        fail("non-finite kernel error")
    log(smi)
    log(json.dumps({"kernels": [{
        "name": "cloth_robot_step_fwd",
        "route": "cuda",
        "source": "unidom_torch/csrc/cloth_robot_step.cu",
        "replaces": "unidom_tpu/ops/pallas/cloth_kernel.py:331",
        "launches": launches,
        "max_abs_err": errs_all,
        "ms": times[B_MAIN]["kernel"],
        "plain_ms": times[B_MAIN]["plain"],
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))


if __name__ == "__main__":
    main()
