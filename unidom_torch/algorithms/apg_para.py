"""Parameter-aware APG training (the GenDOM/GenORM capability).

Counterpart of ``unidom_tpu/algorithms/apg_para.py``, data parallel as
``apg.train`` is (``num_devices``, ``--devices``). Each training iteration starts from the same fixed reset with a fresh stiffness
per env, drawn uniformly from [train_min_stiff, train_max_stiff]; every
``eval_freq`` iterations the policy is evaluated at ``n_eval_points``
stiffness values spread evenly over [eval_min_stiff, eval_max_stiff], each
set in every env of the eval's first state. With ``--env fold_cloth1_para``
the policy observes the normalised stiffness; with a plain cloth env it does
not. Stiffness is a per-env input of the cloth kernels, so a draw or a sweep
point changes no launch and builds nothing. The draw is one for the global
batch, as JAX's is outside ``shard_map``: every rank draws it from the same
stream and takes its envs' share, so the global batch's stiffness does not
depend on the number of ranks.

    python -m unidom_torch.algorithms.apg_para --env fold_cloth1_para --num_envs 1024
"""

import argparse
import json
import os
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as tdist

from unidom_torch.algorithms.apg import (
    _checkpoint,
    _sync,
    add_distributed_args,
    build_apg,
    run_distributed,
)
from unidom_torch.parallel import launch, make_env_mesh


def randomize_stiffness(state, generator, lo, hi, u=None):
    """``state`` with one stiffness per env, ``lo + (hi - lo) * u`` for a
    uniform draw ``u`` in [0, 1) from ``generator`` (a CPU generator), or
    the (B,) draw ``u`` given."""
    B = state.stiffness.shape[0]
    if u is None:
        u = torch.rand(B, generator=generator)
    u = torch.tensor(np.asarray(u, dtype=np.float32))
    draw = (u * (hi - lo) + lo).to(device=state.stiffness.device, dtype=state.stiffness.dtype)
    return state.replace(stiffness=draw)


def stiffness_draw(generator, num_envs, mesh):
    """This rank's share of one uniform draw for the global batch of
    ``num_envs`` envs from ``generator`` (a CPU generator)."""
    B = num_envs // mesh.size
    return torch.rand(num_envs, generator=generator)[mesh.rank * B:(mesh.rank + 1) * B]


def _train_para_rank(kwargs):
    """One rank of a launched ``train_para``: its final checkpoint and history."""
    ts, history = train_para(**kwargs)
    return _checkpoint(ts, kwargs["max_it"]), history


def train_para(
    env_name: str = "fold_cloth1_para",
    episode_length: int = 3,
    num_envs: int = 4,
    learning_rate: float = 1e-4,
    max_it: int = 2000,
    max_gradient_norm: float = 0.3,
    seed: int = 0,
    eval_freq: int = 100,
    num_eval_envs: int = 4,
    train_min_stiff: float = 1000.0,
    train_max_stiff: float = 1600.0,
    eval_min_stiff: float = 10.0,
    eval_max_stiff: float = 1800.0,
    n_eval_points: int = 10,
    num_devices: Optional[int] = None,
    logdir: Optional[str] = None,
    device="cuda",
    dist_backend: Optional[str] = None,
):
    """APG training of ``env_name`` under a stiffness drawn per env and
    iteration, for ``max_it + 1`` iterations. Writes each eval sweep to
    ``metrics.jsonl`` and checkpoints (``apg_para_{env}_{it}.pt``, and
    ``_best.pt`` for the best sweep mean) with ``torch.save``. Returns
    (training state, list of per-iteration records; an eval iteration's
    holds its sweep under ``eval_sweep``). ``num_devices`` and
    ``dist_backend`` split the envs over ranks as in ``apg.train``: launched
    here, it returns the lead rank's final checkpoint and history; only the
    lead rank runs the sweep and writes."""
    if num_devices is not None and num_devices > 1 and not tdist.is_initialized():
        return launch(_train_para_rank, num_devices, device, dist_backend, args=(dict(locals()),))[0]
    from unidom_torch.envs.registration import env_functions

    mesh = make_env_mesh(num_devices, device)
    if num_envs % mesh.size:
        raise ValueError(f"{num_envs} envs do not split over {mesh.size} ranks")

    logdir = logdir or (
        f"logs/apg_para/{env_name}/ep{episode_length}_env{num_envs}"
        f"_stiff{train_min_stiff}-{train_max_stiff}/seed{seed}"
    )
    os.makedirs(logdir, exist_ok=True)

    kwargs = {}
    if env_name.endswith("_para"):
        kwargs["eval_min_max_stiff"] = (eval_min_stiff, eval_max_stiff)
    env = env_functions[env_name](batch_size=num_envs // mesh.size, seed=seed, aux_reward=True,
                                  device=mesh.device, **kwargs)
    eval_env = env_functions[env_name](batch_size=num_eval_envs, seed=seed + 666,
                                       device=mesh.device, **kwargs)
    device = env.device

    init_ts, minimize, reset_batch, run_eval = build_apg(
        env, episode_length, learning_rate, max_gradient_norm, device=device, mesh=mesh)
    ts = init_ts(seed)
    stiff_gen = torch.Generator().manual_seed(seed)
    _, eval_first_state = eval_env.reset(torch.Generator().manual_seed(seed + 666))
    sweep = np.linspace(eval_min_stiff, eval_max_stiff, n_eval_points, dtype=np.float32)

    history = []
    best_mean = -float("inf")
    t_total = time.time()
    metrics_file = open(os.path.join(logdir, "metrics.jsonl"), "a") if mesh.is_lead else None
    try:
        for it in range(max_it + 1):
            # the fixed reset: only the stiffness draw varies between iterations
            first_state = reset_batch(torch.Generator().manual_seed(seed))
            first_state = randomize_stiffness(
                first_state, None, train_min_stiff, train_max_stiff,
                u=stiffness_draw(stiff_gen, num_envs, mesh))

            rec = {"it": it}
            if it % eval_freq == 0 and mesh.is_lead:
                per_stiff = {}
                for s in sweep:
                    st = eval_first_state.replace(
                        stiffness=torch.full_like(eval_first_state.stiffness, float(s)))
                    eval_gen = torch.Generator(device=device).manual_seed(seed + 666)
                    _, _, rewards = run_eval(ts.policy, None, eval_env, st, generator=eval_gen)
                    per_stiff[float(s)] = float(rewards.sum(0).mean())
                mean_r = sum(per_stiff.values()) / len(per_stiff)
                print(f"[it {it}] eval sweep mean {mean_r:.4f} "
                      + " ".join(f"{k:.0f}:{v:.3f}" for k, v in per_stiff.items()))
                ckpt = _checkpoint(ts, it)
                ckpt["sweep"] = per_stiff
                torch.save(ckpt, os.path.join(logdir, f"apg_para_{env_name}_{it}.pt"))
                if mean_r > best_mean:
                    best_mean = mean_r
                    ckpt["mean"] = mean_r
                    torch.save(ckpt, os.path.join(logdir, f"apg_para_{env_name}_best.pt"))
                metrics_file.write(json.dumps(
                    {"it": it, "eval_sweep": per_stiff, "walltime": time.time() - t_total}) + "\n")
                metrics_file.flush()
                rec["eval_sweep"] = per_stiff

            _sync(device)
            t = time.time()
            ts, metrics = minimize(ts, first_state)
            _sync(device)
            rec.update(train_reward=float(metrics["reward_sum"]),
                       grad_norm=float(metrics["grad_norm"]),
                       sps=episode_length * num_envs / (time.time() - t))
            history.append(rec)
            if mesh.is_lead and it % max(1, eval_freq // 4) == 0:
                print(f"[it {it}] train_reward {rec['train_reward']:.4f} "
                      f"grad_norm {rec['grad_norm']:.3f}")
    finally:
        if metrics_file is not None:
            metrics_file.close()
    return ts, history


def main(argv=None):
    p = argparse.ArgumentParser(description="Parameter-aware APG trainer (unidom_torch)")
    p.add_argument("--env", default="fold_cloth1_para")
    p.add_argument("--ep_len", type=int, default=3)
    p.add_argument("--num_envs", type=int, default=4)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--max_it", type=int, default=2000)
    p.add_argument("--max_grad_norm", type=float, default=0.3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--eval_freq", type=int, default=100)
    p.add_argument("--train_min_stiff", type=float, default=1000.0)
    p.add_argument("--train_max_stiff", type=float, default=1600.0)
    p.add_argument("--eval_min_stiff", type=float, default=10.0)
    p.add_argument("--eval_max_stiff", type=float, default=1800.0)
    p.add_argument("--logdir", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain simulator steps on the host")
    add_distributed_args(p)
    a = p.parse_args(argv)
    return run_distributed(
        a, train_para,
        env_name=a.env, episode_length=a.ep_len, num_envs=a.num_envs,
        learning_rate=a.lr, max_it=a.max_it, max_gradient_norm=a.max_grad_norm,
        seed=a.seed, eval_freq=a.eval_freq,
        train_min_stiff=a.train_min_stiff, train_max_stiff=a.train_max_stiff,
        eval_min_stiff=a.eval_min_stiff, eval_max_stiff=a.eval_max_stiff,
        num_devices=a.devices, logdir=a.logdir, device=a.device, dist_backend=a.dist_backend,
    )


if __name__ == "__main__":
    main()
