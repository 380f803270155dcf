"""Analytic policy gradients (APG): BPTT through the differentiable simulator.

Counterpart of ``unidom_tpu/algorithms/apg.py``:
- policy = MLP [512, 256, 2*act] with swish + NormalTanh sampling (+ sigmoid
  squash for cloth envs);
- loss = -mean(reward) over a rollout of ``episode_length`` macro steps, with
  optional stop-gradient truncation windows and a pre-squash penalty;
- grad -> nan_to_num -> global-norm clip on each rank -> mean all-reduce over
  the ranks -> Adam, in exactly that order;
- data parallel over an ``EnvMesh`` (``unidom_torch/parallel``): each rank
  steps ``num_envs // world`` envs and holds a replica of the training
  state, as JAX's ``shard_map`` over ``Mesh(('env',))`` does;
- ``train`` and the CLI (``python -m unidom_torch.algorithms.apg``): fixed
  reset for cloth envs, periodic sampled and deterministic eval, per-eval and
  best checkpoints with ``torch.save``, resume, ``metrics.jsonl``; with
  ``--devices N`` it starts N ranks on this host, with ``--coordinator``,
  ``--num_processes`` and ``--process_id`` it is one rank of a group.

On CUDA tensors every robot step of a cloth rollout runs the cloth kernel
forward and, in the backward pass, the cloth kernel backward; every macro
step of an MPM rollout runs an MPM macro-step kernel forward (K2-fwd, or
K3-fwd on big grids) and, when training, its backward (K2-bwd or K3-bwd) in
the backward pass.
"""

import argparse
import json
import os
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as tdist

from unidom_torch.models.distribution import NormalTanhDistribution
from unidom_torch.models.mlp import PolicyMLP
from unidom_torch.models.normalizer import (
    NormalizerParams,
    create_observation_normalizer,
    normalize,
    update_normalizer,
)
from unidom_torch.ops.gradops import (
    global_norm,
    global_norm_clip,
    nan_to_num_tree,
    pmean_tree,
    tree_flatten,
)
from unidom_torch.parallel import EnvMesh, launch, make_env_mesh

ADAM = dict(betas=(0.9, 0.999), eps=1e-8)  # optax.adam's defaults
LR_END = 1e-5  # end of the linear learning-rate decay


@dataclass
class TrainingState:
    policy: PolicyMLP
    optimizer: torch.optim.Adam
    normalizer: NormalizerParams
    generator: torch.Generator  # sampling noise, on the env's device
    updates: int = 0  # optimizer steps taken (the learning-rate schedule's count)


def _act(policy, normalizer, env, state, dist, eps):
    """Observation -> optional normalize -> policy -> NormalTanh sample with
    noise ``eps`` (the mode when ``eps`` is None) -> squash. Returns
    (actions, logits)."""
    obs = env.get_obs(state)
    if normalizer is not None:
        obs = normalize(normalizer, obs)
    logits = policy(obs)
    actions = dist.mode(logits) if eps is None else dist.sample_from_eps(logits, eps)
    if env.action_squash == "sigmoid":
        actions = torch.sigmoid(actions)
    return actions, logits


def _noise(generator, env, state):
    return torch.randn((state.x.shape[0], env.action_size), generator=generator,
                       device=state.x.device, dtype=state.x.dtype)


def tile_over_ranks(state, n):
    """``state`` with every tensor leaf repeated ``n`` times along the batch:
    the global batch of ``n`` ranks that each hold ``state``."""
    leaves, rebuild = tree_flatten(state)
    return rebuild([torch.cat([t] * n) for t in leaves])


def rank_slice(state, mesh):
    """This rank's envs of a global batch ``state``."""
    leaves, rebuild = tree_flatten(state)
    B = leaves[0].shape[0] // mesh.size
    return rebuild([t[mesh.rank * B:(mesh.rank + 1) * B] for t in leaves])


def _stop_gradient(state):
    """``state`` with every tensor leaf detached (an MPM state nests its
    primitives in a tuple)."""
    leaves, rebuild = tree_flatten(state)
    return rebuild([t.detach() for t in leaves])


@torch.no_grad()
def run_eval(policy, normalizer, env, state, generator=None, deterministic=False):
    """Roll ``policy`` out from ``state``. ``normalizer`` (NormalizerParams
    or None) normalizes observations; ``deterministic`` takes the
    distribution's mode instead of a sample drawn from ``generator``.
    Returns (final state, actions (T, B, 6), rewards (T, B))."""
    dist = NormalTanhDistribution(event_size=env.action_size)
    actions_list, rewards = [], []
    for _ in range(env.max_steps):
        eps = None if deterministic else _noise(generator, env, state)
        actions, _ = _act(policy, normalizer, env, state, dist, eps)
        _, reward, _, info = env.step_diff(actions, state)
        state = info["state"]
        actions_list.append(actions)
        rewards.append(reward)
    return state, torch.stack(actions_list), torch.stack(rewards)


def build_apg(
    env,
    episode_length: int,
    learning_rate: float = 1e-4,
    max_gradient_norm: float = 0.3,
    truncation_length: Optional[int] = None,
    lr_decay_iters: Optional[int] = None,
    normalize_obs: bool = False,
    pre_squash_penalty: float = 0.0,
    device="cuda",
    mesh: Optional[EnvMesh] = None,
):
    """Build (init_training_state, minimize, reset_batch, run_eval) for
    ``env``, which must live on ``device``; the policy, the optimizer state
    and the normalizer are made there too. With a ``mesh`` (``EnvMesh``),
    ``env`` holds this rank's share of the batch, and ``minimize`` takes this
    rank's share of the first state and returns the same training state on
    every rank."""
    if torch.device(device).type != env.device.type:
        raise ValueError(f"env is on {env.device}, but build_apg was asked for {device}")
    device = env.device
    mesh = mesh or EnvMesh(1, 0, device)
    dist = NormalTanhDistribution(event_size=env.action_size)

    def learning_rate_at(updates):
        if not lr_decay_iters:
            return learning_rate
        frac = min(updates, lr_decay_iters) / lr_decay_iters
        return learning_rate + (LR_END - learning_rate) * frac

    def init_training_state(seed):
        policy_seed, noise_seed = np.random.SeedSequence(seed).generate_state(2)
        policy = PolicyMLP(env.observation_size, dist.param_size,
                           generator=torch.Generator().manual_seed(int(policy_seed)),
                           device=device)
        return TrainingState(
            policy=policy,
            optimizer=torch.optim.Adam(policy.parameters(), lr=learning_rate, **ADAM),
            normalizer=create_observation_normalizer(env.observation_size, device),
            generator=torch.Generator(device=device).manual_seed(int(noise_seed)),
        )

    def loss_grad(ts, state, noise=None):
        """Loss of one rollout from ``state`` and its gradient with respect to
        the policy's parameters. ``noise`` (T, B, act) replaces the draws from
        ``ts.generator``. Returns (loss, grads, (rewards (T, B), states))."""
        normalizer = ts.normalizer if normalize_obs else None
        rewards, states, loc_sq = [], [], []
        for t in range(episode_length):
            eps = _noise(ts.generator, env, state) if noise is None else noise[t]
            actions, logits = _act(ts.policy, normalizer, env, state, dist, eps)
            _, reward, _, info = env.step_diff(actions, state)
            state = info["state"]
            if truncation_length and (t + 1) % truncation_length == 0:
                state = _stop_gradient(state)
            loc = logits[..., : env.action_size]
            loc_sq.append(torch.mean(loc**2))
            rewards.append(reward)
            states.append(state)
        rewards = torch.stack(rewards)
        loss = -torch.mean(rewards)
        if pre_squash_penalty:
            loss = loss + pre_squash_penalty * torch.mean(torch.stack(loc_sq))
        grads = torch.autograd.grad(loss, list(ts.policy.parameters()))
        return loss.detach(), grads, (rewards.detach(), states)

    def minimize(ts, state, noise=None):
        """One APG update from this rank's first state ``state``; updates
        ``ts`` in place and returns (ts, metrics). Every rank draws the same
        noise (``ts.generator`` is seeded alike) for its own envs, clips its
        own gradient, and takes the mean over the ranks of the clipped
        gradients, as JAX's replicated key and ``pmean`` after the local clip
        do. ``reward`` and ``reward_sum`` are means over the ranks;
        ``grad_norm`` is this rank's raw norm (JAX reports shard 0's)."""
        loss, grad_raw, (rewards, states) = loss_grad(ts, state, noise)
        minimize.debug["last"] = (loss, grad_raw)
        grad_raw = nan_to_num_tree(grad_raw)
        grad = global_norm_clip(grad_raw, max_gradient_norm)
        grad = pmean_tree(grad, mesh)

        if normalize_obs:
            # the reset obs is what the policy sees at t = 0: fold it in with
            # the post-step states
            with torch.no_grad():
                obs = torch.stack([env.get_obs(s) for s in [state, *states]])
                ts.normalizer = update_normalizer(ts.normalizer, obs, mesh)

        params = list(ts.policy.parameters())
        for p, g in zip(params, grad):
            p.grad = g
        for group in ts.optimizer.param_groups:
            group["lr"] = learning_rate_at(ts.updates)
        ts.optimizer.step()
        ts.updates += 1
        with torch.no_grad():
            reward, reward_sum = pmean_tree([rewards.mean(), rewards.sum(0).mean()], mesh)
            metrics = {
                "grad_norm": global_norm(grad_raw),
                "params_norm": global_norm(params),
                "reward": reward,
                "reward_sum": reward_sum,
            }
        return ts, metrics

    # test hook: the pieces needed to recompute an update by hand, and the
    # last update's loss and raw gradient (``last``: (loss, grads))
    minimize.debug = {"loss_grad": loss_grad, "learning_rate_at": learning_rate_at}

    def reset_batch(generator=None):
        """This rank's first state of an iteration, laid out as JAX's global
        batch over the mesh:
        - ``"reset"`` envs (cloth): ``env.reset(generator)``; over several
          ranks the generator gives one seed per rank (JAX splits its key
          over the devices) and rank r resets from its own;
        - ``"host_reset"`` envs (the shape_rope family, whose reset pushes
          run forward on the env's batch): one ``env.reset(generator)``,
          the same on every rank (JAX tiles one local reset);
        - ``"auto_reset"`` envs (whip_rope, pour_water, pour_soup):
          ``env.auto_reset`` of the initial state tiled over the ranks, one
          draw per global env; rank r takes its envs.
        Over several ranks every rank must give a generator in the same
        state."""
        n = mesh.size
        if n > 1 and generator is None and env.reset_mode != "host_reset":
            raise ValueError("reset_batch over several ranks needs a generator")
        if env.reset_mode == "reset":
            if n > 1:
                seeds = torch.randint(2**62, (n,), generator=generator)
                generator = torch.Generator().manual_seed(int(seeds[mesh.rank]))
            return env.reset(generator)[1]
        if env.reset_mode == "host_reset":
            return env.reset(generator)[1]
        if env.reset_mode == "auto_reset":
            if n == 1:
                return env.auto_reset(env.init_state, generator)
            return rank_slice(env.auto_reset(tile_over_ranks(env.init_state, n), generator), mesh)
        raise NotImplementedError(f"reset_mode {env.reset_mode!r}")

    return init_training_state, minimize, reset_batch, run_eval


# ---------------------------------------------------------------------- #
# CLI trainer
# ---------------------------------------------------------------------- #


def _checkpoint(ts, it):
    n = ts.normalizer
    return {
        "policy": ts.policy.state_dict(),
        "optimizer": ts.optimizer.state_dict(),
        "updates": ts.updates,
        "normalizer": {"count": n.count, "mean": n.mean, "m2": n.m2},
        "it": it,
    }


def _restore(ts, path, device):
    saved = torch.load(path, map_location=device, weights_only=True)
    ts.policy.load_state_dict(saved["policy"])
    ts.optimizer.load_state_dict(saved["optimizer"])
    ts.updates = saved["updates"]
    ts.normalizer = NormalizerParams(**saved["normalizer"])
    return ts


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _train_rank(kwargs):
    """One rank of a launched ``train``: its final checkpoint and history."""
    ts, history = train(**kwargs)
    return _checkpoint(ts, kwargs["max_it"]), history


def train(
    env_name: str,
    episode_length: int,
    num_envs: int,
    learning_rate: float = 1e-4,
    max_it: int = 2000,
    max_gradient_norm: float = 0.3,
    seed: int = 0,
    eval_freq: int = 20,
    num_eval_envs: int = 20,
    num_devices: Optional[int] = None,
    truncation_length: Optional[int] = None,
    logdir: Optional[str] = None,
    resume: Optional[str] = None,
    lr_decay: bool = False,
    normalize_obs: bool = False,
    randomize_reset: bool = False,
    pre_squash_penalty: float = 0.0,
    aux_reward: bool = True,
    env_kwargs: Optional[dict] = None,
    device="cuda",
    dist_backend: Optional[str] = None,
):
    """APG training of ``env_name`` for ``max_it + 1`` iterations. Returns
    (training state, list of per-iteration metric records).

    The ``num_envs`` envs are split over ``num_devices`` ranks (default: the
    process group's, or one). With ``num_devices > 1`` and no process group,
    ``train`` starts that many ranks on this host (``parallel.launch``,
    ``dist_backend`` NCCL for CUDA and gloo for the CPU; gloo lets several
    ranks share one card) and returns the lead rank's final checkpoint (a
    dict, as ``apg_{env}_{it}.pt`` holds) and history. Every rank builds the
    eval env (the shape_rope family's and the unfold envs' host draws share
    its stream), but only the lead rank evaluates and writes
    ``metrics.jsonl`` and checkpoints; ``resume`` is loaded on every rank."""
    if num_devices is not None and num_devices > 1 and not tdist.is_initialized():
        return launch(_train_rank, num_devices, device, dist_backend, args=(dict(locals()),))[0]
    from unidom_torch.envs.registration import env_functions

    mesh = make_env_mesh(num_devices, device)
    if num_envs % mesh.size:
        raise ValueError(f"{num_envs} envs do not split over {mesh.size} ranks")
    if mesh.group is not None and mesh.is_lead:
        print(f"[mesh] {tdist.get_backend(mesh.group)}: {mesh.size} rank(s), "
              f"{num_envs // mesh.size} envs each on {mesh.device}")

    logdir = logdir or (
        f"logs/apg/{env_name}/ep{episode_length}_env{num_envs}_lr{learning_rate}"
        f"_it{max_it}_clip{max_gradient_norm}/seed{seed}"
    )
    os.makedirs(logdir, exist_ok=True)

    env_kwargs = env_kwargs or {}
    env = env_functions[env_name](batch_size=num_envs // mesh.size, seed=seed,
                                  aux_reward=aux_reward, device=mesh.device, **env_kwargs)
    eval_env = env_functions[env_name](batch_size=num_eval_envs, seed=seed + 666,
                                       device=mesh.device, **env_kwargs)
    device = env.device
    if hasattr(env, "rng"):
        # JAX's resets draw on the host from numpy's global state (the
        # shape_rope family's pushes, the unfold envs' folds), which each
        # env's constructor reseeds: the eval env's last. Both envs share the
        # eval env's stream, drawn in JAX's order: the training env's first
        # reset (host_reset envs only), the eval env's, then one per
        # iteration. So a fixed reset (cloth) repeats its noise but draws new
        # folds every iteration, as JAX's does.
        env.rng = eval_env.rng
    if env.reset_mode == "host_reset":
        env.reset()
    _, eval_first_state = eval_env.reset(torch.Generator().manual_seed(seed + 666))

    init_ts, minimize, reset_batch, run_eval_ = build_apg(
        env, episode_length, learning_rate, max_gradient_norm, truncation_length,
        lr_decay_iters=max_it if lr_decay else None, normalize_obs=normalize_obs,
        pre_squash_penalty=pre_squash_penalty, device=device, mesh=mesh,
    )
    ts = init_ts(seed)
    if resume:
        ts = _restore(ts, resume, device)
        if mesh.is_lead:
            print(f"resumed from {resume}")

    # Cloth envs ("reset") keep one reset for every iteration (reference
    # parity) unless --randomize_reset; "auto_reset" and "host_reset" envs
    # (MPM) draw a fresh one each iteration.
    fixed_reset = env.reset_mode == "reset" and not randomize_reset
    reset_gen = torch.Generator().manual_seed(seed)
    history = []
    best_eval = -float("inf")
    t_total = time.time()
    metrics_file = open(os.path.join(logdir, "metrics.jsonl"), "a") if mesh.is_lead else None
    try:
        for it in range(max_it + 1):
            if fixed_reset:
                reset_gen.manual_seed(seed)
            first_state = reset_batch(reset_gen)

            if it % eval_freq == 0 and mesh.is_lead:
                normalizer = ts.normalizer if normalize_obs else None
                eval_gen = torch.Generator(device=device).manual_seed(seed + 666)
                _, _, rewards = run_eval_(ts.policy, normalizer, eval_env, eval_first_state,
                                          generator=eval_gen)
                test_reward = float(rewards.sum(0).mean())
                _, _, det_rewards = run_eval_(ts.policy, normalizer, eval_env,
                                              eval_first_state, deterministic=True)
                test_reward_det = float(det_rewards.sum(0).mean())
                ckpt = _checkpoint(ts, it)
                torch.save(ckpt, os.path.join(logdir, f"apg_{env_name}_{it}.pt"))
                if test_reward > best_eval:
                    best_eval = test_reward
                    ckpt["test_reward"] = test_reward
                    torch.save(ckpt, os.path.join(logdir, f"apg_{env_name}_best.pt"))
                print(f"[it {it}] test_reward {test_reward:.4f} "
                      f"det {test_reward_det:.4f} (best {best_eval:.4f})")

            _sync(device)
            t = time.time()
            ts, metrics = minimize(ts, first_state)
            _sync(device)
            dt = time.time() - t
            sps = episode_length * num_envs / dt

            rec = {
                "it": it,
                "train_reward": float(metrics["reward_sum"]),
                "grad_norm": float(metrics["grad_norm"]),
                "sps": sps,
                "walltime": time.time() - t_total,
            }
            history.append(rec)
            if metrics_file is not None:
                metrics_file.write(json.dumps(rec) + "\n")
                metrics_file.flush()
                if it % max(1, eval_freq // 4) == 0:
                    print(f"[it {it}] train_reward {rec['train_reward']:.4f} "
                          f"grad_norm {rec['grad_norm']:.3f} sps {sps:.1f}")
    finally:
        if metrics_file is not None:
            metrics_file.close()
    return ts, history


def add_distributed_args(parser):
    """The CLI's data-parallel flags (``apg`` and ``apg_para``)."""
    parser.add_argument("--devices", type=int, default=None,
                        help="ranks to split the envs over (default: the process group's, or "
                             "one); more than one, with no process group, starts them here")
    parser.add_argument("--coordinator", default=None,
                        help="host:port of rank 0, for a run of --num_processes processes")
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)
    parser.add_argument("--dist_backend", default=None, choices=("nccl", "gloo"),
                        help="default NCCL for CUDA, gloo for the CPU; gloo lets several "
                             "ranks share one card")


def run_distributed(args, fn, **kwargs):
    """``fn(**kwargs)`` as one rank of the group the CLI's flags name (none:
    a plain call), leaving the group when it returns."""
    from unidom_torch.parallel import initialize_distributed

    initialize_distributed(args.coordinator, args.num_processes, args.process_id,
                           backend=args.dist_backend, device=args.device)
    try:
        return fn(**kwargs)
    finally:
        if tdist.is_initialized():
            tdist.destroy_process_group()


def main(argv=None):
    parser = argparse.ArgumentParser(description="APG trainer (unidom_torch)")
    parser.add_argument("--env", default="fold_cloth1")
    parser.add_argument("--ep_len", type=int, default=10)
    parser.add_argument("--num_envs", type=int, default=4)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--max_it", type=int, default=2000)
    parser.add_argument("--max_grad_norm", type=float, default=0.3)
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--eval_freq", type=int, default=20)
    parser.add_argument("--num_eval_envs", type=int, default=20)
    parser.add_argument("--truncation_length", type=int, default=None)
    parser.add_argument("--logdir", default=None)
    parser.add_argument("--resume", default=None)
    parser.add_argument("--lr_decay", action="store_true")
    parser.add_argument("--normalize_obs", action="store_true",
                        help="running-moment observation normalization")
    parser.add_argument("--no_aux_reward", action="store_true",
                        help="train WITHOUT the contact-distance aux reward")
    parser.add_argument("--pre_squash_penalty", type=float, default=0.0,
                        help="L2 penalty on the policy's pre-squash means")
    parser.add_argument("--randomize_reset", action="store_true",
                        help="draw a fresh reset every iteration for cloth envs")
    parser.add_argument("--device", default="cuda",
                        help="torch device; 'cpu' runs the plain simulator steps on the host")
    add_distributed_args(parser)
    args = parser.parse_args(argv)

    run_distributed(
        args, train,
        env_name=args.env,
        episode_length=args.ep_len,
        num_envs=args.num_envs,
        learning_rate=args.lr,
        max_it=args.max_it,
        max_gradient_norm=args.max_grad_norm,
        seed=args.seed,
        eval_freq=args.eval_freq,
        num_eval_envs=args.num_eval_envs,
        num_devices=args.devices,
        truncation_length=args.truncation_length,
        logdir=args.logdir,
        resume=args.resume,
        lr_decay=args.lr_decay,
        normalize_obs=args.normalize_obs,
        randomize_reset=args.randomize_reset,
        pre_squash_penalty=args.pre_squash_penalty,
        aux_reward=not args.no_aux_reward,
        device=args.device,
        dist_backend=args.dist_backend,
    )


if __name__ == "__main__":
    main()
