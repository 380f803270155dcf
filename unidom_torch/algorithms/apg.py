"""Analytic policy gradients (APG): BPTT through the differentiable simulator.

Counterpart of ``unidom_tpu/algorithms/apg.py`` on one device:
- policy = MLP [512, 256, 2*act] with swish + NormalTanh sampling (+ sigmoid
  squash for cloth envs);
- loss = -mean(reward) over a rollout of ``episode_length`` macro steps, with
  optional stop-gradient truncation windows and a pre-squash penalty;
- grad -> nan_to_num -> global-norm clip -> (all-reduce: the identity on one
  device) -> Adam, in exactly that order;
- ``train`` and the CLI (``python -m unidom_torch.algorithms.apg``): fixed
  reset for cloth envs, periodic sampled and deterministic eval, per-eval and
  best checkpoints with ``torch.save``, resume, ``metrics.jsonl``.

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

from unidom_torch.models.distribution import NormalTanhDistribution
from unidom_torch.models.mlp import PolicyMLP
from unidom_torch.models.normalizer import (
    NormalizerParams,
    create_observation_normalizer,
    normalize,
    update_normalizer,
)
from unidom_torch.ops.gradops import global_norm, global_norm_clip, nan_to_num_tree, tree_flatten

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
):
    """Build (init_training_state, minimize, reset_batch, run_eval) for
    ``env``, which must live on ``device``; the policy, the optimizer state
    and the normalizer are made there too."""
    if torch.device(device).type != env.device.type:
        raise ValueError(f"env is on {env.device}, but build_apg was asked for {device}")
    device = env.device
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
        """One APG update from the first state ``state``; updates ``ts`` in
        place and returns (ts, metrics)."""
        loss, grad_raw, (rewards, states) = loss_grad(ts, state, noise)
        minimize.debug["last"] = (loss, grad_raw)
        grad_raw = nan_to_num_tree(grad_raw)
        grad = global_norm_clip(grad_raw, max_gradient_norm)
        # the all-reduce of the clipped gradient is the identity on one device

        if normalize_obs:
            # the reset obs is what the policy sees at t = 0: fold it in with
            # the post-step states
            with torch.no_grad():
                obs = torch.stack([env.get_obs(s) for s in [state, *states]])
                ts.normalizer = update_normalizer(ts.normalizer, obs)

        params = list(ts.policy.parameters())
        for p, g in zip(params, grad):
            p.grad = g
        for group in ts.optimizer.param_groups:
            group["lr"] = learning_rate_at(ts.updates)
        ts.optimizer.step()
        ts.updates += 1
        with torch.no_grad():
            metrics = {
                "grad_norm": global_norm(grad_raw),
                "params_norm": global_norm(params),
                "reward": rewards.mean(),
                "reward_sum": rewards.sum(0).mean(),
            }
        return ts, metrics

    # test hook: the pieces needed to recompute an update by hand, and the
    # last update's loss and raw gradient (``last``: (loss, grads))
    minimize.debug = {"loss_grad": loss_grad, "learning_rate_at": learning_rate_at}

    def reset_batch(generator=None):
        """First state of an iteration: ``env.reset(generator)`` for
        ``reset_mode == "reset"`` envs (cloth) and ``"host_reset"`` envs (the
        shape_rope family, whose reset pushes run forward on the env's batch;
        with one device JAX's tiling over devices is the identity),
        ``env.auto_reset`` of the env's initial state for ``"auto_reset"``
        envs (whip_rope, pour_water, pour_soup)."""
        if env.reset_mode in ("reset", "host_reset"):
            return env.reset(generator)[1]
        if env.reset_mode == "auto_reset":
            return env.auto_reset(env.init_state, generator)
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
):
    """APG training of ``env_name`` for ``max_it + 1`` iterations. Returns
    (training state, list of per-iteration metric records)."""
    from unidom_torch.envs.registration import env_functions

    logdir = logdir or (
        f"logs/apg/{env_name}/ep{episode_length}_env{num_envs}_lr{learning_rate}"
        f"_it{max_it}_clip{max_gradient_norm}/seed{seed}"
    )
    os.makedirs(logdir, exist_ok=True)

    env_kwargs = env_kwargs or {}
    env = env_functions[env_name](batch_size=num_envs, seed=seed, aux_reward=aux_reward,
                                  device=device, **env_kwargs)
    eval_env = env_functions[env_name](batch_size=num_eval_envs, seed=seed + 666,
                                       device=device, **env_kwargs)
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
        pre_squash_penalty=pre_squash_penalty, device=device,
    )
    ts = init_ts(seed)
    if resume:
        ts = _restore(ts, resume, device)
        print(f"resumed from {resume}")

    # Cloth envs ("reset") keep one reset for every iteration (reference
    # parity) unless --randomize_reset; "auto_reset" and "host_reset" envs
    # (MPM) draw a fresh one each iteration.
    fixed_reset = env.reset_mode == "reset" and not randomize_reset
    reset_gen = torch.Generator().manual_seed(seed)
    history = []
    best_eval = -float("inf")
    t_total = time.time()
    with open(os.path.join(logdir, "metrics.jsonl"), "a") as metrics_file:
        for it in range(max_it + 1):
            if fixed_reset:
                reset_gen.manual_seed(seed)
            first_state = reset_batch(reset_gen)

            if it % eval_freq == 0:
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
            metrics_file.write(json.dumps(rec) + "\n")
            metrics_file.flush()
            if it % max(1, eval_freq // 4) == 0:
                print(f"[it {it}] train_reward {rec['train_reward']:.4f} "
                      f"grad_norm {rec['grad_norm']:.3f} sps {sps:.1f}")
    return ts, history


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
    args = parser.parse_args(argv)

    train(
        env_name=args.env,
        episode_length=args.ep_len,
        num_envs=args.num_envs,
        learning_rate=args.lr,
        max_it=args.max_it,
        max_gradient_norm=args.max_grad_norm,
        seed=args.seed,
        eval_freq=args.eval_freq,
        num_eval_envs=args.num_eval_envs,
        truncation_length=args.truncation_length,
        logdir=args.logdir,
        resume=args.resume,
        lr_decay=args.lr_decay,
        normalize_obs=args.normalize_obs,
        randomize_reset=args.randomize_reset,
        pre_squash_penalty=args.pre_squash_penalty,
        aux_reward=not args.no_aux_reward,
        device=args.device,
    )


if __name__ == "__main__":
    main()
