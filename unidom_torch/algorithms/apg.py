"""Analytic policy gradients (APG): the policy rollout.

Counterpart of the eval rollout of ``unidom_tpu/algorithms/apg.py``
(``run_eval``): observation -> policy MLP -> NormalTanh -> sigmoid squash ->
``env.step_diff``, for ``env.max_steps`` macro steps.
"""

import torch

from unidom_torch.models.distribution import NormalTanhDistribution
from unidom_torch.models.normalizer import normalize


@torch.no_grad()
def run_eval(policy, normalizer, env, state, generator=None, deterministic=False):
    """Roll ``policy`` out from ``state``. ``normalizer`` (NormalizerParams
    or None) normalizes observations; ``deterministic`` takes the
    distribution's mode instead of a sample drawn from ``generator``.
    Returns (final state, actions (T, B, 6), rewards (T, B))."""
    dist = NormalTanhDistribution(event_size=env.action_size)
    actions_list, rewards = [], []
    for _ in range(env.max_steps):
        obs = env.get_obs(state)
        if normalizer is not None:
            obs = normalize(normalizer, obs)
        logits = policy(obs)
        actions = dist.mode(logits) if deterministic else dist.sample(logits, generator)
        if env.action_squash == "sigmoid":
            actions = torch.sigmoid(actions)
        _, reward, _, info = env.step_diff(actions, state)
        state = info["state"]
        actions_list.append(actions)
        rewards.append(reward)
    return state, torch.stack(actions_list), torch.stack(rewards)
