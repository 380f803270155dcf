"""Carry a policy and an observation normalizer over from the JAX package.

The inputs are the flax parameter tree and the normalizer's (count, mean,
m2) as numpy arrays, e.g. from ``jax.device_get``, so this module needs no
JAX.
"""

import numpy as np
import torch

from unidom_torch.models.mlp import PolicyMLP
from unidom_torch.models.normalizer import NormalizerParams


def policy_from_jax(params_np, device="cpu") -> PolicyMLP:
    """PolicyMLP from ``{'params': {'dense_i': {'kernel', 'bias'}}}``. A flax
    kernel is (in, out); ``nn.Linear.weight`` is its transpose."""
    dense = params_np["params"]
    kernels = [np.asarray(dense[f"dense_{i}"]["kernel"]) for i in range(len(dense))]
    sizes = [k.shape[0] for k in kernels] + [kernels[-1].shape[1]]
    policy = PolicyMLP(sizes[0], sizes[-1], hidden=tuple(sizes[1:-1]), device=device)
    with torch.no_grad():
        for i, layer in enumerate(policy.layers):
            layer.weight.copy_(torch.tensor(kernels[i].T))
            layer.bias.copy_(torch.tensor(np.asarray(dense[f"dense_{i}"]["bias"])))
    return policy


def normalizer_from_jax(count, mean, m2, device="cpu") -> NormalizerParams:
    """NormalizerParams from the JAX normalizer's (count, mean, m2)."""
    def f32(a):
        return torch.tensor(np.asarray(a, dtype=np.float32), device=device)

    return NormalizerParams(count=f32(count), mean=f32(mean), m2=f32(m2))
