"""Carry a policy (new, or into an existing one such as ``SolverNN``'s), an
observation normalizer and an MPM state over from the JAX package.

The inputs are the flax parameter tree, the normalizer's (count, mean, m2)
and the MPM state as numpy arrays, e.g. from ``jax.device_get``, so this
module needs no JAX.
"""

import dataclasses

import numpy as np
import torch

from unidom_torch.models.mlp import PolicyMLP
from unidom_torch.models.normalizer import NormalizerParams


def policy_from_jax(params_np, device="cuda") -> PolicyMLP:
    """PolicyMLP from ``{'params': {'dense_i': {'kernel', 'bias'}}}``. A flax
    kernel is (in, out); ``nn.Linear.weight`` is its transpose."""
    dense = params_np["params"]
    kernels = [np.asarray(dense[f"dense_{i}"]["kernel"]) for i in range(len(dense))]
    sizes = [k.shape[0] for k in kernels] + [kernels[-1].shape[1]]
    policy = PolicyMLP(sizes[0], sizes[-1], hidden=tuple(sizes[1:-1]), device=device)
    return copy_policy_from_jax(policy, params_np)


def copy_policy_from_jax(policy: PolicyMLP, params_np) -> PolicyMLP:
    """``policy`` (e.g. ``SolverNN.policy``) with JAX's parameter tree copied
    into it in place; the layer sizes must agree."""
    dense = params_np["params"]
    if len(dense) != len(policy.layers):
        raise ValueError(f"{len(dense)} JAX layers for a policy of {len(policy.layers)}")
    with torch.no_grad():
        for i, layer in enumerate(policy.layers):
            kernel = np.asarray(dense[f"dense_{i}"]["kernel"])
            if kernel.T.shape != tuple(layer.weight.shape):
                raise ValueError(f"layer {i}: JAX's kernel {kernel.shape}, the policy's weight "
                                 f"{tuple(layer.weight.shape)}")
            layer.weight.copy_(torch.tensor(kernel.T))
            layer.bias.copy_(torch.tensor(np.asarray(dense[f"dense_{i}"]["bias"])))
    return policy


def normalizer_from_jax(count, mean, m2, device="cuda") -> NormalizerParams:
    """NormalizerParams from the JAX normalizer's (count, mean, m2)."""
    def f32(a):
        return torch.tensor(np.asarray(a, dtype=np.float32), device=device)

    return NormalizerParams(count=f32(count), mean=f32(mean), m2=f32(m2))


def mpm_state_from_jax(state_np, device="cuda"):
    """MPMState from a batched JAX ``MPMState`` whose leaves are numpy arrays
    (``key`` is dropped: the port's envs own a ``torch.Generator``)."""
    from unidom_torch.engine.mpm import MPMState
    from unidom_torch.engine.primitives import PrimitiveState

    def tensor(a):
        return torch.tensor(np.asarray(a), device=device)

    prims = tuple(
        PrimitiveState(**{f.name: tensor(getattr(p, f.name))
                          for f in dataclasses.fields(PrimitiveState)})
        for p in state_np.primitives)
    fields = [f.name for f in dataclasses.fields(MPMState) if f.name != "primitives"]
    return MPMState(primitives=prims, **{k: tensor(getattr(state_np, k)) for k in fields})
