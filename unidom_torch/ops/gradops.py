"""Gradient-stabilisation identities for long-horizon BPTT through physics.

Counterpart of ``unidom_tpu/ops/gradops.py``: ``normalize_grad``, which sits
inside every cloth substep, and the trainer's ``nan_to_num_tree`` and
``global_norm_clip``. A gradient "tree" here is a list, tuple or dict of
tensors.
"""

import torch


class NormalizeGrad(torch.autograd.Function):
    """Identity whose backward maps the cotangent g to nan_to_num(g / ||g||) / scale.

    The norm is taken over all dims after the first ``batch_dims``, so
    ``batch_dims=1`` on a (B, ...) tensor is the JAX version under ``vmap``
    (one norm per env) and ``batch_dims=0`` is the JAX version on one array.
    """

    @staticmethod
    def forward(x, scale, batch_dims):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.scale, ctx.batch_dims = inputs

    @staticmethod
    def backward(ctx, g):
        dims = tuple(range(ctx.batch_dims, g.dim()))
        n = torch.linalg.vector_norm(g, dim=dims, keepdim=True)
        g = torch.nan_to_num(g / n)
        return g / ctx.scale, None, None


def normalize_grad(x, scale, batch_dims=0):
    """Cloth engine's per-array ``norm_grad`` (scale = particle count)."""
    return NormalizeGrad.apply(x, float(scale), int(batch_dims))


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: fn(t) for k, t in tree.items()}
    return type(tree)(fn(t) for t in tree)


def _leaves(tree):
    return list(tree.values()) if isinstance(tree, dict) else list(tree)


def nan_to_num_tree(tree):
    """Replace NaN by 0 and +-inf by the dtype's extremes in every leaf."""
    return _map(torch.nan_to_num, tree)


def global_norm(tree):
    """sqrt of the sum of squares of every entry of every leaf (a 0-dim tensor)."""
    return torch.sqrt(sum(torch.sum(t * t) for t in _leaves(tree)))


def global_norm_clip(tree, max_norm):
    """Clip a gradient tree to a global norm, branch-free: rescale by
    ``max_norm / norm`` only when the norm is at least ``max_norm``."""
    g_norm = global_norm(tree)
    trigger = g_norm < max_norm
    return _map(lambda t: torch.where(trigger, t, t / g_norm * max_norm), tree)
