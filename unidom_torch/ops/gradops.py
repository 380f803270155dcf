"""Gradient-stabilisation identities for long-horizon BPTT through physics.

Counterpart of ``unidom_tpu/ops/gradops.py``: ``normalize_grad``, which sits
inside every cloth substep, the MPM macro step's ``clamp_grad_norm_tree``
and ``scrub_mpm_state``, the trainer's ``nan_to_num_tree`` and
``global_norm_clip``, and ``scrub_grad``, which whip_rope's ``grad_test``
puts between chained steps. A gradient "tree" here is a list, tuple or dict of
tensors; an MPM state is a tree of dataclasses. Also ``clip``, ``jnp.clip``
with JAX's gradient.
"""

import dataclasses

import torch


def clip(x, lo, hi):
    """``jnp.clip`` with JAX's gradient: at a tie with a bound, max/min split
    the cotangent in half (``torch.clamp`` would pass all of it). The bounds
    are filled on x's device (``new_tensor`` would copy them from the host,
    and on the GPU wait for the stream: once per robot step on the cloth
    path)."""
    return torch.minimum(torch.maximum(x, x.new_full((), lo)), x.new_full((), hi))


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


def tree_flatten(tree):
    """(tensor leaves, rebuild) of a tree of dataclasses, tuples and lists;
    other values (None, numbers) are kept as they are."""
    if isinstance(tree, torch.Tensor):
        return [tree], lambda leaves: leaves[0]
    if dataclasses.is_dataclass(tree):
        names = [f.name for f in dataclasses.fields(tree)]
        leaves, rebuild = tree_flatten([getattr(tree, n) for n in names])
        return leaves, lambda ls: dataclasses.replace(tree, **dict(zip(names, rebuild(ls))))
    if isinstance(tree, (tuple, list)):
        parts = [tree_flatten(t) for t in tree]
        sizes = [len(p[0]) for p in parts]

        def rebuild(ls):
            out, i = [], 0
            for (_, sub), n in zip(parts, sizes):
                out.append(sub(ls[i:i + n]))
                i += n
            return type(tree)(out)

        return [t for p in parts for t in p[0]], rebuild
    return [], lambda leaves: tree


class _ScrubClamp(torch.autograd.Function):
    """Forward: ``nan_to_num`` on the first ``n_scrub`` tensors, the identity
    on the rest. Backward: NaN-scrub every cotangent, then clamp their joint
    norm per env (over all dims after the first) to 1."""

    @staticmethod
    def forward(ctx, n_scrub, *tensors):
        return tuple(torch.nan_to_num(t) if i < n_scrub else t.view_as(t)
                     for i, t in enumerate(tensors))

    @staticmethod
    def backward(ctx, *grads):
        grads = [torch.nan_to_num(g) for g in grads]
        sq = sum(torch.sum((g * g).reshape(g.shape[0], -1), dim=1) for g in grads)
        norm = torch.sqrt(sq)  # (B,)
        trigger = norm < 1.0

        def clamp(g):
            shape = (-1,) + (1,) * (g.dim() - 1)
            return torch.where(trigger.view(shape), g, g / norm.view(shape))

        return (None, *(clamp(g) for g in grads))


def _scrub_clamp(scrubbed, tree):
    """``_ScrubClamp`` on the tensors ``scrubbed`` and on the float leaves of
    ``tree``. Returns (the scrubbed tensors, the tree rebuilt)."""
    leaves, rebuild = tree_flatten(tree)
    floats = [i for i, t in enumerate(leaves) if t.is_floating_point()]
    outs = _ScrubClamp.apply(len(scrubbed), *scrubbed, *(leaves[i] for i in floats))
    leaves = list(leaves)
    for i, t in zip(floats, outs[len(scrubbed):]):
        leaves[i] = t
    return outs[:len(scrubbed)], rebuild(leaves)


def clamp_grad_norm_tree(tree):
    """Identity; backward scrubs NaNs and clamps the cotangent's global norm
    to 1, per env (the JAX version under ``vmap``)."""
    return _scrub_clamp((), tree)[1]


_MPM_SCRUBBED = ("x", "v", "C", "F", "J")


def scrub_mpm_state(state):
    """NaN-scrub x, v, C, F and J of a batched MPM state on the forward pass,
    and clamp the cotangent of all its float fields to norm 1 per env on the
    backward pass (the JAX version under ``vmap``)."""
    scrubbed = tuple(getattr(state, name) for name in _MPM_SCRUBBED)
    outs, rest = _scrub_clamp(scrubbed, state.replace(**dict.fromkeys(_MPM_SCRUBBED)))
    return rest.replace(**dict(zip(_MPM_SCRUBBED, outs)))


class _ScrubGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return torch.nan_to_num(g)


def scrub_grad(x):
    """Identity; backward replaces NaN cotangents by 0 and +-inf by the
    dtype's extremes (``jnp.nan_to_num``), on float tensors. Other tensors
    pass as they are."""
    return _ScrubGrad.apply(x) if x.is_floating_point() else x
