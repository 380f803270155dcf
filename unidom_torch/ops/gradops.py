"""Gradient-stabilisation identities for long-horizon BPTT through physics.

Counterpart of ``unidom_tpu/ops/gradops.py``. Only ``normalize_grad`` is here
so far: it sits inside every cloth substep, so the plain cloth step needs it
for its gradients to match the JAX oracle's.
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
