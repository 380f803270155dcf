"""Policy MLP: Linear layers [512, 256, param_size] with SiLU (swish) between.

Counterpart of ``unidom_tpu/models/mlp.py``. Weights start like flax's
``Dense`` default (LeCun-normal kernel, truncated at two standard deviations,
and zero bias), drawn from an explicit ``torch.Generator``.
"""

import math

import torch
from torch import nn

# std of a standard normal truncated to [-2, 2]: rescales to unit variance
_TRUNC_STD = 0.87962566103423978


def _truncated_normal(shape, std, generator=None):
    """N(0, std^2) truncated to +-2 std, by the inverse CDF of uniforms drawn
    from ``generator``, so the draw depends only on the uniform stream."""
    lo = 0.5 * math.erfc(2.0 / math.sqrt(2.0))  # Phi(-2)
    u = torch.rand(shape, generator=generator, dtype=torch.float64)
    # erfinv(2 (lo + u (1 - 2 lo)) - 1) sqrt(2) std, in place: the same
    # operations in the same order, without a temporary per step
    z = u.mul_(1.0 - 2.0 * lo).add_(lo).mul_(2.0).sub_(1.0).erfinv_()
    return z.mul_(math.sqrt(2.0)).mul_(std).float()


class PolicyMLP(nn.Module):
    def __init__(self, obs_size, param_size, hidden=(512, 256), generator=None,
                 device="cuda"):
        super().__init__()
        sizes = [obs_size, *hidden, param_size]
        # skip_init: nn.Linear's own init (from the global stream) would be
        # overwritten below
        self.layers = nn.ModuleList(
            nn.utils.skip_init(nn.Linear, i, o, device=device)
            for i, o in zip(sizes[:-1], sizes[1:])
        )
        with torch.no_grad():
            for layer in self.layers:
                std = math.sqrt(1.0 / layer.in_features) / _TRUNC_STD
                layer.weight.copy_(_truncated_normal(layer.weight.shape, std, generator))
                layer.bias.zero_()

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = nn.functional.silu(x)
        return x
