"""Tanh-squashed diagonal Gaussian action distribution.

Counterpart of ``unidom_tpu/models/distribution.py``: logits = [loc,
scale_raw], scale = softplus(scale_raw) + min_std, sample = tanh(loc +
scale * eps).
"""

import torch
from torch.nn import functional as F


class NormalTanhDistribution:
    def __init__(self, event_size: int, min_std: float = 0.001):
        self.event_size = event_size
        self.min_std = min_std

    @property
    def param_size(self) -> int:
        return 2 * self.event_size

    def _loc_scale(self, logits):
        loc, scale_raw = logits.chunk(2, dim=-1)
        return loc, F.softplus(scale_raw) + self.min_std

    def sample_from_eps(self, logits, eps):
        """Sample with the given standard-normal noise ``eps`` (loc's shape)."""
        loc, scale = self._loc_scale(logits)
        return torch.tanh(loc + scale * eps)

    def sample(self, logits, generator: torch.Generator):
        loc, _ = self._loc_scale(logits)
        eps = torch.randn(loc.shape, generator=generator, device=loc.device, dtype=loc.dtype)
        return self.sample_from_eps(logits, eps)

    def mode(self, logits):
        loc, _ = self._loc_scale(logits)
        return torch.tanh(loc)
