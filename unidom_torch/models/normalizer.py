"""Running observation normalizer state and its use.

Counterpart of ``unidom_tpu/models/normalizer.py`` (creation and
``normalize``; the running update comes with training).
"""

from dataclasses import dataclass

import torch


@dataclass
class NormalizerParams:
    count: torch.Tensor  # ()
    mean: torch.Tensor  # (obs_size,)
    m2: torch.Tensor  # (obs_size,) sum of squared deviations


def create_observation_normalizer(obs_size: int, device="cpu") -> NormalizerParams:
    return NormalizerParams(
        count=torch.zeros((), dtype=torch.float32, device=device),
        mean=torch.zeros((obs_size,), dtype=torch.float32, device=device),
        m2=torch.ones((obs_size,), dtype=torch.float32, device=device),
    )


def normalize(params: NormalizerParams, obs: torch.Tensor) -> torch.Tensor:
    var = params.m2 / torch.clamp(params.count, min=1.0)
    return (obs - params.mean) / torch.sqrt(var + 1e-8)
