"""Running observation normalizer state and its use.

Counterpart of ``unidom_tpu/models/normalizer.py``: creation, the running
(Welford-style) update, on one device or all-reduced over the ranks of an
``EnvMesh`` so that every rank holds the same statistics, and ``normalize``.
"""

from dataclasses import dataclass

import torch
import torch.distributed as dist


@dataclass
class NormalizerParams:
    count: torch.Tensor  # ()
    mean: torch.Tensor  # (obs_size,)
    m2: torch.Tensor  # (obs_size,) sum of squared deviations


def create_observation_normalizer(obs_size: int, device="cuda") -> NormalizerParams:
    return NormalizerParams(
        count=torch.zeros((), dtype=torch.float32, device=device),
        mean=torch.zeros((obs_size,), dtype=torch.float32, device=device),
        m2=torch.ones((obs_size,), dtype=torch.float32, device=device),
    )


def update_normalizer(params: NormalizerParams, obs: torch.Tensor, mesh=None) -> NormalizerParams:
    """Fold ``obs`` (..., obs_size) into the statistics; leading axes are the
    batch. With a ``mesh`` that has a process group, the batch is every
    rank's ``obs`` (JAX's ``axis_name`` arm): the ranks' equal-sized batch
    means are averaged, and ``m2`` is summed against that global mean, so
    the variance between the ranks' means is kept."""
    flat = obs.reshape(-1, obs.shape[-1])
    batch_count = torch.tensor(float(flat.shape[0]), device=flat.device)
    batch_mean = flat.mean(0)
    if mesh is not None and mesh.group is not None:
        batch_count = batch_count * mesh.size
        dist.all_reduce(batch_mean, group=mesh.group)
        batch_mean = batch_mean / mesh.size
        batch_m2 = ((flat - batch_mean) ** 2).sum(0)
        dist.all_reduce(batch_m2, group=mesh.group)
    else:
        batch_m2 = ((flat - batch_mean) ** 2).sum(0)
    delta = batch_mean - params.mean
    total = params.count + batch_count
    mean = params.mean + delta * batch_count / total
    m2 = params.m2 + batch_m2 + delta**2 * params.count * batch_count / total
    return NormalizerParams(count=total, mean=mean, m2=m2)


def normalize(params: NormalizerParams, obs: torch.Tensor) -> torch.Tensor:
    var = params.m2 / torch.clamp(params.count, min=1.0)
    return (obs - params.mean) / torch.sqrt(var + 1e-8)
