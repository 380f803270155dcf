"""The env axis over processes, with ``torch.distributed``.

Counterpart of ``unidom_tpu/parallel/mesh.py``. JAX runs the training step
under ``shard_map`` over a 1-D ``Mesh(('env',))``: the env batch sharded
along it, the training state replicated, the clipped gradient and the
normalizer's moments reduced over ``env``. Here each rank is a process with
one device holding ``num_envs // world`` envs and a replica of the training
state; the same reductions are all-reduces over the process group
(``ops/gradops.pmean_tree``, ``models/normalizer.update_normalizer``).

The backend is NCCL for CUDA ranks and gloo for CPU ranks. gloo also
all-reduces CUDA tensors, so ``backend="gloo"`` lets several ranks share
one card, the counterpart of JAX's virtual devices; NCCL needs a card per
rank and refuses more ranks than cards.
"""

from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class EnvMesh:
    """The ranks that split the env batch, as one rank sees them."""

    size: int  # ranks that split the batch
    rank: int  # this rank, 0 <= rank < size
    device: torch.device  # this rank's device
    group: Optional[Any] = None  # the process group; None: this rank alone, no collective

    @property
    def is_lead(self):
        """Whether this rank writes the run's artifacts (JAX's process 0)."""
        return self.rank == 0


def default_backend(device):
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def check_backend(backend, device, num_ranks):
    """Raise unless ``num_ranks`` ranks on ``device`` can run ``backend``
    on this host: NCCL runs CUDA ranks, one card each."""
    if backend != "nccl":
        return
    if torch.device(device).type != "cuda":
        raise ValueError(f"NCCL all-reduces CUDA tensors; ranks on {device} need backend='gloo'")
    cards = torch.cuda.device_count()
    if num_ranks > cards:
        raise ValueError(f"NCCL needs a card per rank: {num_ranks} ranks, {cards} visible "
                         "cards; ranks share a card only under backend='gloo'")


def rank_device(rank, device):
    """Rank ``rank``'s device: the CPU, or card ``rank`` mod the visible cards."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    return torch.device("cuda", rank % torch.cuda.device_count())


def initialize_distributed(coordinator_address=None, num_processes=None, process_id=None,
                           backend=None, device="cuda"):
    """Join the process group of ``num_processes`` processes whose rank 0
    listens at ``coordinator_address`` (``host:port``), as process
    ``process_id``. With no process count, or one process and no
    coordinator, there is nothing to join and this returns; a single
    process given a coordinator makes a group of one, whose all-reduces
    run through the backend all the same. ``backend`` defaults to NCCL for
    CUDA and gloo for the CPU. A CUDA rank takes card ``process_id`` mod
    the visible cards."""
    if num_processes is None or (num_processes <= 1 and coordinator_address is None):
        return
    if coordinator_address is None or process_id is None:
        raise ValueError(f"{num_processes} processes need a coordinator address and a process id")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} outside 0..{num_processes - 1}")
    backend = backend or default_backend(device)
    check_backend(backend, device, 1)
    dev = rank_device(process_id, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def make_env_mesh(num_devices=None, device="cuda"):
    """The mesh over every rank of the process group (``num_devices`` None
    or the world size), or this rank alone (``num_devices`` 1: no
    collective, as JAX's ``make_env_mesh(1)`` for the eval). Without a
    process group there is one rank, on ``device``."""
    if not dist.is_initialized():
        if num_devices not in (None, 1):
            raise ValueError(f"{num_devices} devices but no process group: start the ranks "
                             "with unidom_torch.parallel.launch or initialize_distributed")
        return EnvMesh(1, 0, torch.device(device))
    world, rank = dist.get_world_size(), dist.get_rank()
    dev = rank_device(rank, device)
    if num_devices == 1:
        return EnvMesh(1, 0, dev)
    if num_devices not in (None, world):
        raise ValueError(f"a mesh of {num_devices} devices in a process group of {world}")
    return EnvMesh(world, rank, dev, dist.group.WORLD)
