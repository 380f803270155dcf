"""Start the ranks of a data-parallel run on this host.

The counterpart of JAX's one-process mesh over its local devices: here a
process per rank, started with ``torch.multiprocessing``'s spawn method
(the children inherit ``sys.path``, so they import this package from
wherever the caller did), rank r on card r (NCCL), on card r mod the cards
(gloo on CUDA: ranks may share a card), or on the CPU (gloo). A rank that
raises or dies makes the launch raise, after the others are stopped.
"""

import os
import socket
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from unidom_torch.parallel.mesh import check_backend, default_backend, initialize_distributed


def free_port():
    """A TCP port on localhost that was free when asked."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, fn, args, world, port, backend, device, threads, out):
    torch.set_num_threads(threads)
    initialize_distributed(f"localhost:{port}", world, rank, backend=backend, device=device)
    try:
        result = fn(*args)
        torch.save(result, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def launch(fn, num_devices, device="cuda", backend=None, args=()):
    """Run ``fn(*args)`` on ``num_devices`` ranks of one process group, each
    process started afresh; ``fn`` and ``args`` must pickle (``fn`` a
    module-level function). Returns the ranks' return values, in rank
    order, with their tensors on the CPU. ``backend`` defaults to NCCL for
    CUDA and gloo for the CPU; NCCL with more ranks than visible cards
    raises. The caller's CPU threads are shared out among the ranks."""
    backend = backend or default_backend(device)
    check_backend(backend, device, num_devices)
    with tempfile.TemporaryDirectory(prefix="unidom_ranks_") as out:
        mp.start_processes(_rank_main, args=(fn, tuple(args), num_devices, free_port(), backend,
                                             str(device),
                                             max(1, torch.get_num_threads() // num_devices), out),
                           nprocs=num_devices, start_method="spawn")
        return [torch.load(os.path.join(out, f"rank{r}.pt"), map_location="cpu",
                           weights_only=False)
                for r in range(num_devices)]
