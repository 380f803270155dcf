"""Data parallelism over the env axis: a process per device, the env batch
split over the processes (``mesh``), and a launcher of those processes on
one host (``launch``)."""

from unidom_torch.parallel.launch import launch
from unidom_torch.parallel.mesh import EnvMesh, initialize_distributed, make_env_mesh

__all__ = ["EnvMesh", "initialize_distributed", "launch", "make_env_mesh"]
