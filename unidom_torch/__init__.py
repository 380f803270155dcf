"""UniDOM in PyTorch: the cloth and MPM (material point method) stacks of
``unidom_tpu`` ported to PyTorch, with their hot loops as hand-written CUDA
kernels for Hopper (H100).

The module layout mirrors ``unidom_tpu`` so each module's counterpart is easy
to find. Plain PyTorch code runs on any device; a kernel wrapper runs its
plain version only for CPU tensors and launches its CUDA kernel (or raises)
for CUDA tensors.
"""

__version__ = "0.1.0"


def make_env(name, **kwargs):
    """Instantiate a registered environment by name, e.g.
    ``make_env("fold_cloth3", batch_size=1024, device="cuda", seed=1)`` or
    ``make_env("whip_rope", batch_size=1024, device="cuda", seed=1)``."""
    from unidom_torch.envs.registration import env_functions

    return env_functions[name](**kwargs)
