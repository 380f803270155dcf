"""Task metrics: chamfer distance and mean L2 distance.

Counterpart of ``unidom_tpu/ops/metrics.py``. Rewards are built on them, so
their numerics follow the JAX version. Chamfer's pairwise distance comes from the
Gram-matrix expansion x^2 + y^2 - 2xy, with the RMS taken as the mean over
the xyz axis (euclidean / sqrt(3)).

On CUDA the expansion needs full float32 products: it cancels badly in TF32,
so ``chamfer`` turns TF32 matmuls off when it runs on a CUDA tensor.
"""

import torch


def _pairwise_rms(x, y):
    """dist[b, i, j] = sqrt(mean_d (x[b,i,d] - y[j,d])^2). x: (B, Nx, 3), y: (Ny, 3)."""
    x2 = torch.sum(x * x, dim=-1)  # (B, Nx)
    y2 = torch.sum(y * y, dim=-1)  # (Ny,)
    xy = torch.einsum("bid,jd->bij", x, y)
    d2 = x2[..., :, None] + y2[None, None, :] - 2.0 * xy
    return torch.sqrt(torch.clamp(d2, min=0.0) / x.shape[-1])


# Above this many pairwise elements the (B, Nx, Ny) block is chunked over x:
# fold_cloth3 at 1024 envs against a 512-point goal would be 1 GB per call.
CHAMFER_DENSE_LIMIT = 2**26
CHAMFER_CHUNK = 128


def _chamfer_dense(x, goal):
    d = _pairwise_rms(x, goal)
    return d.min(-1).values.mean(-1) + d.min(-2).values.mean(-1)


def _chamfer_chunked(x, goal, chunk=CHAMFER_CHUNK):
    """Same value as ``_chamfer_dense`` up to the order of the sums, with one
    (B, chunk, Ny) block alive at a time. Nx must be a multiple of ``chunk``."""
    B, Nx, _ = x.shape
    x2y_sum = x.new_zeros((B,))
    y2x_min = x.new_full((B, goal.shape[0]), float("inf"))
    for xi in x.split(chunk, dim=1):
        d = _pairwise_rms(xi, goal)
        x2y_sum = x2y_sum + d.min(-1).values.sum(-1)
        y2x_min = torch.minimum(y2x_min, d.min(-2).values)
    return x2y_sum / Nx + y2x_min.mean(-1)


def chamfer(x, goal):
    """Bidirectional chamfer distance per batch element.
    x: (B, Nx, 3) particles; goal: (Ny, 3). Returns (B,)."""
    if x.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    B, Nx, _ = x.shape
    if B * Nx * goal.shape[0] <= CHAMFER_DENSE_LIMIT or Nx % CHAMFER_CHUNK != 0:
        return _chamfer_dense(x, goal)
    return _chamfer_chunked(x, goal)


def l2_distance(x, goal):
    """Mean per-particle RMS distance to the index-aligned goal. x: (B, N, 3),
    goal: (N, 3). Returns (B,)."""
    return torch.sqrt(((x - goal[None]) ** 2).mean(-1)).mean(-1)
