"""Component-form batched 3x3 linear algebra.

Counterpart of ``unidom_tpu/ops/m3.py``: a batch of 3x3 matrices is a 3x3
nested tuple of identically shaped tensors (``M[i][j]`` is the (i, j)
component across the batch), a batch of 3-vectors a 3-tuple. Every op
unrolls to elementwise multiply-adds in the same order as the JAX version,
so the SVD and the MPM stress built on them round as the JAX package does.
"""

import torch


def from_aos(A):
    """(..., 3, 3) tensor -> nested tuple of 9 (...) tensors."""
    return tuple(tuple(A[..., i, j] for j in range(3)) for i in range(3))


def to_aos(M):
    """Nested tuple -> (..., 3, 3) tensor."""
    return torch.stack([torch.stack(row, dim=-1) for row in M], dim=-2)


def eye_like(x):
    one = torch.ones_like(x)
    zero = torch.zeros_like(x)
    return tuple(tuple(one if i == j else zero for j in range(3)) for i in range(3))


def transpose(M):
    return tuple(tuple(M[j][i] for j in range(3)) for i in range(3))


def add(A, B):
    return tuple(tuple(A[i][j] + B[i][j] for j in range(3)) for i in range(3))


def sub(A, B):
    return tuple(tuple(A[i][j] - B[i][j] for j in range(3)) for i in range(3))


def hadamard(A, B):
    return tuple(tuple(A[i][j] * B[i][j] for j in range(3)) for i in range(3))


def matmul(A, B):
    """C = A @ B, unrolled: 27 multiply-adds."""
    return tuple(
        tuple(A[i][0] * B[0][j] + A[i][1] * B[1][j] + A[i][2] * B[2][j] for j in range(3))
        for i in range(3)
    )


def matmul_tn(A, B):
    """C = A^T @ B."""
    return tuple(
        tuple(A[0][i] * B[0][j] + A[1][i] * B[1][j] + A[2][i] * B[2][j] for j in range(3))
        for i in range(3)
    )


def matmul_nt(A, B):
    """C = A @ B^T."""
    return tuple(
        tuple(A[i][0] * B[j][0] + A[i][1] * B[j][1] + A[i][2] * B[j][2] for j in range(3))
        for i in range(3)
    )


def col(M, j):
    return (M[0][j], M[1][j], M[2][j])


def scale_cols(M, s):
    """M @ diag(s): column j scaled by s[j]."""
    return tuple(tuple(M[i][j] * s[j] for j in range(3)) for i in range(3))


def diag(M):
    return (M[0][0], M[1][1], M[2][2])


def dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross3(a, b):
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )
