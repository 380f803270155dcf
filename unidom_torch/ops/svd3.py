"""Batched 3x3 SVD by cyclic Jacobi, with a degenerate-safe backward.

Counterpart of the forward of ``unidom_tpu/ops/svd3.py``, operation for
operation: a one-sided Jacobi eigendecomposition of ``A^T A`` (6 sweeps of
the 3 off-diagonal rotations), singular values sorted descending by a
compare-exchange network, and U = A V / sigma, regularised and
re-orthonormalised by Gram-Schmidt with deterministic fallbacks, so that U
and V are what the JAX package computes, also where singular values repeat
(F = I after every reset) and where det(A) < 0.

Not ``torch.linalg.svd``: its U and V differ from these where singular
values repeat, and its autograd is not finite there. The MPM kernel
(``unidom_torch/csrc/mpm_step.cu``) runs the same sweeps in registers.

The backward is ``svd3_soa_bwd`` of the JAX package, term for term: the
standard SVD adjoint with ``x / (x^2 + eps)`` in place of every inverse, so
that it stays finite where singular values repeat or vanish. Autograd never
walks the Jacobi sweeps (that is not finite at F = I). The MPM backward
kernel evaluates the same terms in the same order.
"""

import torch

from unidom_torch.ops import m3

DEFAULT_EPS = 1e-12
_JACOBI_SWEEPS = 6  # full sweeps of the 3 off-diagonal rotations


def _jacobi_rotation(app, aqq, apq):
    """Stable Givens rotation (c, s) that annihilates ``apq``."""
    small = torch.abs(apq) < 1e-30
    safe_apq = torch.where(small, torch.ones_like(apq), apq)
    tau = (aqq - app) / (2.0 * safe_apq)
    t = torch.sign(tau) / (torch.abs(tau) + torch.sqrt(1.0 + tau * tau))
    t = torch.where(small, torch.zeros_like(t), t)
    c = 1.0 / torch.sqrt(1.0 + t * t)
    s = t * c
    return c, s


def _apply_jacobi(S, V, p, q):
    """One (p, q) rotation: S <- G^T S G, V <- V G, in component form."""
    c, s = _jacobi_rotation(S[p][p], S[q][q], S[p][q])
    S = [list(row) for row in S]
    for j in range(3):  # rows p and q
        rp, rq = S[p][j], S[q][j]
        S[p][j] = c * rp - s * rq
        S[q][j] = s * rp + c * rq
    for i in range(3):  # columns p and q
        cp, cq = S[i][p], S[i][q]
        S[i][p] = c * cp - s * cq
        S[i][q] = s * cp + c * cq
    V = [list(row) for row in V]
    for i in range(3):
        vp, vq = V[i][p], V[i][q]
        V[i][p] = c * vp - s * vq
        V[i][q] = s * vp + c * vq
    return tuple(tuple(r) for r in S), tuple(tuple(r) for r in V)


def _eigh3_soa(M):
    """Cyclic-Jacobi eigendecomposition of symmetric 3x3 batches in component
    form. Returns (w, V) with ``M ~= V diag(w) V^T``."""
    S, V = M, m3.eye_like(M[0][0])
    for _ in range(_JACOBI_SWEEPS):
        for p, q in ((0, 1), (0, 2), (1, 2)):
            S, V = _apply_jacobi(S, V, p, q)
    return m3.diag(S), V


def _sort_desc_soa(sig, V):
    """Descending 3-sort of singular values and the matching V columns by a
    compare-exchange network."""
    sig = list(sig)
    V = [list(row) for row in V]

    def cswap(a, b):
        swap = sig[a] < sig[b]
        sig[a], sig[b] = torch.where(swap, sig[b], sig[a]), torch.where(swap, sig[a], sig[b])
        for i in range(3):
            va, vb = V[i][a], V[i][b]
            V[i][a] = torch.where(swap, vb, va)
            V[i][b] = torch.where(swap, va, vb)

    cswap(0, 1)
    cswap(0, 2)
    cswap(1, 2)
    return tuple(sig), tuple(tuple(r) for r in V)


def _norm3(v):
    return torch.sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])


def svd3_soa_fwd(A):
    """Component-form forward SVD: A (nested 3x3 tuple of tensors) ->
    (U, sig, V) with ``A == U diag(sig) V^T``; sig non-negative, sorted
    descending; U orthogonal, with a reflection when det(A) < 0."""
    ATA = m3.matmul_tn(A, A)
    w, V = _eigh3_soa(ATA)
    sig = tuple(torch.sqrt(torch.clamp(wi, min=0.0)) for wi in w)
    sig, V = _sort_desc_soa(sig, V)

    # U = A V / sig, regularised for tiny singular values, then
    # re-orthonormalised by modified Gram-Schmidt with fallbacks
    AV = m3.matmul(A, V)
    safe = tuple(s / (s * s + 1e-30) for s in sig)
    U = m3.scale_cols(AV, safe)

    one = torch.ones_like(sig[0])
    zero = torch.zeros_like(sig[0])
    e0 = (one, zero, zero)

    def normalize(col, fallback):
        n = _norm3(col)
        ok = n > 1e-6
        nsafe = torch.where(ok, n, one)
        return tuple(torch.where(ok, ci / nsafe, fi) for ci, fi in zip(col, fallback))

    u0 = normalize(m3.col(U, 0), e0)
    c1 = m3.col(U, 1)
    d = m3.dot3(c1, u0)
    u1 = tuple(c1i - d * u0i for c1i, u0i in zip(c1, u0))
    # fallback for u1: any vector orthogonal to u0
    rolled = (u0[2] + 0.5, u0[0], u0[1])
    alt = m3.cross3(u0, rolled)
    altn_den = torch.clamp(_norm3(alt), min=1e-12)
    altn = tuple(a / altn_den for a in alt)
    u1 = normalize(u1, altn)
    u2 = m3.cross3(u0, u1)
    # keep the sign consistent with A V when sigma_2 is meaningful
    sgn = torch.sign(m3.dot3(u2, m3.col(AV, 2)))
    sgn = torch.where(torch.abs(sgn) < 0.5, one, sgn)
    u2 = tuple(u2i * sgn for u2i in u2)

    U = tuple((u0[i], u1[i], u2[i]) for i in range(3))  # columns u0, u1, u2
    return U, sig, V


def _safe_inverse(x, eps):
    return x / (x * x + eps)


def svd3_soa_bwd(epsilon, res, g):
    """Component-form degenerate-safe SVD adjoint. ``res = (U, sig, V)``;
    ``g = (dU, dsig, dV)``; returns dA (all nested tuples)."""
    U, S, V = res
    dU, dS, dV = g

    UtdU = m3.matmul_tn(U, dU)
    VtdV = m3.matmul_tn(V, dV)

    S2 = tuple(s * s for s in S)
    S_inv = tuple(_safe_inverse(s, epsilon) for s in S)

    # F[i][j] = safe_inv(S2[j] - S2[i]) off the diagonal, 0 on it
    zero = torch.zeros_like(S[0])
    Fm = tuple(
        tuple(zero if i == j else _safe_inverse(S2[j] - S2[i], epsilon) for j in range(3))
        for i in range(3)
    )
    J = m3.hadamard(Fm, UtdU)
    K = m3.hadamard(Fm, VtdV)
    JJt = m3.add(J, m3.transpose(J))
    KKt = m3.add(K, m3.transpose(K))

    Vh = m3.transpose(V)
    # term 1: (U * dS) @ Vh
    dA = m3.matmul(m3.scale_cols(U, dS), Vh)
    # term 2: U @ ((J + J^T) * S_row) @ Vh
    dA = m3.add(dA, m3.matmul(U, m3.matmul(m3.scale_cols(JJt, S), Vh)))
    # term 3: (U * S) @ (K + K^T) @ Vh
    dA = m3.add(dA, m3.matmul(m3.scale_cols(U, S), m3.matmul(KKt, Vh)))
    # term 4: (I - U U^T) @ (dU * S_inv) @ Vh
    PU = m3.sub(m3.eye_like(S[0]), m3.matmul_nt(U, U))
    dA = m3.add(dA, m3.matmul(PU, m3.matmul(m3.scale_cols(dU, S_inv), Vh)))
    # term 5: (U * S_inv) @ dV^T @ (I - V V^T)
    PV = m3.sub(m3.eye_like(S[0]), m3.matmul_nt(V, V))
    dA = m3.add(dA, m3.matmul(m3.scale_cols(U, S_inv), m3.matmul(m3.transpose(dV), PV)))
    return dA


class _SVD3(torch.autograd.Function):
    """The SVD as one autograd node whose backward is ``svd3_soa_bwd``."""

    @staticmethod
    def forward(ctx, A):
        U, sig, V = svd3_soa_fwd(m3.from_aos(A))
        U, S, Vh = m3.to_aos(U), torch.stack(sig, dim=-1), m3.to_aos(m3.transpose(V))
        ctx.save_for_backward(U, S, Vh)
        return U, S, Vh

    @staticmethod
    def backward(ctx, dU, dS, dVh):
        U, S, Vh = ctx.saved_tensors
        res = (m3.from_aos(U), tuple(S[..., i] for i in range(3)),
               m3.transpose(m3.from_aos(Vh)))
        g = (m3.from_aos(dU), tuple(dS[..., i] for i in range(3)),
             m3.transpose(m3.from_aos(dVh)))
        return m3.to_aos(svd3_soa_bwd(DEFAULT_EPS, res, g))


def svd3(A):
    """(..., 3, 3) -> (U, S, Vh) with ``A == (U * S[..., None, :]) @ Vh``, as
    ``unidom_tpu.ops.svd3.svd3`` computes them, with its degenerate-safe
    backward."""
    return _SVD3.apply(A)
