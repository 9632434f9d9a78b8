"""Matrix-vector products, named as in `cvxopt_tpu/ops/matvec.py`.

The JAX module works around slow emulated-f64 dot products on the TPU.
On the GPU f64 is native, so these are plain batched matmuls; they keep
their names so that callers port line for line.  A (m, n) matrix is
shared across a batch of vectors (..., n); a (..., m, n) stack pairs
with the vectors' leading axes.
"""

__all__ = ["mv", "mvt", "vdot"]


def mv(A, x):
    """A @ x for A (..., m, n), x (..., n) -> (..., m)."""
    if A.dim() == 2:
        return x @ A.transpose(0, 1)
    return (A @ x.unsqueeze(-1)).squeeze(-1)


def mvt(A, z):
    """A' @ z for A (..., m, n), z (..., m) -> (..., n)."""
    if A.dim() == 2:
        return z @ A
    return (A.transpose(-1, -2) @ z.unsqueeze(-1)).squeeze(-1)


def vdot(a, b):
    """Dot product along the last axis."""
    return (a * b).sum(-1)
