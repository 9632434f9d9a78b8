"""The yardstick of the kernels' roofline shares: one H100's published
peaks and the work and bytes that a factor or solve call of the KKT
layer needs.

The counts are of the problem's own work at its unpadded n, not of the
program's layout: P's lower triangle, Gt and dinv2 read once, S's
assembly and Cholesky FLOPs, L's lower triangle written once; for a
solve, L's lower triangle read once and the right-hand sides read and
the solutions written once.  A kernel that changes its tiling, padding
or panel inverses cannot make them stale.
"""

from __future__ import annotations

# NVIDIA's H100 SXM data sheet, dense rates at the 700 W limit: 67
# TFLOP/s in float32 outside the tensor cores and in float64 on the
# tensor cores (DMMA), and 3.35 TB/s of HBM3.
PEAK_FLOPS = {4: 67e12, 8: 67e12}
PEAK_BYTES = 3.35e12


def pad64(n):
    return -(-n // 64) * 64


def true_n(n_call, n_problem):
    """The problem's n where the call is at n padded to 64 for it."""
    if n_problem and n_problem < n_call == pad64(n_problem):
        return n_problem
    return n_call


def factor_work(B, n, m, shared, esize):
    """(FLOPs, bytes) of L = chol(P + Gt diag(dinv2) Gt') for B instances
    of order n with m columns of Gt (shared by the batch or not)."""
    tri = n * (n + 1) / 2
    flops = B * (2.0 * tri * m + n ** 3 / 3.0)
    words = B * (tri + m + tri) + (n * m if shared else B * n * m)
    return flops, words * esize


def solve_work(B, n, nrhs, rhs_shared, esize):
    """(FLOPs, bytes) of X = (L L')^{-1} R for B instances, nrhs
    right-hand sides each (one set for the batch if rhs_shared)."""
    flops = B * 2.0 * n * n * nrhs
    words = B * (n * (n + 1) / 2 + nrhs * n) + \
        (nrhs * n if rhs_shared else B * nrhs * n)
    return flops, words * esize


def least_seconds(flops, nbytes, esize):
    """The least time the card needs: the larger of the FLOPs at the
    dtype's peak and the bytes at the memory bandwidth."""
    return max(flops / PEAK_FLOPS[esize], nbytes / PEAK_BYTES)
