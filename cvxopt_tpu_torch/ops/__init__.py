"""Numeric layer of the port, twin of `cvxopt_tpu/ops/__init__.py`:

  blas     cvxopt.blas equivalents (34 functions)
  lapack   cvxopt.lapack equivalents (factorizations, eigen/SVD, Schur)
  spsolve  cvxopt.cholmod/umfpack/amd equivalents (the sparse direct
           path over ops/banded and ops/blocksparse)

plus the solver kernels and matrix helpers (fused_chol, blockinv,
jacobi, matvec, sparse_kkt).  All functions are pure (they return their
results) and batched over leading axes.
"""

from cvxopt_tpu_torch.ops import blas, lapack, spsolve

__all__ = ["blas", "lapack", "spsolve"]
