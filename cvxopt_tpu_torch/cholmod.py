"""cvxopt.cholmod-compatible namespace, twin of `cvxopt_tpu/cholmod.py`.

Backed by `cvxopt_tpu_torch.ops.spsolve`: RCM and banded Cholesky for
bandable patterns, the tile-map block-sparse Cholesky for band-hostile
ones, a dense factor otherwise.  Solutions are returned rather than
written into B, and factors are small dataclasses.  `options` is the
SAME dict object as `cvxopt_tpu_torch.ops.spsolve.options`
(supernodal/print/nmethods/postorder/dbound).
"""

from cvxopt_tpu_torch.ops.spsolve import (
    symbolic, numeric, solve, linsolve, splinsolve, diag, getfactor,
    options,
)


def spsolve(F, B, sys: int = 0):
    """cholmod.spsolve: solve with a sparse right-hand side (scipy or
    torch sparse); the solution comes back dense, as in the JAX
    package."""
    return solve(F, B, sys=sys)


__all__ = ["symbolic", "numeric", "solve", "spsolve", "linsolve",
           "splinsolve", "diag", "getfactor", "options"]
