"""cvxopt.umfpack-compatible namespace, twin of `cvxopt_tpu/umfpack.py`.

Sparse unsymmetric LU behind the reference's names: `symbolic`,
`numeric`, `solve` (trans 'N'/'T'/'C') and one-shot `linsolve`, backed
by `cvxopt_tpu_torch.ops.spsolve`'s LU path: RCM and the pivoted banded
LU for bandable patterns, the tile-map block LU for band-hostile ones,
a dense LU otherwise.  Solutions are returned rather than written into
B.
"""

from cvxopt_tpu_torch.ops.spsolve import (
    lu_symbolic as symbolic,
    lu_numeric as numeric,
    lu_solve as solve,
    lu_linsolve as linsolve,
)

__all__ = ["symbolic", "numeric", "solve", "linsolve"]
