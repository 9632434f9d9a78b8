"""cvxopt.glpk-compatible namespace: `lp`, `ilp` and `options`.

Twin of `cvxopt_tpu/glpk.py`.  The reference binds GLPK's C simplex and
branch-and-cut (glpk.c:85 `lp`, :467 `ilp`); here both are native:
`lp` is the batched dense revised simplex (`simplex.lp`), `ilp` the
best-first branch-and-bound with lifted cover cuts over the batched
cone-LP cores (`ilp.ilp`).  Both take `device=` ("cuda" unless the
caller asks for the CPU).  `options` takes GLPK parameter names, as the
reference's options plumbing does.
"""

from cvxopt_tpu_torch.simplex import lp
from cvxopt_tpu_torch.ilp import ilp

#: module-level options dict, mirroring cvxopt.glpk.options
options: dict = {}

__all__ = ["lp", "ilp", "options"]
