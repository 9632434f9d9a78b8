"""The pieces of `cvxopt_tpu/conelp.py` that the cone-QP solver uses:
status codes, step constants, the mixed-precision rescue triggers,
input preparation and the stacked residual norm.  The cone-LP solver
itself is a later slice (ROADMAP.md, Queue 1 item 8)."""

from __future__ import annotations

import torch

from cvxopt_tpu_torch import cones
from cvxopt_tpu_torch.cones import ConeDims

STATUS_RUNNING = -1
STATUS_OPTIMAL = 0
STATUS_PRIMAL_INFEASIBLE = 1
STATUS_DUAL_INFEASIBLE = 2
STATUS_UNKNOWN_MAXITERS = 3
STATUS_UNKNOWN_SINGULAR = 4
# internal only: instance handed from the mixed-precision phase to the
# full-precision rescue phase (never escapes the solver)
STATUS_NEEDS_F64 = 5
# internal only: the cone-LP refresh loop's stall exit
STATUS_STALLED = 6

# mixed-precision rescue triggers (per instance, outcome-based):
# RESCUE_STALL_ITERS non-improving iterations, a >100x regression of the
# convergence measure, a gap collapse with residuals >10x feastol, or a
# refinement round that expands the residual (relres > RESCUE_RELRES).
RESCUE_STALL_ITERS = 4
RESCUE_RELRES = 1.0

STATUS_STRINGS = {
    STATUS_OPTIMAL: "optimal",
    STATUS_PRIMAL_INFEASIBLE: "primal infeasible",
    STATUS_DUAL_INFEASIBLE: "dual infeasible",
    STATUS_UNKNOWN_MAXITERS: "unknown",
    STATUS_UNKNOWN_SINGULAR: "unknown",
    STATUS_STALLED: "unknown",
}

# step and centering exponent (coneprog.py:423-424)
STEP = 0.99
EXPON = 3


def _tnorm_parts(parts):
    """sqrt(sum of squared 2-norms) over a tuple of (B, k) tensors,
    one value per instance."""
    t = 0.0
    for pt in parts:
        t = t + (pt * pt).sum(-1)
    return torch.sqrt(torch.clamp(t, min=0.0))


def _prep_inputs(c, G, h, dims, A, b, dtype=torch.float64, device="cpu"):
    """Dense single-problem inputs as tensors: c (n,), G (cdim, n),
    h (cdim,), A (p, n), b (p,), with 's' rows symmetrized from their
    column-major lower triangles."""
    kw = dict(dtype=dtype, device=device)
    c = torch.as_tensor(c, **kw).reshape(-1)
    n = c.shape[0]
    h = torch.as_tensor(h, **kw).reshape(-1)
    if dims is None:
        dims = ConeDims(l=h.shape[0])
    elif isinstance(dims, dict):
        dims = ConeDims.from_dict(dims)
    if h.shape[0] != dims.cdim:
        raise TypeError(f"'h' must have length {dims.cdim}")
    G = torch.as_tensor(G, **kw).reshape(-1, n)
    if G.shape[0] != dims.cdim:
        raise TypeError(f"'G' must have {dims.cdim} rows")
    G = cones.symmetrize_lower(G.transpose(0, 1), dims).transpose(0, 1)
    if A is None:
        A = torch.zeros((0, n), **kw)
    else:
        A = torch.as_tensor(A, **kw).reshape(-1, n)
    if b is None:
        b = torch.zeros((A.shape[0],), **kw)
    else:
        b = torch.as_tensor(b, **kw).reshape(-1)
    h = cones.symmetrize_lower(h, dims)
    return c, G, h, dims, A, b
