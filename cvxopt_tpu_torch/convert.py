"""Problem data and solver state carried into the port.

The solver has no weights: what carries across from the JAX package (or
any numpy source) is problem data, cone dimensions and warm-start
iterates.  Everything goes through numpy arrays, so this module needs
no import of the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from cvxopt_tpu_torch.cones import ConeDims


def problem_from_numpy(P, q, G, h, A, b, *, device, dtype=torch.float64):
    """(P, q, G, h, A, b) as tensors of `dtype` on `device`."""
    return tuple(torch.as_tensor(np.asarray(u), dtype=dtype, device=device)
                 for u in (P, q, G, h, A, b))


def dims_from(obj) -> ConeDims:
    """ConeDims from any object with `l`, `q`, `s` (and optionally
    `mnl`) attributes, or from a reference-style dims dict."""
    if isinstance(obj, dict):
        return ConeDims.from_dict(obj)
    return ConeDims(l=int(obj.l), q=tuple(obj.q), s=tuple(obj.s),
                    mnl=int(getattr(obj, "mnl", 0)))


def initvals_from_numpy(d, *, device, dtype=torch.float64):
    """Warm start for the port from a dict of iterates: 'x', 'y', 's',
    'z' become `dtype` tensors and '_valid' a bool tensor."""
    out = {}
    for k in ("x", "y", "s", "z"):
        if k in d:
            out[k] = torch.as_tensor(np.asarray(d[k]), dtype=dtype,
                                     device=device)
    if "_valid" in d:
        out["_valid"] = torch.as_tensor(np.asarray(d["_valid"]),
                                        dtype=torch.bool, device=device)
    return out


def startvals_from_numpy(d, *, device, dtype=torch.float64):
    """conelp warm start from a dict of iterates: returns (primalstart,
    dualstart) with 'x', 's' / 'y', 'z' as `dtype` tensors, each None
    when the dict holds none of its entries."""
    def part(keys):
        out = {k: torch.as_tensor(np.asarray(d[k]), dtype=dtype,
                                  device=device) for k in keys if k in d}
        return out or None
    return part(("x", "s")), part(("y", "z"))


def spmatrix_from_numpy(V, I, J, size, *, device):
    """The port's sparse matrix (an uncoalesced torch sparse COO tensor)
    from triplets, e.g. a JAX BCOO's ``(data, indices[:, 0],
    indices[:, 1])`` as numpy: the entries keep their order and their
    duplicates, so sp_I/sp_J/sp_V agree element for element."""
    from cvxopt_tpu_torch.base import spmatrix
    return spmatrix(np.asarray(V), np.asarray(I), np.asarray(J),
                    size=tuple(size), device=device)
