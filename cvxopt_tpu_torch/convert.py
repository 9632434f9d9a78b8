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
