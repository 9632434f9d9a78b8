"""Judge an answer of min 1/2 x'Px + q'x  s.t. Gx + s = h, s >= 0, Ax = b
by what it says, in float64, from the problem's own data.

`kkt_numbers` recomputes the configuration's stopping criteria (CVXOPT's
coneqp: coneprog.py's pres, dres and gap) from the returned x, y, s, z,
so the numbers do not come from the solver's own bookkeeping, and adds
how far s or z leaves the cone.  `gap` is s'z: the configurations here
stop on gap <= abstol (reltol = 0, or |pcost| < 1 so that relgap <=
reltol implies it).  Imports torch only.
"""

from __future__ import annotations

import torch


def kkt_numbers(P, q, G, h, A, b, x, y, s, z):
    """dict(pres, dres, gap, cone) of one answer, in float64."""
    d = torch.float64
    P, q, G, h, A, b, x, y, s, z = (
        torch.as_tensor(u).to(d) for u in (P, q, G, h, A, b, x, y, s, z))
    nrm = torch.linalg.vector_norm
    Px = P @ x
    pres = max(float(nrm(A @ x - b)) / max(1.0, float(nrm(b))),
               float(nrm(G @ x + s - h)) / max(1.0, float(nrm(h))))
    dres = float(nrm(Px + q + A.T @ y + G.T @ z)) / max(1.0, float(nrm(q)))
    return dict(pres=pres, dres=dres, gap=float(s @ z),
                cone=max(0.0, -float(s.min()), -float(z.min())))
