"""Judge an answer of min 1/2 x'Px + q'x  s.t. Gx + s = h, Ax = b, s in
R^l_+ x SOC(m_1) x ... (dims: a {'l', 'q'} dict, parts in that order)
by what it says, in float64, from the problem's own data.

`kkt_numbers` takes CVXOPT's coneqp stopping criteria (pres, dres and
gap = s'z) from `qp_check.kkt_numbers`, recomputed from the returned
x, y, s, z, and replaces its `cone`, which tests u >= 0 entrywise and
so is no test of a second-order cone, by how far s or z leaves the
cone: the worst of -u_i over the 'l' part and of ||u1|| - u0 over the
blocks u = (u0, u1), or 0 where both lie in it.  Imports torch only.
"""

from __future__ import annotations

import itertools

import torch

from benchmark.reference import qp_check


def cone_excess(u, dims):
    """max(0, -min u_l, max over the blocks of ||u1|| - u0)."""
    l = dims.get("l", 0)
    worst = [0.0] + ([-float(u[:l].min())] if l else [])
    off = l
    for m, grp in itertools.groupby(dims.get("q", ())):
        cnt = len(list(grp))
        blk = u[off:off + cnt * m].reshape(cnt, m)
        worst.append(float((torch.linalg.vector_norm(blk[:, 1:], dim=-1)
                            - blk[:, 0]).max()))
        off += cnt * m
    return max(worst)


def kkt_numbers(P, q, G, h, A, b, dims, x, y, s, z):
    """dict(pres, dres, gap, cone) of one answer, in float64."""
    nums = qp_check.kkt_numbers(P, q, G, h, A, b, x, y, s, z)
    s, z = (torch.as_tensor(u).to(torch.float64) for u in (s, z))
    nums["cone"] = max(cone_excess(s, dims), cone_excess(z, dims))
    return nums
