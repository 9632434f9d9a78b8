"""Solver front-ends: lp, qp, socp, sdp.

Twin of `cvxopt_tpu/frontends.py`: stack cone blocks, dispatch to
conelp/coneqp, and split the solution back into per-block pieces with
the reference's result keys ('sl'/'sq'/'zl'/'zq' for socp,
'sl'/'ss'/'zl'/'zs' for sdp).  Inputs are numpy arrays (or anything
`numpy.asarray` takes); the iterates come back as tensors on the device
that solved them.

Only the default solver (None, the package's own interior-point method)
is ported: `solver='glpk'` and `solver='mosek'` raise NotImplementedError
(ROADMAP.md, Queue 1 items 16 and 17).  'dsdp' has no counterpart and
raises ValueError, as in the JAX package.
"""

from __future__ import annotations

import numpy as np

from cvxopt_tpu_torch.cones import ConeDims
from cvxopt_tpu_torch.conelp import conelp
from cvxopt_tpu_torch.coneqp import coneqp

_LATER = {"glpk": "Queue 1 item 16 (simplex, glpk, ilp)",
          "mosek": "Queue 1 item 17 (modeling, mpsio, msk)"}


def _check_solver(solver):
    if solver in _LATER:
        raise NotImplementedError(
            f"solver '{solver}' is not ported yet (ROADMAP.md "
            f"{_LATER[solver]})")
    if solver == "dsdp":
        raise ValueError(
            "external solver 'dsdp' is not available; use the default "
            "(None) solver")
    if solver is not None:
        raise ValueError(f"invalid solver '{solver}'")


def lp(c, G, h, A=None, b=None, solver=None, options=None, device="cuda",
       **kwargs):
    """LP front-end (coneprog.py:2550): conelp with dims = {'l': m}."""
    _check_solver(solver)
    return conelp(c, G, h, dims=None, A=A, b=b, options=options,
                  device=device)


def qp(P, q, G=None, h=None, A=None, b=None, solver=None, options=None,
       initvals=None, device="cuda", **kwargs):
    """QP front-end (coneprog.py:4156): coneqp with dims = {'l': m}."""
    _check_solver(solver)
    return coneqp(P, q, G, h, dims=None, A=A, b=b, initvals=initvals,
                  options=options, device=device)


def _stack_cols(blocks, n):
    mats = [np.asarray(B, dtype=float).reshape(-1, n) for B in blocks]
    if not mats:
        return np.zeros((0, n))
    return np.concatenate(mats, axis=0)


def _stacked(c, Gl, hl, Gblocks, hblocks):
    """(c, n, ml, G, h) with the 'l' block on top of the cone blocks."""
    c = np.asarray(c, dtype=float).reshape(-1)
    n = c.shape[0]
    if Gl is None:
        Gl = np.zeros((0, n))
        hl = np.zeros((0,))
    Gl = np.asarray(Gl, dtype=float).reshape(-1, n)
    hl = np.asarray(hl, dtype=float).reshape(-1)
    G = np.concatenate([Gl, _stack_cols(Gblocks, n)], axis=0)
    h = np.concatenate([hl] + list(hblocks))
    return c, Gl.shape[0], G, h


def _split(sol, ml, sizes, shape, lkey, bkey):
    """Replace sol['s'], sol['z'] by their 'l' part and per-block lists."""
    for k in ("s", "z"):
        v = sol.pop(k, None)
        vl = vb = None
        if v is not None:
            vl, vb, ind = v[:ml], [], ml
            for m in sizes:
                vb.append(v[ind:ind + m].reshape(shape(m)))
                ind += m
        sol[k + lkey], sol[k + bkey] = vl, vb
    return sol


def socp(c, Gl=None, hl=None, Gq=None, hq=None, A=None, b=None,
         solver=None, options=None, device="cuda", **kwargs):
    """SOCP front-end (coneprog.py:3013): stacks Gl and the Gq[k] blocks
    into one conelp call; splits s, z back into 'sl'/'sq'/'zl'/'zq'."""
    _check_solver(solver)
    hq = [np.asarray(hk, dtype=float).reshape(-1) for hk in (hq or [])]
    mq = [hk.size for hk in hq]
    c, ml, G, h = _stacked(c, Gl, hl, Gq or [], hq)
    sol = conelp(c, G, h, dims=ConeDims(l=ml, q=tuple(mq)), A=A, b=b,
                 options=options, device=device)
    return _split(sol, ml, mq, lambda m: (m,), "l", "q")


def sdp(c, Gl=None, hl=None, Gs=None, hs=None, A=None, b=None,
        solver=None, options=None, device="cuda", **kwargs):
    """SDP front-end (coneprog.py:3566): Gs[k] are (m_k^2, n) blocks,
    hs[k] are (m_k, m_k) matrices; splits s, z back into
    'sl'/'ss'/'zl'/'zs' (ss/zs as (m_k, m_k) matrices)."""
    _check_solver(solver)
    hs = [np.asarray(hk, dtype=float).reshape(-1) for hk in (hs or [])]
    msizes = [int(round(len(v) ** 0.5)) for v in hs]
    c, ml, G, h = _stacked(c, Gl, hl, Gs or [], hs)
    sol = conelp(c, G, h, dims=ConeDims(l=ml, s=tuple(msizes)), A=A, b=b,
                 options=options, device=device)
    return _split(sol, ml, [m * m for m in msizes],
                  lambda mm: (int(round(mm ** 0.5)),) * 2, "l", "s")
