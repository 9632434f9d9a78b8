"""Solver front-ends: lp, qp, socp, sdp.

Twin of `cvxopt_tpu/frontends.py`: stack cone blocks, dispatch to
conelp/coneqp, and split the solution back into per-block pieces with
the reference's result keys ('sl'/'sq'/'zl'/'zq' for socp,
'sl'/'ss'/'zl'/'zs' for sdp).  Inputs are numpy arrays (or anything
`numpy.asarray` takes); the iterates come back as tensors on the device
that solved them.

`solver='glpk'` (lp) runs the native simplex (`glpk.lp`) on `device` and
recomputes every result field from the vertex, as the reference's
dispatch does (coneprog.py:2807-2875); `solver='mosek'` (lp, qp, socp)
hands the problem to the MOSEK bridge (`msk`, which needs the
commercial `mosek` package) on the host.  Both return numpy iterates.
'dsdp' has no counterpart and raises ValueError, as in the JAX package.
"""

from __future__ import annotations

import numpy as np

from cvxopt_tpu_torch.cones import ConeDims
from cvxopt_tpu_torch.conelp import conelp
from cvxopt_tpu_torch.coneqp import coneqp


def _check_solver(solver):
    if solver == "dsdp":
        raise ValueError(
            "external solver 'dsdp' is not available; use the default "
            "(None) solver")
    if solver is not None:
        raise ValueError(f"invalid solver '{solver}'")


def _lp_arrays(c, G, h, A, b):
    """(c, G, h, A, b, has_A) as float64 numpy, A/b empty when absent."""
    c = np.asarray(c, dtype=float).reshape(-1)
    n = c.shape[0]
    G = np.asarray(G, dtype=float).reshape(-1, n)
    h = np.asarray(h, dtype=float).reshape(-1)
    has_A = A is not None
    if has_A:
        A = np.asarray(A, dtype=float).reshape(-1, n)
        b = np.asarray(b, dtype=float).reshape(-1)
    else:
        A = np.zeros((0, n))
        b = np.zeros((0,))
    return c, G, h, A, b, has_A


def _lp_glpk(c, G, h, A, b, options, device):
    """solver='glpk' branch of lp (coneprog.py:2807-2875): run the
    native simplex, then recompute every result-dict field from the
    vertex solution exactly as the reference does."""
    from cvxopt_tpu_torch import glpk as glpk_mod
    from cvxopt_tpu_torch import solvers as _solvers

    # reference semantics (coneprog.py:2807): the options['glpk'] dict
    # (per-call kwarg, else the shared solvers.options) applies INSTEAD
    # of the module options; glpk.options is only the final fallback
    if options is not None and "glpk" in options:
        opts = dict(options["glpk"])
    elif "glpk" in _solvers.options:
        opts = dict(_solvers.options["glpk"])
    else:
        opts = dict(glpk_mod.options)
    c, G, h, A, b, has_A = _lp_arrays(c, G, h, A, b)
    res = glpk_mod.lp(c, G, h, A if has_A else None,
                      b if has_A else None, options=opts, device=device)
    status, x, z = res[:3]
    y = res[3] if has_A else (np.zeros((0,)) if status == "optimal"
                              else None)
    return _vertex_result(c, G, h, A, b, status, x, z, y)


def _vertex_result(c, G, h, A, b, status, x, z, y):
    """Reference-format LP result dict recomputed from an external
    solver's (x, z, y) (coneprog.py:2807-2875 / :2877-3007): every
    residual and objective field is computed here, so the result does
    not depend on the solver."""
    m = G.shape[0]
    out = {"status": status, "x": None, "s": None, "y": None,
           "z": None,
           "residual as primal infeasibility certificate": None,
           "residual as dual infeasibility certificate": None}
    out.update(dict.fromkeys(
        ("primal objective", "dual objective", "gap", "relative gap",
         "primal infeasibility", "dual infeasibility", "primal slack",
         "dual slack")))
    if status != "optimal":
        return out

    s = h - G @ x
    gap = float(s @ z)
    pcost = float(c @ x)
    dcost = float(-h @ z - b @ y)
    relgap = (gap / -pcost if pcost < 0.0
              else gap / dcost if dcost > 0.0 else None)
    resx0 = max(1.0, float(np.linalg.norm(c)))
    resy0 = max(1.0, float(np.linalg.norm(b)))
    resz0 = max(1.0, float(np.linalg.norm(h)))
    rx = c + G.T @ z + A.T @ y
    ry = b - A @ x
    rz = G @ x + s - h
    out.update({
        "x": x, "s": s, "y": y, "z": z,
        "primal objective": pcost, "dual objective": dcost,
        "gap": gap, "relative gap": relgap,
        "primal infeasibility": max(
            float(np.linalg.norm(ry)) / resy0,
            float(np.linalg.norm(rz)) / resz0),
        "dual infeasibility": float(np.linalg.norm(rx)) / resx0,
        "primal slack": float(np.min(s)) if m else 0.0,
        "dual slack": float(np.min(z)) if m else 0.0,
    })
    return out


def _msk_status(solsta):
    """mosek solsta -> reference status string (coneprog.py:2877-3007)."""
    import mosek
    if solsta is mosek.solsta.optimal:
        return "optimal"
    if solsta is mosek.solsta.prim_infeas_cer:
        return "primal infeasible"
    if solsta is mosek.solsta.dual_infeas_cer:
        return "dual infeasible"
    return "unknown"


def _msk_options(options):
    """MOSEK options: per-call kwarg -> solvers.options['mosek'] ->
    msk.options (the same chain for every front end)."""
    from cvxopt_tpu_torch import msk as msk_mod
    from cvxopt_tpu_torch import solvers as _solvers

    if options is not None and "mosek" in options:
        return dict(options["mosek"])
    if "mosek" in _solvers.options:
        return dict(_solvers.options["mosek"])
    return dict(msk_mod.options)


def _lp_mosek(c, G, h, A, b, options):
    """solver='mosek' branch of lp (coneprog.py:2877-3007): run the
    MOSEK bridge, map solsta, recompute every result field here."""
    from cvxopt_tpu_torch import msk as msk_mod

    opts = _msk_options(options)
    c, G, h, A, b, has_A = _lp_arrays(c, G, h, A, b)
    solsta, x, z, y = msk_mod.lp(c, G, h, A if has_A else None,
                                 b if has_A else None, options=opts)
    status = _msk_status(solsta)
    if status != "optimal":
        x = z = y = None
    elif y is None:
        y = np.zeros((0,))
    return _vertex_result(c, G, h, A, b, status, x, z, y)


def _qp_mosek(P, q, G, h, A, b, options):
    """solver='mosek' branch of qp: the bridge's vertex, the result
    fields recomputed with the quadratic objective."""
    from cvxopt_tpu_torch import msk as msk_mod

    q1 = np.asarray(q, dtype=float).reshape(-1)
    n = q1.shape[0]
    if G is None:
        G, h = np.zeros((0, n)), np.zeros((0,))
    q1, Gm, hm, Am, bm, has_A = _lp_arrays(q1, G, h, A, b)
    solsta, x, z, y = msk_mod.qp(
        np.asarray(P, dtype=float), q1, Gm, hm, Am if has_A else None,
        bm if has_A else None, options=_msk_options(options))
    status = _msk_status(solsta)
    ok = status == "optimal"
    out = _vertex_result(q1, Gm, hm, Am, bm, status,
                         x if ok else None, z if ok else None,
                         (y if y is not None else np.zeros((0,)))
                         if ok else None)
    if ok:
        # the objective fields use the quadratic objective; 'relative
        # gap' follows from them by the reference's rule
        # (coneprog.py:2255-2260)
        Pm = np.asarray(P, dtype=float).reshape(n, n)
        pcost = 0.5 * float(x @ Pm @ x) + float(q1 @ x)
        gap = out["gap"] or 0.0
        dcost = pcost - gap
        out["primal objective"] = pcost
        out["dual objective"] = dcost
        out["relative gap"] = (gap / -pcost if pcost < 0.0
                               else gap / dcost if dcost > 0.0 else None)
    return out


def lp(c, G, h, A=None, b=None, solver=None, options=None, device="cuda",
       **kwargs):
    """LP front-end (coneprog.py:2550): conelp with dims = {'l': m}, the
    native simplex under solver='glpk', or the MOSEK bridge under
    solver='mosek' (requires the `mosek` package)."""
    if solver == "glpk":
        return _lp_glpk(c, G, h, A, b, options, device)
    if solver == "mosek":
        return _lp_mosek(c, G, h, A, b, options)
    _check_solver(solver)
    return conelp(c, G, h, dims=None, A=A, b=b, options=options,
                  device=device)


def qp(P, q, G=None, h=None, A=None, b=None, solver=None, options=None,
       initvals=None, device="cuda", **kwargs):
    """QP front-end (coneprog.py:4156): coneqp with dims = {'l': m};
    solver='mosek' uses the MOSEK bridge."""
    if solver == "mosek":
        return _qp_mosek(P, q, G, h, A, b, options)
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
    into one conelp call; splits s, z back into 'sl'/'sq'/'zl'/'zq'.
    solver='mosek' uses the MOSEK bridge (which rejects equality
    constraints, as the reference does, coneprog.py:3340)."""
    if solver != "mosek":
        _check_solver(solver)
    hq = [np.asarray(hk, dtype=float).reshape(-1) for hk in (hq or [])]
    mq = [hk.size for hk in hq]
    c, ml, G, h = _stacked(c, Gl, hl, Gq or [], hq)
    if solver == "mosek":
        sol = _socp_mosek(c, G[:ml], h[:ml], G, h, Gq or [], hq, A,
                          options)
    else:
        sol = conelp(c, G, h, dims=ConeDims(l=ml, q=tuple(mq)), A=A, b=b,
                     options=options, device=device)
    return _split(sol, ml, mq, lambda m: (m,), "l", "q")


def _socp_mosek(c, Gl, hl, G, h, Gq, hq, A, options):
    """solver='mosek' branch of socp: the bridge's (x, zl, zq), the
    result fields recomputed from the vertex."""
    from cvxopt_tpu_torch import msk as msk_mod

    if A is not None:
        raise ValueError("'mosek' does not accept equality constraints "
                         "in socp")
    n = c.shape[0]
    solsta, x, zl, zq = msk_mod.socp(c, Gl, hl, Gq, hq,
                                     options=_msk_options(options))
    status = _msk_status(solsta)
    ok = status == "optimal"
    z = np.concatenate([np.asarray(zl)] + [np.asarray(zk) for zk in zq]) \
        if ok else None
    return _vertex_result(c, G, h, np.zeros((0, n)), np.zeros((0,)),
                          status, np.asarray(x) if ok else None, z,
                          np.zeros((0,)) if ok else None)


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
