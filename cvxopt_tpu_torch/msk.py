"""cvxopt.msk-compatible MOSEK bridge (the reference's msk.py:38 lp,
:192 conelp, :482 socp, :670 qp, :839 ilp).

Twin of `cvxopt_tpu/msk.py`, host code: a translation layer that maps
numpy/scipy problem data onto a `mosek.Task`, runs the MOSEK optimizer
and maps `solsta` codes back.  MOSEK is an optional commercial package;
a call without it installed raises ImportError.  The cone problems use
a primal slack formulation (variables [x; s], constraints [G I; A 0]
[x; s] = [h; b], s in the cones); 's' (PSD) blocks are not bridged.

Options: the `msk.options` dict of MOSEK parameters, overridable per
call through options=..., as the reference plumbs them (msk.py:84-89).
"""

from __future__ import annotations

import numpy as np

#: module-level MOSEK parameter dict (reference msk.py:84-89)
options: dict = {}

inf = float("inf")


def _mosek():
    try:
        import mosek
    except ImportError as e:                          # pragma: no cover
        raise ImportError(
            "the MOSEK python package is required for cvxopt_tpu_torch.msk "
            "(commercial solver; install `mosek` and a license)"
        ) from e
    return mosek


def _apply_options(mosek, task, kwargs):
    opts = kwargs.get("options", options)
    for param, val in opts.items():
        sp = str(param)
        if sp[:6] == "iparam" or ".iparam" in sp:
            task.putintparam(param, val)
        elif sp[:6] == "dparam" or ".dparam" in sp:
            task.putdouparam(param, val)
        elif sp[:6] == "sparam" or ".sparam" in sp:
            task.putstrparam(param, val)
        else:
            raise ValueError(f"invalid MOSEK parameter: {param}")


def _ccs_columns(M):
    """CCS triplet (ptrb, ptre, rows, vals) of a dense/sparse matrix."""
    import scipy.sparse as sp
    M = sp.csc_matrix(M)
    return (M.indptr[:-1], M.indptr[1:], M.indices, M.data)


def _shape_lp(c, G, h, A, b):
    c = np.asarray(c, float).reshape(-1)
    n = c.shape[0]
    import scipy.sparse as sp
    G = G if sp.issparse(G) else np.asarray(G, float).reshape(-1, n)
    h = np.asarray(h, float).reshape(-1)
    if A is None:
        A = np.zeros((0, n))
        b = np.zeros((0,))
    else:
        A = A if sp.issparse(A) else np.asarray(A, float).reshape(-1, n)
        b = np.asarray(b, float).reshape(-1)
    return c, G, h, A, b, n, G.shape[0], A.shape[0]


def lp(c, G, h, A=None, b=None, taskfile=None, **kwargs):
    """LP bridge (msk.py:38): min c'x s.t. Gx <= h, Ax = b.
    Returns (solsta, x, z, y)."""
    mosek = _mosek()
    import scipy.sparse as sp
    c, G, h, A, b, n, m, p = _shape_lp(c, G, h, A, b)
    if m == 0:
        raise ValueError("m cannot be 0")

    bkc = m * [mosek.boundkey.up] + p * [mosek.boundkey.fx]
    blc = m * [-inf] + list(b)
    buc = list(h) + list(b)
    bkx = n * [mosek.boundkey.fr]
    blx, bux = n * [-inf], n * [+inf]
    GA = sp.vstack([sp.csc_matrix(G), sp.csc_matrix(A)])
    ptrb, ptre, rows, vals = _ccs_columns(GA)

    with mosek.Env() as env, env.Task(0, 0) as task:
        _apply_options(mosek, task, kwargs)
        task.inputdata(m + p, n, list(c), 0.0,
                       list(ptrb), list(ptre), list(rows), list(vals),
                       bkc, blc, buc, bkx, blx, bux)
        task.putobjsense(mosek.objsense.minimize)
        if taskfile:
            task.writetask(taskfile)
        task.optimize()
        solsta = task.getsolsta(mosek.soltype.bas)
        x = n * [0.0]
        z = m * [0.0]
        task.getsolutionslice(mosek.soltype.bas, mosek.solitem.xx,
                              0, n, x)
        task.getsolutionslice(mosek.soltype.bas, mosek.solitem.suc,
                              0, m, z)
        if p:
            yu, yl = p * [0.0], p * [0.0]
            task.getsolutionslice(mosek.soltype.bas, mosek.solitem.suc,
                                  m, m + p, yu)
            task.getsolutionslice(mosek.soltype.bas, mosek.solitem.slc,
                                  m, m + p, yl)
            y = np.asarray(yu) - np.asarray(yl)
        else:
            y = np.zeros((0,))
    if solsta is mosek.solsta.unknown:
        return solsta, None, None, None
    return solsta, np.asarray(x), np.asarray(z), np.asarray(y)


def conelp(c, G, h, dims=None, taskfile=None, **kwargs):
    """Cone LP bridge (msk.py:192): min c'x s.t. Gx + s = h, s in C,
    C = R^l_+ x Q_{q0} x ... ('s' blocks are not bridged — the
    reference front-ends route SDPs to DSDP).  Returns
    (solsta, x, z) with z the cone dual."""
    mosek = _mosek()
    import scipy.sparse as sp
    c = np.asarray(c, float).reshape(-1)
    n = c.shape[0]
    G = G if sp.issparse(G) else np.asarray(G, float).reshape(-1, n)
    h = np.asarray(h, float).reshape(-1)
    m = G.shape[0]
    if dims is None:
        dims = {"l": m, "q": [], "s": []}
    if dims.get("s"):
        raise NotImplementedError(
            "PSD blocks are not bridged to MOSEK (use the native "
            "solver or dsdp-capability path)")
    ml = dims.get("l", 0)
    mq = list(dims.get("q", []))
    if ml + sum(mq) != m:
        raise ValueError("dims do not match the rows of G")

    # primal slack form: variables [x; s], constraints Gx + s = h
    bkc = m * [mosek.boundkey.fx]
    blc = buc = list(h)
    bkx = (n * [mosek.boundkey.fr] + ml * [mosek.boundkey.lo]
           + sum(mq) * [mosek.boundkey.fr])
    blx = n * [-inf] + ml * [0.0] + sum(mq) * [-inf]
    bux = (n + m) * [+inf]
    GI = sp.hstack([sp.csc_matrix(G), sp.eye(m, format="csc")])
    ptrb, ptre, rows, vals = _ccs_columns(GI)
    cfull = list(c) + m * [0.0]

    with mosek.Env() as env, env.Task(0, 0) as task:
        _apply_options(mosek, task, kwargs)
        task.inputdata(m, n + m, cfull, 0.0,
                       list(ptrb), list(ptre), list(rows), list(vals),
                       bkc, blc, buc, bkx, blx, bux)
        off = n + ml
        for qk in mq:
            task.appendcone(mosek.conetype.quad, 0.0,
                            list(range(off, off + qk)))
            off += qk
        task.putobjsense(mosek.objsense.minimize)
        if taskfile:
            task.writetask(taskfile)
        task.optimize()
        solsta = task.getsolsta(mosek.soltype.itr)
        x = n * [0.0]
        task.getsolutionslice(mosek.soltype.itr, mosek.solitem.xx,
                              0, n, x)
        # cone dual = multiplier of the Gx + s = h equality rows
        yu, yl = m * [0.0], m * [0.0]
        task.getsolutionslice(mosek.soltype.itr, mosek.solitem.suc,
                              0, m, yu)
        task.getsolutionslice(mosek.soltype.itr, mosek.solitem.slc,
                              0, m, yl)
        z = np.asarray(yu) - np.asarray(yl)
    if solsta is mosek.solsta.unknown:
        return solsta, None, None
    return solsta, np.asarray(x), z


def socp(c, Gl=None, hl=None, Gq=None, hq=None, taskfile=None,
         **kwargs):
    """SOCP bridge (msk.py:482): stacks the 'l' block and the 'q'
    blocks and solves through `conelp`.  Returns
    (solsta, x, zl, zq) with zq a list per cone block."""
    c = np.asarray(c, float).reshape(-1)
    n = c.shape[0]
    Gl = (np.zeros((0, n)) if Gl is None
          else np.asarray(Gl, float).reshape(-1, n))
    hl = (np.zeros((0,)) if hl is None
          else np.asarray(hl, float).reshape(-1))
    Gq = [np.asarray(Gk, float).reshape(-1, n) for Gk in (Gq or [])]
    hq = [np.asarray(hk, float).reshape(-1) for hk in (hq or [])]
    G = np.concatenate([Gl] + Gq, axis=0) if (len(Gq) or Gl.size) \
        else Gl
    h = np.concatenate([hl] + hq) if (len(hq) or hl.size) else hl
    dims = {"l": Gl.shape[0], "q": [Gk.shape[0] for Gk in Gq],
            "s": []}
    res = conelp(c, G, h, dims, taskfile=taskfile, **kwargs)
    solsta, x, z = res
    if z is None:
        return solsta, x, None, None
    ml = dims["l"]
    zl = z[:ml]
    zq, off = [], ml
    for qk in dims["q"]:
        zq.append(z[off:off + qk])
        off += qk
    return solsta, x, zl, zq


def qp(P, q, G=None, h=None, A=None, b=None, taskfile=None, **kwargs):
    """QP bridge (msk.py:670): min 1/2 x'Px + q'x s.t. Gx <= h,
    Ax = b.  Returns (solsta, x, z, y)."""
    mosek = _mosek()
    import scipy.sparse as sp
    q = np.asarray(q, float).reshape(-1)
    n = q.shape[0]
    P = P if sp.issparse(P) else np.asarray(P, float).reshape(n, n)
    if G is None:
        G = np.zeros((0, n))
        h = np.zeros((0,))
    c, G, h, A, b, n, m, p = _shape_lp(q, G, h, A, b)

    bkc = m * [mosek.boundkey.up] + p * [mosek.boundkey.fx]
    blc = m * [-inf] + list(b)
    buc = list(h) + list(b)
    bkx = n * [mosek.boundkey.fr]
    blx, bux = n * [-inf], n * [+inf]
    GA = sp.vstack([sp.csc_matrix(G), sp.csc_matrix(A)])
    ptrb, ptre, rows, vals = _ccs_columns(GA)
    # lower triangle of P for putqobj
    Pl = sp.tril(sp.csc_matrix(P)).tocoo()

    with mosek.Env() as env, env.Task(0, 0) as task:
        _apply_options(mosek, task, kwargs)
        task.inputdata(m + p, n, list(c), 0.0,
                       list(ptrb), list(ptre), list(rows), list(vals),
                       bkc, blc, buc, bkx, blx, bux)
        task.putqobj(list(Pl.row), list(Pl.col), list(Pl.data))
        task.putobjsense(mosek.objsense.minimize)
        if taskfile:
            task.writetask(taskfile)
        task.optimize()
        solsta = task.getsolsta(mosek.soltype.itr)
        x = n * [0.0]
        z = m * [0.0]
        task.getsolutionslice(mosek.soltype.itr, mosek.solitem.xx,
                              0, n, x)
        task.getsolutionslice(mosek.soltype.itr, mosek.solitem.suc,
                              0, m, z)
        if p:
            yu, yl = p * [0.0], p * [0.0]
            task.getsolutionslice(mosek.soltype.itr, mosek.solitem.suc,
                                  m, m + p, yu)
            task.getsolutionslice(mosek.soltype.itr, mosek.solitem.slc,
                                  m, m + p, yl)
            y = np.asarray(yu) - np.asarray(yl)
        else:
            y = np.zeros((0,))
    if solsta is mosek.solsta.unknown:
        return solsta, None, None, None
    return solsta, np.asarray(x), np.asarray(z), np.asarray(y)


def ilp(c, G, h, A=None, b=None, I=None, taskfile=None, **kwargs):
    """Mixed-integer LP bridge (msk.py:839): min c'x s.t. Gx <= h,
    Ax = b, x_i integer for i in I (default: all).  Returns
    (solsta, x)."""
    mosek = _mosek()
    import scipy.sparse as sp
    c, G, h, A, b, n, m, p = _shape_lp(c, G, h, A, b)
    if I is None:
        I = set(range(n))

    bkc = m * [mosek.boundkey.up] + p * [mosek.boundkey.fx]
    blc = m * [-inf] + list(b)
    buc = list(h) + list(b)
    bkx = n * [mosek.boundkey.fr]
    blx, bux = n * [-inf], n * [+inf]
    GA = sp.vstack([sp.csc_matrix(G), sp.csc_matrix(A)])
    ptrb, ptre, rows, vals = _ccs_columns(GA)

    with mosek.Env() as env, env.Task(0, 0) as task:
        _apply_options(mosek, task, kwargs)
        task.inputdata(m + p, n, list(c), 0.0,
                       list(ptrb), list(ptre), list(rows), list(vals),
                       bkc, blc, buc, bkx, blx, bux)
        for i in I:
            task.putvartype(int(i), mosek.variabletype.type_int)
        task.putobjsense(mosek.objsense.minimize)
        if taskfile:
            task.writetask(taskfile)
        task.optimize()
        solsta = task.getsolsta(mosek.soltype.itg)
        x = n * [0.0]
        task.getsolutionslice(mosek.soltype.itg, mosek.solitem.xx,
                              0, n, x)
    if solsta in (mosek.solsta.integer_optimal,):
        return solsta, np.asarray(x)
    return solsta, None


__all__ = ["lp", "conelp", "socp", "qp", "ilp", "options"]
