"""Plain PyTorch coneqp over R^l_+ x SOC(m_1) x ... x SOC(m_k): the
reference iteration for cone QPs whose dims have 'l' and 'q' parts,

    minimize 1/2 x'Px + q'x  s.t.  Gx + s = h,  Ax = b,  s in the cone,

one problem at a time: infeasible start, Mehrotra predictor and
corrector with `refinement` rounds of iterative refinement,
Nesterov-Todd scaling (the 'q' blocks' hyperbolic Householder
W = beta (2 v v' - J)), the step to the boundary of each block, and the
normal equations S = P + Gs'Gs, Gs = W^{-T} G, factored by
`torch.linalg.cholesky`, with a Schur complement for the equalities.

Transcribed from the frozen numpy reference of the benchmark
(`benchmark/reference/npref.py`: `coneqp_np_cones` and its `_np_*`
helpers), not from the solver it is held against.  It runs in the dtype
of its inputs and on their device, with TF32 off while it runs
(`torch.backends.cuda.matmul.allow_tf32` and
`torch.backends.cudnn.allow_tf32` False), so that what it computes in
float32 on a card is float32; it is meant for float64.  Imports torch
only.  `benchmark/reference/socp_torch.py` is a verbatim copy.

Departures from CVXOPT's coneqp (coneprog.py):

- 's' blocks are not handled: dims with an 's' part raise ValueError.
  Without them W is symmetric, so the scalings take no `trans`.
- mu = gap / (l + m_1 + ... + m_k), the length of lambda, as
  `coneqp_np_cones` has it; CVXOPT divides by l + k, the cone's
  degree.  Only the centering target sigma mu e moves; the optimality
  conditions and the stopping tests are CVXOPT's.
- The KKT system is solved by the normal equations and a Cholesky
  factor of S, where CVXOPT's default for 'q' cones ('chol') factors
  the same S after a QR of A'.  Same system, other rounding.
- A factor that is not positive definite ends the solve with status
  'unknown' at the current iterate, as CVXOPT does on a singular KKT
  system (`coneqp_np_cones` raises scipy's LinAlgError there).
- No initial values, no custom kktsolver, no operator-form P, G or A.
- Scalars (steps, sigma, the gap) are Python floats, as numpy's are in
  `coneqp_np_cones`; sums run in torch's order, not numpy's.
"""

from __future__ import annotations

import contextlib
import itertools

import torch


class _Singular(Exception):
    pass


@contextlib.contextmanager
def _no_tf32():
    """TF32 off for matrix products on the card, restored on exit."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


class _Dims:
    def __init__(self, l=0, q=(), s=()):
        if s:
            raise ValueError("'s' blocks are not handled")
        self.l = int(l)
        self.q = [int(m) for m in q]
        self.cdim = self.l + sum(self.q)
        self.q_runs = []                     # (offset, count, m)
        off = self.l
        for m, grp in itertools.groupby(self.q):
            cnt = len(list(grp))
            self.q_runs.append((off, cnt, m))
            off += cnt * m


def _qv(x, run):
    """(..., cnt, m) view of a q-run; broadcasts over leading axes."""
    off, cnt, m = run
    return x[..., off:off + cnt * m].reshape(x.shape[:-1] + (cnt, m))


def _put(out, off, length, val):
    out[..., off:off + length] = val.reshape(
        out[..., off:off + length].shape)


def _jdot(u, v):
    return u[..., 0] * v[..., 0] - (u[..., 1:] * v[..., 1:]).sum(-1)


def _jnrm2(u):
    a = torch.linalg.vector_norm(u[..., 1:], dim=-1)
    return torch.sqrt(torch.clamp(u[..., 0] - a, min=0.0)) * \
        torch.sqrt(torch.clamp(u[..., 0] + a, min=0.0))


def _J(u):
    """J u = (u0, -u1)."""
    return torch.cat([u[..., :1], -u[..., 1:]], -1)


def _identity(dims, like):
    e = like.new_zeros(dims.cdim)
    e[:dims.l] = 1.0
    for off, cnt, m in dims.q_runs:
        e[off:off + cnt * m:m] = 1.0
    return e


def _max_step(x, dims):
    """min { t | x + t e in the cone }: -min over 'l', ||x1|| - x0 over
    each 'q' block."""
    ts = [0.0]
    if dims.l:
        ts.append(-float(x[:dims.l].min()))
    for run in dims.q_runs:
        xk = _qv(x, run)
        ts.append(float((torch.linalg.vector_norm(xk[..., 1:], dim=-1)
                         - xk[..., 0]).max()))
    return max(ts)


def _scale(x, W, dims, inverse="N"):
    """W x (inverse 'I': W^{-1} x); broadcasts over leading axes of x
    (used for matrices via x = M.T)."""
    out = x.clone()
    if dims.l:
        d = W["d"] if inverse == "N" else 1.0 / W["d"]
        out[..., :dims.l] = x[..., :dims.l] * d
    for i, run in enumerate(dims.q_runs):
        off, cnt, m = run
        v, beta = W["v"][i], W["beta"][i]       # (cnt, m), (cnt,)
        xk = _qv(x, run)
        if inverse == "N":
            w = (v * xk).sum(-1, keepdim=True)
            new = beta[:, None] * (2.0 * v * w - _J(xk))
        else:
            t = _jdot(v, xk)[..., None]
            new = _J(2.0 * v * t - xk) / beta[:, None]
        _put(out, off, cnt * m, new)
    return out


def _scale2(lmbda, x, dims, inverse="N"):
    """x scaled by lambda^{-1} in the cone's product (inverse 'I': by
    lambda)."""
    out = x.clone()
    if dims.l:
        if inverse == "N":
            out[:dims.l] = x[:dims.l] / lmbda[:dims.l]
        else:
            out[:dims.l] = x[:dims.l] * lmbda[:dims.l]
    for run in dims.q_runs:
        off, cnt, m = run
        xk = _qv(x, run)
        lk = lmbda[off:off + cnt * m].reshape(cnt, m)
        a = _jnrm2(lk)[:, None]
        lbar = lk / a
        if inverse == "N":
            lx = _jdot(lbar, xk)[:, None]
            c = (lx + xk[..., :1]) / (lbar[..., :1] + 1.0)
            new = torch.cat([lx, xk[..., 1:] - c * lbar[..., 1:]], -1) / a
        else:
            lx = (lbar * xk).sum(-1, keepdim=True)
            c = (lx + xk[..., :1]) / (lbar[..., :1] + 1.0)
            new = torch.cat([lx, xk[..., 1:] + c * lbar[..., 1:]], -1) * a
        _put(out, off, cnt * m, new)
    return out


def _compute_scaling(s, z, dims):
    """The NT scaling W of (s, z) and lambda = W^{-T} z = W s."""
    W = {"d": torch.sqrt(s[:dims.l] / z[:dims.l]), "beta": [], "v": []}
    lmbda = s.new_zeros(dims.cdim)
    lmbda[:dims.l] = torch.sqrt(s[:dims.l] * z[:dims.l])
    for run in dims.q_runs:
        off, cnt, m = run
        sk, zk = _qv(s, run), _qv(z, run)
        aa = _jnrm2(sk)[:, None]
        bb = _jnrm2(zk)[:, None]
        W["beta"].append(torch.sqrt(aa / bb)[:, 0])
        sz = (sk * zk).sum(-1, keepdim=True)
        cc = torch.sqrt((sz / (aa * bb) + 1.0) / 2.0)
        sbar, zbar = sk / aa, zk / bb
        v = (sbar + _J(zbar)) / (2.0 * cc)
        v[:, 0] += 1.0
        v = v / torch.sqrt(2.0 * v[:, :1])
        W["v"].append(v)
        dd = 2.0 * cc + sbar[..., :1] + zbar[..., :1]
        l1 = ((cc + zbar[..., :1]) / dd) * sbar[..., 1:] + \
             ((cc + sbar[..., :1]) / dd) * zbar[..., 1:]
        lmbda[off:off + cnt * m] = (torch.cat([cc, l1], -1)
                                    * torch.sqrt(aa * bb)).reshape(-1)
    return W, lmbda


def _update_scaling(W, lmbda, s, z, dims):
    """The NT update: s, z are the new iterates in the current scaling."""
    lnew = lmbda.clone()
    if dims.l:
        rs, rz = torch.sqrt(s[:dims.l]), torch.sqrt(z[:dims.l])
        W["d"] = W["d"] * rs / rz
        lnew[:dims.l] = rs * rz
    for i, run in enumerate(dims.q_runs):
        off, cnt, m = run
        v, beta = W["v"][i], W["beta"][i]
        sk, zk = _qv(s, run), _qv(z, run)
        aa = _jnrm2(sk)[:, None]
        bb = _jnrm2(zk)[:, None]
        sbar, zbar = sk / aa, zk / bb
        cc = torch.sqrt((1.0 + (sbar * zbar).sum(-1, keepdim=True)) / 2.0)
        vs = (v * sbar).sum(-1, keepdim=True)
        vz = _jdot(v, zbar)[:, None]
        vq = (vs + vz) / (2.0 * cc)
        vu = vs - vz
        w0 = 2.0 * v[:, :1] * vq - (sbar[:, :1] + zbar[:, :1]) / \
            (2.0 * cc)
        dd = (v[:, :1] * vu - sbar[:, :1] / 2.0 + zbar[:, :1] / 2.0) \
            / (w0 + 1.0)
        l1 = v[:, 1:] * (2.0 * (-dd * vq + 0.5 * vu)) + \
            0.5 * (1.0 - dd / cc) * sbar[:, 1:] + \
            0.5 * (1.0 + dd / cc) * zbar[:, 1:]
        lnew[off:off + cnt * m] = (torch.cat([cc, l1], -1)
                                   * torch.sqrt(aa * bb)).reshape(-1)
        vn = 2.0 * vq * v - (_J(sbar) + zbar) / (2.0 * cc)
        vn[:, 0] += 1.0
        vn = vn / torch.sqrt(2.0 * vn[:, :1])
        W["v"][i] = vn
        W["beta"][i] = beta * torch.sqrt(aa / bb)[:, 0]
    return W, lnew


def _sinv(bs, lmbda, dims):
    """lambda^{-1} o bs in the cone's product."""
    out = bs.clone()
    if dims.l:
        out[:dims.l] = bs[:dims.l] / lmbda[:dims.l]
    for run in dims.q_runs:
        off, cnt, m = run
        xk = _qv(bs, run)
        lk = lmbda[off:off + cnt * m].reshape(cnt, m)
        aa = _jdot(lk, lk)[:, None]
        l0 = lk[:, :1]
        cc = xk[:, :1]
        dd = (lk[:, 1:] * xk[:, 1:]).sum(-1, keepdim=True)
        new = torch.cat([cc * l0 - dd,
                         (aa / l0) * xk[:, 1:] + (dd / l0 - cc) * lk[:, 1:]],
                        -1) / aa
        _put(out, off, cnt * m, new)
    return out


def _sprod(x, y, dims):
    """x o y in the cone's product."""
    out = x * y
    for run in dims.q_runs:
        off, cnt, m = run
        xk, yk = _qv(x, run), _qv(y, run)
        new = torch.cat([(xk * yk).sum(-1, keepdim=True),
                         yk[:, :1] * xk[:, 1:] + xk[:, :1] * yk[:, 1:]], -1)
        _put(out, off, cnt * m, new)
    return out


def _chol(S):
    L, info = torch.linalg.cholesky_ex(S)
    if int(info):
        raise _Singular
    return L


def _cs(L, v):
    return torch.cholesky_solve(v.unsqueeze(-1), L).squeeze(-1)


@_no_tf32()
def coneqp_cones(P, q, G, h, dims, A=None, b=None, *, maxiters=100,
                 abstol=1e-7, reltol=1e-6, feastol=1e-7, refinement=1):
    """min 1/2 x'Px + q'x  s.t. Gx + s = h, s in R^l_+ x SOC(q), Ax = b;
    dims is a {'l', 'q'} dict.  Returns dict(x, y, s, z, status,
    iterations, gap, pres, dres, pcost), as `coneqp_np_cones` (and
    pcost)."""
    dims = _Dims(dims.get("l", 0), dims.get("q", ()), dims.get("s", ()))
    nrm = torch.linalg.vector_norm
    n = q.shape[0]
    if A is None:
        A = q.new_zeros((0, n))
        b = q.new_zeros(0)
    p = A.shape[0]
    e = _identity(dims, q)

    resx0 = max(1.0, float(nrm(q)))
    resy0 = max(1.0, float(nrm(b)))
    resz0 = max(1.0, float(nrm(h)))

    def factor(W):
        Gs = _scale(G.T, W, dims, inverse="I").T
        cS = _chol(P + Gs.T @ Gs)
        if p:
            SiAT = torch.cholesky_solve(A.T, cS)
            cK = _chol(A @ SiAT)

        def solve(bx, by, bz):
            # [P A' G'; A 0 0; G 0 -W'W] [ux; uy; uz] = [bx; by; bz],
            # returning (ux, uy, W uz)
            zs = _scale(_scale(bz, W, dims, inverse="I"), W, dims,
                        inverse="I")
            t = _cs(cS, bx + G.T @ zs)
            if p:
                uy = _cs(cK, A @ t - by)
                ux = t - SiAT @ uy
            else:
                uy = by
                ux = t
            return ux, uy, _scale(G @ ux - bz, W, dims, inverse="I")

        return solve

    # initial point: the identity scaling
    Wid = {"d": q.new_ones(dims.l), "beta": [], "v": []}
    for _, cnt, m in dims.q_runs:
        Wid["beta"].append(q.new_ones(cnt))
        v = q.new_zeros((cnt, m))
        v[:, 0] = 1.0
        Wid["v"].append(v)
    x, y, z = factor(Wid)(-q, b, h)
    s = -z
    ts = _max_step(s, dims)
    if ts >= -1e-8 * max(1.0, float(nrm(s))):
        s = s + (1.0 + ts) * e
    tz = _max_step(z, dims)
    if tz >= -1e-8 * max(1.0, float(nrm(z))):
        z = z + (1.0 + tz) * e

    W, lmbda = _compute_scaling(s, z, dims)
    gap = float(s @ z)
    pres = dres = pcost = float("nan")

    def out(status, iters):
        return dict(x=x, y=y, s=s, z=z, status=status, iterations=iters,
                    gap=gap, pres=pres, dres=dres, pcost=pcost)

    for iters in range(maxiters + 1):
        Px = P @ x
        rx = Px + q + A.T @ y + G.T @ z
        ry = A @ x - b
        rz = s + G @ x - h
        pcost = 0.5 * float(x @ Px) + float(q @ x)
        dcost = pcost + float(y @ ry) + float(z @ rz) - gap
        relgap = gap / -pcost if pcost < 0 else (
            gap / dcost if dcost > 0 else float("inf"))
        pres = max(float(nrm(ry)) / resy0, float(nrm(rz)) / resz0)
        dres = float(nrm(rx)) / resx0
        if (pres <= feastol and dres <= feastol
                and (gap <= abstol or relgap <= reltol)):
            return out("optimal", iters)
        if iters == maxiters:
            return out("unknown", iters)

        try:
            f3 = factor(W)
        except _Singular:
            return out("unknown", iters)
        lsq = _sprod(lmbda, lmbda, dims)
        mu = gap / dims.cdim

        def f4_no_ir(bx, by_, bz, bs):
            us = _sinv(bs, lmbda, dims)
            ux, uy, uz = f3(bx, by_, bz - _scale(us, W, dims))
            return ux, uy, uz, us - uz

        def f4(bx, by_, bz, bs):
            u = f4_no_ir(bx, by_, bz, bs)
            for _ in range(refinement):
                ux, uy, uz, us = u
                wz3 = _scale(uz, W, dims, inverse="I")
                vx = bx - P @ ux - A.T @ uy - G.T @ wz3
                vy = by_ - A @ ux
                vz = bz - G @ ux - _scale(us, W, dims)
                vs = bs - _sprod(lmbda, us + uz, dims)
                du = f4_no_ir(vx, vy, vz, vs)
                u = tuple(a + d for a, d in zip(u, du))
            return u

        # predictor
        dx, dy, dz, ds = f4(-rx, -ry, -rz, -lsq)
        dsdz = float(ds @ dz)
        ws3 = _sprod(ds, dz, dims)
        t = max(_max_step(_scale2(lmbda, ds, dims), dims),
                _max_step(_scale2(lmbda, dz, dims), dims), 0.0)
        step = 1.0 if t == 0 else min(1.0, 1.0 / t)
        sigma = min(1.0, max(0.0,
                             1.0 - step + dsdz / gap * step ** 2)) ** 3

        # corrector
        dx, dy, dz, ds = f4(-rx, -ry, -rz, -lsq + sigma * mu * e - ws3)
        ds_sc = _scale2(lmbda, ds, dims)
        dz_sc = _scale2(lmbda, dz, dims)
        t = max(_max_step(ds_sc, dims), _max_step(dz_sc, dims), 0.0)
        step = 1.0 if t == 0 else min(1.0, 0.99 / t)

        x = x + step * dx
        y = y + step * dy
        ds2 = _scale2(lmbda, e + step * ds_sc, dims, inverse="I")
        dz2 = _scale2(lmbda, e + step * dz_sc, dims, inverse="I")
        W, lmbda = _update_scaling(W, lmbda, ds2, dz2, dims)
        s = _scale(lmbda, W, dims)
        z = _scale(lmbda, W, dims, inverse="I")
        gap = float(lmbda @ lmbda)

    return out("unknown", maxiters)
