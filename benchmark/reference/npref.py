# Frozen copy of cvxopt_tpu/_npref.py as of commit e5ea5715ebb2 (the file
# last changed in 3687c154232e; the JAX package's numpy reference
# solver), copied unchanged below this
# header so that the benchmark reads nothing of either package.  Only
# numpy and scipy are imported.  It is the base of the scenario cells'
# reference; `qp_torch.py` transcribes its `coneqp_np` iteration.

"""Single-core numpy reference QP solver (nonnegative-orthant cone).

Serves two roles (mirrors the reference's dual Python/C kernel pattern,
misc.py:25-28, where the pure-Python fallbacks define semantics):

  1. golden cross-check for the JAX solvers in tests (same algorithm,
     independent implementation and arithmetic);
  2. the single-core CPU baseline in bench.py — CVXOPT's hot path is
     LAPACK potrf/potrs driven from interpreted Python, which is
     exactly what this is (scipy.linalg wraps the same LAPACK).

Algorithm: the reference coneqp specialized to dims = {'l': m}
(/root/reference/src/python/coneprog.py:1440-2547): infeasible-start
Mehrotra predictor-corrector, NT scaling W = sqrt(s/z), kkt_chol2-style
normal-equations factorization with a Schur complement for equalities
(misc.py:1352).
"""

from __future__ import annotations

import numpy as np
import scipy.linalg as sla


def coneqp_np(P, q, G, h, A=None, b=None, maxiters=100, abstol=1e-7,
              reltol=1e-6, feastol=1e-7):
    """Solve min 1/2 x'Px + q'x  s.t. Gx + s = h, s >= 0, Ax = b.

    Returns dict(x, y, s, z, status, iterations, gap)."""
    n = q.shape[0]
    m = G.shape[0]
    if A is None:
        A = np.zeros((0, n))
        b = np.zeros(0)
    p = A.shape[0]

    resx0 = max(1.0, np.linalg.norm(q))
    resy0 = max(1.0, np.linalg.norm(b))
    resz0 = max(1.0, np.linalg.norm(h))

    def factor(d):
        # W = diag(d); S = P + G' W^{-2} G;  K = A S^{-1} A'
        D = 1.0 / (d * d)
        S = P + (G.T * D) @ G
        cS = sla.cho_factor(S, lower=True)
        if p:
            SiAT = sla.cho_solve(cS, A.T)
            cK = sla.cho_factor(A @ SiAT, lower=True)
        else:
            cK = None

        def solve(bx, by, bz):
            # solves [P A' G'; A 0 0; G 0 -W'W][ux,uy,uz] = [bx,by,bz],
            # returning (ux, uy, W uz)
            r = bx + G.T @ (D * bz)
            if p:
                uy = sla.cho_solve(cK, A @ sla.cho_solve(cS, r) - by)
                ux = sla.cho_solve(cS, r - A.T @ uy)
            else:
                uy = by
                ux = sla.cho_solve(cS, r)
            uz = (G @ ux - bz) / d
            return ux, uy, uz

        return solve

    # initial point (coneprog.py:2044-2106)
    f = factor(np.ones(m))
    x, y, z = f(-q, b, h)
    s = -z
    ts = -s.min() if m else 0.0
    if ts >= -1e-8 * max(1.0, np.linalg.norm(s)):
        s += 1.0 + ts
    tz = -z.min() if m else 0.0
    if tz >= -1e-8 * max(1.0, np.linalg.norm(z)):
        z += 1.0 + tz

    lmbda = np.sqrt(s * z)
    W = np.sqrt(s / z)
    gap = s @ z

    for iters in range(maxiters + 1):
        Px = P @ x
        rx = Px + q + A.T @ y + G.T @ z
        ry = A @ x - b
        rz = s + G @ x - h
        pcost = 0.5 * x @ Px + q @ x
        dcost = pcost + y @ ry + z @ rz - gap
        relgap = gap / -pcost if pcost < 0 else (
            gap / dcost if dcost > 0 else np.inf)
        pres = max(np.linalg.norm(ry) / resy0,
                   np.linalg.norm(rz) / resz0)
        dres = np.linalg.norm(rx) / resx0
        if (pres <= feastol and dres <= feastol
                and (gap <= abstol or relgap <= reltol)):
            return dict(x=x, y=y, s=s, z=z, status="optimal",
                        iterations=iters, gap=gap)
        if iters == maxiters:
            return dict(x=x, y=y, s=s, z=z, status="unknown",
                        iterations=iters, gap=gap)

        f3 = factor(W)
        lsq = lmbda * lmbda
        mu = gap / m

        def f4(bx, by, bz, bs):
            us = bs / lmbda
            uz = bz - W * us
            ux, uy, uz = f3(bx, by, uz)
            return ux, uy, uz, us - uz

        # predictor
        dx, dy, dz, ds = f4(-rx, -ry, -rz, -lsq)
        dsdz = ds @ dz
        ws3 = ds * dz
        ds_l = ds / lmbda
        dz_l = dz / lmbda
        t = max(0.0, -ds_l.min() if m else 0.0,
                -dz_l.min() if m else 0.0)
        step = 1.0 if t == 0 else min(1.0, 1.0 / t)
        sigma = min(1.0, max(0.0,
                             1.0 - step + dsdz / gap * step ** 2)) ** 3

        # corrector
        dx, dy, dz, ds = f4(-rx, -ry, -rz, -lsq - ws3 + sigma * mu)
        ds_l = ds / lmbda
        dz_l = dz / lmbda
        t = max(0.0, -ds_l.min() if m else 0.0,
                -dz_l.min() if m else 0.0)
        step = 1.0 if t == 0 else min(1.0, 0.99 / t)

        x += step * dx
        y += step * dy
        dsw = lmbda * (1.0 + step * ds_l)   # updated scaled s
        dzw = lmbda * (1.0 + step * dz_l)
        lmbda = np.sqrt(dsw * dzw)
        W *= np.sqrt(dsw / dzw)
        s = W * lmbda
        z = lmbda / W
        gap = lmbda @ lmbda

    return dict(x=x, y=y, s=s, z=z, status="unknown",
                iterations=maxiters, gap=gap)


# ---------------------------------------------------------------------------
# General-cone reference (dims with 'l', 'q', 's') — the single-core
# baseline for the SOCP/SDP benchmark configs and the golden twin for
# the JAX q/s-cone paths.  Same role as `coneqp_np` above: the
# reference coneqp algorithm (coneprog.py:1440-2547) with NT scaling
# over the full symmetric cone (misc.py:250-634), driven from
# interpreted Python over numpy/LAPACK.  Runs of equal-size cone
# blocks are processed as stacked (count, m) / (count, m, m) numpy
# batches — the vectorized analogue of the reference's C cone kernels
# (misc_solvers.c), so the baseline's per-iteration overhead is at
# least as low as CVXOPT's; 's' blocks are stored fully symmetric.


class _NpDims:
    def __init__(self, l=0, q=(), s=()):
        import itertools
        self.l = int(l)
        self.q = [int(m) for m in q]
        self.s = [int(m) for m in s]
        self.qdim = sum(self.q)
        self.sdim = sum(m * m for m in self.s)
        self.cdim = self.l + self.qdim + self.sdim
        self.cdim_diag = self.l + self.qdim + sum(self.s)
        self.q_runs = []                     # (offset, count, m)
        off = self.l
        for m, grp in itertools.groupby(self.q):
            cnt = len(list(grp))
            self.q_runs.append((off, cnt, m))
            off += cnt * m
        self.s_runs = []                     # (off, diag_off, count, m)
        doff = self.l + self.qdim
        for m, grp in itertools.groupby(self.s):
            cnt = len(list(grp))
            self.s_runs.append((off, doff, cnt, m))
            off += cnt * m * m
            doff += cnt * m


def _qv(x, run):
    """(..., cnt, m) view of a q-run; broadcasts over leading axes."""
    off, cnt, m = run
    return x[..., off:off + cnt * m].reshape(x.shape[:-1] + (cnt, m))


def _sV(x, run):
    off, _, cnt, m = run
    return x[..., off:off + cnt * m * m].reshape(
        x.shape[:-1] + (cnt, m, m))


def _sdg(lmbda, run):
    _, doff, cnt, m = run
    return lmbda[..., doff:doff + cnt * m].reshape(
        lmbda.shape[:-1] + (cnt, m))


def _put(out, off, length, val):
    out[..., off:off + length] = val.reshape(out[..., off:off
                                                 + length].shape)


def _jdot(u, v):
    return u[..., 0] * v[..., 0] - np.sum(u[..., 1:] * v[..., 1:], -1)


def _jnrm2(u):
    a = np.linalg.norm(u[..., 1:], axis=-1)
    return np.sqrt(np.maximum(u[..., 0] - a, 0.0)) * \
        np.sqrt(np.maximum(u[..., 0] + a, 0.0))


def _np_identity(dims):
    e = np.zeros(dims.cdim)
    e[:dims.l] = 1.0
    for off, cnt, m in dims.q_runs:
        e[off:off + cnt * m:m] = 1.0
    for off, _, cnt, m in dims.s_runs:
        blk = np.zeros((cnt, m, m))
        blk[:, np.arange(m), np.arange(m)] = 1.0
        e[off:off + cnt * m * m] = blk.reshape(-1)
    return e


def _np_max_step(x, dims):
    ts = [0.0]
    if dims.l:
        ts.append(-x[:dims.l].min())
    for run in dims.q_runs:
        xk = _qv(x, run)
        ts.append((np.linalg.norm(xk[..., 1:], axis=-1)
                   - xk[..., 0]).max())
    for run in dims.s_runs:
        ts.append(-np.linalg.eigvalsh(_sV(x, run))[..., 0].min())
    return max(ts)


def _np_scale(x, W, dims, trans="N", inverse="N"):
    """NT scaling application (misc.py:30-164); broadcasts over
    leading axes of x (used for matrices via x = M.T)."""
    out = x.copy()
    if dims.l:
        d = W["d"] if inverse == "N" else 1.0 / W["d"]
        out[..., :dims.l] = x[..., :dims.l] * d
    for i, run in enumerate(dims.q_runs):
        off, cnt, m = run
        v, beta = W["v"][i], W["beta"][i]       # (cnt, m), (cnt,)
        xk = _qv(x, run)
        if inverse == "N":
            w = np.sum(v * xk, -1, keepdims=True)
            Jx = np.concatenate([xk[..., :1], -xk[..., 1:]], -1)
            new = beta[:, None] * (2.0 * v * w - Jx)
        else:
            t = _jdot(v, xk)[..., None]
            y = 2.0 * v * t - xk
            Jy = np.concatenate([y[..., :1], -y[..., 1:]], -1)
            new = Jy / beta[:, None]
        _put(out, off, cnt * m, new)
    for i, run in enumerate(dims.s_runs):
        off, _, cnt, m = run
        X = _sV(x, run)
        if inverse == "N":
            r = W["r"][i]                        # (cnt, m, m)
            new = (np.swapaxes(r, -1, -2) @ X @ r if trans == "N"
                   else r @ X @ np.swapaxes(r, -1, -2))
        else:
            rti = W["rti"][i]
            new = (rti @ X @ np.swapaxes(rti, -1, -2) if trans == "N"
                   else np.swapaxes(rti, -1, -2) @ X @ rti)
        _put(out, off, cnt * m * m, new)
    return out


def _np_scale2(lmbda, x, dims, inverse="N"):
    out = x.copy()
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
            new = np.concatenate(
                [lx, xk[..., 1:] - c * lbar[..., 1:]], -1) / a
        else:
            lx = np.sum(lbar * xk, -1, keepdims=True)
            c = (lx + xk[..., :1]) / (lbar[..., :1] + 1.0)
            new = np.concatenate(
                [lx, xk[..., 1:] + c * lbar[..., 1:]], -1) * a
        _put(out, off, cnt * m, new)
    for run in dims.s_runs:
        off, _, cnt, m = run
        lk = _sdg(lmbda, run)
        f = np.sqrt(lk[:, :, None] * lk[:, None, :])
        X = _sV(x, run)
        _put(out, off, cnt * m * m, X / f if inverse == "N" else X * f)
    return out


def _np_compute_scaling(s, z, dims):
    W = {"d": np.sqrt(s[:dims.l] / z[:dims.l]),
         "beta": [], "v": [], "r": [], "rti": []}
    lmbda = np.zeros(dims.cdim_diag)
    lmbda[:dims.l] = np.sqrt(s[:dims.l] * z[:dims.l])
    for run in dims.q_runs:
        off, cnt, m = run
        sk, zk = _qv(s, run), _qv(z, run)
        aa = _jnrm2(sk)[:, None]
        bb = _jnrm2(zk)[:, None]
        W["beta"].append(np.sqrt(aa / bb)[:, 0])
        sz = np.sum(sk * zk, -1, keepdims=True)
        cc = np.sqrt((sz / (aa * bb) + 1.0) / 2.0)
        sbar, zbar = sk / aa, zk / bb
        Jz = np.concatenate([zbar[..., :1], -zbar[..., 1:]], -1)
        v = (sbar + Jz) / (2.0 * cc)
        v[:, 0] += 1.0
        v = v / np.sqrt(2.0 * v[:, :1])
        W["v"].append(v)
        dd = 2.0 * cc + sbar[..., :1] + zbar[..., :1]
        l1 = ((cc + zbar[..., :1]) / dd) * sbar[..., 1:] + \
             ((cc + sbar[..., :1]) / dd) * zbar[..., 1:]
        lmbda[off:off + cnt * m] = (np.concatenate([cc, l1], -1)
                                    * np.sqrt(aa * bb)).reshape(-1)
    for run in dims.s_runs:
        _, doff, cnt, m = run
        Sk, Zk = _sV(s, run), _sV(z, run)
        Ls = np.linalg.cholesky(Sk)
        Lz = np.linalg.cholesky(Zk)
        U_, lam, Vt = np.linalg.svd(np.swapaxes(Lz, -1, -2) @ Ls)
        V = np.swapaxes(Vt, -1, -2)
        r = (Ls @ V) / np.sqrt(lam)[:, None, :]
        rti = np.linalg.solve(
            np.swapaxes(Ls, -1, -2), V) * np.sqrt(lam)[:, None, :]
        W["r"].append(r)
        W["rti"].append(rti)
        lmbda[doff:doff + cnt * m] = lam.reshape(-1)
    return W, lmbda


def _np_update_scaling(W, lmbda, s, z, dims):
    """NT update (misc.py:422-634 semantics): 'l'/'q' parts of s, z are
    new iterates in the current scaling; 's' parts are square factors
    (see cvxopt_tpu.scaling.update_scaling)."""
    lnew = lmbda.copy()
    if dims.l:
        rs, rz = np.sqrt(s[:dims.l]), np.sqrt(z[:dims.l])
        W["d"] = W["d"] * rs / rz
        lnew[:dims.l] = rs * rz
    for i, run in enumerate(dims.q_runs):
        off, cnt, m = run
        v, beta = W["v"][i], W["beta"][i]
        sk, zk = _qv(s, run), _qv(z, run)
        aa = _jnrm2(sk)[:, None]
        bb = _jnrm2(zk)[:, None]
        sbar, zbar = sk / aa, zk / bb
        cc = np.sqrt((1.0 + np.sum(sbar * zbar, -1, keepdims=True))
                     / 2.0)
        vs = np.sum(v * sbar, -1, keepdims=True)
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
        lnew[off:off + cnt * m] = (np.concatenate([cc, l1], -1)
                                   * np.sqrt(aa * bb)).reshape(-1)
        Jsbar = np.concatenate([sbar[:, :1], -sbar[:, 1:]], -1)
        vn = 2.0 * vq * v - (Jsbar + zbar) / (2.0 * cc)
        vn[:, 0] += 1.0
        vn = vn / np.sqrt(2.0 * vn[:, :1])
        W["v"][i] = vn
        W["beta"][i] = beta * np.sqrt(aa / bb)[:, 0]
    for i, run in enumerate(dims.s_runs):
        _, doff, cnt, m = run
        Ls, Lz = _sV(s, run), _sV(z, run)
        U_, lam, Vt = np.linalg.svd(np.swapaxes(Lz, -1, -2) @ Ls)
        V = np.swapaxes(Vt, -1, -2)
        isq = 1.0 / np.sqrt(lam)
        W["r"][i] = (W["r"][i] @ (Ls @ V)) * isq[:, None, :]
        W["rti"][i] = (W["rti"][i] @ (Lz @ U_)) * isq[:, None, :]
        lnew[doff:doff + cnt * m] = lam.reshape(-1)
    return W, lnew


def _np_sinv(bs, lmbda, dims):
    out = bs.copy()
    if dims.l:
        out[:dims.l] = bs[:dims.l] / lmbda[:dims.l]
    for run in dims.q_runs:
        off, cnt, m = run
        xk = _qv(bs, run)
        lk = lmbda[off:off + cnt * m].reshape(cnt, m)
        aa = _jdot(lk, lk)[:, None]
        l0 = lk[:, :1]
        cc = xk[:, :1]
        dd = np.sum(lk[:, 1:] * xk[:, 1:], -1, keepdims=True)
        new = np.concatenate(
            [cc * l0 - dd,
             (aa / l0) * xk[:, 1:] + (dd / l0 - cc) * lk[:, 1:]],
            -1) / aa
        _put(out, off, cnt * m, new)
    for run in dims.s_runs:
        off, _, cnt, m = run
        lk = _sdg(lmbda, run)
        gam = 0.5 * (lk[:, :, None] + lk[:, None, :])
        _put(out, off, cnt * m * m, _sV(bs, run) / gam)
    return out


def _np_sprod(x, y, dims):
    out = x * y
    for run in dims.q_runs:
        off, cnt, m = run
        xk, yk = _qv(x, run), _qv(y, run)
        new = np.concatenate(
            [np.sum(xk * yk, -1, keepdims=True),
             yk[:, :1] * xk[:, 1:] + xk[:, :1] * yk[:, 1:]], -1)
        _put(out, off, cnt * m, new)
    for run in dims.s_runs:
        off, _, cnt, m = run
        X, Y = _sV(x, run), _sV(y, run)
        _put(out, off, cnt * m * m, 0.5 * (X @ Y + Y @ X))
    return out


def _np_sprod_diag(lmbda, x, dims):
    """lmbda o x with diagonal-storage lmbda (misc.py:878, diag='D')."""
    out = x.copy()
    nlq = dims.l + dims.qdim
    out[:dims.l] = x[:dims.l] * lmbda[:dims.l]
    for run in dims.q_runs:
        off, cnt, m = run
        xk = _qv(x, run)
        lk = lmbda[off:off + cnt * m].reshape(cnt, m)
        new = np.concatenate(
            [np.sum(xk * lk, -1, keepdims=True),
             lk[:, :1] * xk[:, 1:] + xk[:, :1] * lk[:, 1:]], -1)
        _put(out, off, cnt * m, new)
    for run in dims.s_runs:
        off, _, cnt, m = run
        lk = _sdg(lmbda, run)
        gam = 0.5 * (lk[:, :, None] + lk[:, None, :])
        _put(out, off, cnt * m * m, _sV(x, run) * gam)
    return out


def _np_ssqr_full(lmbda, dims):
    """lmbda o lmbda expanded to FULL (cdim) storage."""
    out = np.zeros(dims.cdim)
    out[:dims.l] = lmbda[:dims.l] ** 2
    for run in dims.q_runs:
        off, cnt, m = run
        lk = lmbda[off:off + cnt * m].reshape(cnt, m)
        new = np.concatenate(
            [np.sum(lk * lk, -1, keepdims=True),
             2.0 * lk[:, :1] * lk[:, 1:]], -1)
        _put(out, off, cnt * m, new)
    for run in dims.s_runs:
        off, _, cnt, m = run
        lk = _sdg(lmbda, run)
        blk = np.zeros((cnt, m, m))
        blk[:, np.arange(m), np.arange(m)] = lk ** 2
        _put(out, off, cnt * m * m, blk)
    return out


def _np_diag_embed(lmbda, dims):
    out = np.zeros(dims.cdim)
    nq = dims.l + dims.qdim
    out[:nq] = lmbda[:nq]
    for run in dims.s_runs:
        off, _, cnt, m = run
        lk = _sdg(lmbda, run)
        blk = np.zeros((cnt, m, m))
        blk[:, np.arange(m), np.arange(m)] = lk
        _put(out, off, cnt * m * m, blk)
    return out


def coneqp_np_cones(P, q, G, h, dims, A=None, b=None, maxiters=100,
                    abstol=1e-7, reltol=1e-6, feastol=1e-7,
                    refinement=1):
    """General-cone coneqp: min 1/2 x'Px + q'x s.t. Gx + s = h,
    s in K = R^l_+ x SOC(q) x PSD(s), Ax = b.  dims is a
    {'l','q','s'} dict.  Returns dict(x, y, s, z, status, iterations,
    gap, pres, dres)."""
    dims = _NpDims(dims.get("l", 0), dims.get("q", ()),
                   dims.get("s", ()))
    n = q.shape[0]
    if A is None:
        A = np.zeros((0, n))
        b = np.zeros(0)
    p = A.shape[0]
    e = _np_identity(dims)

    resx0 = max(1.0, np.linalg.norm(q))
    resy0 = max(1.0, np.linalg.norm(b))
    resz0 = max(1.0, np.linalg.norm(h))

    def factor(W):
        Gs = _np_scale(G.T, W, dims, trans="T", inverse="I").T
        S = P + Gs.T @ Gs
        cS = sla.cho_factor(S, lower=True)
        if p:
            SiAT = sla.cho_solve(cS, A.T)
            cK = sla.cho_factor(A @ SiAT, lower=True)

        def solve(bx, by, bz):
            zs = _np_scale(_np_scale(bz, W, dims, trans="T",
                                     inverse="I"), W, dims,
                           inverse="I")
            r = bx + G.T @ zs
            t = sla.cho_solve(cS, r)
            if p:
                uy = sla.cho_solve(cK, A @ t - by)
                ux = t - SiAT @ uy
            else:
                uy = by
                ux = t
            Wuz = _np_scale(G @ ux - bz, W, dims, trans="T",
                            inverse="I")
            return ux, uy, Wuz

        return solve

    # initial point (identity scaling)
    Wid = {"d": np.ones(dims.l), "beta": [], "v": [], "r": [],
           "rti": []}
    for _, cnt, m in dims.q_runs:
        Wid["beta"].append(np.ones(cnt))
        v = np.zeros((cnt, m))
        v[:, 0] = 1.0
        Wid["v"].append(v)
    for _, _, cnt, m in dims.s_runs:
        Wid["r"].append(np.broadcast_to(np.eye(m), (cnt, m, m)).copy())
        Wid["rti"].append(np.broadcast_to(np.eye(m),
                                          (cnt, m, m)).copy())
    f0 = factor(Wid)
    x, y, z = f0(-q, b, h)
    s = -z
    ts = _np_max_step(s, dims)
    if ts >= -1e-8 * max(1.0, np.linalg.norm(s)):
        s = s + (1.0 + ts) * e
    tz = _np_max_step(z, dims)
    if tz >= -1e-8 * max(1.0, np.linalg.norm(z)):
        z = z + (1.0 + tz) * e

    W, lmbda = _np_compute_scaling(s, z, dims)
    gap = float(np.dot(s, z))
    nlq = dims.l + dims.qdim

    for iters in range(maxiters + 1):
        Px = P @ x
        rx = Px + q + A.T @ y + G.T @ z
        ry = A @ x - b
        rz = s + G @ x - h
        pcost = 0.5 * float(x @ Px) + float(q @ x)
        dcost = pcost + float(y @ ry) + float(z @ rz) - gap
        relgap = gap / -pcost if pcost < 0 else (
            gap / dcost if dcost > 0 else np.inf)
        pres = max(np.linalg.norm(ry) / resy0,
                   np.linalg.norm(rz) / resz0)
        dres = np.linalg.norm(rx) / resx0
        if (pres <= feastol and dres <= feastol
                and (gap <= abstol or relgap <= reltol)):
            return dict(x=x, y=y, s=s, z=z, status="optimal",
                        iterations=iters, gap=gap, pres=pres,
                        dres=dres)
        if iters == maxiters:
            return dict(x=x, y=y, s=s, z=z, status="unknown",
                        iterations=iters, gap=gap, pres=pres,
                        dres=dres)

        f3 = factor(W)
        lsq_full = _np_ssqr_full(lmbda, dims)
        mu = gap / dims.cdim_diag

        def f4_no_ir(bx, by_, bz, bs):
            us = _np_sinv(bs, lmbda, dims)
            uz = bz - _np_scale(us, W, dims, trans="T")
            ux, uy, uz = f3(bx, by_, uz)
            return ux, uy, uz, us - uz

        def f4(bx, by_, bz, bs):
            u = f4_no_ir(bx, by_, bz, bs)
            for _ in range(refinement):
                ux, uy, uz, us = u
                wz3 = _np_scale(uz, W, dims, inverse="I")
                vx = bx - P @ ux - A.T @ uy - G.T @ wz3
                vy = by_ - A @ ux
                vz = bz - G @ ux - _np_scale(us, W, dims, trans="T")
                vs = bs - _np_sprod_diag(lmbda, us + uz, dims)
                du = f4_no_ir(vx, vy, vz, vs)
                u = tuple(a + d for a, d in zip(u, du))
            return u

        # predictor
        dx, dy, dz, ds = f4(-rx, -ry, -rz, -lsq_full)
        dsdz = float(np.dot(ds, dz))
        ws3 = _np_sprod(ds, dz, dims)
        ds_sc = _np_scale2(lmbda, ds, dims)
        dz_sc = _np_scale2(lmbda, dz, dims)
        t = max(_np_max_step(ds_sc, dims), _np_max_step(dz_sc, dims),
                0.0)
        step = 1.0 if t == 0 else min(1.0, 1.0 / t)
        sigma = min(1.0, max(0.0,
                             1.0 - step + dsdz / gap * step ** 2)) ** 3

        # corrector
        dx, dy, dz, ds = f4(-rx, -ry, -rz,
                            -lsq_full + sigma * mu * e - ws3)
        ds_sc = _np_scale2(lmbda, ds, dims)
        dz_sc = _np_scale2(lmbda, dz, dims)
        # eigendecompose the 's' blocks for the scaling update
        sigs, sigz = [], []
        for run in dims.s_runs:
            off, _, cnt, m = run
            w_, V_ = np.linalg.eigh(_sV(ds_sc, run))
            sigs.append(w_)
            _put(ds_sc, off, cnt * m * m, V_)
            w_, V_ = np.linalg.eigh(_sV(dz_sc, run))
            sigz.append(w_)
            _put(dz_sc, off, cnt * m * m, V_)
        tcands = [0.0]
        if dims.l:
            tcands.append(-ds_sc[:dims.l].min())
            tcands.append(-dz_sc[:dims.l].min())
        for run in dims.q_runs:
            for u in (ds_sc, dz_sc):
                xk = _qv(u, run)
                tcands.append((np.linalg.norm(xk[:, 1:], axis=-1)
                               - xk[:, 0]).max())
        for k in range(len(dims.s_runs)):
            tcands.append(-sigs[k][:, 0].min())
            tcands.append(-sigz[k][:, 0].min())
        t = max(tcands)
        step = 1.0 if t == 0 else min(1.0, 0.99 / t)

        x = x + step * dx
        y = y + step * dy

        ds2, dz2 = ds_sc.copy(), dz_sc.copy()
        ds2[:nlq] = e[:nlq] + step * ds_sc[:nlq]
        dz2[:nlq] = e[:nlq] + step * dz_sc[:nlq]
        ds2 = _np_scale2(lmbda, ds2, dims, inverse="I")
        dz2 = _np_scale2(lmbda, dz2, dims, inverse="I")
        for k, run in enumerate(dims.s_runs):
            off, _, cnt, m = run
            lk = _sdg(lmbda, run)
            cs = np.sqrt((1.0 + step * sigs[k]) / lk)
            cz = np.sqrt((1.0 + step * sigz[k]) / lk)
            _put(ds2, off, cnt * m * m,
                 _sV(ds2, run) * cs[:, None, :])
            _put(dz2, off, cnt * m * m,
                 _sV(dz2, run) * cz[:, None, :])
        W, lmbda = _np_update_scaling(W, lmbda, ds2, dz2, dims)
        lam_full = _np_diag_embed(lmbda, dims)
        s = _np_scale(lam_full, W, dims, trans="T")
        z = _np_scale(lam_full, W, dims, inverse="I")
        gap = float(np.dot(lmbda, lmbda))

    return dict(x=x, y=y, s=s, z=z, status="unknown",
                iterations=maxiters, gap=gap, pres=pres, dres=dres)
