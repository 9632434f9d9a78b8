"""Plain PyTorch transcription of `npref.coneqp_np`: the reference coneqp
iteration for dims = {'l': m} (infeasible start, Mehrotra predictor and
corrector, NT scaling W = sqrt(s / z), normal equations with a Schur
complement for the equalities), one problem at a time.

It runs in the dtype of its inputs and on their device: in float32 with
TF32 off it is the dense cell's control, which the comparison has to
fail; in float64 it is held to the frozen copy on the CPU.  Imports torch
only.  A factor that is not positive definite ends the solve with status
'unknown' at the current iterate, as CVXOPT does on a singular KKT
system.
"""

from __future__ import annotations

import torch


class _Singular(Exception):
    pass


def _chol(S):
    L, info = torch.linalg.cholesky_ex(S)
    if int(info):
        raise _Singular
    return L


def _cs(L, v):
    return torch.cholesky_solve(v.unsqueeze(-1), L).squeeze(-1)


def coneqp_l(P, q, G, h, A, b, *, maxiters=100, abstol=1e-7, reltol=1e-6,
             feastol=1e-7):
    """min 1/2 x'Px + q'x  s.t. Gx + s = h, s >= 0, Ax = b.

    Returns dict(x, y, s, z, status, iterations, gap), as coneqp_np."""
    nrm = torch.linalg.vector_norm
    m = G.shape[0]
    p = A.shape[0]
    resx0 = max(1.0, float(nrm(q)))
    resy0 = max(1.0, float(nrm(b)))
    resz0 = max(1.0, float(nrm(h)))

    def factor(d):
        D = 1.0 / (d * d)
        S = P + (G.T * D) @ G
        cS = _chol(S)
        cK = _chol(A @ torch.cholesky_solve(A.T, cS)) if p else None

        def solve(bx, by, bz):
            r = bx + G.T @ (D * bz)
            if p:
                uy = _cs(cK, A @ _cs(cS, r) - by)
                ux = _cs(cS, r - A.T @ uy)
            else:
                uy = by
                ux = _cs(cS, r)
            return ux, uy, (G @ ux - bz) / d

        return solve

    f = factor(torch.ones_like(h))
    x, y, z = f(-q, b, h)
    s = -z
    ts = -float(s.min())
    if ts >= -1e-8 * max(1.0, float(nrm(s))):
        s = s + (1.0 + ts)
    tz = -float(z.min())
    if tz >= -1e-8 * max(1.0, float(nrm(z))):
        z = z + (1.0 + tz)
    lmbda = torch.sqrt(s * z)
    W = torch.sqrt(s / z)
    gap = float(s @ z)

    def out(status, iters):
        return dict(x=x, y=y, s=s, z=z, status=status, iterations=iters,
                    gap=gap)

    for iters in range(maxiters + 1):
        Px = P @ x
        rx = Px + q + A.T @ y + G.T @ z
        ry = A @ x - b
        rz = s + G @ x - h
        pcost = float(0.5 * (x @ Px) + q @ x)
        dcost = pcost + float(y @ ry + z @ rz) - gap
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
        lsq = lmbda * lmbda
        mu = gap / m

        def f4(bx, by, bz, bs):
            us = bs / lmbda
            ux, uy, uz = f3(bx, by, bz - W * us)
            return ux, uy, uz, us - uz

        def step_to(ds, dz, frac):
            t = max(0.0, -float((ds / lmbda).min()),
                    -float((dz / lmbda).min()))
            return 1.0 if t == 0 else min(1.0, frac / t)

        dx, dy, dz, ds = f4(-rx, -ry, -rz, -lsq)
        step = step_to(ds, dz, 1.0)
        sigma = min(1.0, max(0.0, 1.0 - step
                             + float(ds @ dz) / gap * step ** 2)) ** 3
        ws3 = ds * dz
        dx, dy, dz, ds = f4(-rx, -ry, -rz, -lsq - ws3 + sigma * mu)
        step = step_to(ds, dz, 0.99)
        x = x + step * dx
        y = y + step * dy
        dsw = lmbda * (1.0 + step * ds / lmbda)
        dzw = lmbda * (1.0 + step * dz / lmbda)
        lmbda = torch.sqrt(dsw * dzw)
        W = W * torch.sqrt(dsw / dzw)
        s = W * lmbda
        z = lmbda / W
        gap = float(lmbda @ lmbda)
    return out("unknown", maxiters)
