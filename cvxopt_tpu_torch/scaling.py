"""Nesterov-Todd scaling for R^l_+ x SOC x PSD in PyTorch.

Twin of `cvxopt_tpu/scaling.py`:

  scale            W*x, W'*x, W^{-1}*x, W^{-T}*x
  scale2           H(lambda^{1/2})*x, H(lambda^{-1/2})*x
  compute_scaling  initial W with W*z = W^{-T}*s = lambda
  update_scaling   rank-preserving NT update
  update_args      update_scaling's arguments after a step
  unscale          s, z from lambda and W
  identity_scaling W = I

W is a dict: W['d'], W['di'] (..., l); W['dnl'], W['dnli'] (..., mnl)
when mnl > 0; W['beta'] a list over q-runs of (..., count) tensors,
W['v'] of (..., count, m); W['r'], W['rti'] lists over s-runs of
(..., count, m, m).  The leading axes of W are the batch.  A vector
operand x may carry extra axes between the batch axes and the cone
axis (`scale_rows` stacks the columns of a matrix there); W's entries
are lined up with x's leading batch axes.

The Gram eigendecompositions go through `ops/jacobi.py`
(`gram_eigh_accurate`, a float64 eigh).
"""

from __future__ import annotations

from typing import Dict, List

import torch

from cvxopt_tpu_torch._device import resolve_device
from cvxopt_tpu_torch.cones import (
    ConeDims, jdot, jnrm2, qview, sview, sdiagview, diag_embed, _flat,
    _bcast,
)
from cvxopt_tpu_torch.ops.jacobi import gram_eigh_accurate


def _cat(parts):
    """Concatenate per-block parts, broadcast to a common leading shape."""
    return torch.cat(_bcast(parts), dim=-1) if len(parts) > 1 else parts[0]

Tensor = torch.Tensor


def _al(w: Tensor, lead: int, tail: int) -> Tensor:
    """Line W entry `w` (batch axes + `tail` block axes) up with an
    operand that has `lead` leading axes, by inserting singleton axes
    after w's batch axes."""
    wb = w.dim() - tail
    extra = lead - wb
    if extra > 0 and wb > 0:
        w = w.reshape(w.shape[:wb] + (1,) * extra + w.shape[wb:])
    return w


def _floor_eigs(w: Tensor) -> Tensor:
    """Floor Gram eigenvalues away from <= 0 before 1/sqrt
    (scale-relative, with an absolute 1e-30 backstop)."""
    scale = torch.amax(torch.abs(w), dim=-1, keepdim=True)
    floor = torch.clamp(1e-28 * scale, min=1e-30)
    return torch.maximum(w, floor)


def _chol_nan(A: Tensor) -> Tensor:
    """Cholesky factor with NaN in place of a failed factorization."""
    L, info = torch.linalg.cholesky_ex(A)
    bad = (info != 0).reshape(info.shape + (1, 1))
    return torch.where(bad, torch.full_like(L, float("nan")), L)


def identity_scaling(dims: ConeDims, dtype=torch.float64, device="cuda",
                     batch=()) -> Dict:
    """W = identity, with leading batch shape `batch`."""
    batch = tuple(batch)
    kw = dict(dtype=dtype, device=resolve_device(device))
    W = {"d": torch.ones(batch + (dims.l,), **kw),
         "di": torch.ones(batch + (dims.l,), **kw),
         "beta": [], "v": [], "r": [], "rti": []}
    if dims.mnl:
        W["dnl"] = torch.ones(batch + (dims.mnl,), **kw)
        W["dnli"] = torch.ones(batch + (dims.mnl,), **kw)
    for (_, cnt, m) in dims.q_runs:
        W["beta"].append(torch.ones(batch + (cnt,), **kw))
        v = torch.zeros(batch + (cnt, m), **kw)
        v[..., 0] = 1.0
        W["v"].append(v)
    for (_, _, cnt, m) in dims.s_runs:
        eye = torch.eye(m, **kw).expand(batch + (cnt, m, m))
        W["r"].append(eye)
        W["rti"].append(eye)
    return W


def _dfull(W: Dict) -> Tensor:
    if "dnl" in W:
        return torch.cat([W["dnl"], W["d"]], dim=-1)
    return W["d"]


def _difull(W: Dict) -> Tensor:
    if "dnli" in W:
        return torch.cat([W["dnli"], W["di"]], dim=-1)
    return W["di"]


def scale(x: Tensor, W: Dict, dims: ConeDims, trans: str = "N",
          inverse: str = "N") -> Tensor:
    """x := W x ('N','N'), W' x ('T','N'), W^{-1} x ('N','I'),
    W^{-T} x ('T','I')."""
    parts = []
    nl = dims.lnl
    lead = x.dim() - 1
    if nl:
        d = _dfull(W) if inverse == "N" else _difull(W)
        parts.append(x[..., :nl] * _al(d, lead, 1))

    for i, run in enumerate(dims.q_runs):
        xk = qview(x, run)
        v = _al(W["v"][i], lead, 2)
        beta = _al(W["beta"][i][..., None], lead, 2)
        if inverse == "N":
            w = (v * xk).sum(-1, keepdim=True)
            Jx = torch.cat([xk[..., :1], -xk[..., 1:]], dim=-1)
            new = beta * (2.0 * v * w - Jx)
        else:
            t = jdot(v, xk)[..., None]
            y = 2.0 * v * t - xk
            Jy = torch.cat([y[..., :1], -y[..., 1:]], dim=-1)
            new = Jy / beta
        parts.append(_flat(new, 2))

    for i, run in enumerate(dims.s_runs):
        X = sview(x, run)
        if inverse == "N":
            r = _al(W["r"][i], lead, 3)
            rt = r.transpose(-1, -2)
            new = rt @ X @ r if trans == "N" else r @ X @ rt
        else:
            rti = _al(W["rti"][i], lead, 3)
            rtit = rti.transpose(-1, -2)
            new = rti @ X @ rtit if trans == "N" else rtit @ X @ rti
        parts.append(_flat(new, 3))
    return _cat(parts) if parts else x


def scale_w2inv(x: Tensor, W: Dict, dims: ConeDims) -> Tensor:
    """Fused x := W^{-1} W^{-T} x."""
    parts = []
    nl = dims.lnl
    lead = x.dim() - 1
    if nl:
        di = _al(_difull(W), lead, 1)
        parts.append(x[..., :nl] * (di * di))

    for i, run in enumerate(dims.q_runs):
        xk = qview(x, run)
        v = _al(W["v"][i], lead, 2)
        beta = _al(W["beta"][i][..., None], lead, 2)
        vJx = jdot(v, xk)[..., None]
        vx = (v * xk).sum(-1, keepdim=True)
        vv = (v * v).sum(-1, keepdim=True)
        a = 2.0 * vv * vJx - vx
        Jv = torch.cat([v[..., :1], -v[..., 1:]], dim=-1)
        new = (xk + 2.0 * Jv * a - 2.0 * v * vJx) / (beta * beta)
        parts.append(_flat(new, 2))

    for i, run in enumerate(dims.s_runs):
        X = sview(x, run)
        rti = _al(W["rti"][i], lead, 3)
        R2 = rti @ rti.transpose(-1, -2)
        parts.append(_flat(R2 @ X @ R2, 3))
    return _cat(parts) if parts else x


def scale_rows(M: Tensor, W: Dict, dims: ConeDims, trans: str = "N",
               inverse: str = "N") -> Tensor:
    """`scale` on every column of a (..., cdim, n) matrix."""
    return scale(M.transpose(-1, -2), W, dims, trans=trans,
                 inverse=inverse).transpose(-1, -2)


def scale2(lmbda: Tensor, x: Tensor, dims: ConeDims,
           inverse: str = "N") -> Tensor:
    """x := H(lambda^{1/2}) x ('N') or H(lambda^{-1/2}) x ('I'),
    lmbda in diagonal storage."""
    parts = []
    nl = dims.lnl
    lead = x.dim() - 1
    if nl:
        lm = _al(lmbda[..., :nl], lead, 1)
        parts.append(x[..., :nl] / lm if inverse == "N"
                     else x[..., :nl] * lm)

    for run in dims.q_runs:
        xk = qview(x, run)
        lk = _al(qview(lmbda, run), lead, 2)
        a = jnrm2(lk)[..., None]
        lbar = lk / a
        if inverse == "N":
            lx = jdot(lbar, xk)[..., None]
            c = (lx + xk[..., :1]) / (lbar[..., :1] + 1.0)
            new = torch.cat([lx, xk[..., 1:] - c * lbar[..., 1:]],
                            dim=-1) / a
        else:
            lx = (lbar * xk).sum(-1, keepdim=True)
            c = (lx + xk[..., :1]) / (lbar[..., :1] + 1.0)
            new = torch.cat([lx, xk[..., 1:] + c * lbar[..., 1:]],
                            dim=-1) * a
        parts.append(_flat(new, 2))

    for run in dims.s_runs:
        X = sview(x, run)
        lk = _al(sdiagview(lmbda, run), lead, 2)
        f = torch.sqrt(lk[..., :, None] * lk[..., None, :])
        parts.append(_flat(X / f if inverse == "N" else X * f, 3))
    return _cat(parts) if parts else x


def compute_scaling(s: Tensor, z: Tensor, dims: ConeDims):
    """Initial NT scaling: returns (W, lmbda), lmbda in diagonal
    storage (cdim_diag)."""
    W: Dict = {}
    lparts: List[Tensor] = []

    nl = dims.lnl
    sl, zl = s[..., :nl], z[..., :nl]
    d = torch.sqrt(sl / zl)
    if dims.mnl:
        W["dnl"] = d[..., :dims.mnl]
        W["dnli"] = 1.0 / W["dnl"]
        W["d"] = d[..., dims.mnl:]
    else:
        W["d"] = d
    W["di"] = 1.0 / W["d"]
    if nl:
        lparts.append(torch.sqrt(sl * zl))

    W["beta"], W["v"] = [], []
    for run in dims.q_runs:
        sk, zk = qview(s, run), qview(z, run)
        aa = jnrm2(sk)[..., None]
        bb = jnrm2(zk)[..., None]
        W["beta"].append(torch.sqrt(aa / bb)[..., 0])
        sz = (sk * zk).sum(-1, keepdim=True)
        cc = torch.sqrt((sz / (aa * bb) + 1.0) / 2.0)
        sbar, zbar = sk / aa, zk / bb
        Jzbar = torch.cat([zbar[..., :1], -zbar[..., 1:]], dim=-1)
        v = (sbar + Jzbar) / (2.0 * cc)
        v = torch.cat([v[..., :1] + 1.0, v[..., 1:]], dim=-1)
        v = v / torch.sqrt(2.0 * v[..., :1])
        W["v"].append(v)
        dd = 2.0 * cc + sbar[..., :1] + zbar[..., :1]
        l1 = ((cc + zbar[..., :1]) / dd) * sbar[..., 1:] + \
             ((cc + sbar[..., :1]) / dd) * zbar[..., 1:]
        lk = torch.cat([cc, l1], dim=-1) * torch.sqrt(aa * bb)
        lparts.append(_flat(lk, 2))

    W["r"], W["rti"] = [], []
    for run in dims.s_runs:
        sk, zk = sview(s, run), sview(z, run)
        Ls = _chol_nan(sk)
        Lz = _chol_nan(zk)
        M = Lz.transpose(-1, -2) @ Ls
        w, V = gram_eigh_accurate(M)
        lam = torch.sqrt(_floor_eigs(torch.flip(w, (-1,))))
        V = torch.flip(V, (-1,))
        r = (Ls @ V) / torch.sqrt(lam)[..., None, :]
        rti = torch.linalg.solve_triangular(
            Ls.transpose(-1, -2), V, upper=True) * \
            torch.sqrt(lam)[..., None, :]
        W["r"].append(r)
        W["rti"].append(rti)
        lparts.append(_flat(lam, 2))

    lmbda = (torch.cat(lparts, dim=-1) if lparts
             else s.new_zeros(s.shape[:-1] + (0,)))
    return W, lmbda


def update_args(lmbda: Tensor, dq, sig, step: Tensor, e: Tensor,
                dims: ConeDims):
    """The s and z arguments of `update_scaling` after a step of length
    `step` (per instance) along the scaled directions ds, dz, from the
    parts (sig, Qx) that `cones.max_step_eig` returns for them: `dq` is
    the pair (Qds, Qdz), `sig` the pair (sig_s, sig_z), each member
    stacked on a leading axis or a tuple (coneprog.py:1336-1436).  Their
    'l' and 'q' parts are e + step * d and their 's' parts the
    eigenvector matrices; each is scaled by H(lambda^{-1/2}), then
    column j of an 's' block by sqrt((1 + step sig_j) / lambda_j).  `e`
    is the cone's identity; returns (ds2, dz2)."""
    nlq = dims.lnl + dims.qdim
    col = step[..., None]
    out = []
    for d, sg in zip(dq, sig):
        d2 = torch.cat([e[:nlq] + col * d[..., :nlq], d[..., nlq:]], dim=-1)
        d2 = scale2(lmbda, d2, dims, inverse="I")
        if dims.s:
            f = (1.0 + col * sg) / lmbda[..., nlq:]
            lead = d2.shape[:-1]
            parts = [d2[..., :dims.offs]]
            for run in dims.s_runs:
                _, doff, cnt, m = run
                i0 = doff - nlq
                c = torch.sqrt(f[..., i0:i0 + cnt * m]).reshape(
                    lead + (cnt, m))
                parts.append((sview(d2, run) * c[..., None, :]).reshape(
                    lead + (-1,)))
            d2 = torch.cat(parts, dim=-1)
        out.append(d2)
    return tuple(out)


def unscale(lmbda: Tensor, W: Dict, dims: ConeDims):
    """(s, z) = (W' lambda, W^{-1} lambda), lmbda in diagonal storage
    (coneprog.py:1413-1433)."""
    lam = diag_embed(lmbda, dims)
    return scale(lam, W, dims, trans="T"), scale(lam, W, dims, inverse="I")


def update_scaling(W: Dict, lmbda: Tensor, s: Tensor, z: Tensor,
                   dims: ConeDims):
    """Rank-preserving NT scaling update.  On entry the 'l'/'q' parts
    of s, z hold the new iterates in the current scaling; the 's' parts
    hold square factors Ls, Lz.  Returns updated (W, lmbda)."""
    Wn = dict(W)
    lparts: List[Tensor] = []

    nl = dims.lnl
    if nl:
        rs = torch.sqrt(s[..., :nl])
        rz = torch.sqrt(z[..., :nl])
        dl = _dfull(W) * rs / rz
        if dims.mnl:
            Wn["dnl"] = dl[..., :dims.mnl]
            Wn["dnli"] = 1.0 / Wn["dnl"]
            Wn["d"] = dl[..., dims.mnl:]
        else:
            Wn["d"] = dl
        Wn["di"] = 1.0 / Wn["d"]
        lparts.append(rs * rz)

    Wn["beta"], Wn["v"] = [], []
    for i, run in enumerate(dims.q_runs):
        v, beta = W["v"][i], W["beta"][i]
        sk, zk = qview(s, run), qview(z, run)
        aa = jnrm2(sk)[..., None]
        bb = jnrm2(zk)[..., None]
        sbar, zbar = sk / aa, zk / bb
        cc = torch.sqrt((1.0 + (sbar * zbar).sum(-1, keepdim=True)) / 2.0)
        vs = (v * sbar).sum(-1, keepdim=True)
        vz = jdot(v, zbar)[..., None]
        vq = (vs + vz) / (2.0 * cc)
        vu = vs - vz
        w0 = 2.0 * v[..., :1] * vq - (sbar[..., :1] + zbar[..., :1]) / \
            (2.0 * cc)
        dd = (v[..., :1] * vu - sbar[..., :1] / 2.0 +
              zbar[..., :1] / 2.0) / (w0 + 1.0)
        l1 = v[..., 1:] * (2.0 * (-dd * vq + 0.5 * vu)) + \
            0.5 * (1.0 - dd / cc) * sbar[..., 1:] + \
            0.5 * (1.0 + dd / cc) * zbar[..., 1:]
        lk = torch.cat([cc, l1], dim=-1) * torch.sqrt(aa * bb)
        lparts.append(_flat(lk, 2))
        Jsbar = torch.cat([sbar[..., :1], -sbar[..., 1:]], dim=-1)
        vn = 2.0 * vq * v - (Jsbar + zbar) / (2.0 * cc)
        vn = torch.cat([vn[..., :1] + 1.0, vn[..., 1:]], dim=-1)
        vn = vn / torch.sqrt(2.0 * vn[..., :1])
        Wn["v"].append(vn)
        Wn["beta"].append(beta * torch.sqrt(aa / bb)[..., 0])

    Wn["r"], Wn["rti"] = [], []
    for i, run in enumerate(dims.s_runs):
        r, rti = W["r"][i], W["rti"][i]
        Ls, Lz = sview(s, run), sview(z, run)
        M = Lz.transpose(-1, -2) @ Ls
        w, V = gram_eigh_accurate(M)
        lam = torch.sqrt(_floor_eigs(torch.flip(w, (-1,))))
        V = torch.flip(V, (-1,))
        U = (M @ V) / lam[..., None, :]
        inv_sqrt = 1.0 / torch.sqrt(lam)
        Wn["r"].append((r @ (Ls @ V)) * inv_sqrt[..., None, :])
        Wn["rti"].append((rti @ (Lz @ U)) * inv_sqrt[..., None, :])
        lparts.append(_flat(lam, 2))
    lnew = _cat(lparts) if lparts else lmbda
    return Wn, lnew
