"""cvxopt.lapack equivalents, twin of `cvxopt_tpu/ops/lapack.py`: pure
functions on tensors, batched over leading axes.

  potrf/potrs/posv/potri  -> Cholesky (torch.linalg.cholesky + solves)
  getrf/getrs/gesv/getri  -> LU with partial pivoting; the factor
                             handle is torch's (LU, pivots)
  sytrf/sytrs/sysv        -> LU of the symmetrized matrix (as the JAX
                             module: same solution, no Bunch-Kaufman)
  geqrf/orgqr/ormqr/gels  -> QR (torch.linalg.qr / lstsq), handle (Q, R)
  geqp3                   -> column-pivoted Householder QR, one column
                             per step
  syev/syevd/syevr/syevx  -> torch.linalg.eigh
  gesvd/gesdd             -> torch.linalg.svd
  trtrs/trtri             -> triangular solves / inverse
  gees/gges               -> scipy's Schur / QZ on a host copy (the
                             reference's CPU LAPACK call), results
                             returned on the caller's device

Results lie on the device of the tensor arguments.  The banded and
tridiagonal routines come from `banded`.
"""

from __future__ import annotations

import numpy as np
import torch

from cvxopt_tpu_torch._device import tensors
from cvxopt_tpu_torch.ops.blas import _H, _solve_tri
from cvxopt_tpu_torch.ops.banded import (          # noqa: F401
    pbtrf, pbtrs, pbsv, pttrf, pttrs, ptsv,
    gtsv, gttrf, gttrs, tbtrs, gbsv, gbtrf, gbtrs, _lu_solve, _chol_nan,
)

__all__ = [
    "potrf", "potrs", "posv", "potri", "getrf", "getrs", "gesv",
    "getri", "sytrf", "sytrs", "sysv", "trtrs", "trtri", "geqrf",
    "orgqr", "ormqr", "sytri", "hetri", "ungqr", "unmqr", "ormlq",
    "unmlq", "gels", "gelqf", "geqp3", "larfg", "larfx",
    "syev", "syevd",
    "syevr", "syevx", "heev", "heevd", "sygv", "hegv", "gesvd",
    "gesdd", "gees", "gges", "lacpy",
    # banded / tridiagonal (ops/banded.py)
    "pbtrf", "pbtrs", "pbsv", "pttrf", "pttrs", "ptsv",
    "gtsv", "gttrf", "gttrs", "tbtrs", "gbsv", "gbtrf", "gbtrs",
]


def _eye_like(A):
    n = A.shape[-1]
    return torch.eye(n, dtype=A.dtype, device=A.device).expand(
        A.shape[:-2] + (n, n))


# ---- Cholesky ------------------------------------------------------------

def _symmetrize(A, uplo="L"):
    if uplo == "L":
        return torch.tril(A) + _H(torch.tril(A, -1))
    return torch.triu(A) + _H(torch.triu(A, 1))


def potrf(A, uplo="L"):
    """Cholesky factor (lower).  A NaN lower triangle where the matrix
    is not PD (the analogue of the reference's ArithmeticError, without
    a host sync)."""
    A, = tensors(A)
    return _chol_nan(_symmetrize(A, uplo))


def potrs(L, B, uplo="L"):
    L, B = tensors(L, B)
    return _solve_tri(_H(L), _solve_tri(L, B, upper=False), upper=True)


def posv(A, B, uplo="L"):
    L = potrf(A, uplo)
    return L, potrs(L, B)


def potri(L, uplo="L"):
    L, = tensors(L)
    return potrs(L, _eye_like(L))


# ---- LU ------------------------------------------------------------------

def getrf(A):
    A, = tensors(A)
    return torch.linalg.lu_factor(A)


def getrs(lu_piv, B, trans="N"):
    B, = tensors(B, device=lu_piv[0].device)
    return _lu_solve(lu_piv, B, trans)


def gesv(A, B):
    lu_piv = getrf(A)
    return lu_piv, getrs(lu_piv, B)


def getri(lu_piv):
    return getrs(lu_piv, _eye_like(lu_piv[0]))


# ---- symmetric indefinite ------------------------------------------------

def sytrf(A, uplo="L"):
    """Factor handle for sytrs: the LU of the symmetrized matrix."""
    A, = tensors(A)
    return getrf(_symmetrize(A, uplo))


def sytrs(f, B, uplo="L"):
    return getrs(f, B)


def sysv(A, B, uplo="L"):
    f = sytrf(A, uplo)
    return f, sytrs(f, B)


hetrf, hetrs, hesv = sytrf, sytrs, sysv


def sytri(f, uplo="L"):
    """Inverse from a sytrf handle (getri of the symmetrized LU)."""
    return getri(f)


hetri = sytri


# ---- triangular ----------------------------------------------------------

def trtrs(A, B, uplo="L", trans="N", diag="N"):
    A, B = tensors(A, B)
    T = torch.tril(A) if uplo == "L" else torch.triu(A)
    if diag == "U":
        T = T.clone()
        torch.diagonal(T, dim1=-2, dim2=-1).fill_(1.0)
    if trans != "N":
        T = _H(T) if trans == "C" else T.transpose(-1, -2)
        return _solve_tri(T, B, upper=(uplo == "L"))
    return _solve_tri(T, B, upper=(uplo != "L"))


def trtri(A, uplo="L", diag="N"):
    A, = tensors(A)
    return trtrs(A, _eye_like(A), uplo=uplo, diag=diag)


# ---- QR / least squares --------------------------------------------------

def geqrf(A):
    """Returns (Q, R), the reduced QR, for `ormqr`/`orgqr`."""
    A, = tensors(A)
    return torch.linalg.qr(A, mode="reduced")


def orgqr(qr_):
    return qr_[0]


def ormqr(qr_, C, trans="N", side="L"):
    Q = qr_[0]
    C, = tensors(C, device=Q.device)
    Qo = Q if trans == "N" else _H(Q)
    return Qo @ C if side == "L" else C @ Qo


# the QR is dtype-generic, so the unitary ('un*') entry points are the
# orthogonal ones
ungqr, unmqr = orgqr, ormqr


def ormlq(lq_, C, trans="N", side="L"):
    """Multiply by the Q of a gelqf handle (L, Q), Q stored explicitly
    (k x n)."""
    Q = lq_[1]
    C, = tensors(C, device=Q.device)
    Qo = Q if trans == "N" else _H(Q)
    return Qo @ C if side == "L" else C @ Qo


unmlq = ormlq


def gels(A, B):
    A, B = tensors(A, B)
    Bm = B.unsqueeze(-1) if B.dim() == A.dim() - 1 else B
    # gelsd: the minimum-norm solution for any shape (the CPU driver;
    # CUDA's lstsq takes full-rank tall matrices only)
    driver = "gelsd" if A.device.type == "cpu" else None
    x = torch.linalg.lstsq(A, Bm, driver=driver).solution
    return x[..., 0] if B.dim() == A.dim() - 1 else x


def gelqf(A):
    A, = tensors(A)
    Q, R = torch.linalg.qr(A.transpose(-1, -2), mode="reduced")
    return R.transpose(-1, -2), Q.transpose(-1, -2)


def larfg(x):
    """Householder reflector: (v, tau, beta) with (I - tau v v') x =
    beta e_1 and v[0] = 1."""
    x, = tensors(x)
    alpha = x[0]
    xnorm = torch.linalg.vector_norm(x[1:])
    one = torch.ones_like(alpha)
    beta = -torch.sign(torch.where(alpha == 0, one, alpha)) * torch.sqrt(
        alpha * alpha + xnorm * xnorm)
    safe = beta.abs() > 0
    tau = torch.where(safe, (beta - alpha) / torch.where(safe, beta, one),
                      torch.zeros_like(alpha))
    scale = torch.where(safe, alpha - beta, one)
    v = torch.cat([one[None], x[1:] / scale])
    return v, tau, torch.where(safe, beta, alpha)


def larfx(v, tau, C, side="L"):
    """Apply the reflector I - tau v v'."""
    v, C = tensors(v, C)
    if side == "L":
        return C - tau * torch.outer(v, v @ C)
    return C - tau * torch.outer(C @ v, v)


def geqp3(A):
    """Column-pivoted QR: (Q, R, jpvt) with A[:, jpvt] = Q @ R and R's
    diagonal non-increasing in magnitude.  A Householder step per
    column with the trailing column of largest remaining norm as pivot
    (the JAX module's fori_loop, step for step)."""
    A, = tensors(A)
    m, n = A.shape
    dev = A.device
    Aj = A.clone()
    Q = torch.eye(m, dtype=A.dtype, device=dev)
    piv = torch.arange(n, device=dev)
    rowi = torch.arange(m, device=dev)
    coli = torch.arange(n, device=dev)
    zero = torch.zeros((), dtype=A.dtype, device=dev)
    for j in range(min(m, n)):
        norms = torch.linalg.vector_norm(
            torch.where(rowi[:, None] >= j, Aj, zero), dim=0)
        p = torch.argmax(torch.where(coli >= j, norms, -1.0))
        # swap columns j <-> p, and the permutation record
        sw = torch.where(coli == j, p, torch.where(coli == p, j, coli))
        Aj = Aj[:, sw]
        piv = piv[sw]
        x = torch.where(rowi >= j, Aj[:, j], zero)
        alpha = Aj[j, j]
        xnorm = torch.linalg.vector_norm(torch.where(rowi > j, x, zero))
        beta = -torch.sign(torch.where(alpha == 0, 1.0, alpha)) * \
            torch.sqrt(alpha * alpha + xnorm * xnorm)
        safe = beta.abs() > 1e-300
        tau = torch.where(safe, (beta - alpha)
                          / torch.where(safe, beta, 1.0), zero)
        scale = torch.where(safe & ((alpha - beta).abs() > 0),
                            alpha - beta, 1.0)
        v = torch.where(rowi > j, x / scale, zero)
        v = torch.where(rowi == j, 1.0, v)
        Aj = Aj - tau * torch.outer(v, v @ Aj)
        Q = Q - tau * torch.outer(Q @ v, v)
    return Q, torch.triu(Aj), piv


# ---- eigenvalues / SVD ---------------------------------------------------

def syev(A, uplo="L", jobz="V"):
    A, = tensors(A)
    S = _symmetrize(A, uplo)
    if jobz == "V":
        return torch.linalg.eigh(S)
    return torch.linalg.eigvalsh(S)


syevd = syev
heev = syev
heevd = syev


def syevr(A, uplo="L", jobz="V", il=None, iu=None):
    """Subset selection (range='I'): the il..iu-th eigenvalues (1-based,
    ascending) of a full eigh."""
    out = syev(A, uplo, jobz)
    if il is None:
        return out
    sl = slice(il - 1, iu)
    if jobz == "V":
        w, V = out
        return w[..., sl], V[..., :, sl]
    return out[..., sl]


syevx = syevr


def sygv(A, B, uplo="L"):
    """Generalized symmetric-definite eigenproblem A v = w B v by
    Cholesky reduction (itype 1)."""
    A, B = tensors(A, B)
    L = torch.linalg.cholesky(_symmetrize(B, uplo))
    Li = trtri(L)
    w, Y = torch.linalg.eigh(Li @ _symmetrize(A, uplo) @ _H(Li))
    return w, _H(Li) @ Y


hegv = sygv


def gesvd(A, jobu="S", jobvt="S"):
    A, = tensors(A)
    full = (jobu == "A") or (jobvt == "A")
    return torch.linalg.svd(A, full_matrices=full)


gesdd = gesvd


def _w_dtype(dtype):
    return np.complex128 if dtype in (torch.float64, torch.complex128) \
        else np.complex64


def _from_host(a, dev, dtype=None):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)


def gees(A, select=None):
    """Schur factorization A = V S V' (reference gees): (S, w, V[,
    sdim]), the real or complex Schur form, the eigenvalues, the Schur
    vectors and, with ``select``, the count of selected eigenvalues
    (ordered first).  The QR iteration runs in scipy (the same LAPACK
    the reference calls) on a host copy, one matrix at a time; the
    results come back on A's device."""
    import scipy.linalg as sla
    A, = tensors(A)
    a_all = A.detach().cpu().numpy()
    wdt = _w_dtype(A.dtype)
    batch = a_all.shape[:-2]
    n = a_all.shape[-1]
    Ss, ws, Vs, sd = [], [], [], []
    for a in a_all.reshape((-1, n, n)):
        output = "complex" if np.iscomplexobj(a) else "real"
        if select is None:
            S, V = sla.schur(a, output=output)
            sdim = 0
        else:
            if output == "real":
                def sel(wr, wi):
                    return bool(select(complex(wr, wi))
                                or select(complex(wr, -wi)))
            else:
                def sel(s):
                    return bool(select(complex(s)))
            S, V, sdim = sla.schur(a, output=output, sort=sel)
        w = sla.eigvals(S) if output == "real" else np.diag(S)
        Ss.append(S.astype(a.dtype))
        ws.append(w.astype(wdt))
        Vs.append(V.astype(a.dtype))
        sd.append(sdim)
    dev = A.device
    S = _from_host(np.reshape(Ss, batch + (n, n)), dev)
    w = _from_host(np.reshape(ws, batch + (n,)), dev)
    V = _from_host(np.reshape(Vs, batch + (n, n)), dev)
    if select is None:
        return S, w, V
    return S, w, V, _from_host(np.reshape(sd, batch), dev, torch.int32)


def gges(A, B, select=None):
    """Generalized Schur factorization (A, B) = (V S W', V T W')
    (reference gges): (S, T, a, b, Vl, Vr[, sdim]) with generalized
    eigenvalues a/b.  scipy's QZ on a host copy, as `gees`."""
    import scipy.linalg as sla
    A, B = tensors(A, B)
    out_dt = torch.promote_types(A.dtype, B.dtype)
    np_out = np.dtype(str(out_dt).replace("torch.", ""))
    wdt = _w_dtype(out_dt)
    a_all, b_all = A.detach().cpu().numpy(), B.detach().cpu().numpy()
    batch = a_all.shape[:-2]
    n = a_all.shape[-1]
    outs = []
    for a, b in zip(a_all.reshape((-1, n, n)), b_all.reshape((-1, n, n))):
        output = "complex" if (np.iscomplexobj(a) or np.iscomplexobj(b)) \
            else "real"
        if select is None:
            S, T, al, be, Q, Z = sla.ordqz(a, b, output=output)
            sdim = 0
        else:
            def sel(alpha, beta):
                with np.errstate(divide="ignore", invalid="ignore"):
                    return np.asarray(
                        [bool(select(complex(x) / complex(y)))
                         if y != 0 else False
                         for x, y in zip(np.atleast_1d(alpha),
                                         np.atleast_1d(beta))])
            S, T, al, be, Q, Z = sla.ordqz(a, b, sort=sel, output=output)
            sdim = int(sel(al, be).sum())
        outs.append((S.astype(np_out), T.astype(np_out), al.astype(wdt),
                     be.astype(wdt), Q.astype(np_out), Z.astype(np_out),
                     sdim))
    dev = A.device
    mats = [_from_host(np.reshape([o[i] for o in outs], batch + (n, n)), dev)
            for i in (0, 1)]
    vecs = [_from_host(np.reshape([o[i] for o in outs], batch + (n,)), dev)
            for i in (2, 3)]
    QZ = [_from_host(np.reshape([o[i] for o in outs], batch + (n, n)), dev)
          for i in (4, 5)]
    res = (mats[0], mats[1], vecs[0], vecs[1], QZ[0], QZ[1])
    if select is None:
        return res
    return res + (_from_host(np.reshape([o[6] for o in outs], batch), dev,
                             torch.int32),)


def lacpy(A, uplo=None):
    A, = tensors(A)
    if uplo == "L":
        return torch.tril(A)
    if uplo == "U":
        return torch.triu(A)
    return A.clone()
