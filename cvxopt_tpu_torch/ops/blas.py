"""cvxopt.blas equivalents, twin of `cvxopt_tpu/ops/blas.py`: the 34
BLAS wrappers as pure functions on tensors (complex included).

As in the JAX module, every function RETURNS its result instead of
writing into an output argument, the strided-view kwargs are gone
(slice the tensors instead), and everything broadcasts over leading
batch axes.  Banded routines (gb/sb/hb/tb) take LAPACK band storage.
Results lie on the device of the tensor arguments; other array data
goes there too (to the card when no argument is a tensor).
"""

from __future__ import annotations

import torch

from cvxopt_tpu_torch._device import tensors

__all__ = [
    "swap", "scal", "copy", "axpy", "dot", "dotu", "nrm2", "asum",
    "iamax", "gemv", "gbmv", "symv", "hemv", "sbmv", "hbmv", "trmv",
    "tbmv", "trsv", "tbsv", "ger", "geru", "syr", "her", "syr2",
    "her2", "gemm", "symm", "hemm", "syrk", "herk", "syr2k", "her2k",
    "trmm", "trsm",
]


def _T(A):
    return A.transpose(-1, -2)


def _H(A):
    return A.transpose(-1, -2).conj()


# ---- level 1 -------------------------------------------------------------

def swap(x, y):
    return y, x


def scal(alpha, x):
    x, = tensors(x)
    return alpha * x


def copy(x):
    x, = tensors(x)
    return x.clone()


def axpy(x, y, alpha=1.0):
    x, y = tensors(x, y)
    return alpha * x + y


def dot(x, y):
    x, y = tensors(x, y)
    return (x.conj() * y).sum(-1)


def dotu(x, y):
    x, y = tensors(x, y)
    return (x * y).sum(-1)


def nrm2(x):
    x, = tensors(x)
    return torch.linalg.vector_norm(x, dim=-1)


def _abs1(x):
    return x.real.abs() + x.imag.abs() if x.is_complex() else x.abs()


def asum(x):
    x, = tensors(x)
    return _abs1(x).sum(-1)


def iamax(x):
    x, = tensors(x)
    return torch.argmax(_abs1(x), dim=-1)


# ---- band storage helpers ------------------------------------------------

def _band_to_dense(Ab, n, kl, ku):
    """LAPACK general band storage (kl+ku+1, n) -> dense (n, n)."""
    out = torch.zeros((n, n), dtype=Ab.dtype, device=Ab.device)
    for d in range(-kl, ku + 1):
        length = n - abs(d)
        out = out + torch.diag(Ab[ku - d, max(d, 0):max(d, 0) + length], d)
    return out


def _symband_to_dense(Ab, n, k, uplo="L"):
    out = torch.zeros((n, n), dtype=Ab.dtype, device=Ab.device)
    for d in range(k + 1):
        vals = Ab[d, :n - d] if uplo == "L" else Ab[k - d, d:]
        out = out + torch.diag(vals, -d)
        if d:
            out = out + torch.diag(vals.conj(), d)
    return out


# ---- level 2 -------------------------------------------------------------

def _apply_trans(A, trans):
    if trans == "N":
        return A
    return _T(A) if trans == "T" else _H(A)


def gemv(A, x, y=None, trans="N", alpha=1.0, beta=0.0):
    A, x, y = tensors(A, x, y)
    r = alpha * torch.einsum("...ij,...j->...i", _apply_trans(A, trans), x)
    return r if y is None else r + beta * y


def gbmv(Ab, m, n, kl, ku, x, y=None, trans="N", alpha=1.0, beta=0.0):
    Ab, x, y = tensors(Ab, x, y)
    A = _band_to_dense(Ab, max(m, n), kl, ku)[:m, :n]
    return gemv(A, x, y, trans=trans, alpha=alpha, beta=beta)


def _sym_from(A, uplo="L"):
    if uplo == "L":
        return torch.tril(A) + _T(torch.tril(A, -1))
    return torch.triu(A) + _T(torch.triu(A, 1))


def _herm_from(A, uplo="L"):
    if uplo == "L":
        return torch.tril(A) + _H(torch.tril(A, -1))
    return torch.triu(A) + _H(torch.triu(A, 1))


def symv(A, x, y=None, alpha=1.0, beta=0.0, uplo="L"):
    A, x, y = tensors(A, x, y)
    return gemv(_sym_from(A, uplo), x, y, alpha=alpha, beta=beta)


def hemv(A, x, y=None, alpha=1.0, beta=0.0, uplo="L"):
    A, x, y = tensors(A, x, y)
    return gemv(_herm_from(A, uplo), x, y, alpha=alpha, beta=beta)


def sbmv(Ab, n, k, x, y=None, alpha=1.0, beta=0.0, uplo="L"):
    Ab, x, y = tensors(Ab, x, y)
    return gemv(_symband_to_dense(Ab, n, k, uplo), x, y, alpha=alpha,
                beta=beta)


hbmv = sbmv


def _tri_from(A, uplo="L", diag="N"):
    T = torch.tril(A) if uplo == "L" else torch.triu(A)
    if diag == "U":
        T = T.clone()
        torch.diagonal(T, dim1=-2, dim2=-1).fill_(1.0)
    return T


def trmv(A, x, uplo="L", trans="N", diag="N"):
    A, x = tensors(A, x)
    return gemv(_tri_from(A, uplo, diag), x, trans=trans)


def tbmv(Ab, n, k, x, uplo="L", trans="N", diag="N"):
    Ab, x = tensors(Ab, x)
    T = _tri_from(_symband_to_dense(Ab, n, k, uplo), uplo, diag)
    return gemv(T, x, trans=trans)


def _solve_tri(T, B, upper, left=True):
    """T^{-1} B (B T^{-1} with left=False); B a vector or a matrix, each
    with T's batch axes."""
    vec = B.dim() == T.dim() - 1
    X = torch.linalg.solve_triangular(T, B.unsqueeze(-1) if vec else B,
                                      upper=upper, left=left)
    return X[..., 0] if vec else X


def trsv(A, b, uplo="L", trans="N", diag="N"):
    A, b = tensors(A, b)
    T = _apply_trans(_tri_from(A, uplo, diag), trans)
    lower = (uplo == "L") != (trans != "N")
    return _solve_tri(T, b, upper=not lower)


def tbsv(Ab, n, k, b, uplo="L", trans="N", diag="N"):
    Ab, b = tensors(Ab, b)
    return trsv(_symband_to_dense(Ab, n, k, uplo), b, uplo=uplo,
                trans=trans, diag=diag)


def _outer(x, y):
    return torch.einsum("...i,...j->...ij", x, y)


def ger(x, y, A=None, alpha=1.0):
    x, y, A = tensors(x, y, A)
    r = alpha * _outer(x, y.conj())
    return r if A is None else A + r


def geru(x, y, A=None, alpha=1.0):
    x, y, A = tensors(x, y, A)
    r = alpha * _outer(x, y)
    return r if A is None else A + r


def syr(x, A=None, alpha=1.0):
    x, A = tensors(x, A)
    r = alpha * _outer(x, x)
    return r if A is None else A + r


def her(x, A=None, alpha=1.0):
    x, A = tensors(x, A)
    r = alpha * _outer(x, x.conj())
    return r if A is None else A + r


def syr2(x, y, A=None, alpha=1.0):
    x, y, A = tensors(x, y, A)
    r = alpha * (_outer(x, y) + _outer(y, x))
    return r if A is None else A + r


def _conj(alpha):
    return alpha.conjugate() if isinstance(alpha, complex) else alpha


def her2(x, y, A=None, alpha=1.0):
    x, y, A = tensors(x, y, A)
    xy = _outer(x, y.conj())
    r = alpha * xy + _conj(alpha) * _H(xy)
    return r if A is None else A + r


# ---- level 3 -------------------------------------------------------------

def gemm(A, B, C=None, transA="N", transB="N", alpha=1.0, beta=0.0):
    A, B, C = tensors(A, B, C)
    r = alpha * (_apply_trans(A, transA) @ _apply_trans(B, transB))
    return r if C is None else r + beta * C


def symm(A, B, C=None, side="L", uplo="L", alpha=1.0, beta=0.0):
    A, B, C = tensors(A, B, C)
    S = _sym_from(A, uplo)
    r = alpha * (S @ B if side == "L" else B @ S)
    return r if C is None else r + beta * C


def hemm(A, B, C=None, side="L", uplo="L", alpha=1.0, beta=0.0):
    A, B, C = tensors(A, B, C)
    S = _herm_from(A, uplo)
    r = alpha * (S @ B if side == "L" else B @ S)
    return r if C is None else r + beta * C


def syrk(A, C=None, trans="N", alpha=1.0, beta=0.0):
    A, C = tensors(A, C)
    At = A if trans == "N" else _T(A)
    r = alpha * (At @ _T(At))
    return r if C is None else r + beta * C


def herk(A, C=None, trans="N", alpha=1.0, beta=0.0):
    A, C = tensors(A, C)
    At = A if trans == "N" else _H(A)
    r = alpha * (At @ _H(At))
    return r if C is None else r + beta * C


def syr2k(A, B, C=None, trans="N", alpha=1.0, beta=0.0):
    A, B, C = tensors(A, B, C)
    if trans == "N":
        r = A @ _T(B) + B @ _T(A)
    else:
        r = _T(A) @ B + _T(B) @ A
    r = alpha * r
    return r if C is None else r + beta * C


def her2k(A, B, C=None, trans="N", alpha=1.0, beta=0.0):
    A, B, C = tensors(A, B, C)
    if trans == "N":
        r = alpha * (A @ _H(B)) + _conj(alpha) * (B @ _H(A))
    else:
        r = alpha * (_H(A) @ B) + _conj(alpha) * (_H(B) @ A)
    return r if C is None else r + beta * C


def trmm(A, B, side="L", uplo="L", transA="N", diag="N", alpha=1.0):
    A, B = tensors(A, B)
    T = _apply_trans(_tri_from(A, uplo, diag), transA)
    return alpha * (T @ B if side == "L" else B @ T)


def trsm(A, B, side="L", uplo="L", transA="N", diag="N", alpha=1.0):
    A, B = tensors(A, B)
    T = _apply_trans(_tri_from(A, uplo, diag), transA)
    lower = (uplo == "L") != (transA != "N")
    return _solve_tri(T, alpha * B, upper=not lower, left=(side == "L"))
