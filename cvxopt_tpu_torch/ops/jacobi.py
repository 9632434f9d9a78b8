"""Symmetric eigensolvers of the 's'-cone paths, in one place.

Twin of `cvxopt_tpu/ops/jacobi.py`:

  eigh_jacobi         batched parallel-ordered cyclic Jacobi: pure
                      batched elementwise/gather work, relative accuracy
                      on the small eigenvalues of graded positive
                      definite matrices (Demmel-Veselic);
  eigvalsh_jacobi     its eigenvalues;
  eigh_accurate       the eigendecomposition `cones.max_step_eig` and
                      `kkt.psqrt_factor` consume;
  eigvalsh_accurate   the eigenvalues `cones.max_step` consumes;
  gram_eigh_accurate  eigendecomposition of M'M for the NT scaling.

The JAX package polishes an f32 seed with Jacobi sweeps because its
backend's float64 eigh is only f32-grade.  float64 is native on the GPU
and on the CPU, so the three `*_accurate` functions here are float64
`torch.linalg.eigh`/`eigvalsh` of the SYMMETRIZED input (torch reads one
triangle; the JAX package's eigh symmetrizes), returned in the input's
dtype.

Odd m is handled in `eigh_jacobi` by padding to m+1 with a decoupled
unit diagonal: pairs touching the pad index see a zero coupling, their
rotations reduce to the identity, and the pad row/column is sliced off
before sorting.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=32)
def _partner_tables(m: int):
    """Round-robin tournament tables for me = m + (m % 2) players:
    (me-1) rounds of me/2 disjoint pairs (p < q) covering all pairs.
    Every index is in exactly one pair per round, so a round's column
    update is a full rebuild
    newA[:, j] = c[j]*A[:, j] + sgn[j]*s[j]*A[:, partner[j]].
    Returns (p, q, partner, sign, pair_idx, me): p, q shaped
    (me-1, me/2); partner/sign/pair_idx shaped (me-1, me)."""
    me = m + (m % 2)
    players = list(range(me))
    nr = me - 1
    ps = np.zeros((nr, me // 2), np.int64)
    qs = np.zeros((nr, me // 2), np.int64)
    partner = np.zeros((nr, me), np.int64)
    sign = np.zeros((nr, me), np.float64)
    pidx = np.zeros((nr, me), np.int64)
    for r in range(nr):
        for k in range(me // 2):
            a, b = players[k], players[me - 1 - k]
            p, q = min(a, b), max(a, b)
            ps[r, k], qs[r, k] = p, q
            partner[r, p], partner[r, q] = q, p
            sign[r, p], sign[r, q] = -1.0, 1.0
            pidx[r, p] = pidx[r, q] = k
        players = [players[0]] + [players[-1]] + players[1:-1]
    return ps, qs, partner, sign, pidx, me


def _pad_even(A, me):
    """Pad (..., m, m) to (..., me, me) with a decoupled unit diagonal."""
    m = A.shape[-1]
    if me == m:
        return A
    out = A.new_zeros(A.shape[:-2] + (me, me))
    out[..., :m, :m] = A
    idx = torch.arange(m, me, device=A.device)
    out[..., idx, idx] = 1.0
    return out


def _rotation(app, aqq, apq):
    """Stable Jacobi rotation (Golub & Van Loan 8.4): (c, s) zeroing the
    (p, q) coupling; identity where apq == 0.  Range-safe form: every
    intermediate stays at the scale of the matrix entries."""
    theta = aqq - app
    denom = torch.abs(theta) + torch.sqrt(theta * theta + 4.0 * apq * apq)
    sgn = torch.where(theta >= 0.0, 1.0, -1.0).to(app.dtype)
    t = 2.0 * apq * sgn / torch.where(denom == 0.0,
                                      torch.ones_like(denom), denom)
    t = torch.where(apq == 0.0, torch.zeros_like(t), t)
    c = 1.0 / torch.sqrt(1.0 + t * t)
    return c, t * c


def eigh_jacobi(A, sweeps: int = 12):
    """Batched eigh by cyclic Jacobi: (w, V) with A = V diag(w) V',
    w ascending; the contract of `torch.linalg.eigh`.  A: (..., m, m)
    symmetric."""
    m = A.shape[-1]
    dev = A.device
    prs, qrs, partner, sign, pidx, me = _partner_tables(m)
    tabs = [tuple(torch.as_tensor(t[r], device=dev)
                  for t in (prs, qrs, partner, pidx))
            + (torch.as_tensor(sign[r], dtype=A.dtype, device=dev),)
            for r in range(prs.shape[0])]
    A = _pad_even(A, me)
    V = torch.eye(me, dtype=A.dtype, device=dev).expand(A.shape).clone()
    for _ in range(sweeps):
        for p, q, prt, pix, sgn in tabs:
            # the round's me/2 rotations are disjoint and cover every
            # index once, so J'AJ is a full rebuild:
            #   cols:  A <- cs*A + ss*A[:, partner]
            #   rows:  A <- cs'*A + ss'*A[partner, :]
            c, s = _rotation(A[..., p, p], A[..., q, q], A[..., p, q])
            cs = c[..., pix]
            ss = s[..., pix] * sgn
            ccol, scol = cs[..., None, :], ss[..., None, :]
            A = ccol * A + scol * A[..., :, prt]
            A = cs[..., :, None] * A + ss[..., :, None] * A[..., prt, :]
            V = ccol * V + scol * V[..., :, prt]
        # re-symmetrize against drift once per sweep
        A = 0.5 * (A + A.transpose(-1, -2))
    w = torch.diagonal(A, dim1=-2, dim2=-1)[..., :m]
    V = V[..., :m, :m]
    w, order = torch.sort(w, dim=-1)
    V = torch.gather(V, -1, order[..., None, :].expand(V.shape))
    return w, V


def eigvalsh_jacobi(A, sweeps: int = 12):
    return eigh_jacobi(A, sweeps=sweeps)[0]


def _sym64(X):
    """(X + X')/2 in float64."""
    X = X.double()
    return 0.5 * (X + X.transpose(-1, -2))


def _nan_safe(fn, S):
    """fn(S) for fn = eigh or eigvalsh, with NaN results for the
    matrices of the batch that hold a non-finite entry: the library
    raises on such input, while the solvers carry a failed instance as
    NaN beside its healthy neighbours."""
    bad = ~torch.isfinite(S).all(-1).all(-1)
    eye = torch.eye(S.shape[-1], dtype=S.dtype, device=S.device)
    out = fn(torch.where(bad[..., None, None], eye, S))
    nan = float("nan")
    if torch.is_tensor(out):
        return out.masked_fill(bad[..., None], nan)
    w, V = out
    return (w.masked_fill(bad[..., None], nan),
            V.masked_fill(bad[..., None, None], nan))


def eigh_accurate(A, sweeps: int = 5, force: bool = False):
    """(w ascending, V) of symmetric A by float64 eigh of (A + A')/2,
    in A's dtype.  `sweeps` and `force` are the JAX package's Jacobi
    polish controls, taken for its signature and ignored: the polish
    repairs an f32-grade eigh, and float64 eigh here is what the JAX
    package runs when it needs no polish."""
    w, V = _nan_safe(torch.linalg.eigh, _sym64(A))
    return w.to(A.dtype), V.to(A.dtype)


def eigvalsh_accurate(A):
    """Ascending eigenvalues of symmetric A by float64 eigvalsh of
    (A + A')/2, in A's dtype."""
    return _nan_safe(torch.linalg.eigvalsh, _sym64(A)).to(A.dtype)


def gram_eigh_accurate(M, sweeps: int = 6, force: bool = False):
    """(w ascending, V) with M'M = V diag(w) V', by float64 eigh, in
    M's dtype.  `sweeps` and `force` are taken and ignored, as in
    `eigh_accurate`."""
    M64 = M.double()
    w, V = _nan_safe(torch.linalg.eigh,
                     _sym64(M64.transpose(-1, -2) @ M64))
    return w.to(M.dtype), V.to(M.dtype)
