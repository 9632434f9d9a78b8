"""Banded and tridiagonal factorizations, twin of
`cvxopt_tpu/ops/banded.py` (the reference's gbsv/gbtrf/gbtrs,
gtsv/gttrf/gttrs, pbsv/pbtrf/pbtrs, ptsv/pttrf/pttrs and tbtrs).

Each `lax.scan` of the JAX module is a Python loop over tensors here:
the scalar recurrences (`pbtrf`, `pbtrs`, `pt*`, `gtsv`, `tbtrs`,
`gbtrf_scan`/`gbtrs_scan`) take n steps of a few small tensor ops each,
and the block-panel Cholesky (`pbtrf_blocked`/`pbtrs_blocked`) takes
n/cb steps of dense (cb, cb) Cholesky, triangular-solve and product
calls.  On the card every step is a few kernel launches, so only the
block-panel pair belongs on a large problem's path.

Storage conventions (LAPACK band storage, as the reference uses):
  - symmetric positive definite band, LOWER: ``AB[j, i] = A[i+j, i]``,
    shape (kd+1, n); AB[0] is the diagonal;
  - general band: ``AB[ku + i - j, j] = A[i, j]``, shape (kl+ku+1, n);
  - general tridiagonal: vectors (dl, d, du) of lengths n-1, n, n-1.

Functions take tensors and return tensors on the same device; other
array data goes to the device of the tensor arguments (the card when
there is none).  Non-PD pivots come back as NaN, as in the JAX module.
"""

from __future__ import annotations

import torch

from cvxopt_tpu_torch._device import tensors

__all__ = [
    "pbtrf", "pbtrs", "pbsv", "pbtrf_blocked", "pbtrs_blocked",
    "pttrf", "pttrs", "ptsv",
    "gtsv", "gttrf", "gttrs", "tbtrs", "gbsv", "gbtrf", "gbtrs",
    "band_to_dense", "dense_to_band",
]


def _mat(B):
    """(B as a matrix of columns, whether B was a vector)."""
    return (B.unsqueeze(1), True) if B.dim() == 1 else (B, False)


def band_to_dense(AB, uplo="L"):
    """Symmetric band (kd+1, n) lower storage -> dense (n, n)."""
    AB, = tensors(AB)
    kdp1, n = AB.shape
    A = torch.zeros((n, n), dtype=AB.dtype, device=AB.device)
    for j in range(kdp1):
        d = AB[j, : n - j]
        A = A + torch.diag(d, -j)
        if j:
            A = A + torch.diag(d, j)
    return A


def dense_to_band(A, kd, uplo="L"):
    """Dense symmetric (n, n) -> lower band storage (kd+1, n)."""
    A, = tensors(A)
    rows = [torch.nn.functional.pad(torch.diagonal(A, -j), (0, j))
            for j in range(kd + 1)]
    return torch.stack(rows)


def _band_rows(AB):
    """(kd+1, n) lower band -> row-window layout (n, kd+1) with
    R[r, j] = A[r, r-kd+j] (zero out of range; R[r, kd] the diagonal)."""
    kdp1, n = AB.shape
    kd = kdp1 - 1
    r = torch.arange(n, device=AB.device)[:, None]
    j = torch.arange(kd + 1, device=AB.device)[None, :]
    col = r - kd + j
    vals = AB[kd - j, col.clamp(0, n - 1)]
    return torch.where(col >= 0, vals, torch.zeros_like(vals))


def pbtrf(AB, dbound: float = 0.0):
    """Banded Cholesky (lower), one pivot per step: AB (kd+1, n) ->
    LB (kd+1, n) with LB[0] = diag(L), LB[j, i] = L[i+j, i].  NaN from
    a non-PD pivot on.  `dbound` > 0 clamps the pivots during the
    elimination (CHOLMOD's dbound)."""
    AB, = tensors(AB)
    kdp1, n = AB.shape
    kd = kdp1 - 1
    if kd == 0:
        return torch.sqrt(AB.clamp(min=dbound) if dbound > 0 else AB)
    if n < kd + 1:
        raise ValueError("n must be >= kd+1")
    R = _band_rows(AB)
    # the window A[i:i+kd+1, i:i+kd+1] of the partly eliminated matrix;
    # rows stream in from R, then kd+1 unit pad rows keep it PD
    rin = torch.cat([R[kd + 1:], torch.zeros((kd + 1, kd + 1),
                                             dtype=AB.dtype,
                                             device=AB.device)])
    rin[n - kd - 1:, kd] = 1.0
    W = band_to_dense(AB[:, : kd + 1])
    Wn = torch.zeros_like(W)
    out = torch.empty((n, kd + 1), dtype=AB.dtype, device=AB.device)
    for i in range(n):
        d2 = W[0, 0]
        if dbound > 0:
            d2 = d2.clamp(min=dbound)
        dinv = torch.where(d2 > 0, torch.rsqrt(d2), float("nan"))
        col = torch.mul(W[1:, 0], dinv, out=out[i, 1:])
        torch.reciprocal(dinv, out=out[i, 0])
        Wn[:kd, :kd] = torch.addr(W[1:, 1:], col, col, alpha=-1)
        Wn[kd] = rin[i]
        Wn[:kd, kd] = rin[i, :kd]
        W, Wn = Wn, W
    return out.T.contiguous()


def _band_blocks(AB, cb):
    """Band (kd+1, n) lower storage -> block-tridiagonal dense blocks:
    D (nb, cb, cb) symmetric diagonal blocks and E (nb, cb, cb)
    subdiagonal blocks (E[i] couples block i+1 to block i; E[nb-1] is
    zero).  n is padded to nb*cb with a unit diagonal."""
    kdp1, n = AB.shape
    kd = kdp1 - 1
    nb = -(-n // cb)
    npad = nb * cb
    dev = AB.device
    ABp = torch.nn.functional.pad(AB, (0, npad - n))
    if npad > n:
        ABp[0, n:] = 1.0
    i = torch.arange(nb, device=dev)[:, None, None]
    r = torch.arange(cb, device=dev)[None, :, None]
    c = torch.arange(cb, device=dev)[None, None, :]
    q = (i * cb + c).expand(nb, cb, cb)
    zero = torch.zeros((), dtype=AB.dtype, device=dev)
    # D[i][r, c] = A[i*cb + r, i*cb + c] (lower: d = r - c in [0, kd])
    d = (r - c).expand(nb, cb, cb)
    Dl = torch.where((d >= 0) & (d <= kd), ABp[d.clamp(0, kd), q], zero)
    D = Dl + torch.tril(Dl, -1).transpose(-1, -2)
    # E[i][r, c] = A[(i+1)*cb + r, i*cb + c] (d = cb + r - c)
    dE = d + cb
    E = torch.where(dE <= kd, ABp[dE.clamp(0, kd), q], zero)
    E[nb - 1] = 0.0
    return D, E


def _chol_nan(S):
    """Lower Cholesky factor whose lower triangle is NaN where S is not
    PD (as jnp.linalg.cholesky), without a host sync."""
    L, info = torch.linalg.cholesky_ex(S)
    nan = torch.tril(torch.full_like(L, float("nan")))
    return torch.where((info == 0)[..., None, None], L, nan)


def pbtrf_blocked(AB, cb: int = 128, dbound: float = 0.0):
    """Block-panel banded Cholesky: the band as a block-tridiagonal
    matrix of dense (cb, cb) blocks (cb >= kd), factored by a loop over
    the n/cb panels (Cholesky, triangular solve and product per panel)
    instead of the n scalar steps of `pbtrf`.

    Returns (Ls, Cs): the block-bidiagonal factor with lower-triangular
    diagonal blocks Ls (nb, cb, cb) and subdiagonal blocks Cs (nb, cb,
    cb) (Cs[i] couples block i+1; Cs[nb-1] unused).  Solve with
    `pbtrs_blocked`.  NaN blocks signal a non-PD pivot."""
    AB, = tensors(AB)
    kd = AB.shape[0] - 1
    if cb < kd:
        raise ValueError(f"cb ({cb}) must be >= bandwidth kd ({kd})")
    D, E = _band_blocks(AB, cb)
    if dbound > 0:
        dg = torch.diagonal(D, dim1=-2, dim2=-1)
        dg.copy_(dg.clamp(min=dbound))
    nb = D.shape[0]
    Ls = torch.empty_like(D)
    Cs = torch.empty_like(D)
    Cprev = torch.zeros((cb, cb), dtype=AB.dtype, device=AB.device)
    for i in range(nb):
        S = torch.addmm(D[i], Cprev, Cprev.T, alpha=-1)
        Ls[i] = _chol_nan(S)
        # C_i = E_i L_i^{-T} = (L_i^{-1} E_i')'
        Cs[i] = torch.linalg.solve_triangular(Ls[i], E[i].T,
                                              upper=False).T
        Cprev = Cs[i]
    return Ls, Cs


def pbtrs_blocked(fac, B):
    """Solve L L' x = B with (Ls, Cs) from `pbtrf_blocked`.  B: (n,) or
    (n, nrhs); n may be shorter than nb*cb (padded)."""
    Ls, Cs = fac
    B, = tensors(B, device=Ls.device)
    nb, cb, _ = Ls.shape
    Bm, vec = _mat(B)
    n, nrhs = Bm.shape
    npad = nb * cb
    Bp = torch.nn.functional.pad(Bm, (0, 0, 0, npad - n)).reshape(
        nb, cb, nrhs)
    # forward: y_i = L_i^{-1} (b_i - C_{i-1} y_{i-1})
    y = torch.empty_like(Bp)
    y[0] = torch.linalg.solve_triangular(Ls[0], Bp[0], upper=False)
    for i in range(1, nb):
        y[i] = torch.linalg.solve_triangular(
            Ls[i], torch.addmm(Bp[i], Cs[i - 1], y[i - 1], alpha=-1),
            upper=False)
    # backward: x_i = L_i^{-T} (y_i - C_i' x_{i+1})
    x = torch.empty_like(Bp)
    x[nb - 1] = torch.linalg.solve_triangular(Ls[nb - 1].T, y[nb - 1],
                                              upper=True)
    for i in range(nb - 2, -1, -1):
        x[i] = torch.linalg.solve_triangular(
            Ls[i].T, torch.addmm(y[i], Cs[i].T, x[i + 1], alpha=-1),
            upper=True)
    x = x.reshape(npad, nrhs)[:n]
    return x[:, 0] if vec else x


def pbtrs(LB, B):
    """Solve L L' x = B with LB from pbtrf.  B: (n,) or (n, nrhs)."""
    LB, B = tensors(LB, B)
    kdp1, n = LB.shape
    kd = kdp1 - 1
    Bm, vec = _mat(B)
    if kd == 0:
        x = Bm / LB[0][:, None] / LB[0][:, None]
        return x[:, 0] if vec else x
    y = _lower_solve(LB, Bm)
    x = _lower_solve_t(LB, y)
    return x[:, 0] if vec else x


def _lower_solve(LB, Bm):
    """L y = B for lower band storage LB, one row per step."""
    kd = LB.shape[0] - 1
    n, nrhs = Bm.shape
    Lr = _band_rows(LB)
    # y_i = (b_i - sum_j L[i, i-kd+j] y_{i-kd+j}) / L[i, i], with the
    # kd rows before y_0 kept zero
    Y = torch.zeros((n + kd, nrhs), dtype=Bm.dtype, device=Bm.device)
    for i in range(n):
        t = torch.addmv(Bm[i], Y[i:i + kd].T, Lr[i, :kd], alpha=-1)
        torch.div(t, Lr[i, kd], out=Y[kd + i])
    return Y[kd:]


def _lower_solve_t(LB, Ym):
    """L' x = Y for lower band storage LB, one row per step from the
    end."""
    kd = LB.shape[0] - 1
    n, nrhs = Ym.shape
    LBc = LB.T                     # (n, kd+1): L[i+j, i] = LBc[i, j]
    X = torch.zeros((n + kd, nrhs), dtype=Ym.dtype, device=Ym.device)
    for i in range(n - 1, -1, -1):
        t = torch.addmv(Ym[i], X[i + 1:i + 1 + kd].T, LBc[i, 1:], alpha=-1)
        torch.div(t, LBc[i, 0], out=X[i])
    return X[:n]


def pbsv(AB, B):
    LB = pbtrf(AB)
    return LB, pbtrs(LB, B)


# ---- tridiagonal PD (pt*) ------------------------------------------------

def pttrf(d, e):
    """LDL' of a symmetric PD tridiagonal: (dfac, efac) with
    D = diag(dfac) and L unit lower bidiagonal with subdiagonal efac."""
    d, e = tensors(d, e)
    n = d.shape[0]
    df = torch.empty_like(d)
    lf = torch.empty((n,), dtype=d.dtype, device=d.device)
    e_in = torch.cat([e, e.new_zeros(1)])
    dprev = d.new_ones(())
    lprev = d.new_zeros(())
    for i in range(n):
        dcur = torch.sub(d[i], lprev * lprev * dprev, out=df[i])
        lprev = torch.div(e_in[i], dcur, out=lf[i])
        dprev = dcur
    return df, lf[:-1]


def pttrs(df, ef, B):
    """Solve L D L' x = B with (df, ef) from pttrf."""
    df, ef, B = tensors(df, ef, B)
    Bm, vec = _mat(B)
    n = Bm.shape[0]
    y = torch.empty_like(Bm)
    y[0] = Bm[0]
    for i in range(1, n):
        torch.sub(Bm[i], ef[i - 1] * y[i - 1], out=y[i])
    y = y / df[:, None]
    x = torch.empty_like(Bm)
    x[n - 1] = y[n - 1]
    for i in range(n - 2, -1, -1):
        torch.sub(y[i], ef[i] * x[i + 1], out=x[i])
    return x[:, 0] if vec else x


def ptsv(d, e, B):
    df, ef = pttrf(d, e)
    return (df, ef), pttrs(df, ef, B)


# ---- general tridiagonal with partial pivoting (gt*) ---------------------

def gtsv(dl, d, du, B):
    """Solve a general tridiagonal system with partial pivoting.
    dl/du of length n-1, d of length n; B (n,) or (n, nrhs)."""
    dl, d, du, B = tensors(dl, d, du, B)
    n = d.shape[0]
    Bm, vec = _mat(B)
    z1 = d.new_zeros(1)
    du_in = torch.cat([du, z1])
    du_next = torch.cat([du[1:], d.new_zeros(2)])[:n]
    # current row (p, u1, u2 | r); each step pivots it against the
    # next raw row (a, d, du | b) and keeps the upper row
    U = torch.empty((n, 3), dtype=d.dtype, device=d.device)
    R = torch.empty_like(Bm)
    p, u1, u2, r = d[0], du_in[0], d.new_zeros(()), Bm[0]
    for i in range(n - 1):
        a, dn, dun, bn = dl[i], d[i + 1], du_next[i], Bm[i + 1]
        swap = a.abs() > p.abs()
        top = torch.where(swap, a, p)
        tu1 = torch.where(swap, dn, u1)
        tu2 = torch.where(swap, dun, u2)
        tr = torch.where(swap, bn, r)
        m = torch.where(swap, p, a) / top
        nu1 = torch.where(swap, u1, dn) - m * tu1
        nu2 = torch.where(swap, u2, dun) - m * tu2
        r = torch.where(swap, r, bn) - m * tr
        U[i, 0], U[i, 1], U[i, 2] = top, tu1, tu2
        R[i] = tr
        p, u1, u2 = nu1, nu2, d.new_zeros(())
    U[n - 1, 0], U[n - 1, 1], U[n - 1, 2] = p, u1, u2
    R[n - 1] = r
    X = torch.zeros((n + 2, Bm.shape[1]), dtype=Bm.dtype, device=Bm.device)
    for i in range(n - 1, -1, -1):
        X[i] = (R[i] - U[i, 1] * X[i + 1] - U[i, 2] * X[i + 2]) / U[i, 0]
    x = X[:n]
    return x[:, 0] if vec else x


def gttrf(dl, d, du):
    """Factor handle for gttrs: the inputs (the pivoted elimination runs
    in the solve)."""
    return tensors(dl, d, du)


def gttrs(fac, B, trans="N"):
    dl, d, du = fac
    if trans == "N":
        return gtsv(dl, d, du, B)
    return gtsv(du, d, dl, B)              # A' is tridiagonal too


# ---- pivoted banded LU one column per step (gbtrf_scan / gbtrs_scan) -----

def _gb_entry(AB, kl, ku, r, c, n):
    """A[r, c] from general band storage AB[ku+r-c, c]: 0 outside the
    band and the matrix, a unit diagonal on pad rows r >= n."""
    d = r - c
    inband = (d >= -ku) & (d <= kl) & (c >= 0) & (c < n) & (r >= 0)
    vals = AB[(ku + d).clamp(0, kl + ku), c.clamp(0, n - 1)]
    zero = torch.zeros((), dtype=AB.dtype, device=AB.device)
    vals = torch.where(inband & (r < n), vals, zero)
    return torch.where((r >= n) & (r == c), torch.ones_like(vals), vals)


def gbtrf_scan(AB, kl, ku):
    """Banded LU with partial pivoting, one column per step (LAPACK's
    pivoting over the kl+1 candidate rows; U's bandwidth grows to
    kl+ku).  AB: (kl+ku+1, n) general band storage.

    Returns (Urows, Lcols, piv): U[j, j:j+kl+ku+1] per row, the kl
    multipliers L[j+1:j+kl+1, j], and the chosen pivot offset in [0, kl]
    per column.  Zero pivots give inf/NaN."""
    AB, = tensors(AB)
    n = AB.shape[1]
    w = kl + ku + 1
    dev = AB.device
    r = torch.arange(kl + 1, device=dev)[:, None]
    c = torch.arange(w, device=dev)[None, :]
    W = _gb_entry(AB, kl, ku, r, c, n)             # rows 0..kl
    # incoming rows: step j appends row j+kl+1 over cols j+1..j+w
    j = torch.arange(n, device=dev)[:, None]
    Rin = _gb_entry(AB, kl, ku, j + kl + 1, j + 1 + c, n)
    Urows = torch.empty((n, w), dtype=AB.dtype, device=dev)
    Lcols = torch.empty((n, kl), dtype=AB.dtype, device=dev)
    piv = torch.empty((n,), dtype=torch.int32, device=dev)
    ar = torch.arange(kl + 1, device=dev)
    Wn = torch.zeros((kl + 1, w), dtype=AB.dtype, device=dev)
    for jj in range(n):
        p = torch.argmax(W[:, 0].abs())
        # swap rows 0 <-> p
        idx = torch.where(ar == 0, p, torch.where(ar == p, 0, ar))
        W = W[idx]
        Urows[jj] = W[0]
        m = torch.div(W[1:, 0], W[0, 0], out=Lcols[jj])
        piv[jj] = p
        Wn[:kl, :w - 1] = W[1:, 1:] - m[:, None] * W[0:1, 1:]
        Wn[:kl, w - 1] = 0.0
        Wn[kl] = Rin[jj]
        W, Wn = Wn, W
    return Urows, Lcols, piv


def gbtrs_scan(fac, B, kl, ku):
    """Solve with a `gbtrf_scan` factor.  B: (n,) or (n, nrhs)."""
    Urows, Lcols, piv = fac
    B, = tensors(B, device=Urows.device)
    n = Urows.shape[0]
    w = kl + ku + 1
    Bm, vec = _mat(B)
    nrhs = Bm.shape[1]
    dev = Bm.device
    Bpad = torch.cat([Bm, Bm.new_zeros((kl + 1, nrhs))])
    # forward: replay the swaps and eliminations on a (kl+1)-row window
    ar = torch.arange(kl + 1, device=dev)
    v = Bpad[: kl + 1]
    y = torch.empty_like(Bm)
    vn = Bm.new_zeros((kl + 1, nrhs))
    pl = piv.long()
    for jj in range(n):
        p = pl[jj]
        idx = torch.where(ar == 0, p, torch.where(ar == p, 0, ar))
        v = v[idx]
        y[jj] = v[0]
        vn[:kl] = torch.addr(v[1:], Lcols[jj], v[0], alpha=-1)
        vn[kl] = Bpad[kl + 1 + jj]
        v, vn = vn, v
    # backward: x_j = (y_j - U[j, j+1:] x) / U[j, j]
    X = Bm.new_zeros((n + w - 1, nrhs))
    for jj in range(n - 1, -1, -1):
        t = torch.addmv(y[jj], X[jj + 1:jj + w].T, Urows[jj, 1:], alpha=-1)
        torch.div(t, Urows[jj, 0], out=X[jj])
    x = X[:n]
    return x[:, 0] if vec else x


# ---- banded triangular / general band (tb*, gb*) -------------------------

def tbtrs(AB, B, uplo="L", trans="N"):
    """Triangular banded solve.  AB (kd+1, n): lower storage (AB[0] the
    diagonal, AB[j, i] = A[i+j, i]) for uplo='L', LAPACK upper storage
    (AB[kd] the diagonal, AB[kd-d, j] = A[j-d, j]) for uplo='U'.  One
    row per step, O(n kd) per right-hand side."""
    AB, B = tensors(AB, B)
    kdp1, n = AB.shape
    kd = kdp1 - 1
    if uplo == "U":
        # U in upper storage is U' in lower storage: LB[d, i] =
        # U[i, i+d] = AB[kd-d, i+d]; U x = b is the transposed solve
        LB = torch.stack([torch.cat([AB[kd - d, d:], AB.new_zeros(d)])
                          for d in range(kd + 1)])
        return tbtrs(LB, B, uplo="L", trans="T" if trans == "N" else "N")
    Bm, vec = _mat(B)
    x = _lower_solve(AB, Bm) if trans == "N" else _lower_solve_t(AB, Bm)
    return x[:, 0] if vec else x


def _lu_solve(lu_piv, B, trans="N"):
    """jax.scipy.linalg.lu_solve's trans 0/1/2 on torch's LU handle."""
    LU, piv = lu_piv
    Bm, vec = _mat(B)
    if trans == "N":
        X = torch.linalg.lu_solve(LU, piv, Bm)
    elif trans == "C" or not LU.is_complex():
        X = torch.linalg.lu_solve(LU, piv, Bm, adjoint=True)
    else:                                  # A' x = b: conj of A^H
        X = torch.linalg.lu_solve(LU, piv, Bm.conj(), adjoint=True).conj() \
            .resolve_conj()
    return X[..., 0] if vec else X


def gbtrf(AB, kl, ku):
    """General band LU by dense expansion and LU with partial pivoting
    (as the JAX module: the scalable paths are pb*/pt*/tb* and
    `gbtrf_scan`).  AB: (kl+ku+1, n) general band storage.  Returns
    torch's (LU, pivots) handle."""
    AB, = tensors(AB)
    n = AB.shape[1]
    A = torch.zeros((n, n), dtype=AB.dtype, device=AB.device)
    for k in range(-kl, ku + 1):
        dlen = n - abs(k)
        if k >= 0:
            A = A + torch.diag(AB[ku - k, k:k + dlen], k)
        else:
            A = A + torch.diag(AB[ku - k, :dlen], k)
    return torch.linalg.lu_factor(A)


def gbtrs(fac, B, trans="N"):
    B, = tensors(B, device=fac[0].device)
    return _lu_solve(fac, B, trans)


def gbsv(AB, kl, ku, B):
    fac = gbtrf(AB, kl, ku)
    return fac, gbtrs(fac, B)
