"""Sparse direct-solver API, the cvxopt.cholmod / umfpack / amd
equivalents; twin of `cvxopt_tpu/ops/spsolve.py`.

Symbolic/numeric factorization handles, solve with the CHOLMOD sys
table, one-shot linsolve, and the fill-reducing ordering.  Sparse
inputs (scipy.sparse, or the port's torch sparse COO matrices) get a
real sparse analysis on the host: an RCM ordering, and the banded
factor when the band is narrow, the tile-map blocksparse factor for
band-hostile patterns whose block fill stays well under dense, a dense
factor otherwise.  Dense inputs are factored dense.

The numeric phase runs on the device of a tensor argument, else on
``device=`` (default "cuda").  On the card, the banded route computes
its band factor by the block-panel method (`banded.pbtrf_blocked`, n/cb
steps) and writes it into band storage: the same factor as the JAX
package's one-row-per-step `pbtrf`, which the CPU runs, and which the
card runs too when ``options['dbound']`` clamps the pivots.
`amd_order` runs on the host, with the port's native minimum-degree
library when it builds and pure Python otherwise.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from cvxopt_tpu_torch._device import resolve_device

options = {"supernodal": 2, "print": 0, "nmethods": 0, "postorder": True,
           "dbound": 0.0}


def _device_of(*xs, device="cuda"):
    for x in xs:
        if torch.is_tensor(x):
            return x.device
    return resolve_device(device)


def _dense(A, dev):
    """A as a dense tensor on dev (float data as float64 unless it is a
    tensor already)."""
    if torch.is_tensor(A):
        A = A.to_dense() if A.is_sparse else A
        return A.to(dev)
    if sp.issparse(A):
        A = A.toarray()
    a = np.asarray(A)
    if a.dtype.kind in "iub":
        a = a.astype(np.float64)
    return torch.as_tensor(a, device=dev)


# ---- cholmod-like --------------------------------------------------------

@dataclass
class CholSymbolic:
    n: int
    perm: Optional[np.ndarray]
    banded: bool = False
    kd: int = 0
    bsp: Optional[object] = None     # BlockSymbolic (tile-map path)


@dataclass
class CholFactor:
    L: torch.Tensor             # dense factor OR band storage (kd+1, n)
    perm: Optional[np.ndarray]
    banded: bool = False
    bsp: Optional[object] = None     # BlockSymbolic when tile-map


def _is_sparse_input(A):
    return sp.issparse(A) or (torch.is_tensor(A) and A.is_sparse)


def _to_scipy(A):
    if sp.issparse(A):
        return sp.csr_matrix(A)
    idx = A._indices().cpu().numpy()
    return sp.coo_matrix((A._values().cpu().numpy(), (idx[0], idx[1])),
                         shape=tuple(A.shape)).tocsr()


def symbolic(A, p=None, uplo="L") -> CholSymbolic:
    """Symbolic analysis (cholmod.symbolic).

    Sparse inputs get a real sparse analysis: an RCM ordering (or the
    caller's `p`); with a small bandwidth the numeric phase runs the
    O(n kd^2) banded Cholesky, for band-hostile patterns the tile-map
    factor (ops/blocksparse) when its block fill stays under 0.35 n^2,
    else dense.  Dense inputs record the ordering only."""
    if _is_sparse_input(A):
        from cvxopt_tpu_torch.ops.sparse_kkt import rcm_order, \
            band_width_of
        S = _to_scipy(A)
        Ssym = ((S + S.T) != 0)
        n = S.shape[0]
        if p is not None:
            perm = np.asarray(p)
            kd = band_width_of(Ssym, perm)
        else:
            # cholmod.options['nmethods']: 0/1 the default ordering
            # (RCM here); >= 2 also tries minimum degree and keeps the
            # smaller bandwidth
            perm = rcm_order(Ssym)
            kd = band_width_of(Ssym, perm)
            if int(options.get("nmethods", 0)) >= 2:
                p2 = np.asarray(amd_order(Ssym))
                kd2 = band_width_of(Ssym, p2)
                if kd2 < kd:
                    perm, kd = p2, kd2
        # options['supernodal']: 0 = always the banded (simplicial-
        # analogue) path; >= 1 = automatic choice
        if int(options.get("supernodal", 2)) == 0:
            banded = True
        else:
            banded = (kd + 1) * 4 < n
        bsp_symb = None
        if not banded and p is None:
            from cvxopt_tpu_torch.ops import blocksparse as bsp
            t = 32 if n >= 64 else max(8, n // 4)
            cand = bsp.analyze(Ssym, t=t)
            if cand.nnzb * t * t < 0.35 * n * n:
                bsp_symb = cand
                perm = cand.perm
        if options.get("print", 0):
            path = ("banded" if banded else
                    "blocksparse" if bsp_symb is not None else "dense")
            print(f"cvxopt_tpu_torch.spsolve: n={n} bandwidth={kd} "
                  f"path={path}")
        return CholSymbolic(n=n, perm=perm, banded=banded, kd=kd,
                            bsp=bsp_symb)
    n = A.shape[-1] if hasattr(A, "shape") else np.asarray(A).shape[-1]
    return CholSymbolic(n=n, perm=None if p is None else np.asarray(p))


def _sym_scipy(A, uplo):
    S = _to_scipy(A)
    if uplo == "L":
        return sp.tril(S) + sp.tril(S, -1).T
    return sp.triu(S) + sp.triu(S, 1).T


def _blocked_band(AB, cb=128):
    """The banded Cholesky factor of AB (kd+1, n) in band storage,
    computed by `banded.pbtrf_blocked` (n/cb panel steps): LB[j, i] =
    L[i+j, i] read from the diagonal block or the subdiagonal block of
    column block i // cb."""
    from cvxopt_tpu_torch.ops import banded as bnd
    kd, n = AB.shape[0] - 1, AB.shape[1]
    cb = max(cb, kd)
    Ls, Cs = bnd.pbtrf_blocked(AB, cb=cb)
    i = torch.arange(n, device=AB.device)[None, :]
    r = i + torch.arange(kd + 1, device=AB.device)[:, None]
    bi, ci = i // cb, i % cb
    same = (r // cb) == bi
    nb = Ls.shape[0]
    LB = torch.where(same, Ls[bi, r % cb, ci],
                     Cs[bi.clamp(max=nb - 1), r % cb, ci])
    return torch.where(r < n, LB, torch.zeros_like(LB))


def numeric(A, symb: CholSymbolic, uplo="L", device="cuda") -> CholFactor:
    """Numeric Cholesky (cholmod.numeric)."""
    dev = _device_of(A, device=device)
    if symb.bsp is not None:
        from cvxopt_tpu_torch.ops import blocksparse as bsp
        Ab = bsp.assemble_scipy(symb.bsp, _sym_scipy(A, uplo), device=dev)
        return CholFactor(L=bsp.factor(symb.bsp, Ab), perm=symb.bsp.perm,
                          bsp=symb.bsp)
    if symb.banded:
        from cvxopt_tpu_torch.ops import banded as bnd
        coo = sp.coo_matrix(sp.csr_matrix(_sym_scipy(A, uplo))[symb.perm]
                            [:, symb.perm])
        AB = np.zeros((symb.kd + 1, symb.n))
        mask = coo.row >= coo.col
        AB[coo.row[mask] - coo.col[mask], coo.col[mask]] = coo.data[mask]
        AB = torch.as_tensor(AB, device=dev)
        dbound = float(options.get("dbound", 0.0))
        if dev.type == "cuda" and dbound == 0.0:
            LB = _blocked_band(AB)
        else:
            LB = bnd.pbtrf(AB, dbound=dbound)
        return CholFactor(L=LB, perm=symb.perm, banded=True)
    A = _dense(A, dev)
    A = torch.tril(A) + torch.tril(A, -1).transpose(-1, -2) \
        if uplo == "L" else \
        torch.triu(A) + torch.triu(A, 1).transpose(-1, -2)
    if symb.perm is not None:
        p = torch.as_tensor(symb.perm, device=dev)
        A = A[..., p, :][..., :, p]
    from cvxopt_tpu_torch.ops.banded import _chol_nan
    return CholFactor(L=_chol_nan(A), perm=symb.perm)


def _apply_perm(B, idx):
    """X[i] = B[idx[i]] along the leading axis."""
    return B[torch.as_tensor(np.asarray(idx), device=B.device)]


def solve(F: CholFactor, B, sys: int = 0):
    """Solve with the factor (cholmod.solve): the CHOLMOD sys table for
    P A P' = L L' (D = I):

        0  A X = B          5  L' X = B
        1  L D L' X = B     6  D X = B      (identity for LL')
        2  L D X = B        7  P' X = B  ->  X = P B
        3  D L' X = B       8  P X = B   ->  X = P' B
        4  L X = B

    sys 1-6 act in the permuted coordinates; only sys 0 round-trips
    through P."""
    B = _dense(B, F.L.device)
    if not 0 <= sys <= 8:
        raise ValueError(f"sys must be in 0..8, got {sys}")
    perm = F.perm if F.perm is not None else (
        F.bsp.perm if F.bsp is not None else None)
    if sys in (7, 8):
        if perm is None:
            return B
        idx = np.asarray(perm) if sys == 7 else np.argsort(perm)
        return _apply_perm(B, idx)
    if sys == 6:                 # D = I for an LL' factor
        return B
    if F.bsp is not None:
        from cvxopt_tpu_torch.ops import blocksparse as bsp
        if sys == 0:
            return bsp.solve(F.bsp, F.L, B)
        if sys == 1:
            # A = P' L L' P, so (LL')^{-1} B = P A^{-1} P' B
            p = np.asarray(F.bsp.perm)
            X = bsp.solve(F.bsp, F.L, _apply_perm(B, np.argsort(p)))
            return _apply_perm(X, p)
        raise ValueError("blocksparse factor supports sys in "
                         "{0,1,6,7,8} only")
    if F.banded:
        from cvxopt_tpu_torch.ops import banded as bnd
        if sys == 0:
            X = bnd.pbtrs(F.L, _apply_perm(B, F.perm))
            return _apply_perm(X, np.argsort(F.perm))
        if sys == 1:
            return bnd.pbtrs(F.L, B)
        if sys in (2, 4):        # L D X = B -> L X = B (D = I)
            return bnd.tbtrs(F.L, B)
        return bnd.tbtrs(F.L, B, trans="T")      # sys 3, 5
    from cvxopt_tpu_torch.ops.blas import _solve_tri
    if F.perm is not None and sys == 0:
        B = _apply_perm(B, F.perm)
    if sys in (2, 4):
        X = _solve_tri(F.L, B, upper=False)
    elif sys in (3, 5):
        X = _solve_tri(F.L.transpose(-1, -2), B, upper=True)
    else:                        # 0 or 1: the full L L' solve
        X = _solve_tri(F.L.transpose(-1, -2), _solve_tri(F.L, B, upper=False),
                 upper=True)
    if F.perm is not None and sys == 0:
        X = _apply_perm(X, np.argsort(F.perm))
    return X


def linsolve(A, B, p=None, uplo="L", device="cuda"):
    """One-shot solve (cholmod.linsolve), on the device of a tensor A
    or B, else on `device`."""
    dev = _device_of(A, B, device=device)
    return solve(numeric(A, symbolic(A, p), uplo, device=dev), B)


def splinsolve(A, B, p=None, uplo="L", device="cuda"):
    return linsolve(A, B, p, uplo, device=device)


def diag(F: CholFactor):
    """Diagonal of the factor (cholmod.diag)."""
    return torch.diagonal(F.L, dim1=-2, dim2=-1)


def getfactor(F: CholFactor):
    return F.L


# ---- umfpack-like --------------------------------------------------------

@dataclass
class LUSymbolic:
    n: int
    perm: Optional[np.ndarray] = None    # banded path: RCM ordering
    kl: int = 0
    ku: int = 0
    banded: bool = False
    bsp: Optional[object] = None    # BlockSymbolic (tile-map LU path)


@dataclass
class LUFactor:
    lu: object                  # torch (LU, pivots) OR gbtrf_scan factor
    piv: object
    symb: Optional[LUSymbolic] = None
    ABT: Optional[torch.Tensor] = None   # unused, as in the JAX package
    facT: Optional[object] = None        # banded: factor of A'
    Utab: Optional[torch.Tensor] = None  # blocksparse: U slot table


def _band_widths(S, perm):
    pos = np.argsort(perm)
    coo = sp.coo_matrix(S)
    if not coo.nnz:
        return 0, 0
    d = pos[coo.row] - pos[coo.col]
    return int(max(d.max(), 0)), int(max((-d).max(), 0))


def lu_symbolic(A) -> LUSymbolic:
    """umfpack.symbolic.  Sparse inputs get an RCM ordering of the
    symmetrized pattern; a banded result runs the pivoted banded LU
    (`banded.gbtrf_scan`), a band-hostile pattern the tile-map block
    LU (`blocksparse.factor_lu`) when its block fill stays under
    0.35 n^2, anything else a dense LU."""
    if _is_sparse_input(A):
        from cvxopt_tpu_torch.ops.sparse_kkt import rcm_order
        S = _to_scipy(A)
        n = S.shape[0]
        perm = rcm_order((S + S.T) != 0)
        kl, ku = _band_widths(S != 0, perm)
        banded = (kl + ku + 2) * 4 < n
        bsp_symb = None
        if not banded:
            from cvxopt_tpu_torch.ops import blocksparse as bsp
            t = 32 if n >= 64 else max(8, n // 4)
            cand = bsp.analyze(((S + S.T) != 0), t=t)
            if cand.nnzb * t * t < 0.35 * n * n:
                bsp_symb = cand
        if options.get("print", 0):
            path = ("banded" if banded else
                    "blocksparse" if bsp_symb is not None else "dense")
            print(f"cvxopt_tpu_torch.spsolve(lu): n={n} kl={kl} ku={ku} "
                  f"path={path}")
        return LUSymbolic(n=n, perm=perm, kl=kl, ku=ku, banded=banded,
                          bsp=bsp_symb)
    n = A.shape[-1] if hasattr(A, "shape") else np.asarray(A).shape[-1]
    return LUSymbolic(n=n)


def _to_gb_storage(S, perm, kl, ku, dev):
    n = S.shape[0]
    Spp = sp.coo_matrix(sp.csr_matrix(S)[perm][:, perm])
    AB = np.zeros((kl + ku + 1, n))
    AB[ku + Spp.row - Spp.col, Spp.col] = Spp.data
    return torch.as_tensor(AB, device=dev)


def lu_numeric(A, symb: LUSymbolic, device="cuda") -> LUFactor:
    """umfpack.numeric."""
    from cvxopt_tpu_torch.ops import banded as bnd
    dev = _device_of(A, device=device)
    if symb.banded:
        S = _to_scipy(A)
        fac = bnd.gbtrf_scan(_to_gb_storage(S, symb.perm, symb.kl,
                                            symb.ku, dev), symb.kl, symb.ku)
        # A' under the same permutation is (ku, kl)-banded
        facT = bnd.gbtrf_scan(_to_gb_storage(S.T, symb.perm, symb.ku,
                                             symb.kl, dev), symb.ku, symb.kl)
        return LUFactor(lu=fac, piv=None, symb=symb, facT=facT)
    if symb.bsp is not None:
        from cvxopt_tpu_torch.ops import blocksparse as bsp
        Alow, Aupt = bsp.assemble_lu(symb.bsp, _to_scipy(A), device=dev)
        Ltab, Utab = bsp.factor_lu(symb.bsp, Alow, Aupt)
        return LUFactor(lu=Ltab, piv=None, symb=symb, Utab=Utab)
    lu, piv = torch.linalg.lu_factor(_dense(A, dev))
    return LUFactor(lu=lu, piv=piv)


def lu_solve(F: LUFactor, B, trans="N"):
    """umfpack.solve, trans 'N', 'T' or 'C'."""
    if F.symb is not None and F.symb.bsp is not None:
        from cvxopt_tpu_torch.ops import blocksparse as bsp
        return bsp.solve_lu(F.symb.bsp, F.lu, F.Utab,
                            _dense(B, F.lu.device),
                            trans="N" if trans == "N" else "T")
    if F.symb is not None and F.symb.banded:
        from cvxopt_tpu_torch.ops import banded as bnd
        symb = F.symb
        B = _dense(B, F.lu[0].device)
        Bp = _apply_perm(B, symb.perm)
        if trans == "N":
            X = bnd.gbtrs_scan(F.lu, Bp, symb.kl, symb.ku)
        else:
            X = bnd.gbtrs_scan(F.facT, Bp, symb.ku, symb.kl)
        return _apply_perm(X, np.argsort(symb.perm))
    from cvxopt_tpu_torch.ops.banded import _lu_solve
    return _lu_solve((F.lu, F.piv), _dense(B, F.lu.device), trans)


def lu_linsolve(A, B, device="cuda"):
    """umfpack.linsolve, on the device of a tensor A or B, else on
    `device`."""
    dev = _device_of(A, B, device=device)
    return lu_solve(lu_numeric(A, lu_symbolic(A), device=dev), B)


# ---- amd-like ------------------------------------------------------------

def amd_order(A):
    """Minimum-degree fill-reducing ordering of the symmetrized pattern
    (amd.order), on the host: the port's native library
    (cvxopt_tpu_torch/native/mindeg.c) when it builds, this pure-Python
    loop otherwise."""
    if torch.is_tensor(A):
        S = _to_scipy(A) if A.is_sparse else \
            sp.csr_matrix(A.cpu().numpy() != 0)
    elif sp.issparse(A):
        S = sp.csr_matrix(A)
    else:
        S = sp.csr_matrix(np.asarray(A) != 0)
    Ssym = ((S + S.T) != 0)
    n = Ssym.shape[0]
    from cvxopt_tpu_torch import native
    csr = Ssym.tocsr()
    perm = native.mindeg_order(csr.indptr, csr.indices, n)
    if perm is not None:
        return perm.astype(np.int64)
    S = Ssym.tolil()
    deg = np.array([len(r) for r in S.rows])
    alive = np.ones(n, bool)
    order = []
    adj = [set(r) - {i} for i, r in enumerate(S.rows)]
    for _ in range(n):
        cand = np.where(alive)[0]
        v = cand[np.argmin(deg[cand])]
        order.append(v)
        alive[v] = False
        nb = [u for u in adj[v] if alive[u]]
        for u in nb:
            adj[u].discard(v)
            for w in nb:
                if w != u and w not in adj[u]:
                    adj[u].add(w)
            deg[u] = sum(1 for t in adj[u] if alive[t])
    return np.array(order)
